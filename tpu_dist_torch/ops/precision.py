"""Mixed-precision policy for the port (``tpu_dist/ops/precision.py``
``:35-57``, ``Policy`` and ``make_policy``).

* ``fp32``: params and compute in fp32;
* ``bf16``: fp32 master params, bf16 compute (each call casts the params,
  as flax does); LayerNorm statistics, softmax and logits stay fp32;
* ``bf16_params``: params stored in bf16 as well.

:meth:`Policy.cast_params_for_storage` stores a model's floating params in
``param_dtype`` (``:48``).

The dynamic loss scale (``LossScaleState``, :func:`scale_loss`,
:func:`unscale_and_update`, ``:60-97``) is apex's fp16 recipe: the loss
is multiplied by the scale before the backward, the grads are divided by
it after, and a step whose grads are not all finite is skipped while the
scale halves (never below 1); ``growth_interval`` finite steps in a row
double it. The state is two 0-d device tensors, so no step reads it on
the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import torch

PRECISIONS = ("fp32", "bf16", "bf16_params")


@dataclass(frozen=True)
class Policy:
    """Dtype policy: where params live, where compute happens."""

    name: str = "fp32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.name in ("bf16", "bf16_params")
                else torch.float32)

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.name == "bf16_params" else torch.float32

    def cast_params_for_storage(self, model):
        """Store every floating parameter of ``model`` in ``param_dtype``
        (in place, the same ``Parameter`` objects); returns ``model``."""
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(self.param_dtype)
        return model


def make_policy(name: str) -> Policy:
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r} (fp32|bf16|bf16_params)")
    return Policy(name)


class LossScaleState(NamedTuple):
    """Dynamic loss-scale state: 0-d fp32 ``scale`` and int32
    ``good_steps`` (consecutive finite-grad steps) on the device."""

    scale: torch.Tensor
    good_steps: torch.Tensor

    @staticmethod
    def create(initial: float = 2.0 ** 15, device=None) -> "LossScaleState":
        return LossScaleState(
            torch.tensor(float(initial), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def scale_loss(loss: torch.Tensor,
               state: Optional[LossScaleState]) -> torch.Tensor:
    return loss if state is None else loss * state.scale


def unscale_and_update(grads: List[torch.Tensor],
                       state: Optional[LossScaleState],
                       growth_interval: int = 2000
                       ) -> Tuple[List[torch.Tensor],
                                  Optional[LossScaleState], torch.Tensor]:
    """(unscaled grads, new state, all-finite flag as a 0-d bool tensor).
    With ``state=None`` the grads pass through and the flag is True."""
    if state is None:
        dev = grads[0].device if grads else None
        return grads, None, torch.ones((), dtype=torch.bool, device=dev)
    inv = 1.0 / state.scale
    grads = [g.float() * inv for g in grads]
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    good = torch.where(finite, state.good_steps + 1,
                       torch.zeros_like(state.good_steps))
    grow = good >= growth_interval
    scale = torch.where(
        finite, torch.where(grow, state.scale * 2.0, state.scale),
        torch.clamp(state.scale * 0.5, min=1.0))
    good = torch.where(grow, torch.zeros_like(good), good)
    return grads, LossScaleState(scale, good), finite
