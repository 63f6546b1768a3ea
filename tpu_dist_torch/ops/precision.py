"""Mixed-precision policy for the port (``tpu_dist/ops/precision.py``
``:35-57``, ``Policy`` and ``make_policy``).

* ``fp32``: params and compute in fp32;
* ``bf16``: fp32 master params, bf16 compute (each call casts the params,
  as flax does); LayerNorm statistics, softmax and logits stay fp32;
* ``bf16_params``: params stored in bf16 as well.

:meth:`Policy.cast_params_for_storage` stores a model's floating params in
``param_dtype`` (``:48``). The reference's dynamic loss scaling
(``LossScaleState``, ``:60-97``) emulates apex's fp16 path; no ported
configuration uses it, and :func:`loss_scale` raises naming the knob.
"""

from __future__ import annotations

from dataclasses import dataclass

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


def loss_scale(initial=None):
    """The reference's dynamic fp16 loss scale is not ported."""
    raise NotImplementedError(
        "loss_scale is not ported yet: the dynamic fp16 loss scale "
        "(tpu_dist/ops/precision.py LossScaleState) has no port; bf16 needs "
        "none")
