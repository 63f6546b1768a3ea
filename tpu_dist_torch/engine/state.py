"""Train state for the port (``tpu_dist/engine/state.py``).

The reference threads an immutable pytree ``(step, params, batch_stats,
opt_state, loss_scale)`` through its jitted step. The port's step runs
eagerly and updates the model's parameters, its BatchNorm buffers and the
optimizer state in place, so the state is a small mutable record: the
step count (on the host, so reading it never syncs the device), the
parameter list in ``named_parameters`` order, the optimizer state aligned
with it, ``batch_stats``, the model's running buffers in ``named_buffers``
order (BN ``mean``/``var``; none for the LM), the leaf names of both
(checkpoints carry them, so a warm start can match leaves by name) and
the fp16 ``loss_scale`` (``ops.precision.LossScaleState``; None unless
the run scales its loss).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import torch
from torch import nn

from tpu_dist_torch.ops.precision import LossScaleState


@dataclass
class TrainState:
    step: int
    params: List[nn.Parameter]
    opt_state: Any
    batch_stats: List[torch.Tensor] = field(default_factory=list)
    param_names: List[str] = field(default_factory=list)
    stat_names: List[str] = field(default_factory=list)
    loss_scale: Optional[LossScaleState] = None

    @classmethod
    def create(cls, model: nn.Module, tx,
               loss_scale: Optional[LossScaleState] = None) -> "TrainState":
        names, params = zip(*model.named_parameters())
        stats = list(model.named_buffers())
        return cls(step=0, params=list(params),
                   opt_state=tx.init(list(params)),
                   batch_stats=[b for _, b in stats],
                   param_names=list(names),
                   stat_names=[n for n, _ in stats], loss_scale=loss_scale)

    def opt_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the optimizer state, field by field (a field is
        a tensor, such as the optax-style count, or a per-parameter
        list)."""
        out = []
        for v in self.opt_state:
            out.extend([v] if torch.is_tensor(v) else v)
        return out
