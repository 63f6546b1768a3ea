"""Train state for the port (``tpu_dist/engine/state.py``).

The reference threads an immutable pytree ``(step, params, batch_stats,
opt_state, loss_scale)`` through its jitted step. The port's step runs
eagerly and updates the model's parameters, its BatchNorm buffers and the
optimizer state in place, so the state is a small mutable record: the
step count (on the host, so reading it never syncs the device), the
parameter list in ``named_parameters`` order, the optimizer state aligned
with it, and ``batch_stats``, the model's running buffers in
``named_buffers`` order (BN ``mean``/``var``; none for the LM). The fp16
loss scale is not ported (``ops.precision.loss_scale``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List

import torch
from torch import nn


@dataclass
class TrainState:
    step: int
    params: List[nn.Parameter]
    opt_state: Any
    batch_stats: List[torch.Tensor] = field(default_factory=list)

    @classmethod
    def create(cls, model: nn.Module, tx) -> "TrainState":
        params = [p for _, p in model.named_parameters()]
        return cls(step=0, params=params, opt_state=tx.init(params),
                   batch_stats=[b for _, b in model.named_buffers()])

    def opt_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the optimizer state, field by field (a field is
        a tensor, such as the optax-style count, or a per-parameter
        list)."""
        out = []
        for v in self.opt_state:
            out.extend([v] if torch.is_tensor(v) else v)
        return out
