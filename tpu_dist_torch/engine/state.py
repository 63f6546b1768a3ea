"""Train state for the port (``tpu_dist/engine/state.py``).

The reference threads an immutable pytree ``(step, params, batch_stats,
opt_state, loss_scale)`` through its jitted step. The port's step runs
eagerly and updates the model's parameters and the optimizer state in
place, so the state is a small mutable record: the optimizer step count
(on the host, so reading it never syncs the device), the parameter list in
``named_parameters`` order, and the optimizer state aligned with it.
BatchNorm statistics and the fp16 loss scale belong to the image trainer
and are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import torch
from torch import nn


@dataclass
class TrainState:
    step: int
    params: List[nn.Parameter]
    opt_state: Any

    @classmethod
    def create(cls, model: nn.Module, tx) -> "TrainState":
        params = [p for _, p in model.named_parameters()]
        return cls(step=0, params=params, opt_state=tx.init(params))

    def opt_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the optimizer state (both optimizers keep two
        per-parameter lists, ``mu`` and ``nu``)."""
        return [*self.opt_state.mu, *self.opt_state.nu]
