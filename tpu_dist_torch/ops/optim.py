"""Optimizers and the LM learning-rate schedule for the port
(``tpu_dist/ops/optim.py``: ``lm_lr_schedule :33``, ``make_optimizer
:82``).

The reference builds optax chains; the port keeps their semantics as
plain-PyTorch functional transforms over lists of tensors, with optax's
``init(params) -> state`` / ``update(grads, state, params) -> (updates,
state)`` protocol, so :func:`tpu_dist_torch.engine.steps.apply_update`
treats both the same way:

* ``sgd``: clip by global norm, then weight decay added to the gradient
  (``optax.add_decayed_weights``), then torch-SGD momentum as
  ``optax.trace`` (``buf = g + mu * buf``), then ``-lr * buf``;
* ``adamw``: clip by global norm, then ``optax.scale_by_adam`` with
  ``eps_root = 0`` (b2 defaults to 0.95, the large-LM convention), then
  decoupled weight decay, then ``-lr * update``.

The schedule is evaluated at the optimizer's own 0-indexed step count, as
optax's ``scale_by_learning_rate`` does; the step count lives in the state.
All optimizer state is fp32 on the params' device.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch


def lm_lr_schedule(base_lr: float, kind: str = "constant",
                   warmup_steps: int = 0, total_steps: int = 0,
                   steps_per_epoch: int = 1, step_epochs: int = 30,
                   factor: float = 0.1, min_frac: float = 0.0) -> Callable:
    """``step -> lr`` (a Python float computed in fp32, as the reference's
    jnp schedule): linear warmup from base/warmup_steps into constant |
    cosine (half-cosine to ``min_frac * base`` over ``total_steps -
    warmup_steps``, flat after) | step (x ``factor`` every ``step_epochs``
    epochs of ``steps_per_epoch``)."""
    if kind not in ("constant", "cosine", "step"):
        raise ValueError(f"unknown lr schedule {kind!r} "
                         "(constant|cosine|step)")
    if kind == "cosine" and total_steps <= warmup_steps:
        raise ValueError(f"cosine needs total_steps ({total_steps}) > "
                         f"warmup_steps ({warmup_steps})")
    f32 = np.float32

    def schedule(step) -> float:
        s = f32(step)
        if kind == "cosine":
            horizon = f32(max(total_steps - warmup_steps, 1))
            t = np.clip((s - f32(warmup_steps)) / horizon, f32(0), f32(1))
            lr = f32(base_lr) * (f32(min_frac) + (f32(1) - f32(min_frac))
                                 * f32(0.5) * (f32(1) + np.cos(f32(math.pi)
                                                               * t)))
        elif kind == "step":
            epoch = np.floor(s / f32(max(steps_per_epoch, 1)))
            lr = f32(base_lr) * np.power(f32(factor),
                                         np.floor(epoch / f32(step_epochs)))
        else:
            lr = f32(base_lr)
        if warmup_steps and s < warmup_steps:
            lr = f32(base_lr) * (s + f32(1)) / f32(warmup_steps)
        return float(f32(lr))

    return schedule


def step_decay_schedule(base_lr: float, steps_per_epoch: int,
                        step_epochs: int = 30, factor: float = 0.1
                        ) -> Callable:
    """lr = base * factor^(epoch // step_epochs): the reference's default
    when ``make_optimizer`` gets no schedule."""
    def schedule(step) -> float:
        epoch = int(step) // max(steps_per_epoch, 1)
        return base_lr * factor ** (epoch // step_epochs)
    return schedule


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm: ``g / norm * max_norm`` when the global
    norm exceeds ``max_norm``, else g unchanged (on the device, no sync)."""
    norm = _global_norm(grads)
    clip = norm >= max_norm
    return [torch.where(clip, g / norm * max_norm, g) for g in grads]


class OptState(NamedTuple):
    count: int                   # optimizer steps taken (schedule index)
    mu: List[torch.Tensor]       # sgd trace or adam first moments
    nu: List[torch.Tensor]       # adam second moments ([] for sgd)


class Optimizer:
    """A functional optimizer with optax's protocol (module docstring)."""

    def __init__(self, kind: str, schedule: Callable, momentum: float,
                 weight_decay: float, b1: float, b2: float, eps: float,
                 grad_clip: float):
        if kind not in ("sgd", "adamw"):
            raise ValueError(f"unknown optimizer kind {kind!r} (sgd|adamw)")
        self.kind, self.schedule = kind, schedule
        self.momentum, self.weight_decay = momentum, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip = grad_clip

    def init(self, params) -> OptState:
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
        return OptState(0, [z(p) for p in params],
                        [z(p) for p in params] if self.kind == "adamw"
                        else [])

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        """(updates, new_state): updates to add to ``params``."""
        u = [g.float() for g in grads]
        if self.grad_clip > 0:
            u = clip_by_global_norm(u, self.grad_clip)
        lr = self.schedule(state.count)
        if self.kind == "adamw":
            t = state.count + 1
            mu = [(1 - self.b1) * g + self.b1 * m for g, m in zip(u, state.mu)]
            nu = [(1 - self.b2) * (g * g) + self.b2 * n
                  for g, n in zip(u, state.nu)]
            c1 = 1 - np.float32(self.b1) ** np.float32(t)
            c2 = 1 - np.float32(self.b2) ** np.float32(t)
            u = [(m / float(c1)) / (torch.sqrt(n / float(c2)) + self.eps)
                 for m, n in zip(mu, nu)]
            if self.weight_decay:
                u = [x + self.weight_decay * p.float()
                     for x, p in zip(u, params)]
            new = OptState(t, mu, nu)
        else:
            if self.weight_decay:
                u = [x + self.weight_decay * p.float()
                     for x, p in zip(u, params)]
            mu = [x + self.momentum * m for x, m in zip(u, state.mu)]
            u = mu
            new = OptState(state.count + 1, mu, [])
        return [-lr * x for x in u], new


def make_optimizer(lr: float, momentum: float = 0.9,
                   weight_decay: float = 1e-4, steps_per_epoch: int = 1,
                   lr_step_epochs: int = 30,
                   schedule: Optional[Callable] = None, kind: str = "sgd",
                   b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                   grad_clip: float = 0.0) -> Optimizer:
    """torch.optim.SGD(momentum, weight_decay)-equivalent with step-decay
    LR, or decoupled AdamW (``kind='adamw'``); ``grad_clip > 0`` clips the
    raw gradient by global norm before any momentum/adam statistics."""
    sched = schedule or step_decay_schedule(lr, steps_per_epoch,
                                            lr_step_epochs)
    return Optimizer(kind, sched, momentum, weight_decay, b1, b2, eps,
                     grad_clip)
