"""Optimizers and the LM learning-rate schedule for the port
(``tpu_dist/ops/optim.py``: ``lm_lr_schedule :33``, ``make_optimizer
:82``).

The reference builds optax chains; the port keeps their semantics as
plain-PyTorch transforms over lists of tensors, with optax's
``init(params) -> state`` / ``update(grads, state, params) -> (updates,
state)`` protocol, so :func:`tpu_dist_torch.engine.steps.apply_update`
treats both the same way. ``update`` writes the moments and the count in
place and hands the same state back:

* ``sgd``: clip by global norm, then weight decay added to the gradient
  (``optax.add_decayed_weights``), then torch-SGD momentum as
  ``optax.trace`` (``buf = g + mu * buf``), then ``-lr * buf``;
* ``adamw``: clip by global norm, then ``optax.scale_by_adam`` with
  ``eps_root = 0`` (b2 defaults to 0.95, the large-LM convention), then
  decoupled weight decay, then ``-lr * update``.

The schedule is evaluated at the optimizer's own 0-indexed step count, as
optax's ``scale_by_learning_rate`` does. The count lives in the state as a
0-d int32 tensor on the params' device, so a skipped step
(``engine.steps.apply_update`` under ``health="skip"``) reverts it with the
rest of the state and no step syncs the host. All other optimizer state is
fp32 on the params' device.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

import torch


def _as_step(step) -> torch.Tensor:
    """The step as a 0-d fp32 tensor on its own device (a host int goes to
    a CPU tensor), so a schedule reads a device count without a sync."""
    return torch.as_tensor(step).to(torch.float32)


def _like_step(lr: torch.Tensor, step):
    """A tensor step gets a 0-d fp32 tensor back, a host int a float."""
    return lr if torch.is_tensor(step) else float(lr)


def lm_lr_schedule(base_lr: float, kind: str = "constant",
                   warmup_steps: int = 0, total_steps: int = 0,
                   steps_per_epoch: int = 1, step_epochs: int = 30,
                   factor: float = 0.1, min_frac: float = 0.0) -> Callable:
    """``step -> lr``, computed in fp32 with torch ops as the reference's
    jnp schedule is: linear warmup from base/warmup_steps into constant |
    cosine (half-cosine to ``min_frac * base`` over ``total_steps -
    warmup_steps``, flat after) | step (x ``factor`` every ``step_epochs``
    epochs of ``steps_per_epoch``). A 0-d tensor step (the optimizer's
    device count) gives a 0-d tensor on its device; a host int, a float."""
    if kind not in ("constant", "cosine", "step"):
        raise ValueError(f"unknown lr schedule {kind!r} "
                         "(constant|cosine|step)")
    if kind == "cosine" and total_steps <= warmup_steps:
        raise ValueError(f"cosine needs total_steps ({total_steps}) > "
                         f"warmup_steps ({warmup_steps})")

    def schedule(step):
        s = _as_step(step)
        if kind == "cosine":
            horizon = float(max(total_steps - warmup_steps, 1))
            t = torch.clamp((s - warmup_steps) / horizon, 0.0, 1.0)
            lr = base_lr * (min_frac + (1.0 - min_frac) * 0.5 * (
                1.0 + torch.cos(math.pi * t)))
        elif kind == "step":
            epoch = torch.floor(s / max(steps_per_epoch, 1))
            lr = base_lr * torch.pow(torch.full_like(s, factor),
                                     torch.floor(epoch / step_epochs))
        else:
            lr = torch.full_like(s, base_lr)
        if warmup_steps:
            lr = torch.where(s < warmup_steps,
                             base_lr * (s + 1.0) / warmup_steps, lr)
        return _like_step(lr, step)

    return schedule


def step_decay_schedule(base_lr: float, steps_per_epoch: int,
                        step_epochs: int = 30, factor: float = 0.1
                        ) -> Callable:
    """lr = base * factor^(epoch // step_epochs): the reference's default
    when ``make_optimizer`` gets no schedule (``:23``), in fp32 with torch
    ops on the step (tensor in, tensor out; int in, float out)."""
    def schedule(step):
        s = _as_step(step)
        epoch = torch.floor(s / max(steps_per_epoch, 1))
        lr = base_lr * torch.pow(torch.full_like(s, factor),
                                 torch.floor(epoch / step_epochs))
        return _like_step(lr, step)
    return schedule


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        sq_norm=None):
    """optax.clip_by_global_norm: ``g / norm * max_norm`` when the global
    norm exceeds ``max_norm``, else g unchanged (on the device, no sync).
    ``sq_norm`` (leaves -> global sum of squares) takes the norm over
    sharded leaves."""
    norm = (_global_norm(grads) if sq_norm is None
            else torch.sqrt(sq_norm(grads)))
    clip = norm >= max_norm
    return [torch.where(clip, g / norm * max_norm, g) for g in grads]


class OptState(NamedTuple):
    count: torch.Tensor          # 0-d int32: steps taken (schedule index)
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
        self.sq_norm = None   # as FusedAdamW.sq_norm

    def init(self, params) -> OptState:
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
        dev = params[0].device if len(params) else None
        return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                        [z(p) for p in params],
                        [z(p) for p in params] if self.kind == "adamw"
                        else [])

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        """(updates, state): updates to add to ``params``. The moments and
        the count are updated in place and ``state`` comes back: no new
        state is allocated, and the train state keeps its storage (as
        buffer donation gives the reference; the program audit's PL003)."""
        u = [g.float() for g in grads]
        if self.grad_clip > 0:
            u = clip_by_global_norm(u, self.grad_clip, self.sq_norm)
        lr = self.schedule(state.count)
        state.count.add_(1)
        if self.kind == "adamw":
            torch._foreach_mul_(state.mu, self.b1)
            torch._foreach_add_(state.mu, u, alpha=1 - self.b1)
            torch._foreach_mul_(state.nu, self.b2)
            torch._foreach_addcmul_(state.nu, u, u, value=1 - self.b2)
            tf = state.count.to(torch.float32)
            c1 = 1 - torch.pow(torch.full_like(tf, self.b1), tf)
            c2 = 1 - torch.pow(torch.full_like(tf, self.b2), tf)
            u = [(m / c1) / (torch.sqrt(n / c2) + self.eps)
                 for m, n in zip(state.mu, state.nu)]
            if self.weight_decay:
                u = [x + self.weight_decay * p.float()
                     for x, p in zip(u, params)]
        else:
            if self.weight_decay:
                u = [x + self.weight_decay * p.float()
                     for x, p in zip(u, params)]
            torch._foreach_mul_(state.mu, self.momentum)
            torch._foreach_add_(state.mu, u)
            u = state.mu
        return [-lr * x for x in u], state


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
