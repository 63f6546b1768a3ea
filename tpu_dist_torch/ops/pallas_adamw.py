"""Fused AdamW for the port (``tpu_dist/ops/pallas_adamw.py``).

:class:`FusedAdamW` keeps the reference's engine-facing protocol
(``init(params)``, ``apply(params, grads, state, step)``) and its scalar
row ``[lr, b1, b2, eps, wd, 1-b1^t, 1-b2^t, clip_scale]`` (``:143-151``),
with ``t`` the 1-indexed step. A step is one launch of the hand-written
Hopper kernel ``csrc/adamw.cu`` (the Pallas ``_adamw_kernel``, ``:57-73``)
over every leaf of one p dtype for CUDA tensors
(:func:`fused_adamw_multi_cuda`), or a loop of :func:`fused_adamw_plain`
for CPU tensors. The update rule is optax.adamw with ``eps_root = 0`` and the
global-norm clip fused in::

    g  <- g * cs            (cs = clip / norm when norm > clip, else 1)
    m' = b1 m + (1-b1) g;   v' = b2 v + (1-b2) g g
    p' = p - lr ((m' / (1-b1^t)) / (sqrt(v' / (1-b2^t)) + eps) + wd p)

in fp32 whatever p's dtype, p written back in its own dtype, m and v fp32.
Unlike the reference, which donates p, m and v to a functional call, the
port updates them in place: no second copy of the optimizer state exists.
The scalar row is built on the device each step (:func:`scalar_row`), so a
step syncs nothing with the host. ``clip_scale`` comes from
``ops.pallas_sgd``, as the reference's ``pallas_adamw.py:41`` imports it.
The row-tile knob is ``ops.pallas_sgd``'s one setting (``:46-54``):
:func:`set_block_rows` here is its alias, and each launch's chunk is
``8 x block_rows()`` elements (4096 at the default).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import numpy as np
import torch

from tpu_dist_torch import kernels
from tpu_dist_torch.ops import pallas_sgd as _psgd
from tpu_dist_torch.ops.pallas_sgd import clip_scale, run_multi


def set_block_rows(rows=None) -> None:
    """Alias of ``ops.pallas_sgd.set_block_rows`` (one shared setting)."""
    _psgd.set_block_rows(rows)


def block_rows() -> int:
    """Alias of ``ops.pallas_sgd.block_rows``."""
    return _psgd.block_rows()


def scalar_row(lr: float, b1: float, b2: float, eps: float, wd: float,
               t: int, cs: torch.Tensor) -> torch.Tensor:
    """The kernel's (8,) fp32 scalar row on ``cs``'s device, the bias
    corrections in fp32 as the reference computes them. The host values
    travel in one pinned, non-blocking copy; ``cs`` stays on the device."""
    f32 = np.float32
    host = torch.tensor([lr, b1, b2, eps, wd,
                         f32(1) - f32(b1) ** f32(t),
                         f32(1) - f32(b2) ** f32(t), 1.0],
                        dtype=torch.float32)
    if cs.is_cuda:
        host = host.pin_memory()
    row = host.to(cs.device, non_blocking=True)
    row[7:].copy_(cs.reshape(1))
    return row


@kernels.plain_version
def fused_adamw_plain(p, g, m, v, scalars) -> None:
    """The kernel's function in plain PyTorch, in place on (p, m, v): fp32
    math in the kernel's operation order, p stored back in its dtype."""
    lr, b1, b2, eps, wd, c1, c2, cs = scalars.unbind()
    pf = p.float()
    gf = g.float() * cs
    mf = b1 * m + (1.0 - b1) * gf
    vf = b2 * v + (1.0 - b2) * gf * gf
    update = (mf / c1) / (torch.sqrt(vf / c2) + eps) + wd * pf
    p.copy_((pf - lr * update).to(p.dtype))
    m.copy_(mf)
    v.copy_(vf)


def _check_adamw(p, g, m, v, scalars):
    if p.dtype not in kernels.DTYPE_CODE:
        raise TypeError(f"adamw kernel takes float32 or bfloat16 params, "
                        f"got {p.dtype}")
    for name, t in (("g", g), ("m", m), ("v", v), ("scalars", scalars)):
        if t.dtype != torch.float32:
            raise TypeError(f"adamw kernel: {name} must be float32, got "
                            f"{t.dtype}")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v),
                    ("scalars", scalars)):
        if t.device != p.device or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"adamw kernel: {name} must be contiguous on "
                             f"p's CUDA device")
    if not (g.shape == m.shape == v.shape == p.shape):
        raise ValueError(f"adamw kernel: p, g, m, v shapes differ: "
                         f"{tuple(p.shape)}, {tuple(g.shape)}, "
                         f"{tuple(m.shape)}, {tuple(v.shape)}")
    if scalars.numel() != 8:
        raise ValueError("adamw kernel: the scalar row has 8 entries")


def fused_adamw_multi_cuda(ps, gs, ms, vs, scalars) -> None:
    """One update of every leaf in place on (p, m, v): the leaves are
    grouped by p dtype and each group is one call of ``csrc/adamw.cu`` on
    the current stream (one launch over all its leaves, up to 512). ``g``
    is cast to fp32 where it is not, as the reference casts it. Each call
    adds one to ``kernels.LAUNCHES["adamw"]``; a group of empty leaves
    makes none."""
    run_multi("adamw", _check_adamw,
              (ps, [g.float().contiguous() for g in gs], ms, vs), scalars)


def fused_adamw_cuda(p, g, m, v, scalars) -> None:
    """One leaf through ``csrc/adamw.cu`` (a table of one row), in place
    on (p, m, v); ``g`` must already be fp32."""
    run_multi("adamw", _check_adamw, ([p], [g], [m], [v]), scalars)


def fused_adamw_leaf(p, g, m, v, scalars) -> None:
    """One leaf's update in place: the kernel for CUDA tensors, the plain
    version for CPU tensors. ``g`` is cast to fp32 first, as the reference
    casts it."""
    g = g.float().contiguous()
    if p.device.type == "cpu":
        fused_adamw_plain(p, g, m, v, scalars)
    else:
        fused_adamw_cuda(p, g, m, v, scalars)


class FusedAdamWState(NamedTuple):
    mu: List[torch.Tensor]   # first moments, fp32
    nu: List[torch.Tensor]   # second moments, fp32


class FusedAdamW:
    """Fused-kernel AdamW with the engine-facing ``apply()`` protocol
    (``engine.steps.apply_update`` dispatches on it). ``params`` and
    ``grads`` are equal-length lists of tensors."""

    def __init__(self, schedule: Callable, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: float = 0.0):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        # leaves -> global sum of squares, for a clip over sharded leaves
        # (set by the LM trainer's model-parallel modes)
        self.sq_norm = None

    def init(self, params) -> FusedAdamWState:
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
        return FusedAdamWState(mu=[z(p) for p in params],
                               nu=[z(p) for p in params])

    @torch.no_grad()
    def apply(self, params, grads, state: FusedAdamWState,
              step: int) -> FusedAdamWState:
        """Update ``params`` and ``state`` in place for optimizer step
        ``step`` (0-indexed: the kernel's t is step + 1); returns
        ``state``."""
        scalars = scalar_row(float(self.schedule(step)), self.b1, self.b2,
                             self.eps, self.weight_decay, step + 1,
                             clip_scale(grads, self.clip_norm,
                                        self.sq_norm))
        ps = [p.data for p in params]
        if scalars.is_cuda:
            fused_adamw_multi_cuda(ps, grads, state.mu, state.nu, scalars)
        else:
            for p, g, m, v in zip(ps, grads, state.mu, state.nu):
                fused_adamw_plain(p, g.float().contiguous(), m, v, scalars)
        return state
