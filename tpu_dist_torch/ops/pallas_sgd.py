"""Fused SGD-momentum for the port (``tpu_dist/ops/pallas_sgd.py``).

:class:`FusedSGD` keeps the reference's engine-facing protocol
(``init(params)``, ``apply(params, grads, state, step)``, ``:152-186``) and
its scalar row ``[lr, momentum, weight_decay, clip_scale]`` (``:138-141``).
A step is one launch of the hand-written Hopper kernel ``csrc/sgd.cu``
(the Pallas ``_sgd_kernel``, ``:93-102``) over every leaf of one p dtype
for CUDA tensors (:func:`fused_sgd_multi_cuda`), or a loop of
:func:`fused_sgd_plain` for CPU tensors. The update rule is
torch.optim.SGD's, with the global-norm clip fused in::

    g  <- g * cs + wd * p     (cs = clip / norm when norm > clip, else 1)
    m' = mu * m + g
    p' = p - lr * m'

in fp32 whatever p's dtype, p written back in its own dtype, m fp32. The
kernel works on the flat leaf: the reference's (rows, 128) padding is a
VMEM tiling, not part of the function. Unlike the reference, which donates
p and m to a functional call, the port updates them in place. The scalar
row is built on the device each step (:func:`scalar_row`), so a step syncs
nothing with the host. :func:`clip_scale` lives here, beside its reference
(``:76``); ``ops.pallas_adamw`` imports it, as the reference's does.

The row-tile knob (``:40-70``), shared with ``ops.pallas_adamw``:
:func:`set_block_rows` (seeded by ``TPU_DIST_OPT_BLOCK_ROWS``; the plan's
``opt_block_rows``) sets the chunk one CTA of ``csrc/sgd.cu`` and
``csrc/adamw.cu`` updates to ``8 x rows`` elements: the default 512 rows
give the kernels' 4096-element chunk, 1024 give 8192, and every legal
value (a multiple of 8 rows) keeps the 16-byte vectors aligned. The update
is elementwise, so every value gives the same bits.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from tpu_dist_torch import kernels

# the multi-leaf C entries of csrc/sgd.cu and csrc/adamw.cu:
# tdt_<name>_multi(table, n_leaves, scalars, p_dtype, chunk, stream)
MULTI_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p]

BLOCK_ROWS = 512     # the default rows (the plan's DEFAULT_OPT_BLOCK_ROWS)
ROW = 8              # elements a row: a CTA's chunk is ROW x rows
_BLOCK_ROWS = BLOCK_ROWS


def set_block_rows(rows: Optional[int] = None) -> None:
    """Set the optimizer kernels' rows a CTA (None restores 512), shared
    by ``ops.pallas_adamw``; legality is the plan IR's one rule
    (``plan.ir.validate_opt_block_rows``)."""
    from tpu_dist_torch.plan.ir import validate_opt_block_rows

    global _BLOCK_ROWS
    rows = BLOCK_ROWS if rows is None else int(rows)
    validate_opt_block_rows(rows)
    _BLOCK_ROWS = rows


def block_rows() -> int:
    """The rows a CTA the next launch uses."""
    return _BLOCK_ROWS


if os.environ.get("TPU_DIST_OPT_BLOCK_ROWS"):
    # through the validated setter: a bad value fails at import
    set_block_rows(int(os.environ["TPU_DIST_OPT_BLOCK_ROWS"]))


def clip_scale(grads: Sequence[torch.Tensor], clip_norm: float,
               sq_norm=None):
    """Global-norm clip factor for a list of grads, as a 0-d fp32 tensor on
    their device: ``clip/norm`` when the fp32 global norm exceeds
    ``clip_norm``, else 1 (``tpu_dist/ops/pallas_sgd.py:76 clip_scale``;
    optax.clip_by_global_norm / ``clip_grad_norm_`` semantics). Clipping
    off (``clip_norm <= 0``) gives a constant 1. ``sq_norm`` (leaves ->
    global sum of squares) takes the norm over sharded leaves."""
    dev = grads[0].device
    if clip_norm <= 0:
        return torch.ones((), dtype=torch.float32, device=dev)
    sq = (sq_norm(list(grads)) if sq_norm is not None
          else sum(g.float().square().sum() for g in grads))
    norm = torch.sqrt(sq)
    return torch.where(norm > clip_norm,
                       clip_norm / torch.clamp(norm, min=1e-30),
                       torch.ones((), dtype=torch.float32, device=dev))


def scalar_row(lr: float, momentum: float, weight_decay: float,
               cs: torch.Tensor) -> torch.Tensor:
    """The kernel's (4,) fp32 scalar row on ``cs``'s device. The host
    values travel in one pinned, non-blocking copy; ``cs`` stays on the
    device."""
    host = torch.tensor([lr, momentum, weight_decay, 1.0],
                        dtype=torch.float32)
    if cs.is_cuda:
        host = host.pin_memory()
    row = host.to(cs.device, non_blocking=True)
    row[3:].copy_(cs.reshape(1))
    return row


@kernels.plain_version
def fused_sgd_plain(p, g, m, scalars) -> None:
    """The kernel's function in plain PyTorch, in place on (p, m): fp32
    math in the kernel's operation order, p stored back in its dtype."""
    lr, mu, wd, cs = scalars.unbind()
    pf = p.float()
    gf = g.float() * cs + wd * pf
    mf = mu * m + gf
    p.copy_((pf - lr * mf).to(p.dtype))
    m.copy_(mf)


def _check_sgd(p, g, m, scalars):
    if p.dtype not in kernels.DTYPE_CODE:
        raise TypeError(f"sgd kernel takes float32 or bfloat16 params, "
                        f"got {p.dtype}")
    for name, t in (("g", g), ("m", m), ("scalars", scalars)):
        if t.dtype != torch.float32:
            raise TypeError(f"sgd kernel: {name} must be float32, got "
                            f"{t.dtype}")
    for name, t in (("p", p), ("g", g), ("m", m), ("scalars", scalars)):
        if t.device != p.device or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"sgd kernel: {name} must be contiguous on "
                             f"p's CUDA device")
    if not (g.shape == m.shape == p.shape):
        raise ValueError(f"sgd kernel: p, g, m shapes differ: "
                         f"{tuple(p.shape)}, {tuple(g.shape)}, "
                         f"{tuple(m.shape)}")
    if scalars.numel() != 4:
        raise ValueError("sgd kernel: the scalar row has 4 entries")


def launch_groups(fn, name, lists, scalars, stream) -> int:
    """Call a multi-leaf C entry ``fn`` (``tdt_<name>_multi``) on checked
    leaves: ``lists`` is (params, *fp32 buffers), one tensor per leaf in
    each. The leaves are grouped by p dtype, and each group with any
    element goes in one call as a host table of {pointers..., n} rows
    (int64; the C side splits it into launches of at most its capacity,
    512 leaves on CUDA >= 12.1, and skips empty leaves), at a chunk of
    ``ROW x block_rows()`` elements a CTA. Raise on a launch error;
    returns the number of calls made."""
    chunk = ROW * block_rows()
    groups = {}
    for leaf in zip(*lists):
        groups.setdefault(leaf[0].dtype, []).append(leaf)
    calls = 0
    for leaves in groups.values():
        if not any(leaf[0].numel() for leaf in leaves):
            continue
        table = torch.tensor([[t.data_ptr() for t in leaf] + [leaf[0].numel()]
                              for leaf in leaves], dtype=torch.int64)
        err = fn(table.data_ptr(), len(leaves), scalars.data_ptr(),
                 kernels.DTYPE_CODE[leaves[0][0].dtype], chunk, stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed (cudaError "
                               f"{err})")
        calls += 1
    return calls


def run_multi(name, check, lists, scalars) -> None:
    """``csrc/<name>.cu`` over every leaf of ``lists`` (params, then their
    fp32 buffers, each checked by ``check(*leaf, scalars)``) on the current
    stream; adds the calls made to ``kernels.LAUNCHES[name]``."""
    if len({len(ts) for ts in lists}) != 1:
        raise ValueError(f"{name} kernel: leaf lists of lengths "
                         f"{[len(ts) for ts in lists]}")
    for leaf in zip(*lists):
        check(*leaf, scalars)
    fn = kernels.function(name, f"tdt_{name}_multi", MULTI_ARGS)
    with torch.cuda.device(scalars.device):
        calls = launch_groups(
            fn, name, lists, scalars,
            torch.cuda.current_stream(scalars.device).cuda_stream)
    kernels.LAUNCHES[name] += calls


def fused_sgd_multi_cuda(ps, gs, ms, scalars) -> None:
    """One update of every leaf in place on (p, m): the leaves are grouped
    by p dtype and each group is one call of ``csrc/sgd.cu`` on the
    current stream (one launch over all its leaves, up to 512). ``g`` is
    cast to fp32 where it is not, as the reference casts it. Each call
    adds one to ``kernels.LAUNCHES["sgd"]``; a group of empty leaves makes
    none."""
    run_multi("sgd", _check_sgd,
              (ps, [g.float().contiguous() for g in gs], ms), scalars)


def fused_sgd_cuda(p, g, m, scalars) -> None:
    """One leaf through ``csrc/sgd.cu`` (a table of one row), in place on
    (p, m); ``g`` must already be fp32."""
    run_multi("sgd", _check_sgd, ([p], [g], [m]), scalars)


def fused_sgd_leaf(p, g, m, scalars) -> None:
    """One leaf's update in place: the kernel for CUDA tensors, the plain
    version for CPU tensors. ``g`` is cast to fp32 first, as the reference
    casts it."""
    g = g.float().contiguous()
    if p.device.type == "cpu":
        fused_sgd_plain(p, g, m, scalars)
    else:
        fused_sgd_cuda(p, g, m, scalars)


class FusedSGDState(NamedTuple):
    trace: List[torch.Tensor]   # momentum buffers, fp32


class FusedSGD:
    """Fused-kernel SGD with the engine-facing ``apply()`` protocol
    (``engine.steps.apply_update`` dispatches on it). ``params`` and
    ``grads`` are equal-length lists of tensors."""

    def __init__(self, schedule: Callable, momentum: float = 0.9,
                 weight_decay: float = 1e-4, clip_norm: float = 0.0):
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params) -> FusedSGDState:
        return FusedSGDState(trace=[
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params])

    @torch.no_grad()
    def apply(self, params, grads, state: FusedSGDState,
              step: int) -> FusedSGDState:
        """Update ``params`` and ``state`` in place for optimizer step
        ``step`` (0-indexed, the schedule's index); returns ``state``."""
        scalars = scalar_row(float(self.schedule(step)), self.momentum,
                             self.weight_decay,
                             clip_scale(grads, self.clip_norm))
        ps = [p.data for p in params]
        if scalars.is_cuda:
            fused_sgd_multi_cuda(ps, grads, state.trace, scalars)
        else:
            for p, g, m in zip(ps, grads, state.trace):
                fused_sgd_plain(p, g.float().contiguous(), m, scalars)
        return state
