"""Fused int8 matmul for the port (``tpu_dist/ops/pallas_quant.py``).

:func:`fused_quant_matmul` is ``quant_matmul(x, w, "int8")`` in one
kernel: per-row int8 quantization of the activations, per-column int8
quantization of the weights, an int8 x int8 -> int32 product and the
dequant by ``sx * sw``. For CUDA tensors its forward runs the hand-written
Hopper kernels of ``csrc/fused_quant.cu`` (the Pallas
``_fused_quant_kernel``, ``:104-130``) on the int8 tensor cores, each
operand quantized once into a workspace allocated here: one call is a
memset and two kernel launches when M <= 16 (scales, then the split-K
product, whose last split adds the sums) and three when M > 16 (scales,
w quantized and transposed, the GEMM). For
CPU tensors it runs :func:`fused_quant_matmul_plain`. Its backward is
the straight-through estimator of the reference's ``_fused_bwd``
(``:201-205``): the gradients of ``x @ w`` on the unquantized operands.

Under tensor parallelism a row-parallel product's K is sharded over the
group, and the reference's GSPMD program takes its scales over the whole
K. :func:`fused_quant_matmul` with a ``group`` runs that product as the
kernel's two phases apart (``tdt_fused_quant_amax``, then ``tdt_fused_quant_scaled``,
with the row and column maxima max-reduced over the group between them;
:func:`fused_quant_amax_plain` and :func:`fused_quant_scaled_plain` for CPU
tensors), so each rank's partial product differs from the reference's one
int32 dot only in the order the partials are summed.

The tile knob (``:53-100``): :func:`set_quant_blocks` (seeded by
``TPU_DIST_QUANT_BLOCKS="bm,bn,bk"``; the plan's ``quant_block``) sets the
GEMM path's tile (M > 16): a (bm, bn) output tile a CTA, and with bk > 0
K split over ceil(K / bk) CTAs whose int32 partial sums are added exactly
before the one dequant, so every tile is bit-equal to the default
(128, 128, 0), the kernel's tile before the knob. Every tile the plan IR
accepts runs: the (bm, bn) tiles of :data:`INSTANTIATED_TILES` on warp
grids compiled for them, every other one on the kernel's general instance
(the tile a run-time parameter, walked in 64 x 128 sub-tiles). The
split-K decode kernel (M <= 16) keeps its own tiling whatever the knob. The
dispatch switch (``set_fused_quant``, ``TPU_DIST_FUSED_QUANT``) lives in
``ops.quant``: set off, ``quant_matmul(..., "int8")`` does not come here.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from tpu_dist_torch import kernels
from tpu_dist_torch.ops.quant import quantize_by_amax, quantize_int8

# tdt_fused_quant(x, w, out, ws, M, K, N, dtype, bm, bn, bk, stream) and
# tdt_fused_quant_workspace(M, K, N, bk, &bytes)
_FUSED_QUANT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]
_WORKSPACE_ARGS = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
# tdt_fused_quant_amax(x, w, x_amax, w_amax, M, K, N, dtype, stream) and
# tdt_fused_quant_scaled(x, w, x_amax, w_amax, out, ws, M, K, N, dtype, bm,
# bn, bk, stream)
_AMAX_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SCALED_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]
# tdt_fused_quant_tiles(tiles, cap)
_TILES_ARGS = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
# int32 sums stay exact while K * 127^2 < 2^31
MAX_K = (2 ** 31 - 1) // 127 ** 2

BLOCK_M = 128        # the default output tile (the plan's DEFAULT_QUANT_BLOCK)
BLOCK_N = 128
# the (bm, bn) GEMM tiles csrc/fused_quant.cu compiles a warp grid for (its
# TDT_FQ_TILES; any other legal tile runs on its general instance); the
# tuner's space lies inside them
INSTANTIATED_TILES = ((128, 128), (256, 128), (128, 256), (64, 256))

_BLOCKS: Tuple[int, int, int] = (BLOCK_M, BLOCK_N, 0)


def set_quant_blocks(bm: Optional[int] = None, bn: Optional[int] = None,
                     bk: Optional[int] = None) -> None:
    """Set the GEMM path's tile ((None, None, None) restores 128 x 128
    over the whole of K). Legality is the plan IR's one rule
    (``plan.ir.validate_quant_block``); the kernel runs every legal
    tile."""
    from tpu_dist_torch.plan.ir import validate_quant_block

    global _BLOCKS
    bm = BLOCK_M if bm is None else int(bm)
    bn = BLOCK_N if bn is None else int(bn)
    bk = 0 if bk is None else int(bk)
    validate_quant_block(bm, bn, bk)
    _BLOCKS = (bm, bn, bk)


def quant_blocks() -> Tuple[int, int, int]:
    """The (bm, bn, bk) tile the next launch uses."""
    return _BLOCKS


def _seed_blocks_from_env() -> None:
    # through the validated setter, so a malformed value fails at import
    spec = os.environ.get("TPU_DIST_QUANT_BLOCKS", "")
    if not spec:
        return
    parts = spec.split(",")
    if len(parts) != 3:
        raise ValueError(f"TPU_DIST_QUANT_BLOCKS={spec!r}: expected "
                         "'bm,bn,bk' (bk 0 = whole contracting dim)")
    set_quant_blocks(*(int(v) for v in parts))


_seed_blocks_from_env()


@kernels.plain_version
def fused_quant_matmul_plain(x2, w):
    """The kernel's function in plain PyTorch on (M, K) x (K, N): the int8
    values of both operands (``quantize_int8``: row amax for x, column amax
    for w), their product in float64 -- exact while |acc| < 2^53, and
    float64 runs on both devices where torch has no CUDA integer matmul --
    then ``acc.float() * (sx * sw)`` and one cast to x's dtype, the
    reference's steps in its order."""
    qx, sx = quantize_int8(x2, (1,))                  # (M, K), (M, 1)
    qw, sw = quantize_int8(w, (0,))                   # (K, N), (1, N)
    acc = qx.double() @ qw.double()
    return (acc.float() * (sx * sw)).to(x2.dtype)


@kernels.plain_version
def fused_quant_amax_plain(x2, w):
    """The scales phase alone: (each row's max |x| over K (M,), each
    column's max |w| over K (N,)), fp32."""
    return x2.float().abs().amax(1), w.float().abs().amax(0)


@kernels.plain_version
def fused_quant_scaled_plain(x2, w, x_amax, w_amax):
    """:func:`fused_quant_matmul_plain` with the row maxima ``x_amax``
    (M,) and column maxima ``w_amax`` (N,) given; with
    :func:`fused_quant_amax_plain`'s it is that function, bit for bit."""
    qx, sx = quantize_by_amax(x2, x_amax[:, None])
    qw, sw = quantize_by_amax(w, w_amax[None, :])
    acc = qx.double() @ qw.double()
    return (acc.float() * (sx * sw)).to(x2.dtype)


def _check_fused_quant(x2, w):
    if not (x2.is_cuda and w.device == x2.device):
        raise ValueError("fused_quant kernel: x and w must be on one CUDA "
                         "device")
    if x2.dtype not in kernels.DTYPE_CODE or w.dtype != x2.dtype:
        raise TypeError(f"fused_quant kernel takes float32 or bfloat16 x and "
                        f"w of one dtype, got {x2.dtype}/{w.dtype}")
    if x2.dim() != 2 or w.dim() != 2 or x2.shape[1] != w.shape[0]:
        raise ValueError(f"fused_quant kernel: (M, K) x (K, N) expected, got "
                         f"{tuple(x2.shape)} x {tuple(w.shape)}")
    if min(*x2.shape, w.shape[1]) < 1:
        raise ValueError("fused_quant kernel: empty operand")
    if x2.shape[1] > MAX_K:
        raise ValueError(f"fused_quant kernel: K = {x2.shape[1]} exceeds "
                         f"{MAX_K} = (2^31 - 1) // 127^2, past which int32 "
                         f"sums can overflow")
    if not (x2.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_quant kernel: x and w must be contiguous")


def _launch(fn, ws_fn, x2, w, stream, amax=None, tile=None):
    """Call the C entry ``fn`` (``tdt_fused_quant``, or with ``amax`` =
    (x maxima, w maxima) ``tdt_fused_quant_scaled``) on checked tensors at
    ``tile`` (default: :func:`quant_blocks`; a tile the plan IR refuses
    raises its ``PlanError``): allocate the output and the workspace
    ``ws_fn``
    (``tdt_fused_quant_workspace``) asks for, launch on ``stream``, raise
    on a launch error."""
    from tpu_dist_torch.plan.ir import validate_quant_block

    bm, bn, bk = quant_blocks() if tile is None else tile
    validate_quant_block(bm, bn, bk)
    m, k = x2.shape
    n = w.shape[1]
    size = ctypes.c_longlong()
    if ws_fn(m, k, n, bk, ctypes.byref(size)) != 0:
        raise RuntimeError(f"fused_quant kernel: no workspace size for "
                           f"({m}, {k}) x ({k}, {n}) at bk={bk}")
    ws = torch.empty(size.value, dtype=torch.uint8, device=x2.device)
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    scales = () if amax is None else tuple(a.data_ptr() for a in amax)
    err = fn(x2.data_ptr(), w.data_ptr(), *scales, out.data_ptr(),
             ws.data_ptr(), m, k, n, kernels.DTYPE_CODE[x2.dtype], bm, bn,
             bk, stream)
    if err != 0:
        raise RuntimeError(f"fused_quant kernel launch failed "
                           f"(cudaError {err})")
    return out


def kernel_tiles(fn) -> Tuple[Tuple[int, int], ...]:
    """The (bm, bn) tiles a build of ``csrc/fused_quant.cu`` compiles a
    warp grid for (every other legal tile runs on its general instance),
    read through its ``tdt_fused_quant_tiles`` entry ``fn``."""
    buf = (ctypes.c_int * 64)()
    n = fn(buf, 32)
    return tuple((buf[2 * i], buf[2 * i + 1]) for i in range(min(n, 32)))


def _launch_amax(fn, x2, w, stream):
    """Call ``tdt_fused_quant_amax`` on checked tensors: (x maxima (M,),
    w maxima (N,)), fp32 on x's device."""
    m, k = x2.shape
    n = w.shape[1]
    xa = torch.empty(m, dtype=torch.float32, device=x2.device)
    wa = torch.empty(n, dtype=torch.float32, device=x2.device)
    err = fn(x2.data_ptr(), w.data_ptr(), xa.data_ptr(), wa.data_ptr(), m, k,
             n, kernels.DTYPE_CODE[x2.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_quant amax kernel launch failed "
                           f"(cudaError {err})")
    return xa, wa


def _check_amax(x2, w, x_amax, w_amax):
    for name, a, n in (("x_amax", x_amax, x2.shape[0]),
                       ("w_amax", w_amax, w.shape[1])):
        if (a.device != x2.device or a.dtype != torch.float32
                or tuple(a.shape) != (n,) or not a.is_contiguous()):
            raise ValueError(f"fused_quant scaled kernel: {name} must be a "
                             f"contiguous float32 ({n},) tensor on "
                             f"{x2.device}, got {a.dtype} {tuple(a.shape)} "
                             f"on {a.device}")


def fused_quant_cuda(x2, w):
    """Run ``csrc/fused_quant.cu`` on the current stream: (M, N). One call
    adds one to ``kernels.LAUNCHES["fused_quant"]``, whatever the number
    of kernel launches it makes (module docstring)."""
    _check_fused_quant(x2, w)
    fn = kernels.function("fused_quant", "tdt_fused_quant", _FUSED_QUANT_ARGS)
    ws_fn = kernels.function("fused_quant", "tdt_fused_quant_workspace",
                             _WORKSPACE_ARGS)
    with torch.cuda.device(x2.device):
        out = _launch(fn, ws_fn, x2, w,
                      torch.cuda.current_stream(x2.device).cuda_stream)
    kernels.LAUNCHES["fused_quant"] += 1
    return out


def fused_quant_amax_cuda(x2, w):
    """The scales phase of ``csrc/fused_quant.cu`` alone on the current
    stream (``tdt_fused_quant_amax``): (x maxima (M,), w maxima (N,)). One
    call adds one to ``kernels.LAUNCHES["fused_quant_amax"]``."""
    _check_fused_quant(x2, w)
    fn = kernels.function("fused_quant", "tdt_fused_quant_amax", _AMAX_ARGS)
    with torch.cuda.device(x2.device):
        out = _launch_amax(fn, x2, w,
                           torch.cuda.current_stream(x2.device).cuda_stream)
    kernels.LAUNCHES["fused_quant_amax"] += 1
    return out


def fused_quant_scaled_cuda(x2, w, x_amax, w_amax):
    """``csrc/fused_quant.cu`` with the given maxima on the current stream
    (``tdt_fused_quant_scaled``): (M, N). One call adds one to
    ``kernels.LAUNCHES["fused_quant_scaled"]``."""
    _check_fused_quant(x2, w)
    _check_amax(x2, w, x_amax, w_amax)
    fn = kernels.function("fused_quant", "tdt_fused_quant_scaled",
                          _SCALED_ARGS)
    ws_fn = kernels.function("fused_quant", "tdt_fused_quant_workspace",
                             _WORKSPACE_ARGS)
    with torch.cuda.device(x2.device):
        out = _launch(fn, ws_fn, x2, w,
                      torch.cuda.current_stream(x2.device).cuda_stream,
                      (x_amax, w_amax))
    kernels.LAUNCHES["fused_quant_scaled"] += 1
    return out


def fused_quant_amax(x2, w):
    """(x maxima, w maxima) of an (M, K) x (K, N) product: the kernel for
    CUDA tensors, its plain version for CPU tensors."""
    if x2.device.type == "cpu":
        return fused_quant_amax_plain(x2, w)
    return fused_quant_amax_cuda(x2.contiguous(), w.contiguous())


def fused_quant_scaled(x2, w, x_amax, w_amax):
    """The int8 product scaled by the given maxima: the kernel for CUDA
    tensors, its plain version for CPU tensors."""
    if x2.device.type == "cpu":
        return fused_quant_scaled_plain(x2, w, x_amax, w_amax)
    return fused_quant_scaled_cuda(x2.contiguous(), w.contiguous(),
                                   x_amax.contiguous(), w_amax.contiguous())


def _forward_2d(x2, w):
    if x2.device.type == "cpu":
        return fused_quant_matmul_plain(x2, w)
    return fused_quant_cuda(x2.contiguous(), w.contiguous())


def _forward(x, w, group=None):
    """Leading batch dims fold to 2-D (``_fused_fwd_impl``, ``:191-194``).
    With a ``group``, one maxima all-reduce (max) over it between the two
    phases."""
    x2 = x.reshape(-1, x.shape[-1])
    if group is None:
        out2 = _forward_2d(x2, w)
    else:
        from tpu_dist_torch.parallel.collectives import pmax

        xa, wa = fused_quant_amax(x2, w)
        both = pmax(torch.cat([xa, wa]), group)
        out2 = fused_quant_scaled(x2, w, both[:xa.numel()],
                                  both[xa.numel():])
    return out2.reshape(*x.shape[:-1], w.shape[1])


class FusedQuantMatmul(torch.autograd.Function):
    """Forward: the fused kernel (or its plain version on the CPU);
    backward: the straight-through estimator, the vjp of ``x @ w``."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        return _forward(x, w, group)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = (g2 @ w.t()).reshape(x.shape)
        gw = x.reshape(-1, x.shape[-1]).t() @ g2
        return gx, gw, None


def fused_quant_matmul(x, w, group=None):
    """``quant_matmul(x, w, "int8")`` as one fused kernel: ``x`` (..., K)
    and ``w`` (K, N) in the compute dtype; returns (..., N) in x's dtype.
    Differentiable (STE) when autograd records. ``group``: ``x`` and ``w``
    hold this rank's part of a K shared by the group (a row-parallel
    shard); the int8 scales are then the whole K's (module docstring) and
    the result is this rank's partial product, for the caller to sum."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return FusedQuantMatmul.apply(x, w, group)
    return _forward(x, w, group)
