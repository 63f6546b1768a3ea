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

The reference's dispatch switches (``set_fused_quant``,
``TPU_DIST_FUSED_QUANT``) and tile knobs (``set_quant_blocks``,
``TPU_DIST_QUANT_BLOCKS``) choose between the Pallas kernel and XLA or
size Pallas tiles; they have no counterpart here: a CUDA
``quant="int8"`` always runs the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_dist_torch import kernels
from tpu_dist_torch.ops.quant import quantize_int8

# tdt_fused_quant(x, w, out, ws, M, K, N, dtype, stream) and
# tdt_fused_quant_workspace(M, K, N, &bytes)
_FUSED_QUANT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
_WORKSPACE_ARGS = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
# int32 sums stay exact while K * 127^2 < 2^31
MAX_K = (2 ** 31 - 1) // 127 ** 2


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


def _launch(fn, ws_fn, x2, w, stream):
    """Call the C entry ``fn`` (``tdt_fused_quant``) on checked tensors:
    allocate the output and the workspace ``ws_fn``
    (``tdt_fused_quant_workspace``) asks for, launch on ``stream``, raise
    on a launch error."""
    m, k = x2.shape
    n = w.shape[1]
    size = ctypes.c_longlong()
    if ws_fn(m, k, n, ctypes.byref(size)) != 0:
        raise RuntimeError(f"fused_quant kernel: no workspace size for "
                           f"({m}, {k}) x ({k}, {n})")
    ws = torch.empty(size.value, dtype=torch.uint8, device=x2.device)
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    err = fn(x2.data_ptr(), w.data_ptr(), out.data_ptr(), ws.data_ptr(), m,
             k, n, kernels.DTYPE_CODE[x2.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_quant kernel launch failed "
                           f"(cudaError {err})")
    return out


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


def _forward_2d(x2, w):
    if x2.device.type == "cpu":
        return fused_quant_matmul_plain(x2, w)
    return fused_quant_cuda(x2.contiguous(), w.contiguous())


def _forward(x, w):
    """Leading batch dims fold to 2-D (``_fused_fwd_impl``, ``:191-194``)."""
    out2 = _forward_2d(x.reshape(-1, x.shape[-1]), w)
    return out2.reshape(*x.shape[:-1], w.shape[1])


class FusedQuantMatmul(torch.autograd.Function):
    """Forward: the fused kernel (or its plain version on the CPU);
    backward: the straight-through estimator, the vjp of ``x @ w``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = (g2 @ w.t()).reshape(x.shape)
        gw = x.reshape(-1, x.shape[-1]).t() @ g2
        return gx, gw


def fused_quant_matmul(x, w):
    """``quant_matmul(x, w, "int8")`` as one fused kernel: ``x`` (..., K)
    and ``w`` (K, N) in the compute dtype; returns (..., N) in x's dtype.
    Differentiable (STE) when autograd records."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return FusedQuantMatmul.apply(x, w)
    return _forward(x, w)
