"""Flash attention forward for the port (``tpu_dist/ops/flash_attention.py``).

:func:`flash_attention_fn` returns ``attn(q, k, v, *, causal, q_offset,
kv_offset)`` over (B, L, H, D) tensors -- the model's pluggable
``attn_fn``, which serving runs in every prefill. For CUDA tensors it
launches the hand-written Hopper kernel ``csrc/flash_fwd.cu`` (the port of
the Pallas ``_fa_fwd_kernel``); for CPU tensors it runs
:func:`flash_forward_plain`, the same function in plain PyTorch. There is
no other path: a CUDA tensor the kernel does not take raises.

Forward only: the backward kernels (``_fa_bwd_dq_kernel``,
``_fa_bwd_dkv_kernel``) belong to LM training and are not ported yet, so
a call that autograd would differentiate raises. Serving calls run under
``torch.inference_mode()``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tpu_dist_torch import kernels
from tpu_dist_torch.ops.quant import quantize_int8

NEG_INF = -1e30  # avoids -inf - -inf = nan in the online max updates

BACKWARD_KERNELS = ("ops/flash_attention.py:_fa_bwd_dq_kernel and "
                    "ops/flash_attention.py:_fa_bwd_dkv_kernel")


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """Per-row symmetric int8 quantization of a (B, L, H, D) KV pair:
    ``(k_q, k_scale, v_q, v_scale)`` with one fp32 scale per (b, l, h),
    by :func:`~tpu_dist_torch.ops.quant.quantize_int8` itself."""
    kq, ks = quantize_int8(k, (-1,))
    vq, vs = quantize_int8(v, (-1,))
    return kq, ks[..., 0], vq, vs[..., 0]


def masked_softmax_pv(s, v):
    """fp32 softmax of masked scores ``s`` (B, H, Lq, Lk) times ``v``
    (B, H, Lk, D), with the kernels' rules: masked entries hold
    ``NEG_INF`` and get exactly zero probability, so a fully masked row
    gives zeros. Returns (out (B, H, Lq, D), row max, clamped row sum)."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return (p @ v) / l, m, l


def flash_forward_plain(q, k, v, causal: bool = True, q_offset: int = 0,
                        kv_offset: int = 0):
    """The kernel's function in plain PyTorch: fp32 masked softmax with
    the ``NEG_INF`` / ``p = 0`` rules (a fully masked row gives exact
    zeros), output in v's dtype, per-row logsumexp (B*H, Lq) fp32."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    if causal:
        qpos = q_offset + torch.arange(lq, device=q.device)
        kpos = kv_offset + torch.arange(lk, device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
    o, m, l = masked_softmax_pv(s, v.float().transpose(1, 2))
    out = o.transpose(1, 2).to(v.dtype).contiguous()
    lse = (m + torch.log(l)).reshape(b * h, lq)
    return out, lse


def _check_flash(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash kernel: q, k, v must be on one CUDA device")
    if q.dtype not in kernels.DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"flash kernel: q (B, Lq, H, D) and k/v (B, Lk, "
                         f"H, D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] not in kernels.HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {q.shape[-1]} not in "
                         f"{kernels.HEAD_DIMS}")
    if min(q.shape[0], q.shape[1], k.shape[1], q.shape[2]) < 1:
        raise ValueError("flash kernel: empty q or k/v")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel: q, k, v must be contiguous")


_FLASH_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _launch(fn, q, k, v, causal, q_offset, kv_offset, stream):
    """Call the C entry ``fn`` (``tdt_flash_fwd``) on checked tensors:
    allocate the outputs, launch on ``stream``, raise on a launch error."""
    b, lq, h, d = q.shape
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    lse = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, h, lq, k.shape[1], d, int(bool(causal)),
             int(q_offset), int(kv_offset), 1.0 / math.sqrt(d),
             kernels.DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed (cudaError {err})")
    return out, lse


def flash_forward_cuda(q, k, v, causal: bool = True, q_offset: int = 0,
                       kv_offset: int = 0):
    """Launch ``csrc/flash_fwd.cu`` on the current stream: (out, lse)."""
    _check_flash(q, k, v)
    fn = kernels.function("flash_fwd", "tdt_flash_fwd", _FLASH_ARGS)
    with torch.cuda.device(q.device):
        out, lse = _launch(fn, q, k, v, causal, q_offset, kv_offset,
                           torch.cuda.current_stream(q.device).cuda_stream)
    kernels.LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_forward(q, k, v, *, causal: bool = True, q_offset: int = 0,
                  kv_offset: int = 0):
    """(out, lse): the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash attention backward is not ported: the TPU kernels "
            f"{BACKWARD_KERNELS} have no Hopper kernel yet (run under "
            "torch.inference_mode() / no_grad)")
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, q_offset, kv_offset)
    return flash_forward_cuda(q, k, v, causal, q_offset, kv_offset)


@functools.lru_cache(maxsize=None)
def flash_attention_fn(block_q: int = 1024, block_k: int | None = None):
    """Returns ``attn(q, k, v, *, causal=True, q_offset=0, kv_offset=0)``
    backed by the flash forward kernel. ``block_q``/``block_k`` are the TPU
    kernel's tile knobs, kept so configurations carry over; the Hopper
    kernel does not read them (fixed 64 x 64 tiles, ragged edges masked,
    so no length divisibility rule). Memoized per config, like the
    reference, so equal configs give the same callable."""

    def attn(q, k, v, *, causal: bool = True, q_offset=0, kv_offset=0):
        return flash_forward(q, k, v, causal=causal, q_offset=q_offset,
                             kv_offset=kv_offset)[0]

    return attn
