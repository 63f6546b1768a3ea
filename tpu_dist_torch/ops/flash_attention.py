"""Flash attention for the port (``tpu_dist/ops/flash_attention.py``).

:func:`flash_attention_fn` returns ``attn(q, k, v, *, causal, q_offset,
kv_offset)`` over (B, L, H, D) tensors -- the model's pluggable
``attn_fn``, which serving runs in every prefill and LM training in every
layer. For CUDA tensors it launches the hand-written Hopper kernels; for
CPU tensors it runs their plain PyTorch versions. There is no other path:
a CUDA tensor a kernel does not take raises.

* forward: ``csrc/flash_fwd.cu`` (the Pallas ``_fa_fwd_kernel``, lines
  138-198) beside :func:`flash_forward_plain`;
* the int8-K/V forward: ``csrc/flash_fwd_int8kv.cu``
  (``_fa_fwd_int8kv_kernel``, lines 446-500) beside
  :func:`int8kv_flash_plain`;
* backward (lines 201-412): :class:`FlashAttention`, a
  ``torch.autograd.Function`` whose forward is the forward kernel and whose
  backward computes ``delta = rowsum(out * dO)`` in plain PyTorch (the
  reference also computes it outside Pallas, ``:367-373``) and launches
  ``csrc/flash_bwd_dq.cu`` (``_fa_bwd_dq_kernel``) and
  ``csrc/flash_bwd_dkv.cu`` (``_fa_bwd_dkv_kernel``), beside
  :func:`flash_backward_plain`.

:func:`blockwise_attention_fn` is the reference's plain blockwise
attention (``:41-104``): a loop over KV blocks with an fp32 online softmax
in plain PyTorch, differentiated by autograd through the loop. The
reference's is ``lax.scan`` and ``jnp.einsum`` with no Pallas kernel
behind it, so there is no kernel to port; it launches none.

A call that autograd would not differentiate (serving runs under
``torch.inference_mode()``) skips the Function and saves nothing.

Every head dim from 1 up runs (``kernels.HEAD_DIM_RULE``, the rule of
``csrc/head_dim.cuh``; above 256 on the kernels' wide path, which splits
the output's columns into chunks over the grid and sums the scores over
d in streamed slices), on tensors of any alignment: a view at an odd
element offset, or a head dim whose rows are not a whole number of
16-byte chunks, runs on the general instance (or the wide path's), which
copies such rows by narrower ``cp.async`` or byte loads. Nothing is copied
or padded on the host.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tpu_dist_torch import kernels
from tpu_dist_torch.ops.quant import quantize_int8

NEG_INF = -1e30  # avoids -inf - -inf = nan in the online max updates

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


@functools.lru_cache(maxsize=None)
def blockwise_attention_fn(block_size: int = 512):
    """Returns ``attn(q, k, v, *, causal=True, q_offset=0, kv_offset=0)``
    over (B, L, H, D) tensors: the KV axis in blocks of ``block_size``
    with a running (max, sum, acc) online softmax in fp32, q scaled first.
    The block fits as the flash kernels' does: clamped to the kv length,
    then the gcd with it where it does not divide. Masked scores get
    exactly zero probability, so a row that sees no key gives zeros (also
    under q/kv offsets). Memoized per config, as the reference's is."""

    def attn(q, k, v, *, causal: bool = True, q_offset=0, kv_offset=0):
        b, lq, h, d = q.shape
        lk = k.shape[1]
        blk = min(block_size, lk)
        if lk % blk:
            blk = math.gcd(blk, lk)
        if blk < 1:
            raise ValueError(f"kv length {lk} has no usable block "
                             f"<= {block_size}")
        qh = q.transpose(1, 2).float() * (1.0 / math.sqrt(d))
        kh = k.transpose(1, 2)
        vh = v.transpose(1, 2)
        q_pos = q_offset + torch.arange(lq, device=q.device)
        acc = torch.zeros((b, h, lq, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
        for i in range(lk // blk):
            kb = kh[:, :, i * blk:(i + 1) * blk].float()
            vb = vh[:, :, i * blk:(i + 1) * blk].float()
            s = qh @ kb.transpose(-1, -2)
            if causal:
                k_pos = kv_offset + i * blk + torch.arange(blk,
                                                           device=q.device)
                s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(s <= NEG_INF / 2, 0.0,
                            torch.exp(s - m_new[..., None]))
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p @ vb
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.transpose(1, 2).to(v.dtype)

    return attn


@kernels.plain_version
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


def _launch_error(kernel: str, err: int) -> RuntimeError:
    """The wrappers' error for a nonzero C entry code."""
    if err == -1:
        return RuntimeError(f"{kernel} kernel has no instance for this "
                            "dtype and head_dim (code -1)")
    return RuntimeError(f"{kernel} kernel launch failed (cudaError {err})")


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
    kernels.check_head_dim("flash kernel", q.shape[-1])
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
        raise _launch_error("flash_fwd", err)
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
    tensors. Not differentiable: :class:`FlashAttention` is."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, q_offset, kv_offset)
    return flash_forward_cuda(q, k, v, causal, q_offset, kv_offset)


# ---- backward -------------------------------------------------------------

@kernels.plain_version
def flash_backward_plain(q, k, v, out, lse, g, causal: bool = True,
                         q_offset: int = 0, kv_offset: int = 0):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv) in
    q's, k's and v's dtypes from the forward's (out, lse (B*H, Lq)) and the
    output cotangent ``g`` (B, Lq, H, D). Scores and products in fp32, with
    the TPU kernels' rounding points:

    * ``p = exp(s - lse)``, and ``p = 0`` where ``s <= NEG_INF / 2``, so a
      fully masked row or key gets exact zero gradients (``:227``, ``:273``);
    * ``delta = rowsum(out * g)`` in fp32 (``:370``);
    * ``ds = p * (g.v - delta) * scale``;
    * ``dq = ds.astype(k) . k`` (``:232-234``), ``dv = p.astype(g)^T . g``
      (``:274-276``), ``dk = ds.astype(q)^T . q`` (``:281-283``)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, gf = (t.float().transpose(1, 2) for t in (q, k, v, g))
    s = (qf @ kf.transpose(-1, -2)) * scale                # (B, H, Lq, Lk)
    if causal:
        qpos = q_offset + torch.arange(lq, device=q.device)
        kpos = kv_offset + torch.arange(lk, device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
    lse4 = lse.reshape(b, h, lq, 1)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse4))
    delta = bwd_delta(out, g).reshape(b, h, lq, 1)
    ds = p * (gf @ vf.transpose(-1, -2) - delta) * scale
    rnd = lambda t, like: t.to(like.dtype).float()
    dq = rnd(ds, k) @ kf
    dv = rnd(p, g).transpose(-1, -2) @ gf
    dk = rnd(ds, q).transpose(-1, -2) @ qf
    back = lambda t, like: t.transpose(1, 2).to(like.dtype).contiguous()
    return back(dq, q), back(dk, k), back(dv, v)


_BWD_DQ_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_DKV_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check_backward(q, k, v, out, lse, g):
    _check_flash(q, k, v)
    b, lq, h, _ = q.shape
    if out.shape != q.shape or g.shape != q.shape or out.dtype != q.dtype \
            or g.dtype != q.dtype:
        raise ValueError(f"flash backward: out and dO must match q "
                         f"{tuple(q.shape)} {q.dtype}, got {tuple(out.shape)} "
                         f"{out.dtype} / {tuple(g.shape)} {g.dtype}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b * h, lq):
        raise ValueError(f"flash backward: lse must be float32 (B*H, Lq) = "
                         f"{(b * h, lq)}, got {lse.dtype} {tuple(lse.shape)}")
    for t in (out, lse, g):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash backward: out, lse, dO must be "
                             "contiguous on q's device")


def _bwd_common(q, k, causal, q_offset, kv_offset, stream):
    b, lq, h, d = q.shape
    return (b, h, lq, k.shape[1], d, int(bool(causal)), int(q_offset),
            int(kv_offset), 1.0 / math.sqrt(d), kernels.DTYPE_CODE[q.dtype],
            stream)


def _launch_bwd_dq(fn, q, k, v, g, lse, delta, causal, q_offset, kv_offset,
                   stream):
    """Call the C entry ``tdt_flash_bwd_dq`` on checked tensors; returns
    dq, raises on a launch error."""
    dq = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             *_bwd_common(q, k, causal, q_offset, kv_offset, stream))
    if err != 0:
        raise _launch_error("flash_bwd_dq", err)
    return dq


def _launch_bwd_dkv(fn, q, k, v, g, lse, delta, causal, q_offset, kv_offset,
                    stream):
    """Call the C entry ``tdt_flash_bwd_dkv`` on checked tensors; returns
    (dk, dv), raises on a launch error."""
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_bwd_common(q, k, causal, q_offset, kv_offset, stream))
    if err != 0:
        raise _launch_error("flash_bwd_dkv", err)
    return dk, dv


def bwd_delta(out, g):
    """``delta = rowsum(out * dO)`` in fp32, in the kernels' (B*H, Lq)
    layout (the reference's ``:370``)."""
    b, lq, h, _ = out.shape
    return (out.float() * g.float()).sum(-1).transpose(1, 2).reshape(
        b * h, lq).contiguous()


def _launch_backward(fn_dq, fn_dkv, q, k, v, out, lse, g, causal, q_offset,
                     kv_offset, stream):
    """delta in plain PyTorch, then both kernels on ``stream``: (dq, dk,
    dv)."""
    delta = bwd_delta(out, g)
    args = (q, k, v, g, lse, delta, causal, q_offset, kv_offset, stream)
    return (_launch_bwd_dq(fn_dq, *args), *_launch_bwd_dkv(fn_dkv, *args))


def flash_backward_cuda(q, k, v, out, lse, g, causal: bool = True,
                        q_offset: int = 0, kv_offset: int = 0):
    """Launch ``csrc/flash_bwd_dq.cu`` then ``csrc/flash_bwd_dkv.cu`` on the
    current stream: (dq, dk, dv)."""
    _check_backward(q, k, v, out, lse, g)
    fn_dq = kernels.function("flash_bwd_dq", "tdt_flash_bwd_dq", _BWD_DQ_ARGS)
    fn_dkv = kernels.function("flash_bwd_dkv", "tdt_flash_bwd_dkv",
                              _BWD_DKV_ARGS)
    with torch.cuda.device(q.device):
        grads = _launch_backward(
            fn_dq, fn_dkv, q, k, v, out, lse, g, causal, q_offset, kv_offset,
            torch.cuda.current_stream(q.device).cuda_stream)
    kernels.LAUNCHES["flash_bwd_dq"] += 1
    kernels.LAUNCHES["flash_bwd_dkv"] += 1
    return grads


def flash_backward(q, k, v, out, lse, g, *, causal: bool = True,
                   q_offset: int = 0, kv_offset: int = 0):
    """(dq, dk, dv): the kernels for CUDA tensors, the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, out, lse, g, causal, q_offset,
                                    kv_offset)
    return flash_backward_cuda(q, k, v, out, lse, g, causal, q_offset,
                               kv_offset)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``custom_vjp``):
    the forward saves ``(q, k, v, out, lse)``, the backward recomputes the
    scores from ``lse`` -- never a second full forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_offset):
        out, lse = flash_forward(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, q_offset, kv_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, kv_offset = ctx.mask
        dq, dk, dv = flash_backward(q, k, v, out, lse, g.contiguous(),
                                    causal=causal, q_offset=q_offset,
                                    kv_offset=kv_offset)
        return dq, dk, dv, None, None, None


@functools.lru_cache(maxsize=None)
def flash_attention_fn(block_q: int = 1024, block_k: int | None = None):
    """Returns ``attn(q, k, v, *, causal=True, q_offset=0, kv_offset=0)``
    backed by the flash kernels, differentiable through
    :class:`FlashAttention` when autograd records. ``block_q``/``block_k``
    are the TPU kernels' tile knobs, kept so configurations carry over; the
    Hopper kernels do not read them (fixed 64 x 64 tiles, ragged edges
    masked, so no length divisibility rule). Memoized per config, like the
    reference, so equal configs give the same callable."""

    def attn(q, k, v, *, causal: bool = True, q_offset=0, kv_offset=0):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, q_offset, kv_offset)
        return flash_forward(q, k, v, causal=causal, q_offset=q_offset,
                             kv_offset=kv_offset)[0]

    return attn


# ---- forward over pre-quantized int8 K/V ----------------------------------

@kernels.plain_version
def int8kv_flash_plain(q, kv, causal: bool = True, q_offset: int = 0,
                       kv_offset: int = 0):
    """The int8-K/V kernel's function in plain PyTorch: K/V dequantized to
    fp32 (``k * ks``, ``v * vs``), then :func:`flash_forward_plain`'s fp32
    masked softmax with the offsets; output in q's dtype."""
    kq, ks, vq, vs = kv
    kf = kq.float() * ks[..., None]
    vf = vq.float() * vs[..., None]
    out, _ = flash_forward_plain(q.float(), kf, vf, causal, q_offset,
                                 kv_offset)
    return out.to(q.dtype)


def _check_int8kv(q, kq, ks, vq, vs):
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (kq, ks, vq, vs))):
        raise ValueError("flash int8-KV kernel: q and the K/V pack must be "
                         "on one CUDA device")
    if q.dtype not in kernels.DTYPE_CODE:
        raise TypeError(f"flash int8-KV kernel: q float32 or bfloat16, got "
                        f"{q.dtype}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8 \
            or ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError("flash int8-KV kernel: int8 K/V with float32 scales")
    if q.dim() != 4 or kq.dim() != 4:
        raise ValueError(f"flash int8-KV kernel: q (B, Lq, H, D) and K/V "
                         f"(B, Lk, H, D) expected, got {tuple(q.shape)}, "
                         f"{tuple(kq.shape)}")
    b, lq, h, d = q.shape
    lk = kq.shape[1]
    if kq.shape != (b, lk, h, d) or vq.shape != kq.shape \
            or ks.shape != (b, lk, h) or vs.shape != ks.shape:
        raise ValueError(f"flash int8-KV kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(kq.shape)}, scale {tuple(ks.shape)} do "
                         "not agree")
    kernels.check_head_dim("flash int8-KV kernel", d)
    if min(b, lq, lk, h) < 1:
        raise ValueError("flash int8-KV kernel: empty q or K/V")
    if not all(t.is_contiguous() for t in (q, kq, ks, vq, vs)):
        raise ValueError("flash int8-KV kernel: inputs must be contiguous")


_INT8KV_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _launch_int8kv(fn, q, kv, causal, q_offset, kv_offset, stream):
    """Call the C entry ``fn`` (``tdt_flash_fwd_int8kv``) on checked
    tensors: allocate the output, launch on ``stream``, raise on a launch
    error."""
    kq, ks, vq, vs = kv
    b, lq, h, d = q.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
             vs.data_ptr(), out.data_ptr(), b, h, lq, kq.shape[1], d,
             int(bool(causal)), int(q_offset), int(kv_offset),
             1.0 / math.sqrt(d), kernels.DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise _launch_error("flash_fwd_int8kv", err)
    return out


def int8kv_flash_cuda(q, kv, causal: bool = True, q_offset: int = 0,
                      kv_offset: int = 0):
    """Launch ``csrc/flash_fwd_int8kv.cu`` on the current stream."""
    _check_int8kv(q, *kv)
    fn = kernels.function("flash_fwd_int8kv", "tdt_flash_fwd_int8kv",
                          _INT8KV_ARGS)
    with torch.cuda.device(q.device):
        out = _launch_int8kv(fn, q, kv, causal, q_offset, kv_offset,
                             torch.cuda.current_stream(q.device).cuda_stream)
    kernels.LAUNCHES["flash_fwd_int8kv"] += 1
    return out


@functools.lru_cache(maxsize=None)
def int8kv_flash_attention_fn(block_q: int = 1024, block_k: int | None = None):
    """Returns ``attn(q, kv, *, causal=True, q_offset=0, kv_offset=0)`` over
    a pre-quantized K/V pack ``kv = quantize_kv(k, v)`` (int8 values and
    per-(b, l, h) fp32 scales): the port of the reference's int8-KV flash
    forward. Forward only. The kernel ``csrc/flash_fwd_int8kv.cu`` for CUDA
    tensors, :func:`int8kv_flash_plain` for CPU tensors. ``block_q`` /
    ``block_k`` are the TPU kernel's tile knobs; the Hopper kernel does not
    read them (fixed 64 x 64 tiles, ragged edges masked)."""

    def attn(q, kv, *, causal: bool = True, q_offset=0, kv_offset=0):
        if q.device.type == "cpu":
            return int8kv_flash_plain(q, kv, causal, q_offset, kv_offset)
        return int8kv_flash_cuda(q, kv, causal, q_offset, kv_offset)

    return attn
