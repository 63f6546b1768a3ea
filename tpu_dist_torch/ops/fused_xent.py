"""Chunked vocab cross entropy for the port (``tpu_dist/ops/fused_xent.py``).

The unchunked LM loss holds the whole (B, L, V) fp32 logits tensor: at the
training geometry (B8, L2048, V32000) about 2.1 GB, plus its softmax in the
backward. :func:`chunked_softmax_xent` computes the same loss without ever
holding more than one (chunk, V) tile of logits:

* forward: a loop over row chunks of the flattened (B*L, D) features; each
  chunk's head product (fp32 output), reduced to the per-row logsumexp,
  target logit and argmax hit, then dropped. Only the (N,) fp32
  logsumexp is kept for the backward;
* backward (:class:`ChunkedSoftmaxXent`, the reference's ``custom_vjp``):
  a second loop recomputes each chunk's logits, forms softmax - onehot
  against the SAVED logsumexp, casts it to the compute dtype, and adds up
  the features' rows and the (D, V) head-weight gradient in fp32.

The head product multiplies compute-dtype operands with an fp32 result,
as ``jnp.dot(..., preferred_element_type=float32)`` does
(:func:`~tpu_dist_torch.ops.f32_product.mm_f32`: ``torch.mm(...,
out_dtype=torch.float32)`` where this PyTorch takes it, else an exact
upcast; ``f32_product.mm_route`` says which).

Against the unchunked loss (``engine.lm_steps.lm_loss_and_metrics``) the
result differs by that path's rounding of the logits to the compute dtype
before its fp32 softmax (none in fp32; one bf16 rounding, 2^-9 relative
to each logit, under bf16), plus fp32 summation order.

It is plain PyTorch: the reference's function is ``lax.scan`` and
``jnp.dot`` with no Pallas kernel behind it.
"""

from __future__ import annotations

import torch

from tpu_dist_torch.ops.f32_product import mm_f32


def _chunk_stats(x_c, w_c, t_c):
    """One chunk's (logsumexp, target logit, argmax == target)."""
    logits = mm_f32(x_c, w_c)                                  # (C, V) fp32
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
    tgt = logits.gather(-1, t_c[:, None])[:, 0]
    hit = (logits.argmax(dim=-1) == t_c).float()
    return lse, tgt, hit


def _pad_rows(a, n_pad):
    if n_pad == 0:
        return a
    return torch.cat([a, a.new_zeros((n_pad, *a.shape[1:]))])


def _flat_padded(x, targets, mask, chunk):
    b, l, d = x.shape
    n = b * l
    chunk = max(1, min(chunk, n))
    n_pad = (-n) % chunk
    # padded rows carry mask 0 and add nothing
    return (_pad_rows(x.reshape(n, d), n_pad),
            _pad_rows(targets.reshape(n).long(), n_pad),
            _pad_rows(mask.reshape(n).float(), n_pad), chunk, n_pad)


class ChunkedSoftmaxXent(torch.autograd.Function):
    """(loss_sum, correct1) with the chunked backward; differentiable in
    ``x`` and ``w`` only."""

    @staticmethod
    def forward(ctx, x, w, targets, mask, chunk, compute_dtype):
        xf, tf, mf, chunk, n_pad = _flat_padded(x, targets, mask, chunk)
        w_c = w.to(compute_dtype)
        loss_sum = x.new_zeros((), dtype=torch.float32)
        correct = x.new_zeros((), dtype=torch.float32)
        lse_all = []
        for s in range(0, xf.shape[0], chunk):
            x_c = xf[s:s + chunk].to(compute_dtype)
            lse, tgt, hit = _chunk_stats(x_c, w_c, tf[s:s + chunk])
            m_c = mf[s:s + chunk]
            loss_sum = loss_sum + ((lse - tgt) * m_c).sum()
            correct = correct + (hit * m_c).sum()
            lse_all.append(lse)
        ctx.save_for_backward(xf, w, tf, mf, torch.cat(lse_all))
        ctx.meta = (x.shape, x.dtype, chunk, n_pad, compute_dtype)
        ctx.mark_non_differentiable(correct)
        return loss_sum, correct

    @staticmethod
    def backward(ctx, g_loss, _g_correct):
        xf, w, tf, mf, lse_all = ctx.saved_tensors
        x_shape, x_dtype, chunk, n_pad, cd = ctx.meta
        w_c = w.to(cd)
        w_t = w_c.t()
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dx = []
        for s in range(0, xf.shape[0], chunk):
            x_c = xf[s:s + chunk].to(cd)
            logits = mm_f32(x_c, w_c)
            p = torch.exp(logits - lse_all[s:s + chunk, None])
            scale = (mf[s:s + chunk] * g_loss)[:, None]
            p.scatter_add_(1, tf[s:s + chunk, None],
                           -torch.ones_like(p[:, :1]))
            dl_c = (p * scale).to(cd)
            dx.append(mm_f32(dl_c, w_t))
            dw += mm_f32(x_c.t(), dl_c)
        dx = torch.cat(dx)
        if n_pad:
            dx = dx[:dx.shape[0] - n_pad]
        return (dx.reshape(x_shape).to(x_dtype), dw.to(w.dtype), None, None,
                None, None)


def chunked_softmax_xent(x, w, targets, mask, chunk: int = 1024,
                         compute_dtype=torch.float32):
    """(loss_sum, correct1) over the positions ``mask`` keeps, without the
    full logits. ``x`` (B, L, D) features after the final LayerNorm, ``w``
    (D, V) the lm_head kernel, ``targets`` (B, L) int, ``mask`` (B, L).
    ``correct1`` counts argmax hits (first maximal index on ties) and
    carries no gradient."""
    return ChunkedSoftmaxXent.apply(x, w, targets, mask, int(chunk),
                                    compute_dtype)
