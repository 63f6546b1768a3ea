"""Ring attention for the port (``tpu_dist/parallel/ring_attention.py``):
exact causal attention over a sequence-sharded ``seq`` mesh axis.

Each rank holds one contiguous chunk of the sequence. Its q stays; its K/V
travel around the ring by
:func:`~tpu_dist_torch.parallel.collectives.ppermute` (rank p sends to
p+1, so after i steps the resident block came from rank ``index - i``).
Each block's scores fold into an fp32 online softmax (running max, sum
and output, log-sum-exp rescaling, ``NEG_INF = -1e30`` so a fully masked
block never makes ``-inf - -inf``). Causality comes from global
positions: blocks wholly in the future are masked, the diagonal block
gets the triangle. After ``size`` steps every row has seen every key it
may: the result equals full attention.

The reference computes this in plain JAX with no Pallas kernel, so the
products here are plain torch. The gradient flows through ``ppermute``'s
backward (the reverse shift), as JAX transposes ``lax.ppermute``.
"""

from __future__ import annotations

import math
from functools import lru_cache, partial
from typing import Callable

import torch

from tpu_dist_torch.parallel.collectives import ppermute

NEG_INF = -1e30  # avoid nan from (-inf) - (-inf) in the rescaling


def ring_attention(q, k, v, axis, causal: bool = True, q_offset: int = 0,
                   kv_offset: int = 0):
    """Exact attention with K/V rotating around ``axis`` (a
    ``parallel.mesh.Axis``; ``q_offset``/``kv_offset`` are taken for the
    ``attn_fn`` signature and must be 0: positions come from the ring).
    q, k, v: (B, L_shard, H, D), this rank's chunk. Returns (B, L_shard,
    H, D) accumulated in fp32, cast to q's dtype."""
    if q_offset or kv_offset:
        raise ValueError("ring attention places chunks by the ring index; "
                         "q_offset/kv_offset must be 0")
    n, me = axis.size, axis.index
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_sum = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    qpos = me * lq + torch.arange(lq, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        kv_idx = (me - i) % n
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_cur.float()) * scale
        if causal:
            kpos = kv_idx * lk + torch.arange(lk, device=q.device)
            mask = kpos[None, :] <= qpos[:, None]
            scores = torch.where(mask[None, None], scores,
                                 torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_sum = l_sum * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v_cur.float())
        o = o * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
        if i < n - 1:
            k_cur, v_cur = ppermute([k_cur, v_cur], 1, axis.group)
    o = o / torch.clamp(l_sum, min=1e-30).transpose(1, 2)[..., None]
    return o.to(q.dtype)


@lru_cache(maxsize=None)
def ring_attention_fn(axis, causal: bool = True) -> Callable:
    """The ``attn_fn`` for the LM: ring attention over ``axis``, memoized
    per config as the reference's is."""
    return partial(ring_attention, axis=axis, causal=causal)
