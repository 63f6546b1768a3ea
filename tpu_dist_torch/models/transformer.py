"""Causal transformer LM for the port (``tpu_dist/models/transformer.py``).

Numerics follow the flax model the reference trains and serves:

* pre-LN blocks; LayerNorm statistics in fp32 with eps 1e-6 and flax's
  fast variance (E[x^2] - E[x]^2, clipped at 0), fp32 output;
* GELU is the tanh approximation (``nn.gelu`` default), not torch's erf;
* attention scores and softmax in fp32, logits cast to fp32;
* dense kernels keep flax's (in, out) layout (``ops.quant.QuantDense``),
  so :mod:`tpu_dist_torch.interop` loads a flax tree without transposes.

``attn_fn`` is pluggable exactly as in the reference: :func:`full_attention`
(plain PyTorch), ``ops.flash_attention.blockwise_attention_fn()`` (plain
PyTorch over KV blocks) or ``ops.flash_attention.flash_attention_fn()``
(the flash kernels). The model serves through three caches: none (``forward`` over
whole sequences), a contiguous per-block cache (``engine.generate``), and
an external paged pool (``engine.serve``; ``paged=`` makes ``forward``
return ``(logits, layers)``).

Training mode (``engine.lm_loop.LMTrainer``): parameters are kept in
``param_dtype`` (fp32 masters under ``precision="bf16"``) and cast to the
compute ``dtype`` at each call, as flax does; the trainer turns
``requires_grad`` on (a serving model keeps it off); ``remat=True`` runs
each block under ``torch.utils.checkpoint`` when autograd records, the
reference's ``nn.remat``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.ops.quant import make_dense


def full_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                   kv_offset: int = 0):
    """Reference attention over (B, L, H, D) tensors, fp32 softmax."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(d)
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = kv_offset + torch.arange(k.shape[1], device=q.device)[None, :]
        scores = scores.masked_fill(~(kpos <= qpos), float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


def attend_maybe_cached(q, k, v, *, attn_fn: Callable, dtype, cache=None,
                        paged=None, paged_prefill: bool = False):
    """The attention contraction of one block, maintaining its KV cache.

    ``paged`` delegates to ``ops.paged_attention.paged_attend`` (returns
    ``(out, layer)``). ``cache`` is the contiguous per-block cache of
    ``engine.generate``: ``{"k", "v": (B, T, H, D), "index": int}`` --
    the rows are written at ``index`` and attention runs over the whole
    buffer with the causal mask hiding positions past the write (the
    reference's flax decode cache). Neither: ``attn_fn(q, k, v)``."""
    if paged is not None:
        from tpu_dist_torch.ops.paged_attention import paged_attend

        return paged_attend(q, k, v, paged, prefill=paged_prefill,
                            attn_fn=attn_fn, dtype=dtype)
    if cache is None:
        return attn_fn(q, k, v)
    idx = cache["index"]
    cache["k"][:, idx:idx + q.shape[1]] = k.to(dtype)
    cache["v"][:, idx:idx + q.shape[1]] = v.to(dtype)
    cache["index"] = idx + q.shape[1]
    return full_attention(q, cache["k"], cache["v"], q_offset=idx,
                          kv_offset=0)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: fp32 statistics, eps 1e-6,
    fast variance, fp32 output; params ``scale``/``bias`` (fp32)."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features, device=device),
                                 requires_grad=False)

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (xf - mean) * mul + self.bias


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 attn_fn: Callable = full_attention, quant: str = "none",
                 device=None, param_dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_fn = attn_fn
        dense = dict(dtype=dtype, quant=quant, device=device,
                     param_dtype=param_dtype)
        self.ln1 = LayerNorm(d_model, device=device)
        self.qkv = make_dense(d_model, 3 * d_model, use_bias=False, **dense)
        self.proj = make_dense(d_model, d_model, use_bias=False, **dense)
        self.ln2 = LayerNorm(d_model, device=device)
        self.mlp_in = make_dense(d_model, 4 * d_model, **dense)
        self.mlp_out = make_dense(4 * d_model, d_model, **dense)

    def forward(self, x, cache=None, paged=None, paged_prefill: bool = False):
        b, l, d_model = x.shape
        head_dim = d_model // self.num_heads
        qkv = self.qkv(self.ln1(x))
        q, k, v = (t.reshape(b, l, self.num_heads, head_dim).contiguous()
                   for t in qkv.split(d_model, dim=-1))
        out = attend_maybe_cached(q, k, v, attn_fn=self.attn_fn,
                                  dtype=self.dtype, cache=cache, paged=paged,
                                  paged_prefill=paged_prefill)
        layer = None
        if paged is not None:
            out, layer = out
        x = x + self.proj(out.reshape(b, l, d_model))
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        x = x + self.mlp_out(h)
        return x, layer


class TransformerLM(nn.Module):
    """Decoder-only LM: int tokens (B, L) -> fp32 logits (B, L, V).

    Parameters are made on ``device`` (default CUDA; ``device="cpu"`` for
    the plain path) in ``param_dtype`` (default: the compute ``dtype``) and
    filled by :meth:`init_weights` from a seed, or loaded from a flax tree
    by :mod:`tpu_dist_torch.interop`."""

    def __init__(self, vocab_size: int = 32000, num_layers: int = 4,
                 d_model: int = 256, num_heads: int = 8, max_len: int = 2048,
                 dtype=torch.float32, attn_fn: Callable = full_attention,
                 quant: str = "none", device=None, seed: Optional[int] = 0,
                 param_dtype=None, remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        param_dtype = dtype if param_dtype is None else param_dtype
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.d_model, self.num_heads = d_model, num_heads
        self.max_len = max_len
        self.dtype, self.attn_fn, self.quant = dtype, attn_fn, quant
        self.remat = remat
        self.tok_emb = nn.Embedding(vocab_size, d_model, dtype=param_dtype,
                                    device=device)
        self.pos_emb = nn.Embedding(max_len, d_model, dtype=param_dtype,
                                    device=device)
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, dtype, attn_fn, quant, device,
                  param_dtype) for _ in range(num_layers))
        self.ln_f = LayerNorm(d_model, device=device)
        self.lm_head = make_dense(d_model, vocab_size, use_bias=False,
                                  dtype=dtype, quant=quant, device=device,
                                  param_dtype=param_dtype)
        self.requires_grad_(False)
        if seed is not None:
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.weight.device

    def _embed(self, emb: nn.Embedding, idx):
        """flax ``nn.Embed(dtype=...)``: the table is cast to the compute
        dtype, then indexed (its gradient accumulates in that dtype)."""
        return F.embedding(idx, emb.weight.to(self.dtype))

    def init_weights(self, seed: int) -> None:
        """Random weights from ``seed`` with flax's initializers: embeddings
        normal(1/sqrt(d_model)), dense lecun_normal, LayerNorm 1 and 0."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        with torch.no_grad():
            for emb in (self.tok_emb, self.pos_emb):
                w = torch.randn(emb.weight.shape, generator=gen,
                                device=self.device) / math.sqrt(self.d_model)
                emb.weight.copy_(w)
            for m in self.modules():
                if hasattr(m, "reset_parameters") and m is not self \
                        and not isinstance(m, nn.Embedding):
                    m.reset_parameters(gen)

    def forward(self, tokens, pos_offset=0, caches: Optional[List] = None,
                paged=None, paged_prefill: bool = False,
                return_features: bool = False):
        """``pos_offset``: global position of the first token, an int or a
        (B,) tensor of per-row positions (the paged tick). ``caches``: one
        contiguous cache dict per block (``engine.generate``). ``paged``:
        the pool context ``{"layers", "block_tables", "positions",
        "lengths"[, "valid"]}``; then returns ``(logits, layers)``."""
        l = tokens.shape[1]
        x = self._embed(self.tok_emb, tokens.long())
        ar = torch.arange(l, device=tokens.device)
        if torch.is_tensor(pos_offset) and pos_offset.dim():
            # padding rows of a last prefill chunk may run past max_len;
            # their outputs are discarded, so clamp rather than index out
            # of the table (a device-side fault on CUDA)
            pos = torch.clamp(pos_offset.long()[:, None] + ar[None, :],
                              max=self.max_len - 1)
            x = x + self._embed(self.pos_emb, pos)
        else:
            x = x + self._embed(self.pos_emb, int(pos_offset) + ar)[None]
        ctx = None if paged is None else {
            k: paged.get(k) for k in ("block_tables", "positions", "lengths",
                                      "valid", "sp_mesh")}
        new_layers = []
        remat = (self.remat and torch.is_grad_enabled() and caches is None
                 and paged is None)
        for i, blk in enumerate(self.blocks):
            if remat:
                x, _ = checkpoint(blk, x, use_reentrant=False)
                continue
            x, layer = blk(
                x, cache=None if caches is None else caches[i],
                paged=None if paged is None else {**ctx,
                                                  "layer": paged["layers"][i]},
                paged_prefill=paged_prefill)
            new_layers.append(layer)
        x = self.ln_f(x)
        if return_features:
            if paged is not None:
                raise ValueError("return_features=True cannot ride the "
                                 "paged cache path")
            return x
        logits = self.lm_head(x).float()
        if paged is not None:
            return logits, tuple(new_layers)
        return logits


def tiny_lm(vocab_size=256, num_layers=2, d_model=64, num_heads=4,
            max_len=512, dtype=torch.float32, attn_fn=full_attention,
            quant="none", device=None, seed=0, param_dtype=None,
            remat=False, **_):
    return TransformerLM(vocab_size=vocab_size, num_layers=num_layers,
                         d_model=d_model, num_heads=num_heads,
                         max_len=max_len, dtype=dtype, attn_fn=attn_fn,
                         quant=quant, device=device, seed=seed,
                         param_dtype=param_dtype, remat=remat)
