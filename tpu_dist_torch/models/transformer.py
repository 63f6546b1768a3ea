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

Tensor parallelism over a ``model`` mesh axis (``parallel.tp`` and
``parallel.overlap``) sets ``tp`` on the model and its blocks: under
``tp_impl="gspmd"`` the blocks hold their Megatron shards (``qkv`` and
``mlp_in`` column-parallel, ``proj`` and ``mlp_out`` row-parallel, the
``lm_head`` over a vocab shard) and run Megatron's collectives around
them, so attention runs over this rank's H/M heads and the logits are its
vocab shard (under ``quant="int8"`` a row-parallel product quantizes by the
whole contracted dim's scales, :func:`row_matmul`); under ``tp_impl="ring"`` the params stay whole, the residual
stream is this rank's sequence chunk, and each projection is a ring
collective matmul (``parallel.overlap.RingDense``). Decode refuses the
ring, as the reference does.

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
from tpu_dist_torch.ops.f32_product import matmul_f32
from tpu_dist_torch.ops.quant import make_dense


def full_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                   kv_offset: int = 0):
    """Reference attention over (B, L, H, D) tensors, fp32 softmax. The
    scores are the compute-dtype q and k's product with an fp32 result,
    as the reference's einsum with ``preferred_element_type=float32``."""
    d = q.shape[-1]
    scores = matmul_f32(q.transpose(1, 2),
                        k.transpose(1, 2).mT) / math.sqrt(d)
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


def refuse_ring_decode(tp_impl: str, decoding: bool) -> None:
    if tp_impl != "gspmd" and decoding:
        raise ValueError("tp_impl='ring' is a training path; decode rides "
                         "the GSPMD layers")


def row_matmul(dense, x, group):
    """A row-parallel shard's product without the bias: under ``int8`` the
    scales are the whole contracted dim's, taken over ``group``
    (``ops.pallas_quant.fused_quant_matmul(group=)``), as the reference's
    one GSPMD program takes them."""
    if dense.mode != "int8" or dense.prequantized:
        return dense.matmul(x)
    from tpu_dist_torch.ops.pallas_quant import fused_quant_matmul

    return fused_quant_matmul(x.to(dense.dtype),
                              dense.kernel.to(dense.dtype), group)


class Attention(nn.Module):
    """The attention contraction of a block (``attend_maybe_cached``) as a
    module of its own, with no parameters: module-scoped tools see its
    operators (the cost attribution of ``obs.attr`` buckets them as
    attention, forward and backward)."""

    def __init__(self, attn_fn: Callable):
        super().__init__()
        self.fn = attn_fn

    def forward(self, q, k, v, dtype, cache=None, paged=None,
                paged_prefill: bool = False):
        return attend_maybe_cached(q, k, v, attn_fn=self.fn, dtype=dtype,
                                   cache=cache, paged=paged,
                                   paged_prefill=paged_prefill)


class AttentionBlock(nn.Module):
    """The attention half of a pre-LN block (``ln1``, ``qkv``, ``proj``)
    and the ``ln2`` of its MLP half, shared by :class:`Block` and the MoE
    block (``models.moe``). ``tp`` (a ``parallel.mesh.Axis``) is set by
    ``parallel.tp`` / ``parallel.overlap`` for tensor parallelism."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 attn_fn: Callable = full_attention, quant: str = "none",
                 device=None, param_dtype=None, tp_impl: str = "gspmd"):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        # outside the module tree (no parameters, no state), so trees that
        # mirror the flax module's (interop's walkers) see the same children;
        # the global module hooks still see its calls
        object.__setattr__(self, "attn", Attention(attn_fn))
        self.tp_impl = tp_impl
        self.tp = None
        self._dense = dict(dtype=dtype, quant=quant, device=device,
                           param_dtype=param_dtype)
        self.ln1 = LayerNorm(d_model, device=device)
        self.qkv = make_dense(d_model, 3 * d_model, use_bias=False,
                              **self._dense)
        self.proj = make_dense(d_model, d_model, use_bias=False,
                               **self._dense)
        self.ln2 = LayerNorm(d_model, device=device)

    @property
    def tp_group(self):
        """This rank's model-axis group when tensor parallelism is on."""
        return None if self.tp is None or self.tp.size == 1 else self.tp.group

    def column(self, dense, x, fused: int = 1):
        """A column-parallel product: the whole input, this rank's output
        features (gspmd: Megatron's ``f`` first, the bias sliced from its
        replicated leaf; ring: the all-gather ring over sequence chunks)."""
        g = self.tp_group
        if g is None:
            return dense(x)
        if self.tp_impl in ("ring", "ring_ar"):
            from tpu_dist_torch.parallel.overlap import RingDense

            return RingDense(dense, "column", self.tp, fused,
                             self.tp_impl)(x)
        from tpu_dist_torch.parallel.collectives import (copy_to_group,
                                                         slice_shard)
        y = dense.matmul(copy_to_group(x, g))
        if dense.bias is not None:
            y = y + slice_shard(dense.bias, 0, g).to(dense.dtype)
        return y

    def row(self, dense, x):
        """A row-parallel product: this rank's input features, the whole
        output (gspmd: the partial products summed by Megatron's ``g``,
        then the replicated bias; ring: the reduce-scatter ring)."""
        g = self.tp_group
        if g is None:
            return dense(x)
        if self.tp_impl in ("ring", "ring_ar"):
            from tpu_dist_torch.parallel.overlap import RingDense

            return RingDense(dense, "row", self.tp,
                             flavor=self.tp_impl)(x)
        from tpu_dist_torch.parallel.collectives import reduce_from_group
        y = reduce_from_group(row_matmul(dense, x, g), g)
        if dense.bias is not None:
            y = y + dense.bias.to(dense.dtype)
        return y

    def attend(self, x, cache=None, paged=None, paged_prefill: bool = False):
        """x + proj(attention(qkv(ln1(x)))): (x, paged layer or None).
        Under tensor parallelism the heads are this rank's H/M."""
        refuse_ring_decode(self.tp_impl, cache is not None or paged is not None)
        b = x.shape[0]
        head_dim = x.shape[-1] // self.num_heads
        qkv = self.column(self.qkv, self.ln1(x), fused=3)
        l = qkv.shape[1]          # the whole sequence under the ring
        q, k, v = (t.reshape(b, l, -1, head_dim).contiguous()
                   for t in qkv.split(qkv.shape[-1] // 3, dim=-1))
        out = self.attn(q, k, v, self.dtype, cache=cache, paged=paged,
                        paged_prefill=paged_prefill)
        layer = None
        if paged is not None:
            out, layer = out
        return x + self.row(self.proj, out.reshape(b, l, -1)), layer


class Block(AttentionBlock):
    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 attn_fn: Callable = full_attention, quant: str = "none",
                 device=None, param_dtype=None, tp_impl: str = "gspmd"):
        super().__init__(d_model, num_heads, dtype, attn_fn, quant, device,
                         param_dtype, tp_impl)
        self.mlp_in = make_dense(d_model, 4 * d_model, **self._dense)
        self.mlp_out = make_dense(4 * d_model, d_model, **self._dense)

    def forward(self, x, cache=None, paged=None, paged_prefill: bool = False):
        x, layer = self.attend(x, cache, paged, paged_prefill)
        h = F.gelu(self.column(self.mlp_in, self.ln2(x)), approximate="tanh")
        x = x + self.row(self.mlp_out, h)
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
                 param_dtype=None, remat: bool = False,
                 tp_impl: str = "gspmd"):
        super().__init__()
        device = resolve_device(device)
        param_dtype = dtype if param_dtype is None else param_dtype
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.d_model, self.num_heads = d_model, num_heads
        self.max_len = max_len
        self.dtype, self.attn_fn, self.quant = dtype, attn_fn, quant
        self.remat = remat
        self.tp_impl = tp_impl
        self.tp = None
        self.tok_emb = nn.Embedding(vocab_size, d_model, dtype=param_dtype,
                                    device=device)
        self.pos_emb = nn.Embedding(max_len, d_model, dtype=param_dtype,
                                    device=device)
        self.blocks = nn.ModuleList(
            self._block(d_model, num_heads, dtype, attn_fn, quant, device,
                        param_dtype) for _ in range(num_layers))
        self.ln_f = LayerNorm(d_model, device=device)
        self.lm_head = make_dense(d_model, vocab_size, use_bias=False,
                                  dtype=dtype, quant=quant, device=device,
                                  param_dtype=param_dtype)
        self.requires_grad_(False)
        if seed is not None:
            self.init_weights(seed)

    def _block(self, d_model, num_heads, dtype, attn_fn, quant, device,
               param_dtype):
        return Block(d_model, num_heads, dtype, attn_fn, quant, device,
                     param_dtype, self.tp_impl)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.weight.device

    def set_tp(self, axis) -> None:
        """Run tensor-parallel over ``axis`` (a ``parallel.mesh.Axis``):
        ``parallel.tp.shard_lm_`` and ``parallel.overlap.ring_lm_`` call
        this after laying the params out."""
        self.tp = axis
        for blk in self.blocks:
            blk.tp = axis

    @property
    def tp_group(self):
        return None if self.tp is None or self.tp.size == 1 else self.tp.group

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
                return_features: bool = False, return_aux: bool = False):
        """``pos_offset``: global position of the first token, an int or a
        (B,) tensor of per-row positions (the paged tick). ``caches``: one
        contiguous cache dict per block (``engine.generate``). ``paged``:
        the pool context ``{"layers", "block_tables", "positions",
        "lengths"[, "valid", "sp_mesh", "attn_fn"]}``
        (``ops.paged_attention.paged_attend``); then returns ``(logits,
        layers)``.
        ``return_aux`` returns ``(out, aux)`` with the MoE blocks' router
        sums (:meth:`collect_aux`; zeros for a dense model). Under
        ``tp_impl="ring"`` the output holds this rank's sequence chunk,
        and under gspmd tensor parallelism the logits are this rank's
        vocab shard."""
        refuse_ring_decode(self.tp_impl,
                           caches is not None or paged is not None)
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
                                      "valid", "sp_mesh", "attn_fn")}
        if self.tp_group is not None and self.tp_impl == "ring":
            from tpu_dist_torch.parallel.overlap import seq_shard

            x = seq_shard(x, self.tp)
        new_layers, extras = [], []
        remat = (self.remat and torch.is_grad_enabled() and caches is None
                 and paged is None)
        for i, blk in enumerate(self.blocks):
            if remat:
                x, extra = checkpoint(blk, x, use_reentrant=False)
            else:
                x, extra = blk(
                    x, cache=None if caches is None else caches[i],
                    paged=None if paged is None else {
                        **ctx, "layer": paged["layers"][i]},
                    paged_prefill=paged_prefill)
            new_layers.append(extra)
            extras.append(extra)
        x = self.ln_f(x)
        if return_features:
            if paged is not None:
                raise ValueError("return_features=True cannot ride the "
                                 "paged cache path")
            return (x, self.collect_aux(extras, x)) if return_aux else x
        if self.tp_group is not None and self.tp_impl == "gspmd":
            from tpu_dist_torch.parallel.collectives import copy_to_group

            x = copy_to_group(x, self.tp_group)   # vocab-parallel head
        logits = self.lm_head(x).float()
        if paged is not None:
            return logits, tuple(new_layers)
        return (logits, self.collect_aux(extras, x)) if return_aux \
            else logits

    def collect_aux(self, extras, like) -> dict:
        """The router sums of one forward (``lm_steps._apply_collect_aux``):
        ``aux`` the blocks' balance + z losses, ``mass_sum`` and ``mass_n``
        the combine mass diagnostic. A dense model has none: zeros."""
        zero = torch.zeros((), dtype=torch.float32, device=like.device)
        return {"aux": zero, "mass_sum": zero, "mass_n": zero}


def tiny_lm(vocab_size=256, num_layers=2, d_model=64, num_heads=4,
            max_len=512, dtype=torch.float32, attn_fn=full_attention,
            quant="none", device=None, seed=0, param_dtype=None,
            remat=False, tp_impl="gspmd", **_):
    return TransformerLM(vocab_size=vocab_size, num_layers=num_layers,
                         d_model=d_model, num_heads=num_heads,
                         max_len=max_len, dtype=dtype, attn_fn=attn_fn,
                         quant=quant, device=device, seed=seed,
                         param_dtype=param_dtype, remat=remat,
                         tp_impl=tp_impl)
