"""Mixture-of-Experts LM for the port (``tpu_dist/models/moe.py``):
GShard/Switch routing with a fixed expert capacity.

Numerics follow the reference:

* :func:`moe_group_geometry` (``:26-36``): tokens route in groups of
  ``group_size`` (the rows when that does not divide the tokens), each
  expert taking ``capacity = int(S / E * factor * k)`` per group;
* :class:`MoEMLP` (``:39-175``): an fp32 router (``gate``, no bias),
  softmax probabilities, top-1 (Switch) or top-2 (GShard) choice with
  ``torch.argmax``'s first maximum (``jnp.argmax``'s rule), capacity slots
  from the cumsum (``:86-110``; second choices queue behind every first
  choice of their expert, the two gates renormalized to sum to 1), tokens
  over capacity dropped (they pass through the residual), the dispatch and
  combine as one-hot einsums, and the expert MLPs (``w_in`` (E, d, f),
  tanh GELU, ``w_out`` (E, f, d)) through ``ops.quant.moe_expert_matmul``
  (``quant="int8"``: ``csrc/fused_quant.cu`` per expert on the card);
* the Switch balance loss ``E * sum(token_fraction * mean_prob)`` plus
  ``z_loss_coef`` times the router z-loss ``mean(logsumexp(logits)^2)``
  (``:117-124``), and the per-token combine mass diagnostic
  (``:126-128``). The reference sows them; here each block returns them
  and :meth:`MoETransformerLM.collect_aux` sums them, for
  ``engine.lm_steps`` to add ``aux_weight`` times the aux to the
  objective (``tpu_dist/engine/lm_steps.py:87``);
* :class:`MoETransformerLM`: the dense LM's embeddings, attention, final
  norm and head (``models.transformer``), an MoE MLP in every block.

Expert parallelism (``parallel.ep``) sets ``ep`` on the MLPs: each rank
holds E/M experts, routes every token, runs its experts and sums the
combine over the expert group. Where the batch is split over ``data`` in
a mode the reference runs through GSPMD (dp, fsdp, ep), the trainer sets
``data`` too: routing stays group-local, but the balance loss's token
fraction and mean probability and the z-loss's mean are taken over the
whole batch, as GSPMD takes them (``parallel.collectives.sum_over_group``);
under ``sp`` the reference takes them per sequence shard, and so does the
port. Decode runs through the dense LM's
contiguous cache (``attend_maybe_cached``); the paged serving engine
refuses MoE, as the reference's does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_dist_torch.models.transformer import (AttentionBlock,
                                               TransformerLM, full_attention)
from tpu_dist_torch.ops.quant import moe_expert_matmul, validate_quant


def moe_group_geometry(total_tokens: int, seq_len: int, num_experts: int,
                       router_top_k: int, group_size: int = 512,
                       capacity_factor: float = 1.25):
    """(group tokens S, per-expert capacity C): the dispatch geometry,
    shared by :class:`MoEMLP` and the trainer's FLOP count."""
    s = min(group_size, total_tokens)
    if total_tokens % s:
        s = seq_len
    cap = max(1, int(s / num_experts * capacity_factor * router_top_k))
    return s, cap


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen) -> None:
    """flax's ``lecun_normal``: a truncated normal (2 std), variance
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    w = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
    t.copy_(w)


class Gate(nn.Module):
    """The router: an fp32 dense layer without bias, ``kernel`` (d, E).
    Not a ``QuantDense``: no quant mode or decode quantization touches it
    (int8 logits would reroute tokens rather than perturb them)."""

    def __init__(self, d_model: int, num_experts: int, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_model, num_experts,
                                               dtype=param_dtype,
                                               device=device),
                                   requires_grad=False)

    def reset_parameters(self, generator) -> None:
        with torch.no_grad():
            _lecun_normal_(self.kernel, self.kernel.shape[0], generator)

    def forward(self, x):
        return x.float() @ self.kernel.float()


class MoEMLP(nn.Module):
    """MoE feed-forward, (B, L, D) -> ((B, L, D), (aux, mass_sum,
    mass_n)). ``mode`` is the quant knob of the expert matmuls only."""

    def __init__(self, d_model: int, num_experts: int = 4,
                 mlp_ratio: int = 4, capacity_factor: float = 1.25,
                 group_size: int = 512, router_top_k: int = 1,
                 z_loss_coef: float = 1e-3, dtype=torch.float32,
                 quant: str = "none", device=None, param_dtype=None):
        super().__init__()
        if router_top_k not in (1, 2):
            raise ValueError("router_top_k must be 1 or 2")
        param_dtype = dtype if param_dtype is None else param_dtype
        self.num_experts, self.router_top_k = num_experts, router_top_k
        self.capacity_factor, self.group_size = capacity_factor, group_size
        self.z_loss_coef = z_loss_coef
        self.dtype, self.mode = dtype, validate_quant(quant)
        self.ep = self.tp = self.data = None
        f = mlp_ratio * d_model
        self.gate = Gate(d_model, num_experts, device)
        self.w_in = nn.Parameter(torch.empty(num_experts, d_model, f,
                                             dtype=param_dtype,
                                             device=device),
                                 requires_grad=False)
        self.w_out = nn.Parameter(torch.empty(num_experts, f, d_model,
                                              dtype=param_dtype,
                                              device=device),
                                  requires_grad=False)

    def reset_parameters(self, generator) -> None:
        with torch.no_grad():
            _lecun_normal_(self.w_in, self.w_in.shape[-2], generator)
            _lecun_normal_(self.w_out, self.w_out.shape[-2], generator)

    def route(self, tokens, cap: int):
        """(dispatch, combine, aux, mass) of (G, S, D) tokens at capacity
        ``cap``: dispatch and combine (G, S, E, C) fp32, the aux loss, the
        (G, S) combine mass."""
        e, k = self.num_experts, self.router_top_k
        gate_logits = self.gate(tokens)                     # (G, S, E)
        probs = torch.softmax(gate_logits, dim=-1)
        expert_idx = probs.argmax(dim=-1)
        gate = probs.amax(dim=-1)
        onehot = F.one_hot(expert_idx, e).float()

        def slots(pos, keep):
            return keep[..., None] * F.one_hot(pos.clamp(max=cap - 1),
                                               cap).float()

        pos = (torch.cumsum(onehot, 1) * onehot - onehot).long()
        keep = (pos < cap).float() * onehot
        disp = slots(pos, keep)
        if k == 1:
            combine = disp * gate[..., None, None]
        else:
            probs2 = probs * (1.0 - onehot)
            idx2 = probs2.argmax(dim=-1)
            gate2 = probs2.amax(dim=-1)
            denom = torch.clamp(gate + gate2, min=1e-9)
            combine = disp * (gate / denom)[..., None, None]
            onehot2 = F.one_hot(idx2, e).float()
            count1 = keep.sum(dim=1, keepdim=True)
            pos2 = (torch.cumsum(onehot2, 1) * onehot2 - onehot2
                    + count1 * onehot2).long()
            keep2 = (pos2 < cap).float() * onehot2
            disp2 = slots(pos2, keep2)
            disp = disp + disp2
            combine = combine + disp2 * (gate2 / denom)[..., None, None]
        frac = onehot.mean(dim=(0, 1))
        mean_prob = probs.mean(dim=(0, 1))
        z = torch.logsumexp(gate_logits, dim=-1).square().mean()
        data = self.data if self.data is not None and self.data.size > 1 \
            else None
        if data is not None:         # the whole batch's means (docstring)
            from tpu_dist_torch.parallel.collectives import (all_reduce,
                                                             sum_over_group)
            frac = all_reduce(frac, data.group) / data.size
            mean_prob = sum_over_group(mean_prob, data.group) / data.size
            z = sum_over_group(z, data.group) / data.size
        aux = e * (frac * mean_prob).sum() + self.z_loss_coef * z
        return disp, combine, aux, combine.sum(dim=(-2, -1))

    def forward(self, x):
        from tpu_dist_torch.parallel.collectives import (copy_to_group,
                                                         reduce_from_group)

        b, l, d = x.shape
        s, cap = moe_group_geometry(b * l, l, self.num_experts,
                                    self.router_top_k, self.group_size,
                                    self.capacity_factor)
        tokens = x.reshape(b * l // s, s, d)
        disp, combine, aux, mass = self.route(tokens, cap)
        tok = tokens.to(self.dtype)
        ep = self.ep if self.ep is not None and self.ep.size > 1 else None
        tp = self.tp if self.tp is not None and self.tp.size > 1 else None
        if ep is not None:
            # every rank routes every token; this rank runs its experts
            el = self.w_in.shape[0]
            tok = copy_to_group(tok, ep.group)
            combine = copy_to_group(combine, ep.group)
            disp = disp.narrow(2, ep.index * el, el)
            combine = combine.narrow(2, ep.index * el, el)
        if tp is not None:
            tok = copy_to_group(tok, tp.group)
        expert_in = torch.einsum("gsec,gsd->gecd", disp.to(self.dtype), tok)
        h = moe_expert_matmul("gecd,edf->gecf", expert_in,
                              self.w_in.to(self.dtype), self.mode)
        h = F.gelu(h, approximate="tanh")
        out = moe_expert_matmul("gecf,efd->gecd", h,
                                self.w_out.to(self.dtype), self.mode,
                                None if tp is None else tp.group)
        if tp is not None:
            out = reduce_from_group(out, tp.group)
        out = torch.einsum("gsec,gecd->gsd", combine.to(self.dtype), out)
        if ep is not None:
            out = reduce_from_group(out, ep.group)
        mass_n = torch.full((), float(mass.numel()), device=x.device)
        return out.reshape(b, l, d), (aux, mass.sum(), mass_n)


class MoEBlock(AttentionBlock):
    """A transformer block whose MLP is an :class:`MoEMLP` (attention as
    the dense block's). Returns (x, (aux, mass_sum, mass_n))."""

    def __init__(self, d_model: int, num_heads: int, num_experts: int = 4,
                 dtype=torch.float32, attn_fn: Callable = full_attention,
                 router_top_k: int = 1, group_size: int = 512,
                 capacity_factor: float = 1.25, quant: str = "none",
                 device=None, param_dtype=None, tp_impl: str = "gspmd"):
        super().__init__(d_model, num_heads, dtype, attn_fn, quant, device,
                         param_dtype, tp_impl)
        self.moe = MoEMLP(d_model, num_experts, dtype=dtype,
                          router_top_k=router_top_k, group_size=group_size,
                          capacity_factor=capacity_factor, quant=quant,
                          device=device, param_dtype=param_dtype)

    def forward(self, x, cache=None, paged=None, paged_prefill: bool = False):
        if paged is not None:
            raise ValueError("the MoE LM does not serve from the paged pool "
                             "(the reference's ServeEngine refuses MoE)")
        x, _ = self.attend(x, cache)
        y, aux = self.moe(self.ln2(x))
        return x + y, aux


class MoETransformerLM(TransformerLM):
    """Decoder-only LM with an MoE feed-forward in every block: int tokens
    (B, L) -> fp32 logits (B, L, V); the dense LM's keyword arguments plus
    the MoE knobs."""

    def __init__(self, vocab_size: int = 256, num_layers: int = 2,
                 d_model: int = 64, num_heads: int = 4, num_experts: int = 4,
                 max_len: int = 512, dtype=torch.float32,
                 attn_fn: Optional[Callable] = None, router_top_k: int = 1,
                 group_size: int = 512, capacity_factor: float = 1.25,
                 remat: bool = False, quant: str = "none",
                 tp_impl: str = "gspmd", device=None,
                 seed: Optional[int] = 0, param_dtype=None):
        self.num_experts, self.router_top_k = num_experts, router_top_k
        self.group_size, self.capacity_factor = group_size, capacity_factor
        super().__init__(vocab_size=vocab_size, num_layers=num_layers,
                         d_model=d_model, num_heads=num_heads,
                         max_len=max_len, dtype=dtype,
                         attn_fn=attn_fn or full_attention, quant=quant,
                         device=device, seed=seed, param_dtype=param_dtype,
                         remat=remat, tp_impl=tp_impl)

    def _block(self, d_model, num_heads, dtype, attn_fn, quant, device,
               param_dtype):
        return MoEBlock(d_model, num_heads, self.num_experts, dtype, attn_fn,
                        self.router_top_k, self.group_size,
                        self.capacity_factor, quant, device, param_dtype,
                        self.tp_impl)

    def set_tp(self, axis) -> None:
        super().set_tp(axis)
        for blk in self.blocks:
            blk.moe.tp = axis

    def set_data(self, axis) -> None:
        """Take the balance loss's means over the data axis (module
        docstring)."""
        for blk in self.blocks:
            blk.moe.data = axis

    def set_ep(self, axis) -> None:
        """Run the experts expert-parallel over ``axis``
        (``parallel.ep.shard_moe_`` calls this after slicing them)."""
        for blk in self.blocks:
            blk.moe.ep = axis

    def collect_aux(self, extras, like) -> dict:
        aux = sum(e[0] for e in extras)
        return {"aux": aux, "mass_sum": sum(e[1] for e in extras),
                "mass_n": sum(e[2] for e in extras)}
