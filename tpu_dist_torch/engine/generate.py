"""Autoregressive decoding for the port's LM (``tpu_dist/engine/generate.py``).

:func:`generate` is the one-shot batch call: ``use_cache=True`` decodes
through a contiguous per-block KV cache (one prefill forward, then one
token per tick); ``use_cache=False`` re-runs the whole buffer every tick.
It is the single-request reference the serving engine is held to: greedy
tokens through the paged pool equal the contiguous cache's
(tests/test_torch_serve.py). :func:`_sample`, :func:`_quantize_for_decode`
and :func:`prepare_draft` are shared with ``engine.serve``.

Sampling draws from an explicit ``torch.Generator``; it cannot reproduce
``jax.random``'s stream, so only greedy decoding compares across the two
packages.

Sharded decode (``mesh=``, the reference's ``:62`` and
``_shard_decode_inputs``, ``:294-335``): every rank of the mesh calls
:func:`generate` with the whole model and the whole prompt. The batch
shards over ``data`` when that divides B (each data rank decodes its
rows; the buffers are gathered at the end, so every rank returns the
whole (B, P + steps) buffer); the weights take the training tensor
parallel layout over ``model`` (``parallel.tp``: heads split
column/row, a vocab-sharded ``lm_head``; ``int8_wo`` kernels shard with
their scales), the KV cache holds this rank's H/M heads, and a greedy
token is the argmax across the vocab shards (each shard's max and first
index gathered, ``jnp.argmax``'s first-maximum rule); a sampled one draws
from the gathered logits with the same generator on every tp rank. The
MoE LM's experts shard over ``expert`` where the mesh carries that axis
(``parallel.ep``, with the Megatron split when ``model`` rides along).
"""

from __future__ import annotations

import copy
import itertools
import threading
import time
import weakref
from collections import OrderedDict
from typing import Optional

import torch

from tpu_dist_torch.ops.quant import (QuantDense, params_are_wo_quantized,
                                      quantize_int8, validate_quant)


def _sample(nxt_logits, temperature: float,
            generator: Optional[torch.Generator] = None, top_k: int = 0,
            top_p: float = 0.0):
    """Next tokens (B,) from logits (B, V): greedy argmax at temperature
    0, else categorical over logits/temperature truncated to the ``top_k``
    best and/or the ``top_p`` nucleus (the first token always kept)."""
    if temperature <= 0.0:
        return torch.argmax(nxt_logits, dim=-1)
    logits = nxt_logits.float() / temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits >= kth, logits, neg_inf)
    if top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep_sorted = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(keep_sorted, sorted_logits,
                             torch.tensor(float("inf"),
                                          device=logits.device)
                             ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= cutoff, logits, neg_inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _refuse_wo_tree(effective_mode: str, model) -> None:
    """Raise when a wo-quantized model meets any decode mode but
    'int8_wo' (the dynamic-int8 program cannot be built without the fp
    weights, and a plain read of the int8 kernels would be garbage)."""
    if effective_mode != "int8_wo" and params_are_wo_quantized(model):
        raise ValueError(
            "model holds wo-quantized (int8 kernel + kernel_scale) dense "
            f"layers but the decode mode is {effective_mode!r}; pass "
            "quant='int8_wo' for a pre-quantized model, or keep the fp one.")


def _with_dense_mode(model, quant: str):
    """A copy of ``model``'s module tree whose dense layers run ``quant``,
    sharing every parameter and buffer with ``model`` (the reference's
    ``model.clone(quant=...)`` over the same param tree): neither the
    caller's model is changed nor a weight copied."""
    shared = {id(t): t for t in itertools.chain(model.parameters(),
                                                model.buffers())}
    clone = copy.deepcopy(model, memo=shared)
    for m in clone.modules():
        if isinstance(m, QuantDense) or _is_moe_mlp(m):
            m.mode = quant
    clone.quant = quant
    return clone


def _is_moe_mlp(m) -> bool:
    from tpu_dist_torch.models.moe import MoEMLP

    return isinstance(m, MoEMLP)


def _quantize_for_decode(model, quant: str):
    """The model to decode ``quant`` with. ``int8`` returns a view of the
    model (shared parameters) whose dense layers run the fused int8 kernel.
    ``int8_wo`` returns a copy whose dense kernels are int8 with fp32
    per-channel scales (weight bytes halve against bf16); the copy is
    memoized in a small LRU keyed on the model's identity and its
    parameters' in-place versions, holding only a weakref to the model, so
    a serving process never re-quantizes a live model and never pins a
    dead one."""
    validate_quant(quant)
    if quant == "none":
        # the model's own mode decides what its layers may hold
        _refuse_wo_tree(getattr(model, "quant", "none"), model)
        return model
    _refuse_wo_tree(quant, model)
    if quant == "int8":
        if getattr(model, "quant", "none") == "int8":
            return model
        return _with_dense_mode(model, quant)
    if params_are_wo_quantized(model):
        return model
    key = (id(model), quant,
           tuple(p._version for p in model.parameters()))
    with _wo_memo_lock:
        hit = _wo_memo.get(key)
        if hit is not None and hit[0]() is model:
            _wo_memo.move_to_end(key)
            return hit[1]
    qmodel = copy.deepcopy(model)
    with torch.no_grad():
        for m in qmodel.modules():
            if hasattr(m, "load_quantized"):
                q, s = quantize_int8(m.kernel, (0,))
                m.load_quantized(q, s)
            elif _is_moe_mlp(m):
                # experts read through their int8 round trip (amax over
                # the contracted dim), the reference's pre-quantized
                # experts' values; the router gate stays fp
                m.mode = quant
    qmodel.quant = quant

    def _evict(_ref, _key=key):
        with _wo_memo_lock:
            _wo_memo.pop(_key, None)

    evicted = []
    with _wo_memo_lock:
        _wo_memo[key] = (weakref.ref(model, _evict), qmodel)
        _wo_memo.move_to_end(key)
        while len(_wo_memo) > _WO_MEMO_MAX:
            evicted.append(_wo_memo.popitem(last=False))
    del evicted  # destroyed outside the lock (see the reference's note)
    return qmodel


_WO_MEMO_MAX = 4
_wo_memo: "OrderedDict" = OrderedDict()
# RLock: gc may run a weakref _evict on the thread already holding it
_wo_memo_lock = threading.RLock()


def prepare_draft(base_model, draft_model, quant: str):
    """Validate a speculative-decoding draft against its base and give it
    the base's quant mode (``engine.serve`` calls this once at engine
    construction). The draft proposes token ids the base verifies, so the
    vocabularies must be one space; it must sit at every position the base
    serves. Depth, width and heads are free to differ."""
    if getattr(draft_model, "vocab_size", None) != base_model.vocab_size:
        raise ValueError(
            f"draft vocab_size={getattr(draft_model, 'vocab_size', None)} "
            f"!= base vocab_size={base_model.vocab_size}: speculative "
            "verification compares token ids, so the vocabularies must "
            "be the same space")
    if draft_model.max_len < base_model.max_len:
        raise ValueError(
            f"draft max_len={draft_model.max_len} < base "
            f"max_len={base_model.max_len}: the draft must be able to "
            "sit at every position the base serves")
    return _quantize_for_decode(draft_model, quant)


def _new_caches(model, b: int, total: int):
    head_dim = model.d_model // model.num_heads
    tp = model.tp.size if getattr(model, "tp", None) is not None else 1
    shape = (b, total, model.num_heads // tp, head_dim)
    return [{"k": torch.zeros(shape, dtype=model.dtype, device=model.device),
             "v": torch.zeros(shape, dtype=model.dtype, device=model.device),
             "index": 0} for _ in range(model.num_layers)]


def _shard_decode_model(model, mesh, b: int):
    """(the decode model laid out over ``mesh``, the data axis the batch
    shards over or None): a copy of ``model`` whose weights take the
    training layout (module docstring), the caller's model untouched."""
    from tpu_dist_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                              MODEL_AXIS, shard_leaf)
    from tpu_dist_torch.parallel.tp import _spec_for, fused_of, shard_params_

    data, tp, ep = (mesh.axis(a) for a in (DATA_AXIS, MODEL_AXIS,
                                           EXPERT_AXIS))
    data = data if data.size > 1 and b % data.size == 0 else None
    experts = getattr(model, "num_experts", 0)
    ep = ep if experts and ep.size > 1 else None
    tp = tp if tp.size > 1 else None
    if tp is not None and model.num_heads % tp.size:
        raise ValueError(f"TP decode shards attention heads: num_heads="
                         f"{model.num_heads} must divide by mesh 'model' "
                         f"size {tp.size}")
    if tp is not None and model.vocab_size % tp.size:
        raise ValueError(f"TP decode shards the vocab: vocab_size="
                         f"{model.vocab_size} must divide by mesh 'model' "
                         f"size {tp.size}")
    if ep is not None and experts % ep.size:
        raise ValueError(f"EP decode shards experts: num_experts={experts} "
                         f"must divide by mesh 'expert' size {ep.size}")
    if tp is None and ep is None:
        return model, data
    # the copy shares every tensor: the layout replaces what it shards
    shared = {id(t): t for t in itertools.chain(model.parameters(),
                                                model.buffers())}
    model = copy.deepcopy(model, memo=shared)
    if ep is not None:
        from tpu_dist_torch.parallel.ep import ep_param_specs

        specs = ep_param_specs(
            ((n, t.shape) for n, t in model.named_parameters()),
            EXPERT_AXIS, MODEL_AXIS if tp is not None else None)
    else:
        from tpu_dist_torch.parallel.tp import lm_param_specs

        specs = lm_param_specs((n, t.shape)
                               for n, t in model.named_parameters())
    shard_params_(model, specs, mesh)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if not (isinstance(mod, QuantDense) and mod.prequantized):
                continue
            # a wo-quantized layer: its int8 kernel and (1, out) scales
            spec = _spec_for(f"{name}.kernel", mod.kernel.shape)
            fused = fused_of(name)
            mod.kernel = shard_leaf(mod.kernel, spec, mesh, fused)
            if spec[1] == MODEL_AXIS:
                mod.kernel_scale = shard_leaf(mod.kernel_scale,
                                              (None, MODEL_AXIS), mesh, fused)
    if ep is not None:
        model.set_ep(ep)
    if tp is not None:
        model.set_tp(tp)
    return model, data


def _gather_vocab(logits, tp):
    """The whole vocab's logits from this rank's shard (sampling)."""
    from tpu_dist_torch.parallel.collectives import all_gather

    return torch.cat(all_gather(logits.contiguous(), tp.group).unbind(0), -1)


def _greedy_over_shards(logits, tp):
    """Argmax token ids (B,) across vocab shards (B, V/M): each shard's
    max and first index gathered, the first maximum of the whole vocab."""
    from tpu_dist_torch.parallel.collectives import all_gather

    x = logits.float()
    mx, arg = x.max(dim=-1)
    both = all_gather(torch.stack([mx, (arg + tp.index * x.shape[-1])
                                   .float()]), tp.group)       # (M, 2, B)
    top = both[:, 0].amax(dim=0)
    cand = torch.where(both[:, 0] == top, both[:, 1],
                       torch.full_like(both[:, 1], float("inf")))
    return cand.amin(dim=0).long()


def generate(model, prompt, steps: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             use_cache: bool = False, top_k: int = 0, top_p: float = 0.0,
             quant: str = "none", ledger=None, mesh=None) -> torch.Tensor:
    """Continue ``prompt`` (B, P) by ``steps`` tokens on the model's
    device; returns the (B, P + steps) int32 buffer. Temperature 0 is
    greedy; above 0, draws come from ``generator`` (on the model's
    device). ``quant`` decodes through quantized matmuls (``int8`` or
    ``int8_wo``). ``mesh`` (a ``parallel.mesh.Mesh``; every rank calls)
    decodes sharded over it (module docstring).
    ``ledger`` records the call as one ``decode`` event."""
    prompt = torch.as_tensor(prompt, dtype=torch.int32).to(model.device)
    b, p = prompt.shape
    if steps <= 0:
        return prompt
    model = _quantize_for_decode(model, quant)
    data = None
    if mesh is not None:
        model, data = _shard_decode_model(model, mesh, b)
        if data is not None:
            prompt = prompt.narrow(0, data.index * (b // data.size),
                                   b // data.size)
            b = prompt.shape[0]
    tp = model.tp if getattr(model, "tp", None) is not None \
        and model.tp.size > 1 else None

    def pick(logits):
        if tp is None:
            return _sample(logits, temperature, generator, top_k, top_p)
        if temperature <= 0.0:
            return _greedy_over_shards(logits, tp)
        return _sample(_gather_vocab(logits, tp), temperature, generator,
                       top_k, top_p)

    total = p + steps
    buf = torch.zeros((b, total), dtype=torch.int32, device=model.device)
    buf[:, :p] = prompt
    t0 = time.perf_counter()
    with torch.inference_mode():
        if use_cache:
            caches = _new_caches(model, b, total)
            logits = model(buf[:, :p], pos_offset=0, caches=caches)
            buf[:, p] = pick(logits[:, -1]).to(torch.int32)
            for pos in range(p, total - 1):
                logits = model(buf[:, pos:pos + 1], pos_offset=pos,
                               caches=caches)
                buf[:, pos + 1] = pick(logits[:, 0]).to(torch.int32)
        else:
            for pos in range(p - 1, total - 1):
                logits = model(buf)
                buf[:, pos + 1] = pick(logits[:, pos]).to(torch.int32)
        if data is not None:          # every data shard's rows, in order
            from tpu_dist_torch.parallel.collectives import all_gather

            buf = torch.cat(all_gather(buf, data.group).unbind(0), 0)
            b = buf.shape[0]
    if ledger is None:
        return buf
    dispatch_s = time.perf_counter() - t0
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    total_s = time.perf_counter() - t0
    tokens = b * steps
    ledger.emit("decode", tokens=tokens, seconds=round(total_s, 6),
                throughput=round(tokens / max(total_s, 1e-9), 1),
                dispatch_s=round(dispatch_s, 6),
                device_s=round(total_s - dispatch_s, 6),
                cached=use_cache, batch=b, prompt_len=p, steps=steps,
                quant=quant)
    return buf
