"""Carry params between a flax tree and the port's models.

* ``TransformerLM``: :func:`load_flax_params` loads a tree,
  :func:`export_flax_params` writes the port's params back out as one (so
  trained params compare with the reference's leaf by leaf);
* the image models (``models/{resnet,lenet,cnn_zoo,inception,mobile,
  vit}.py``):
  :func:`load_flax_image_params` and :func:`export_flax_image_params` do
  the same for a ``(params, batch_stats)`` pair (table at the bottom).

The tree is the reference's nested dict (``model.init(...)["params"]``),
with leaves anything ``numpy.asarray`` takes -- so this module needs no
JAX. Both fp trees and ``wo_quantize_params`` trees load, and the MoE LM's
blocks carry ``moe.{gate.kernel, w_in, w_out}`` under the same names.
:func:`flax_named_leaves` maps a tree's leaves to the port's param and
buffer names without requiring every leaf (a warm start's graft matches
them by name and shape):

=====================================  ===================================
flax path                              port
=====================================  ===================================
``tok_emb.embedding``                  ``tok_emb.weight``
``pos_emb.embedding``                  ``pos_emb.weight``
``block{i}.{ln1,ln2}.{scale,bias}``    ``blocks.{i}.{ln1,ln2}.{scale,bias}``
``block{i}.{qkv,proj}.kernel``         ``blocks.{i}.{qkv,proj}.kernel``
``block{i}.{mlp_in,mlp_out}.*``        ``blocks.{i}.{mlp_in,mlp_out}.*``
``ln_f.{scale,bias}``                  ``ln_f.{scale,bias}``
``lm_head.kernel``                     ``lm_head.kernel``
``*.kernel`` + ``*.kernel_scale``      int8 kernel + fp32 scale buffers
=====================================  ===================================

Dense kernels keep flax's (in, out) layout: no transposes anywhere. fp
leaves are cast to the model's dtype (what flax does at every call).

Pipeline trees: the reference's pp state is stage-stacked
(``tpu_dist/parallel/pp.py:65 stack_pipeline_params``: ``{"embed_head":
{tok_emb, pos_emb, ln_f, lm_head}, "blocks": leaves (S, N/S, ...)}``).
:func:`pp_stage_tree` gives rank s's stage tree from it (the embedding
and head, and the stage's blocks as ``block0 ..``), which
:func:`load_flax_params` loads into that rank's stage model
(``parallel.pp.lay_out_stage_``); :func:`pp_stack_trees` puts the stage
trees back into the stacked layout, and :func:`pp_unstack_tree` turns a
stacked tree into the whole model's.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_dist_torch.ops.quant import QuantDense

_DENSE = ("qkv", "proj", "mlp_in", "mlp_out")


def _copy(dst: torch.Tensor, src, path: str) -> None:
    arr = torch.from_numpy(np.array(src, copy=True))
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{path}: shape {tuple(arr.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(arr.to(device=dst.device, dtype=dst.dtype))


def _load_dense(dense: QuantDense, node: dict, path: str) -> None:
    expect = {"kernel"} | ({"bias"} if dense.bias is not None else set())
    if "kernel_scale" in node:
        expect.add("kernel_scale")
    if set(node) != expect:
        raise ValueError(f"{path}: leaves {sorted(node)}, expected "
                         f"{sorted(expect)}")
    if "kernel_scale" in node:
        dense.load_quantized(
            torch.from_numpy(np.array(node["kernel"], np.int8, copy=True)),
            torch.from_numpy(np.array(node["kernel_scale"], np.float32,
                                      copy=True)))
    else:
        _copy(dense.kernel, node["kernel"], path + ".kernel")
    if dense.bias is not None:
        _copy(dense.bias, node["bias"], path + ".bias")


def _load_norm(norm, node: dict, path: str) -> None:
    if set(node) != {"scale", "bias"}:
        raise ValueError(f"{path}: leaves {sorted(node)}")
    _copy(norm.scale, node["scale"], path + ".scale")
    _copy(norm.bias, node["bias"], path + ".bias")


_MOE = {"gate", "w_in", "w_out"}


def _load_moe(moe, node: dict, path: str) -> None:
    if set(node) != _MOE or set(node["gate"]) != {"kernel"}:
        raise ValueError(f"{path}: leaves {sorted(node)}, expected "
                         f"{sorted(_MOE)} with gate.kernel")
    _copy(moe.gate.kernel, node["gate"]["kernel"], path + ".gate.kernel")
    _copy(moe.w_in, node["w_in"], path + ".w_in")
    _copy(moe.w_out, node["w_out"], path + ".w_out")


def load_flax_params(model, params: dict):
    """Copy a flax TransformerLM (or MoETransformerLM) tree into ``model``
    (a port model of the same geometry); returns ``model``. Missing or
    extra leaves raise."""
    blocks = {f"block{i}" for i in range(len(model.blocks))}
    expect = {"tok_emb", "pos_emb", "ln_f", "lm_head"} | blocks
    if set(params) != expect:
        raise ValueError(f"param tree keys {sorted(params)}, expected "
                         f"{sorted(expect)}")
    with torch.no_grad():
        for name in ("tok_emb", "pos_emb"):
            if set(params[name]) != {"embedding"}:
                raise ValueError(f"{name}: leaves {sorted(params[name])}")
            _copy(getattr(model, name).weight, params[name]["embedding"],
                  name + ".embedding")
        for i, blk in enumerate(model.blocks):
            node = params[f"block{i}"]
            moe = hasattr(blk, "moe")
            dense = ("qkv", "proj") if moe else _DENSE
            if set(node) != {"ln1", "ln2", *dense, *(("moe",) if moe
                                                     else ())}:
                raise ValueError(f"block{i}: children {sorted(node)}")
            _load_norm(blk.ln1, node["ln1"], f"block{i}.ln1")
            _load_norm(blk.ln2, node["ln2"], f"block{i}.ln2")
            for name in dense:
                _load_dense(getattr(blk, name), node[name],
                            f"block{i}.{name}")
            if moe:
                _load_moe(blk.moe, node["moe"], f"block{i}.moe")
        _load_norm(model.ln_f, params["ln_f"], "ln_f")
        _load_dense(model.lm_head, params["lm_head"], "lm_head")
    return model


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def export_flax_params(model) -> dict:
    """The port model's params as a flax-layout tree of numpy arrays (the
    inverse of :func:`load_flax_params`; bf16 leaves come out as fp32,
    which holds them exactly). Pre-quantized kernels export as their int8
    values with the ``kernel_scale`` beside them."""
    def dense(m: QuantDense) -> dict:
        node = {"kernel": _np(m.kernel)}
        if m.kernel_scale is not None:
            node["kernel_scale"] = _np(m.kernel_scale)
        if m.bias is not None:
            node["bias"] = _np(m.bias)
        return node

    def norm(m) -> dict:
        return {"scale": _np(m.scale), "bias": _np(m.bias)}

    tree = {"tok_emb": {"embedding": _np(model.tok_emb.weight)},
            "pos_emb": {"embedding": _np(model.pos_emb.weight)},
            "ln_f": norm(model.ln_f), "lm_head": dense(model.lm_head)}
    for i, blk in enumerate(model.blocks):
        if hasattr(blk, "moe"):
            tree[f"block{i}"] = {
                "ln1": norm(blk.ln1), "ln2": norm(blk.ln2),
                "qkv": dense(blk.qkv), "proj": dense(blk.proj),
                "moe": {"gate": {"kernel": _np(blk.moe.gate.kernel)},
                        "w_in": _np(blk.moe.w_in),
                        "w_out": _np(blk.moe.w_out)}}
            continue
        tree[f"block{i}"] = {"ln1": norm(blk.ln1), "ln2": norm(blk.ln2),
                             **{n: dense(getattr(blk, n)) for n in _DENSE}}
    return tree


# ---- leaf names for a warm start --------------------------------------------

def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(
        np.array(x, copy=True))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _lm_name(path) -> str:
    head, rest = path[0], path[1:]
    if head in ("tok_emb", "pos_emb") and rest == ("embedding",):
        return f"{head}.weight"
    if head.startswith("block") and head[5:].isdigit():
        return ".".join(("blocks", head[5:]) + rest)
    return ".".join(path)


def flax_named_leaves(model, params: dict, batch_stats=None):
    """({port param name: tensor}, {port buffer name: tensor}) of a flax
    tree for ``model`` (the LM families or any image model): the LM's
    ``tok_emb.embedding`` -> ``tok_emb.weight`` and ``block{i}`` ->
    ``blocks.{i}``; an image model's leaves by its module tree (the table
    above, conv kernels HWIO -> OIHW). Leaves the model lacks are left out;
    nothing is copied into the model."""
    from tpu_dist_torch.models.transformer import TransformerLM

    if isinstance(model, TransformerLM):
        return {_lm_name(p): _as_tensor(v)
                for p, v in _flat(params)}, {}
    from tpu_dist_torch.models.resnet import Conv

    out_p, out_s = {}, {}

    def join(path, name):
        return f"{path}.{name}" if path else name

    def walk(mod, pnode, snode, path):
        leaves = _image_leaves(mod)
        if leaves is not None:
            p, st = leaves
            own = {id(t): n for n, t in mod.named_parameters(recurse=False)}
            own.update({id(t): n for n, t in mod.named_buffers(
                recurse=False)})
            for k, t in p.items():
                if k in pnode:
                    src = _as_tensor(pnode[k])
                    if isinstance(mod, Conv) and k == "kernel":
                        src = src.permute(3, 2, 0, 1).contiguous()
                    out_p[join(path, own[id(t)])] = src
            for k, t in st.items():
                if snode and k in snode:
                    out_s[join(path, own[id(t)])] = _as_tensor(snode[k])
            return
        for name, _ in mod.named_parameters(recurse=False):
            if name in pnode and not isinstance(pnode[name], dict):
                out_p[join(path, name)] = _as_tensor(pnode[name])
        for name, kid in mod.named_children():
            if isinstance(pnode.get(name), dict):
                walk(kid, pnode[name], (snode or {}).get(name),
                     join(path, name))

    walk(model, params, batch_stats or {}, "")
    return out_p, out_s


# ---- image models ----------------------------------------------------------
#
# The port's image modules carry flax's names, so the trees map name for
# name: ``conv1``, ``bn1``, ``layer{i}_block{j}`` / ``Conv_k``,
# ``BatchNorm_k`` or ``GroupNorm_k``, ``downsample_conv``, ``downsample_bn``,
# ``fc``; LeNet's ``conv1``, ``conv2``, ``fc1``, ``fc2``; the zoo's
# (``models/{cnn_zoo,inception,mobile}.py``) names of each plan, SE blocks'
# ``fc1``/``fc2`` included; the ViT's ``patch_embed``, ``block{i}`` (``ln1``,
# ``qkv``, ``proj``, ``ln2``, ``mlp_in``, ``mlp_out``), ``ln_f``, ``head``
# and its own ``cls`` and ``pos_embed`` params. Per leaf:
#
# ===========================  =============================================
# flax                          port
# ===========================  =============================================
# Conv ``kernel`` (kh,kw,i/g,o) ``Conv.weight`` (o, i/g, kh, kw); ``bias``
# Dense ``kernel`` (in, out)    ``QuantDense.kernel`` (in, out); ``bias``
# BatchNorm ``scale``/``bias``  ``BatchNorm.scale``/``bias`` (params)
# batch_stats ``mean``/``var``  ``BatchNorm.mean``/``var`` (buffers)
# GroupNorm, LayerNorm          ``scale``/``bias``
# a module's own param          the ``nn.Parameter`` of that name
# ===========================  =============================================
#
# Grouped and depthwise convs need nothing more: flax's HWIO kernel holds
# in/groups input channels, as torch's OIHW weight does.


def _image_leaves(mod):
    """(params leaves, batch_stats leaves) of one port leaf module as
    {name: tensor} dicts, or None for a container."""
    from tpu_dist_torch.models.resnet import BatchNorm, Conv, GroupNorm
    from tpu_dist_torch.models.transformer import LayerNorm

    if isinstance(mod, Conv):
        p = {"kernel": mod.weight}
        return ({**p, "bias": mod.bias} if mod.bias is not None else p), {}
    if isinstance(mod, QuantDense):
        p = {"kernel": mod.kernel}
        return ({**p, "bias": mod.bias} if mod.bias is not None else p), {}
    if isinstance(mod, BatchNorm):
        return ({"scale": mod.scale, "bias": mod.bias},
                {"mean": mod.mean, "var": mod.var})
    if isinstance(mod, (GroupNorm, LayerNorm)):
        return {"scale": mod.scale, "bias": mod.bias}, {}
    return None


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))


def load_flax_image_params(model, params: dict, batch_stats=None):
    """Copy a flax image-model tree (``variables["params"]`` and
    ``variables["batch_stats"]``) into a port image model (any arch of
    ``models.registry``) of the same geometry; returns ``model``. Missing or extra leaves raise; fp leaves
    are cast to the port's storage dtype."""
    from tpu_dist_torch.models.resnet import Conv

    def walk(mod, pnode, snode, path):
        leaves = _image_leaves(mod)
        if leaves is not None:
            p, st = leaves
            if set(pnode) != set(p) or set(snode or {}) != set(st):
                raise ValueError(f"{path}: leaves {sorted(pnode)} / "
                                 f"{sorted(snode or {})}, expected "
                                 f"{sorted(p)} / {sorted(st)}")
            for k, t in {**p, **st}.items():
                src = pnode[k] if k in p else snode[k]
                if isinstance(mod, Conv) and k == "kernel":
                    src = _hwio_to_oihw(np.asarray(src))
                _copy(t, src, f"{path}.{k}")
            return
        kids = dict(mod.named_children())
        own = dict(mod.named_parameters(recurse=False))
        if set(pnode) != set(kids) | set(own):
            raise ValueError(f"{path or 'params'}: children {sorted(pnode)}, "
                             f"expected {sorted({**kids, **own})}")
        for name, t in own.items():
            _copy(t, pnode[name], f"{path}.{name}" if path else name)
        for name, kid in kids.items():
            walk(kid, pnode[name], (snode or {}).get(name),
                 f"{path}.{name}" if path else name)

    with torch.no_grad():
        walk(model, params, batch_stats or {}, "")
    return model


def export_flax_image_params(model):
    """``(params, batch_stats)`` of a port image model as flax-layout trees
    of numpy arrays (the inverse of :func:`load_flax_image_params`; bf16
    leaves come out as fp32, which holds them exactly)."""
    from tpu_dist_torch.models.resnet import Conv

    def walk(mod):
        leaves = _image_leaves(mod)
        if leaves is not None:
            p, st = leaves
            out = {k: _np(t) for k, t in p.items()}
            if isinstance(mod, Conv):
                out["kernel"] = np.ascontiguousarray(
                    np.transpose(out["kernel"], (2, 3, 1, 0)))
            return out, {k: _np(t) for k, t in st.items()}
        params = {n: _np(t) for n, t in mod.named_parameters(recurse=False)}
        stats = {}
        for name, kid in mod.named_children():
            params[name], s = walk(kid)
            if s:
                stats[name] = s
        return params, stats

    return walk(model)


# ---- pipeline (stage-stacked) trees --------------------------------------

def _map_tree(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map_tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def pp_stage_tree(tree: dict, stage: int) -> dict:
    """Rank ``stage``'s flax tree of a stage-stacked one: the embedding
    and head leaves, and ``block{j}`` = the stage's j-th block."""
    blocks = tree["blocks"]
    leaf = next(iter(_flat(blocks)))[1]
    per = np.asarray(leaf).shape[1]
    out = {k: v for k, v in tree["embed_head"].items()}
    for j in range(per):
        out[f"block{j}"] = _map_tree(
            lambda a, j=j: np.asarray(a)[stage, j], blocks)
    return out


def pp_stack_trees(stage_trees) -> dict:
    """The stage-stacked tree of every stage's tree (inverse of
    :func:`pp_stage_tree` over the stages; the embedding and head from
    stage 0's)."""
    first = stage_trees[0]
    per = sum(1 for k in first if k.startswith("block"))
    stacked = [_map_tree(lambda *a: np.stack([np.asarray(x) for x in a]),
                         *(t[f"block{j}"] for j in range(per)))
               for t in stage_trees]
    return {"embed_head": {k: v for k, v in first.items()
                           if not k.startswith("block")},
            "blocks": _map_tree(lambda *a: np.stack(a), *stacked)}


def pp_unstack_tree(tree: dict) -> dict:
    """The whole model's flax tree of a stage-stacked one (the
    reference's ``unstack_pipeline_params``)."""
    leaf = np.asarray(next(iter(_flat(tree["blocks"])))[1])
    n_stages, per = leaf.shape[:2]
    out = dict(tree["embed_head"])
    for s in range(n_stages):
        for j, (k, v) in enumerate(pp_stage_tree(tree, s).items()):
            if k.startswith("block"):
                out[f"block{s * per + int(k[5:])}"] = v
    return out
