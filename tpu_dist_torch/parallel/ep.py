"""Expert parallelism for the port (``tpu_dist/parallel/ep.py``).

The rules of the reference (``_moe_leaf_spec``, ``:20-39``): the MoE
expert weights ``w_in`` and ``w_out`` (E, ., .) shard their experts dim
over ``expert``; with a ``model`` axis as well, ``w_in`` is
column-parallel and ``w_out`` row-parallel on the hidden dim f, and the
attention ``qkv``/``proj`` and the ``lm_head`` follow the tensor-parallel
rules. The gate stays replicated (its output feeds the routing argmax),
and so does every other leaf.

In the reference's layout no all-to-all is needed: the batch is sharded
over ``data`` only (``tpu_dist/engine/lm_loop.py:561-588``), so every rank
of an ``expert`` group holds the same tokens. Each rank routes them all,
runs its E/M experts over them, and the combine sums over the expert group
(``models.moe.MoEMLP``): the MoE input and the combine weights enter the
local experts through Megatron's ``f`` over ``expert`` (their gradients,
each rank's in part, are summed there, and so reach the gate and every
replicated leaf upstream whole), and the combined output leaves through
``g``. The expert leaves' gradients are then averaged over ``data`` only,
as every other leaf's. All of it is all-reduce, which gloo runs on CUDA
tensors, so expert parallelism runs as two ranks sharing one card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from tpu_dist_torch.parallel.mesh import EXPERT_AXIS, MODEL_AXIS

_NAMES = ("w_in", "w_out", "qkv", "proj", "lm_head")


def _moe_leaf_spec(key: str, ndim: int, axis: str,
                   model_axis: Optional[str]) -> Tuple:
    if key in ("w_in", "w_out") and ndim == 3:
        if model_axis is None:
            return (axis, None, None)
        return ((axis, None, model_axis) if key == "w_in"
                else (axis, model_axis, None))
    if model_axis is not None and ndim == 2:
        if key in ("qkv", "lm_head"):
            return (None, model_axis)
        if key == "proj":
            return (model_axis, None)
    return (None,) * ndim


def ep_param_specs(named_shapes, axis: str = EXPERT_AXIS,
                   model_axis: Optional[str] = None) -> Dict[str, Tuple]:
    """{leaf name: spec} for an MoE LM's (name, shape) pairs
    (``ep_param_specs``); ``model_axis`` set gives the MoE x tensor
    parallel composition."""
    out = {}
    for name, shape in named_shapes:
        parts = name.split(".")
        if parts[-1].endswith("_scale"):
            out[name] = (None,) * len(shape)
            continue
        key = next((p for p in reversed(parts) if p in _NAMES), "")
        out[name] = _moe_leaf_spec(key, len(shape), axis, model_axis)
    return out


def shard_moe_(model, mesh):
    """Lay ``model`` (an MoE LM with whole params) out over ``mesh``'s
    expert axis (and its model axis, where it has one of size > 1);
    returns the specs used."""
    from tpu_dist_torch.parallel.tp import shard_params_

    ep, tp = mesh.axis(EXPERT_AXIS), mesh.axis(MODEL_AXIS)
    if model.num_experts % ep.size:
        raise ValueError(f"num_experts {model.num_experts} must divide by "
                         f"the expert axis ({ep.size})")
    if tp.size > 1 and (model.num_heads % tp.size
                        or model.vocab_size % tp.size):
        raise ValueError(f"MoE x tensor parallelism shards heads and the "
                         f"vocab: num_heads {model.num_heads} and vocab_size "
                         f"{model.vocab_size} must divide by the model axis "
                         f"({tp.size})")
    specs = ep_param_specs(((n, p.shape) for n, p in model.named_parameters()),
                           EXPERT_AXIS, MODEL_AXIS if tp.size > 1 else None)
    shard_params_(model, specs, mesh)
    model.set_ep(ep)
    if tp.size > 1:
        model.set_tp(tp)
    return specs
