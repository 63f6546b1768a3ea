"""FSDP / ZeRO-3 sharding over the data axis for the port
(``tpu_dist/parallel/fsdp.py``).

The reference makes FSDP a placement: every sizeable leaf (and its
optimizer state) sharded along one dim over ``data``, GSPMD inserting the
all-gathers and reduce-scatters. The port writes those out:

* :func:`fsdp_specs` is the reference's rule (``_leaf_spec``, ``:24-35``):
  the largest dim divisible by the axis size, the earliest on ties;
  leaves under ``min_size`` elements (and scalars) stay replicated. It
  decides the params and the optimizer state alike, since both follow the
  param's shape;
* the train state holds this rank's shard of each leaf
  (:func:`shard_leaves`), and the model's own params are emptied;
* a step gathers each leaf before use (:func:`gathered`: an all-gather
  whose backward is a reduce-scatter of the leaf's gradient, summed over
  the axis) and runs the model on the gathered leaves
  (:func:`swapped_params`); :func:`sync_grads` then sums the replicated
  leaves' gradients over the axis and divides every gradient by its size,
  so the result is the data-parallel mean, shard by shard;
* the optimizer (``fused_adamw``'s kernel included) steps the shards; the
  clip's global norm sums the shards' squares over the axis, each
  replicated leaf once (``engine.lm_steps.sharded_sq_norm``).

Checkpoints stay layout-free, as the reference's ``gather_to_host``
(``tpu_dist/engine/checkpoint.py:44-70``) makes them: rank 0 writes whole
leaves after a gather, and a resume slices them again, so a dp checkpoint
resumes under fsdp and the reverse.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch

from tpu_dist_torch.parallel.collectives import gather_along, psum
from tpu_dist_torch.parallel.mesh import DATA_AXIS, shard_leaf


def _leaf_spec(shape, axis_size: int, axis: str, min_size: int) -> Tuple:
    n = 1
    for d in shape:
        n *= d
    if not shape or n < min_size:
        return (None,) * len(shape)
    best = None
    for i, d in enumerate(shape):
        if d % axis_size == 0 and (best is None or d > shape[best]):
            best = i
    if best is None:
        return (None,) * len(shape)
    return tuple(axis if i == best else None for i in range(len(shape)))


def fsdp_specs(named_shapes, axis_size: int, axis: str = DATA_AXIS,
               min_size: int = 1024) -> Dict[str, Tuple]:
    """{leaf name: spec} for (name, shape) pairs (shape-driven, so the
    optimizer state shards as its param does)."""
    return {name: _leaf_spec(tuple(shape), axis_size, axis, min_size)
            for name, shape in named_shapes}


def sharded_dim(spec: Tuple):
    return next((i for i, a in enumerate(spec) if a), None)


def shard_leaves(model, specs: Dict[str, Tuple], mesh
                 ) -> Tuple[List[str], List[torch.nn.Parameter]]:
    """(names, this rank's shard of each param) as new leaves that need a
    gradient; the model's own params are emptied (their storage freed),
    so only the shards stay resident."""
    names, shards = [], []
    with torch.no_grad():
        for name, p in model.named_parameters():
            names.append(name)
            shards.append(torch.nn.Parameter(
                shard_leaf(p.data, specs[name], mesh).clone()))
            p.data = p.data.new_empty(0)
    return names, shards


def gathered(shard: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """The whole leaf from every rank's ``shard`` (autograd: the gradient
    is reduce-scattered back, summed over the axis)."""
    dim = sharded_dim(spec)
    if dim is None:
        return shard
    return gather_along(shard, dim, mesh.group(spec[dim]))


@contextmanager
def swapped_params(model, names: List[str], tensors: List[torch.Tensor]):
    """Run ``model`` on ``tensors`` in place of its params of ``names``
    (what ``torch.func.functional_call`` does, kept open so that code
    outside the forward, such as the chunked head, reads them too)."""
    saved = []
    for name, t in zip(names, tensors):
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        saved.append((mod, leaf, mod._parameters[leaf]))
        mod._parameters[leaf] = t
    try:
        yield model
    finally:
        for mod, leaf, p in saved:
            mod._parameters[leaf] = p


def sync_grads(grads: List[torch.Tensor], specs: List[Tuple], mesh
               ) -> List[torch.Tensor]:
    """The data-parallel mean of FSDP gradients: the sharded leaves' came
    out of the gather's backward summed over the axis, the replicated ones
    are summed here (one collective); all divide by the axis size."""
    n = mesh.axis(DATA_AXIS).size
    rep = [i for i, s in enumerate(specs) if sharded_dim(s) is None]
    out = list(grads)
    if rep and n > 1:
        flat = torch.cat([grads[i].float().reshape(-1) for i in rep])
        flat = psum(flat, mesh.group(DATA_AXIS))
        off = 0
        for i in rep:
            k = grads[i].numel()
            out[i] = flat[off:off + k].reshape(grads[i].shape).to(
                grads[i].dtype)
            off += k
    return [g / n for g in out]
