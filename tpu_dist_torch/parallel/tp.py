"""Tensor parallelism, Megatron style, for the port
(``tpu_dist/parallel/tp.py``, ``tp_impl="gspmd"``).

The reference declares PartitionSpecs over a ``model`` mesh axis and lets
GSPMD insert the collectives. The port runs one process per device, so it
writes them out: :func:`shard_lm_` keeps each rank's shard of the leaves
the rules shard (``_RULES``, ``:21-27``: ``qkv`` and ``mlp_in``
column-parallel, ``proj`` and ``mlp_out`` row-parallel, ``lm_head`` over a
vocab shard; ``*_scale`` leaves and everything else replicated), and the
blocks (``models.transformer.AttentionBlock.column``/``row``) run
Megatron's ``f`` before each column-parallel product (identity forward,
the input gradient summed over ``model``) and ``g`` after each
row-parallel one (the partial products summed forward). A 1-D bias of a
column-parallel layer stays replicated, as the reference's rule leaves it
(the rules shard only 2-D kernels), and each rank slices its part at use.

``qkv`` is fused as ``[q | k | v]`` (``tpu_dist/models/transformer.py:
139-143``): each rank keeps its heads' columns of q, of k and of v
(``fused=3``), not a contiguous 1/M of the fused axis, so attention runs
over this rank's H/M heads.

The logits are this rank's vocab shard. :func:`vocab_parallel_xent` is the
sharded softmax cross-entropy: the max and the exp-sum all-reduced over
``model`` (the max as a constant, the sums through ``g``, so each rank's
gradient is its shard's softmax minus its shard's one-hot), and the
argmax taken across shards with ``jnp.argmax``'s first-maximum rule (the
shards' maxima and argmaxes travel by all-gather, the one collective
besides the sum that gloo runs on CUDA tensors). With
``loss_chunk > 0`` the step instead gathers the ``lm_head`` kernel (its
backward keeps this rank's slice) and runs the chunked head
(``ops.fused_xent``) whole on every rank: the (B, L, V) logits still never
exist, at the cost of the head's products on every rank.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tpu_dist_torch.parallel.collectives import (all_gather,
                                                 reduce_from_group)
from tpu_dist_torch.parallel.mesh import MODEL_AXIS, shard_leaf

# name-substring -> spec of a 2-D kernel (flax's (in, out) layout)
_RULES = (
    ("qkv", (None, MODEL_AXIS)),       # column-parallel: heads split
    ("proj", (MODEL_AXIS, None)),      # row-parallel: partial sums
    ("mlp_in", (None, MODEL_AXIS)),    # column-parallel
    ("mlp_out", (MODEL_AXIS, None)),   # row-parallel
    ("lm_head", (None, MODEL_AXIS)),   # vocab-sharded logits
)
# the fused projections and their segment counts
FUSED = {"qkv": 3}


def _spec_for(name: str, shape) -> Tuple:
    if name.endswith("_scale"):
        return (None,) * len(shape)
    for key, spec in _RULES:
        if key in name and len(shape) == len(spec):
            return spec
    return (None,) * len(shape)


def lm_param_specs(named_shapes) -> Dict[str, Tuple]:
    """{leaf name: spec} for a TransformerLM's (name, shape) pairs, by the
    reference's rules (``lm_param_specs``)."""
    return {name: _spec_for(name, tuple(shape))
            for name, shape in named_shapes}


def fused_of(name: str) -> int:
    return next((n for k, n in FUSED.items() if k in name), 1)


@torch.no_grad()
def shard_params_(model, specs: Dict[str, Tuple], mesh) -> None:
    """Replace each param of ``model`` that ``specs`` shards with this
    rank's shard, in place (a new ``nn.Parameter`` of the local shape)."""
    for name, p in list(model.named_parameters()):
        spec = specs.get(name)
        if spec is None or not any(spec):
            continue
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        local = shard_leaf(p.data, spec, mesh, fused_of(name))
        setattr(mod, leaf, torch.nn.Parameter(local.clone(),
                                              requires_grad=p.requires_grad))


def shard_lm_(model, mesh, specs=None):
    """Lay ``model`` (a dense LM with whole params) out for gspmd tensor
    parallelism over ``mesh``'s model axis; returns the specs used."""
    axis = mesh.axis(MODEL_AXIS)
    if model.num_heads % axis.size:
        raise ValueError(f"tensor parallelism shards heads: num_heads "
                         f"{model.num_heads} must divide by the model axis "
                         f"({axis.size})")
    if model.vocab_size % axis.size:
        raise ValueError(f"the lm_head is vocab-sharded: vocab_size "
                         f"{model.vocab_size} must divide by the model axis "
                         f"({axis.size})")
    if specs is None:
        specs = lm_param_specs((n, p.shape)
                               for n, p in model.named_parameters())
    shard_params_(model, specs, mesh)
    model.set_tp(axis)
    return specs


def vocab_parallel_xent(logits, targets, mask, axis):
    """(loss_sum, correct1) of next-token cross entropy over vocab-sharded
    fp32 logits (B, L, V/M) of ``axis`` (module docstring): nll =
    logsumexp - target logit over the whole vocab, the value the same on
    every rank."""
    group = axis.group
    vl = logits.shape[-1]
    lo = axis.index * vl
    x = logits.float()
    with torch.no_grad():
        # (n, 2, B, L): every shard's maximum and first argmax
        local_max, local_arg = x.max(dim=-1)
        both = all_gather(torch.stack([local_max, (local_arg + lo).float()]),
                          group)
        mx = both[:, 0].amax(dim=0)
    sumexp = reduce_from_group(torch.exp(x - mx[..., None]).sum(-1), group)
    lse = mx + torch.log(sumexp)
    t = targets.long() - lo
    mine = (t >= 0) & (t < vl)
    tgt = x.gather(-1, t.clamp(0, vl - 1)[..., None])[..., 0]
    tgt = reduce_from_group(torch.where(mine, tgt, torch.zeros_like(tgt)),
                            group)
    loss_sum = ((lse - tgt) * mask).sum()
    # the global argmax, first maximum on ties: the smallest index among
    # the shards whose local maximum is the global one (indices below 2^24
    # are exact in fp32)
    with torch.no_grad():
        cand = torch.where(both[:, 0] == mx, both[:, 1],
                           torch.full_like(both[:, 1], float("inf")))
        arg = cand.amin(dim=0)
        correct = ((arg == targets.float()).float() * mask).sum()
    return loss_sum, correct


def gathered_head_kernel(kernel: torch.Tensor, axis) -> torch.Tensor:
    """The whole ``lm_head`` kernel from this rank's vocab shard, for the
    chunked head under tensor parallelism: every rank computes the same
    head from the same features, so the backward keeps this rank's slice
    of the (identical) gradient."""
    return _GatherKeepSlice.apply(kernel, axis.group)


class _GatherKeepSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        from tpu_dist_torch.parallel.collectives import all_gather

        ctx.group = group
        return torch.cat(all_gather(x, group).unbind(0), -1)

    @staticmethod
    def backward(ctx, g):
        from tpu_dist_torch.parallel.collectives import (group_rank,
                                                         group_size)

        n, r = group_size(ctx.group), group_rank(ctx.group)
        return g.chunk(n, -1)[r].contiguous(), None
