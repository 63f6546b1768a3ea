"""Bucketed gradient sync for the port (``tpu_dist/parallel/overlap.py``,
``grad_buckets`` and ``bucketed_grad_sync``).

The gradients are reduced as independent size-targeted bucket
collectives instead of one per tensor: DDP's decomposition (Li et al.,
PyTorch Distributed, section 3.2). Each bucket's collective is issued
with ``async_op=True`` and every bucket is waited for at the end, so the
transfers of successive buckets overlap one another. The ring
collective matmuls of that module (``RingDense``) belong to tensor
parallelism, which is not ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from tpu_dist_torch.parallel.collectives import (_dist, group_size,
                                                 ring_allreduce,
                                                 run_collective, tree_leaves,
                                                 tree_map)

GRAD_BUCKET_MB_DEFAULT = 25.0  # DDP's fusion-buffer default
IMPLS = ("rs_ag", "ring", "psum")


def grad_buckets(leaves: Sequence[torch.Tensor],
                 bucket_bytes: float) -> List[List[int]]:
    """Group consecutive leaf indices so each bucket targets
    ``bucket_bytes``: a bucket closes when the next leaf would overflow it
    or changes the dtype (buckets concatenate flat), and an oversized leaf
    gets a bucket of its own."""
    groups: List[List[int]] = []
    cur: List[int] = []
    size = 0
    for i, leaf in enumerate(leaves):
        b = leaf.numel() * leaf.element_size()
        if cur and (size + b > bucket_bytes
                    or leaf.dtype != leaves[cur[-1]].dtype):
            groups.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += b
    if cur:
        groups.append(cur)
    return groups


def _reduce_scatter(shard, flat, group):
    import torch.distributed as dist

    # the *_single names replace the *_tensor ones in newer torch releases
    scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    return run_collective("reduce_scatter_tensor", lambda: scatter(
        shard, flat, group=group, async_op=True), flat, group)


def _all_gather(out, shard, group):
    import torch.distributed as dist

    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    return run_collective("all_gather_into_tensor", lambda: gather(
        out, shard, group=group, async_op=True), shard, group)


def bucketed_grad_sync(tree, bucket_mb: float = GRAD_BUCKET_MB_DEFAULT,
                       mean: bool = True, impl: str = "rs_ag", group=None):
    """Cross-replica gradient sum (``mean``: divided by the group size) as
    one collective per bucket of about ``bucket_mb`` MB. Each bucket is
    flattened, padded to a multiple of the group size and reduced by
    ``reduce_scatter_tensor`` then ``all_gather_into_tensor``
    (``impl="rs_ag"``, the DDP wire pattern), one ``all_reduce``
    (``"psum"``) or :func:`~tpu_dist_torch.parallel.collectives.ring_allreduce`
    (``"ring"``). Returns a new tree; without a process group only the
    mean's division runs."""
    if impl not in IMPLS:
        raise ValueError(f"unknown bucketed sync impl {impl!r}")
    dist = _dist()
    n = group_size(group)
    leaves = tree_leaves(tree)
    flats, shards, pending = [], [], []
    buckets = grad_buckets(leaves, bucket_mb * 1e6)
    for bucket in buckets:
        flat = torch.cat([leaves[i].reshape(-1) for i in bucket])
        pad = (-flat.numel()) % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        if dist is not None and impl == "ring":
            flat = ring_allreduce(flat, group)
        elif dist is not None and impl == "psum":
            pending.append(run_collective("all_reduce", lambda: dist.all_reduce(
                flat, group=group, async_op=True), flat, group))
        elif dist is not None:
            shard = flat.new_empty(flat.numel() // n)
            pending.append(_reduce_scatter(shard, flat, group))
            shards.append(shard)
        flats.append(flat)
    if shards:     # rs_ag: each bucket's gather once its scatter is done
        gathers = []
        for w, flat, shard in zip(pending, flats, shards):
            w.wait()
            gathers.append(_all_gather(flat, shard, group))
        pending = gathers
    for w in pending:
        w.wait()
    out = list(leaves)
    for bucket, flat in zip(buckets, flats):
        if mean:
            flat = flat / n
        off = 0
        for i in bucket:
            leaf = leaves[i]
            out[i] = flat[off:off + leaf.numel()].reshape(leaf.shape)
            off += leaf.numel()
    it = iter(out)
    return tree_map(lambda _: next(it), tree)
