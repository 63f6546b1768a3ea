"""Ring collective matmuls and bucketed gradient sync for the port
(``tpu_dist/parallel/overlap.py``).

**Ring tensor parallelism** (``tp_impl="ring"``, ``:64-255``; the ViT's
full-token ``ring_ar`` flavour is :class:`RingDense`'s): the
Megatron column/row-parallel pair rebuilt as per-chunk products whose
chunks travel around the ``model`` axis by
:func:`~tpu_dist_torch.parallel.collectives.ppermute`. The residual
stream is sequence-sharded over the axis (:func:`seq_shard`);
:func:`ring_allgather_matmul` multiplies the sequence chunk it holds by
its column shard while passing the chunk on, and
:func:`ring_matmul_reduce_scatter` carries an accumulator one hop a round,
adding its partial product for the chunk the accumulator belongs to.
:class:`RingDense` applies them to a dense layer whose params stay whole
and replicated: each rank slices its shard at use (its column shard cut
per fused segment, so ``qkv`` stays q/k/v-aligned). Every rank holds the
whole params, so the gradient of a sliced leaf is summed over ``model``
by the step (``engine.lm_steps``). The per-chunk product routes through
``ops.quant.quant_matmul``, so ``quant`` rides the ring too.

**Bucketed gradient sync**: the gradients are reduced as independent
size-targeted bucket collectives instead of one per tensor: DDP's
decomposition (Li et al., PyTorch Distributed, section 3.2). Each
bucket's collective is issued with ``async_op=True`` and every bucket is
waited for at the end, so the transfers of successive buckets overlap one
another.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from tpu_dist_torch.parallel.collectives import (_dist, copy_to_group,
                                                 group_size, ppermute,
                                                 ring_allreduce,
                                                 run_collective, slice_shard,
                                                 tree_leaves, tree_map)

GRAD_BUCKET_MB_DEFAULT = 25.0  # DDP's fusion-buffer default
IMPLS = ("rs_ag", "ring", "psum")
TP_IMPLS = ("gspmd", "ring")          # the public knob
_RING_FLAVORS = ("ring", "ring_ar")   # RingDense's dataflows (internal)


def validate_tp_impl(mode: str) -> str:
    if mode not in TP_IMPLS:
        raise ValueError(f"unknown tp_impl {mode!r} ({'|'.join(TP_IMPLS)})")
    return mode


# ---- ring collective matmul ------------------------------------------------

def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor, axis,
                          matmul=None) -> torch.Tensor:
    """All-gather then matmul, decomposed (``:78``): (B, L/n, D) sequence
    chunk x (D, F/n) column shard -> (B, L, F/n). Round k multiplies the
    chunk held (first device idx+k's) and passes it to the left
    neighbour."""
    mm = matmul or torch.matmul
    n = axis.size
    if n == 1:
        return mm(x, w)
    chunks = [None] * n
    cur = x
    for k in range(n):
        nxt = ppermute(cur, -1, axis.group) if k < n - 1 else None
        chunks[(axis.index + k) % n] = mm(cur, w)
        cur = nxt
    return torch.cat(chunks, dim=1)


def ring_matmul_reduce_scatter(y: torch.Tensor, w: torch.Tensor, axis,
                               matmul=None) -> torch.Tensor:
    """Matmul then reduce-scatter, decomposed (``:111``): (B, L, F/n) x
    (F/n, D) row shard -> (B, L/n, D) summed over the axis, this rank
    keeping sequence chunk ``index``. The accumulator seeded for chunk
    idx-1 lands home after n-1 hops."""
    mm = matmul or torch.matmul
    n = axis.size
    if n == 1:
        return mm(y, w)
    if y.shape[1] % n:
        raise ValueError(f"sequence length {y.shape[1]} not divisible by "
                         f"the {axis.name} axis ({n})")
    lm = y.shape[1] // n

    def part(c):
        return mm(y.narrow(1, (c % n) * lm, lm), w)

    acc = part(axis.index - 1)
    for k in range(1, n):
        acc = ppermute(acc, 1, axis.group) + part(axis.index - k - 1)
    return acc


def seq_shard(x: torch.Tensor, axis) -> torch.Tensor:
    """This rank's sequence chunk of a (B, L, ...) activation that every
    rank of ``axis`` holds whole (``:145``): the entry into the ring's
    sequence-sharded residual stream."""
    n = axis.size
    if n == 1:
        return x
    if x.shape[1] % n:
        raise ValueError(
            f"tp_impl='ring' shards the sequence over the {axis.name} axis: "
            f"length {x.shape[1]} is not divisible by {n}")
    lm = x.shape[1] // n
    return x.narrow(1, axis.index * lm, lm)


def column_shard(t: torch.Tensor, index: int, n: int, fused: int = 1):
    """The ``index``-th output-feature shard of ``t`` (a kernel's last dim,
    a bias's only one), sliced per fused segment (``RingDense
    ._column_shard``)."""
    seg = t.shape[-1] // fused
    fs = seg // n
    parts = [t.narrow(-1, s * seg + index * fs, fs) for s in range(fused)]
    return parts[0] if fused == 1 else torch.cat(parts, -1)


class _RingAllReduce(torch.autograd.Function):
    """Megatron's ``g`` as a ring: the sum over the axis forward (a
    reduce-scatter then an all-gather of n chunks, each a ``ppermute`` hop,
    so every rank ends with the owner's bits of each chunk), identity
    backward."""

    @staticmethod
    def forward(ctx, x, axis):
        n, idx = axis.size, axis.index
        flat = x.reshape(-1)
        pad = (-flat.numel()) % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        chunks = list(flat.chunk(n))
        for k in range(n - 1):                 # reduce-scatter
            got = ppermute(chunks[(idx - k) % n], 1, axis.group)
            r = (idx - k - 1) % n
            chunks[r] = chunks[r] + got
        for k in range(n - 1):                 # all-gather
            chunks[(idx - k) % n] = ppermute(chunks[(idx + 1 - k) % n], 1,
                                             axis.group)
        return torch.cat(chunks)[:x.numel()].reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ring_allreduce_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` summed over ``axis`` by a chunked ring of ``ppermute`` hops
    (the reference's ``collectives.ring_allreduce`` inside ``RingDense``'s
    ``ring_ar`` flavour, ``:241``); the gradient passes through."""
    if axis.size == 1:
        return x
    return _RingAllReduce.apply(x, axis)


def fused_slice(t: torch.Tensor, n_fused: int, group) -> torch.Tensor:
    """This rank's output-feature shard of ``t`` (a kernel's last dim, a
    bias's only one), per fused segment, as :func:`column_shard` cuts it;
    backward: every rank's shard gradient gathered, so each rank holds the
    whole gradient of ``t`` (``collectives.slice_shard``)."""
    seg = t.shape[-1] // n_fused
    parts = t.reshape(*t.shape[:-1], n_fused, seg)
    local = slice_shard(parts, parts.dim() - 1, group)
    return local.reshape(*t.shape[:-1], -1)


class RingDense:
    """A dense layer's ring-parallel product (``:161``), on the params of
    ``dense`` (a ``QuantDense`` with whole, replicated params; the flax
    module owned them, here the dense layer does). ``kind`` ``column``
    takes the whole contraction dim and gives this rank's feature shard
    over the whole sequence; ``row`` takes a feature shard and gives this
    rank's sequence chunk, summed over the axis. ``n_fused`` equal
    projections share the kernel's output dim (``qkv``: 3).

    ``flavor="ring_ar"`` (``:161-241``, the ViT's ring: its [CLS] token
    makes the token count odd, so the sequence cannot split) keeps the
    activations whole: ``column`` is a local product with this rank's
    column slice (the input entering through Megatron's ``f``), ``row``
    this rank's row slice's partial product summed over the axis by a
    chunked ring all-reduce (:func:`ring_allreduce_sum`). The slices'
    gradients are gathered (:func:`fused_slice`), so every rank's gradient
    of the whole, replicated params is the same."""

    def __init__(self, dense, kind: str, axis, n_fused: int = 1,
                 flavor: str = "ring"):
        if kind not in ("column", "row"):
            raise ValueError(f"RingDense kind {kind!r} (column|row)")
        if flavor not in _RING_FLAVORS:
            raise ValueError(f"RingDense flavor {flavor!r} "
                             f"({'|'.join(_RING_FLAVORS)})")
        self.flavor = flavor
        if dense.prequantized:
            raise ValueError(
                "RingDense got a pre-quantized (wo_quantize_params) kernel; "
                "the ring path is a training path -- decode rides the GSPMD "
                "layers (quant='int8_wo' with tp_impl='gspmd')")
        self.dense, self.kind, self.axis, self.n_fused = (dense, kind, axis,
                                                          n_fused)

    def __call__(self, x):
        d, n, idx = self.dense, self.axis.size, self.axis.index
        x = x.to(d.dtype)
        w = d.kernel.to(d.dtype)

        def mm(a, b):
            from tpu_dist_torch.ops.quant import quant_matmul

            return quant_matmul(a, b, d.mode)

        if self.flavor == "ring_ar":
            return self._ring_ar(x, w, mm)
        if self.kind == "column":
            if d.features % (self.n_fused * n):
                raise ValueError(f"features {d.features} not divisible by "
                                 f"n_fused x the {self.axis.name} axis "
                                 f"({self.n_fused} x {n})")
            y = ring_allgather_matmul(
                x, column_shard(w, idx, n, self.n_fused), self.axis, mm)
            if d.bias is not None:
                y = y + column_shard(d.bias.to(d.dtype), idx, n,
                                     self.n_fused)
            return y
        ls = x.shape[-1]
        y = ring_matmul_reduce_scatter(x, w.narrow(0, idx * ls, ls),
                                       self.axis, mm)
        if d.bias is not None:
            y = y + d.bias.to(d.dtype)
        return y


    def _ring_ar(self, x, w, mm):
        d, g = self.dense, self.axis.group
        if self.kind == "column":
            y = mm(copy_to_group(x, g), fused_slice(w, self.n_fused, g))
            if d.bias is not None:
                y = y + fused_slice(d.bias.to(d.dtype), self.n_fused, g)
            return y
        y = ring_allreduce_sum(mm(x, slice_shard(w, 0, g)), self.axis)
        if d.bias is not None:
            y = y + d.bias.to(d.dtype)
        return y


def ring_lm_(model, axis):
    """Run ``model`` (an LM) under ring tensor parallelism over ``axis``:
    its params stay whole and replicated (each rank slices at use)."""
    if model.num_heads % axis.size:
        raise ValueError(f"tp_impl='ring' shards heads: num_heads "
                         f"{model.num_heads} must divide by the model axis "
                         f"({axis.size})")
    model.tp_impl = "ring"
    for blk in model.blocks:
        blk.tp_impl = "ring"
    model.set_tp(axis)
    return model


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
