"""Collectives for the port (``tpu_dist/parallel/collectives.py``): the
metric reductions, the bf16 gradient compression, Adasum, an explicit ring
all-reduce, a barrier and the all-reduce microbenchmark, on the
``torch.distributed`` process group; and the collectives of the
model-parallel axes, each differentiable.

The reference's versions run inside ``shard_map`` with an axis name; here
each process is one member of the group (``group=None`` is the whole
world, or no group at all over one process). Every function is a no-op
over a world of one process without a process group, so a single-process
run does the same arithmetic (the compression's casts included) and no
communication.

A tree is a tensor, or a list, tuple or dict of them. The functions return
new tensors and leave their inputs as they were.

The model-parallel axes need gradients through their collectives, which
JAX derives by transposition and torch does not, so each is an
``autograd.Function`` (:func:`gather_along` / :func:`scatter_along`, an
all-gather and a reduce-scatter along a dim; :func:`copy_to_group` and
:func:`reduce_from_group`, Megatron's identity-forward/all-reduce-backward
and all-reduce-forward/identity-backward pair; :func:`slice_shard`, this
rank's slice of a replicated tensor whose backward gathers the slices;
:func:`ppermute`, whose backward is the reverse shift).

Point to point: gloo aborts the process on point-to-point transfers of
CUDA tensors, so :func:`adasum_reduce` and :func:`ring_allreduce` refuse
CUDA tensors on a gloo group before any transfer starts.
:func:`ppermute` has a route of its own there instead (two ranks can share
one card only over gloo, and the rings of ring attention and ring tensor
parallelism ride it): over nccl it is ``batch_isend_irecv`` on the device;
over gloo with CUDA tensors it copies them to pinned host buffers,
exchanges those, and copies the result back, and each such call adds one
to :data:`P2P_HOST_STAGED`. That is a transport over the host, not a CPU
compute path, and it is never taken under nccl (:func:`p2p_route` names
the route a group gets).

The sp-sharded page pool of the serving engine sums over its ``sp`` group
with :func:`sum_bytes`: every tensor of one call in one all-reduce of its
raw bytes, exact for any dtype when one rank owns each byte (gloo and
nccl both take ``uint8``, on CUDA tensors too).
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Sequence

import torch


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def group_size(group=None) -> int:
    dist = _dist()
    return dist.get_world_size(group) if dist else 1


def group_rank(group=None) -> int:
    dist = _dist()
    return dist.get_rank(group) if dist else 0


def backend_of(group=None) -> Optional[str]:
    dist = _dist()
    return str(dist.get_backend(group)) if dist else None


def tree_leaves(tree) -> List[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in tree_leaves(tree[k])]
    return [t for v in tree for t in tree_leaves(v)]


def tree_map(fn: Callable, tree, *rest):
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))


def run_collective(name: str, fn: Callable, tensor: torch.Tensor, group=None):
    """``fn()``, with a failure re-raised naming ``name``, the backend and
    the tensor's dtype and device."""
    try:
        return fn()
    except RuntimeError as e:
        raise RuntimeError(
            f"collective {name} failed on the {backend_of(group)} backend "
            f"with {tensor.dtype} tensors on {tensor.device}: {e}") from e


def refuse_p2p_on_gloo_cuda(name: str, tensors, group=None) -> None:
    if backend_of(group) == "gloo" and any(t.is_cuda for t in tensors):
        raise NotImplementedError(
            f"{name} sends point to point (batch_isend_irecv), which the gloo "
            "backend does not run on CUDA tensors (it aborts the process): "
            "use the nccl backend, or CPU tensors with gloo")


def all_reduce_(x: torch.Tensor, group=None, async_op: bool = False):
    """In-place sum of ``x`` over the group; the work handle with
    ``async_op`` (None without a process group)."""
    dist = _dist()
    if dist is None:
        return None
    return run_collective("all_reduce", lambda: dist.all_reduce(
        x, group=group, async_op=async_op), x, group)


# ---- in-step collectives ---------------------------------------------------

def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group."""
    y = x.clone()
    all_reduce_(y, group)
    return y


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``x`` over the group (not differentiable)."""
    dist = _dist()
    y = x.clone()
    if dist is None or group_size(group) == 1:
        return y
    run_collective("all_reduce(max)", lambda: dist.all_reduce(
        y, op=dist.ReduceOp.MAX, group=group), y, group)
    return y


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the group."""
    return psum(x, group) / group_size(group)


def reduce_mean(tree, group=None):
    """Average a metric tree across the group: one all-reduce of the
    leaves stacked in fp32, then each leaf back in its dtype and shape (the
    reference's ``pmean``; no barrier is needed before it)."""
    leaves = tree_leaves(tree)
    flat = torch.cat([t.detach().float().reshape(-1) for t in leaves])
    flat = psum(flat, group) / group_size(group)
    out, off = [], 0
    for t in leaves:
        out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def compress_grads(tree, compression: str = "none"):
    """(down, up): the payload cast before the cross-replica reduction and
    the cast back after it. ``bf16`` mirrors ``hvd.Compression.fp16``
    (cast to bf16, reduce, cast back: half the bytes on the wire)."""
    if compression == "none":
        return tree, lambda t: t
    if compression == "bf16":
        dtypes = tree_map(lambda t: t.dtype, tree)
        down = tree_map(lambda t: t.to(torch.bfloat16), tree)
        up = lambda t: tree_map(lambda x, d: x.to(d), t, dtypes)
        return down, up
    raise ValueError(f"unknown grad compression {compression!r}")


def _exchange(tensors: Sequence[torch.Tensor], peer: int, group=None):
    """Send every tensor to ``peer`` and receive its counterparts, as one
    batch of isend/irecv pairs; returns the received tensors."""
    import torch.distributed as dist

    tensors = [t.contiguous() for t in tensors]
    got = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
           for t in tensors]
    peer = dist.get_global_rank(group, peer) if group is not None else peer
    ops = ([dist.P2POp(dist.isend, t, peer, group)
            for t in tensors]
           + [dist.P2POp(dist.irecv, g, peer, group) for g in got])
    for w in run_collective("batch_isend_irecv",
                            lambda: dist.batch_isend_irecv(ops),
                            tensors[0], group):
        w.wait()
    return got


def adasum_reduce(tree, group=None, granularity: str = "leaf"):
    """Adasum gradient reduction (``hvd.Adasum``): log2(N) rounds of
    recursive halving; in round k each rank exchanges its partial result
    with rank ``r ^ 2^k`` and both combine

        adasum(a, b) = (1 - <a,b> / (2|a|^2)) a + (1 - <a,b> / (2|b|^2)) b

    (orthogonal gradients add, identical ones average). ``"leaf"`` takes
    the inner products per tensor (Horovod's semantics), ``"tree"`` over
    the whole flattened gradient. The world size must be a power of two.
    The formula is symmetric, so both partners compute the same value."""
    if granularity not in ("leaf", "tree"):
        raise ValueError(f"unknown adasum granularity {granularity!r}")
    n = group_size(group)
    if n & (n - 1):
        raise ValueError(f"adasum needs a power-of-two axis size, got {n}")
    leaves = tree_leaves(tree)
    refuse_p2p_on_gloo_cuda("adasum_reduce", leaves, group)
    rank = group_rank(group)

    def dot(xs, ys):
        return sum((x.float() * y.float()).sum() for x, y in zip(xs, ys))

    a = list(leaves)
    for k in range(int(math.log2(n))):
        b = _exchange(a, rank ^ (1 << k), group)
        if granularity == "leaf":
            new = []
            for x, y in zip(a, b):
                xf, yf = x.float(), y.float()
                ab = (xf * yf).sum()
                na = torch.clamp((xf * xf).sum(), min=1e-30)
                nb = torch.clamp((yf * yf).sum(), min=1e-30)
                new.append(((1.0 - ab / (2.0 * na)) * xf
                            + (1.0 - ab / (2.0 * nb)) * yf).to(x.dtype))
            a = new
        else:
            ab = dot(a, b)
            wa = 1.0 - ab / (2.0 * torch.clamp(dot(a, a), min=1e-30))
            wb = 1.0 - ab / (2.0 * torch.clamp(dot(b, b), min=1e-30))
            a = [(wa * x.float() + wb * y.float()).to(x.dtype)
                 for x, y in zip(a, b)]
    it = iter(a)
    return tree_map(lambda _: next(it), tree)


def ring_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Bandwidth-optimal ring all-reduce (sum) in explicit point-to-point
    rounds: a reduce-scatter pass of n-1 rounds, in which each rank
    forwards a rotating accumulator one hop and adds its own chunk, then an
    all-gather pass of n-1 rounds that circulates the reduced chunks. Each
    hop carries 1/n of the buffer. Returns the sum over the group."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    refuse_p2p_on_gloo_cuda("ring_allreduce", [x], group)
    import torch.distributed as dist

    idx = group_rank(group)
    flat = x.reshape(-1)
    size = flat.numel()
    pad = (-size) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    parts = flat.reshape(n, -1)
    to, frm = (idx + 1) % n, (idx - 1) % n
    if group is not None:
        to, frm = (dist.get_global_rank(group, to),
                   dist.get_global_rank(group, frm))

    def hop(t):
        got = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, to, group),
               dist.P2POp(dist.irecv, got, frm, group)]
        for w in run_collective("batch_isend_irecv",
                                lambda: dist.batch_isend_irecv(ops), t, group):
            w.wait()
        return got

    # reduce-scatter: the accumulator seeded with chunk (idx-1) lands home
    # on rank idx after n-1 hops, summing every rank's copy
    acc = parts[(idx - 1) % n].clone()
    for k in range(1, n):
        acc = hop(acc) + parts[(idx - k - 1) % n]
    # all-gather: after hop k the chunk in flight on rank idx is (idx - k)
    out = torch.empty_like(parts)
    out[idx] = acc
    cur = acc
    for k in range(1, n):
        cur = hop(cur)
        out[(idx - k) % n] = cur
    return out.reshape(-1)[:size].reshape(x.shape)


# ---- host-level barrier ----------------------------------------------------

def barrier(device=None, group=None) -> None:
    """Block until every rank reaches this point: a one-element all-reduce
    on ``device`` (the CPU by default), then a read of it."""
    if _dist() is None:
        return
    one = torch.ones((), device=device or "cpu")
    all_reduce_(one, group)
    one.item()


# ---- all-reduce microbenchmark ---------------------------------------------

def timer(device: torch.device):
    """(start, stop -> seconds): CUDA events on the card, the host clock on
    the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def stop():
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

        return start.record, stop
    t0 = [0.0]

    def begin():
        t0[0] = time.perf_counter()

    return begin, lambda: time.perf_counter() - t0[0]


def allreduce_bench(sizes_mb: Sequence[float] = (0.004, 1.0, 16.0, 64.0),
                    dtype=torch.float32, iters: int = 20, device=None,
                    group=None) -> dict:
    """All-reduce latency and bandwidth over the group: {size_mb: {"us":
    mean latency, "gbps": algorithm bandwidth 2 (n-1)/n bytes / time}},
    timed with CUDA events on the card."""
    device = torch.device(device or "cpu")
    n = group_size(group)
    results = {}
    for mb in sizes_mb:
        elems = max(1, int(mb * 1e6 / torch.finfo(dtype).bits * 8))
        x = torch.ones(elems, dtype=dtype, device=device)
        all_reduce_(x, group)               # warm
        barrier(device, group)
        start, stop = timer(device)
        start()
        for _ in range(iters):
            all_reduce_(x, group)
        dt = stop() / iters
        nbytes = x.numel() * x.element_size()
        results[mb] = {"us": dt * 1e6,
                       "gbps": (2 * (n - 1) / max(n, 1)) * nbytes / dt / 1e9}
    return results


# ---- collectives of the model-parallel axes --------------------------------

# calls of ppermute that went through pinned host buffers (gloo + CUDA)
P2P_HOST_STAGED = {"calls": 0}
# host seconds spent in the model-parallel collectives below (each waits
# for its transfer; over gloo with CUDA tensors that includes waiting for
# the card's queued work to reach the tensor): the trainers' sync share
COMM_SECONDS = {"s": 0.0}


def _timed(fn):
    def run(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            COMM_SECONDS["s"] += time.perf_counter() - t0
    run.__name__, run.__doc__ = fn.__name__, fn.__doc__
    return run



@_timed
def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` stacked in group-rank order."""
    n = group_size(group)
    if n == 1 or _dist() is None:
        return x[None].clone()
    from tpu_dist_torch.parallel.overlap import _all_gather

    out = x.new_empty(n * x.numel())
    _all_gather(out, x.reshape(-1).contiguous(), group).wait()
    return out.reshape((n,) + tuple(x.shape))


@_timed
def reduce_scatter(stacked: torch.Tensor, group=None) -> torch.Tensor:
    """``stacked`` (n, ...) summed over the group, this rank keeping row
    ``group_rank``."""
    n = group_size(group)
    if n == 1 or _dist() is None:
        return stacked[0].clone()
    from tpu_dist_torch.parallel.overlap import _reduce_scatter

    out = stacked.new_empty(stacked[0].numel())
    _reduce_scatter(out, stacked.reshape(-1).contiguous(), group).wait()
    return out.reshape(stacked.shape[1:])


@_timed
def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """A new tensor: ``x`` summed over the group."""
    dist = _dist()
    y = x.clone()
    if dist is None or group_size(group) == 1:
        return y
    run_collective("all_reduce", lambda: dist.all_reduce(y, group=group), y,
                   group)
    return y


# calls and bytes of sum_bytes: the sp-sharded page pool's sums
SP_SUMS = {"calls": 0, "bytes": 0}


@_timed
def sum_bytes(xs: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Each tensor of ``xs`` summed over the group on its raw bytes, all
    of them in one all-reduce of one ``uint8`` buffer (any mix of dtypes
    and shapes): new tensors in ``xs``'s dtypes and shapes, or ``xs``
    itself over one process. Exact wherever at most one rank holds a
    nonzero byte at a position, as in the sharded page pool (each page
    has one owner and the others send zeros) and in a value one rank
    sends to all: a byte plus zeros is that byte, so every dtype comes
    back bit for bit (-0.0 included, which a float sum would turn into
    0.0). Counted in :data:`SP_SUMS` (calls and the buffer's bytes)."""
    xs = list(xs)
    dist = _dist()
    if dist is None or group_size(group) == 1:
        return xs
    # each tensor's bytes start on a 16-byte boundary of the buffer, so
    # its slice views back as its dtype
    spans, off = [], 0
    for x in xs:
        n = x.numel() * x.element_size()
        spans.append((off, n))
        off += -(-n // 16) * 16
    flat = torch.zeros(off, dtype=torch.uint8, device=xs[0].device)
    for x, (o, n) in zip(xs, spans):
        flat[o:o + n] = x.contiguous().reshape(-1).view(torch.uint8)
    run_collective("all_reduce(bytes)", lambda: dist.all_reduce(
        flat, group=group), flat, group)
    SP_SUMS["calls"] += 1
    SP_SUMS["bytes"] += off
    return [flat[o:o + n].view(x.dtype).reshape(x.shape)
            for x, (o, n) in zip(xs, spans)]


def _gather_dim(x, dim, group):
    return torch.cat(all_gather(x, group).unbind(0), dim)


def _scatter_dim(x, dim, group):
    n = group_size(group)
    return reduce_scatter(torch.stack(x.chunk(n, dim)), group)


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.dim, ctx.group), None, None


class _ScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group), None, None


def gather_along(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order;
    backward: the gradient's chunk of this rank, summed over the group (a
    reduce-scatter)."""
    if group_size(group) == 1:
        return x
    return _GatherAlong.apply(x, dim, group)


def scatter_along(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """``x`` summed over the group, this rank keeping its chunk along
    ``dim`` (a reduce-scatter); backward: an all-gather."""
    if group_size(group) == 1:
        return x
    return _ScatterAlong.apply(x, dim, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's ``f``: identity forward, the gradient summed over the
    group backward (the input of a column-parallel product, whose
    gradient each rank knows only in part)."""
    if group_size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


def reduce_from_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's ``g``: ``x`` summed over the group forward, identity
    backward (the output of a row-parallel product)."""
    if group_size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def sum_over_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the group forward, and the gradient summed over
    it backward: a statistic of the whole batch that every data rank holds
    whole (the MoE balance loss's token means), whose gradients the step
    then averages over the group."""
    if group_size(group) == 1:
        return x
    return _SumBoth.apply(x, group)


class _SliceShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n, r = group_size(group), group_rank(group)
        return x.chunk(n, dim)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g.contiguous(), ctx.dim, ctx.group), None, None


def slice_shard(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``x``, which every rank holds
    whole; backward: the chunks' gradients gathered, so every rank gets
    the whole gradient of ``x``."""
    if group_size(group) == 1:
        return x
    return _SliceShard.apply(x, dim, group)


def p2p_route(group=None, device=None) -> str:
    """How :func:`ppermute` moves tensors of ``device`` over ``group``:
    ``device`` (nccl), ``host-staged`` (gloo with CUDA tensors), ``host``
    (gloo with CPU tensors) or ``none`` (one process)."""
    if group_size(group) == 1:
        return "none"
    backend = backend_of(group)
    cuda = device is not None and torch.device(device).type == "cuda"
    if backend == "nccl":
        return "device"
    return "host-staged" if cuda else "host"


def _send_recv(xs, dst: int, src: int, group):
    import torch.distributed as dist

    to, frm = dst, src
    if group is not None:
        to = dist.get_global_rank(group, dst)
        frm = dist.get_global_rank(group, src)
    got = [torch.empty_like(x) for x in xs]
    ops = ([dist.P2POp(dist.isend, x, to, group) for x in xs]
           + [dist.P2POp(dist.irecv, g, frm, group) for g in got])
    for w in run_collective("batch_isend_irecv",
                            lambda: dist.batch_isend_irecv(ops), xs[0],
                            group):
        w.wait()
    return got


@_timed
def _shift(xs, shift: int, group):
    n, r = group_size(group), group_rank(group)
    xs = [x.contiguous() for x in xs]
    dst, src = (r + shift) % n, (r - shift) % n
    route = p2p_route(group, xs[0].device)
    if route != "host-staged":
        return _send_recv(xs, dst, src, group)
    host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            for x in xs]
    for h, x in zip(host, xs):
        h.copy_(x)               # synchronous: the bytes are on the host
    got = _send_recv(host, dst, src, group)
    P2P_HOST_STAGED["calls"] += 1
    return [g.to(x.device) for g, x in zip(got, xs)]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shift, group, *xs):
        ctx.shift, ctx.group = shift, group
        return tuple(_shift(xs, shift, group))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(_shift(gs, -ctx.shift, ctx.group))


def ppermute(xs, shift: int, group=None):
    """Rank r's tensors go to rank (r + shift) mod n of the group and it
    gets rank (r - shift) mod n's (``lax.ppermute`` over a ring); a list or
    tuple of tensors travels in one batch. Backward: the reverse shift.
    The route follows the backend (module docstring)."""
    single = torch.is_tensor(xs)
    xs = [xs] if single else list(xs)
    if group_size(group) == 1:
        out = xs
    else:
        out = list(_PPermute.apply(shift, group, *xs))
    return out[0] if single else out
