"""Collectives for the port (``tpu_dist/parallel/collectives.py``): the
metric reductions, the bf16 gradient compression, Adasum, an explicit ring
all-reduce, a barrier and the all-reduce microbenchmark, on the
``torch.distributed`` process group.

The reference's versions run inside ``shard_map`` with an axis name; here
each process is one member of the group (``group=None`` is the whole
world). Every function is a no-op over a world of one process without a
process group, so a single-process run does the same arithmetic (the
compression's casts included) and no communication.

A tree is a tensor, or a list, tuple or dict of them. The functions return
new tensors and leave their inputs as they were.

A collective that a backend does not run raises, naming the collective and
the backend; nothing is staged through the host in its place. gloo aborts
the process on point-to-point transfers of CUDA tensors, so
:func:`adasum_reduce` and :func:`ring_allreduce` refuse CUDA tensors on a
gloo group before any transfer starts.
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
