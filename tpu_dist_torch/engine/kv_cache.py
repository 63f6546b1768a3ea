"""Paged KV cache pool for the port (``tpu_dist/engine/kv_cache.py``,
unsharded).

K/V rows live in one preallocated ``[num_pages + 1, page_size, heads,
head_dim]`` arena per layer on the serving device (the extra page is the
trash page masked writes land on); each sequence owns an ordered block
table of page indices, and allocation is a free-list pop. Pages are
refcounted and a prefix index keyed by the token hash of whole pages maps
a new prompt's prefix onto pages an identical earlier prefix filled; a
page whose refcount drops to zero while still indexed parks in a CACHED
set (content kept, reclaimed FIFO under pressure). Divergence is
copy-on-write: the frontier page holding a shared prompt's tail is forked
(``ops.paged_attention.cow_fork_pages``) onto a page reserved at
admission, right before the first divergent write.

int8 mode stores pages as int8 with one fp32 scale per (slot, head);
``read="flash"`` routes the decode tick through the paged decode kernel.
The allocator is host-side Python; the arenas are updated in place by the
page programs.

``mesh=`` (a ``parallel.mesh.Mesh`` with the ``sp`` axis, one rank per
device) shards the pool: each rank allocates only its own block of
``pages_per_device + 1`` rows of every arena (its pages and a local trash
row), so the pool's capacity grows with the axis and one context can
outgrow a device's pages. The host allocator is replicated: every rank
runs it on the same requests and grants the same pages, one min-heap per
device, lowest global index first. Device programs see FLAT rows
(:meth:`PagedKVPool.flat_block_table`), and
``ops.paged_attention.sp_paged_write``/``sp_gather_many`` route them.
A copy-on-write fork between pages of two ranks goes through one
``collectives.sum_bytes`` (the source's owner sends the page, the others
zeros).
"""

from __future__ import annotations

import hashlib
import heapq
from collections import Counter, OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.ops.paged_attention import (PagedLayer, pages_for,
                                                sp_axis)


def _prefix_key(tokens) -> str:
    """Content address of a token prefix: sha1 over the raw int32 bytes
    (deterministic across runs and processes)."""
    return hashlib.sha1(
        np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()
    ).hexdigest()


class PrefixMatch:
    """One admission's prefix-index result (``PagedKVPool.share_prefix``):
    ``pages`` shared (refcounts bumped) in block-table order, ``full`` of
    them whole-page hits; with ``partial`` the last one is a frontier page
    matched through its leading rows only (it forks on first write).
    ``cov`` is the number of prompt positions already resident."""

    __slots__ = ("pages", "full", "partial", "cov")

    def __init__(self, pages: List[int], full: int, partial: bool,
                 cov: int):
        self.pages = pages
        self.full = full
        self.partial = partial
        self.cov = cov


class PagedKVPool:
    """Preallocated paged KV arenas + the refcounting free-list allocator.

    ``alloc`` is all-or-nothing (``None`` when short: admission control's
    signal to queue). Page states: FREE (on the min-heap, granted
    lowest-index first), LIVE (refcount >= 1), CACHED (refcount 0 but
    indexed; reclaimed FIFO when the heap runs dry). ``pages_free`` counts
    FREE + CACHED. With ``mesh=`` the pool is sp-sharded (module
    docstring); ``device`` defaults to the mesh's.
    """

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_heads: int, head_dim: int, dtype=torch.float32,
                 kv_quant: str = "none", read: str = "exact", mesh=None,
                 device=None):
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant must be 'none' or 'int8', "
                             f"got {kv_quant!r}")
        if read not in ("exact", "flash"):
            raise ValueError(f"read must be 'exact' or 'flash', "
                             f"got {read!r}")
        if read == "flash" and kv_quant != "int8":
            raise ValueError("read='flash' is the int8-KV kernel path; "
                             "pass kv_quant='int8' (the fp exact path "
                             "needs no kernel)")
        # sp sharding: n per-device blocks of pages/n + 1 rows, this rank
        # allocating its own block; an absent or one-rank mesh is the
        # unsharded num_pages + 1 layout with an identity translation
        self.sp_mesh = mesh
        n, self.sp_rank = 1, 0
        if mesh is not None:
            ax = sp_axis(mesh)
            n, self.sp_rank = ax.size, ax.index
            if num_pages % n:
                raise ValueError(
                    f"num_pages {num_pages} must divide by the 'sp' axis "
                    f"size {n} (whole pages per device)")
        self.sharded_devices = n
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        self.num_layers = num_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_quant = kv_quant
        self.read = read
        self.pages_per_device = num_pages // n
        self._rows_local = self.pages_per_device + 1   # + local trash row
        shape = (self._rows_local, page_size, num_heads, head_dim)
        sshape = (self._rows_local, page_size, num_heads)

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=self.device)

        self._layers: List[PagedLayer] = []
        for _ in range(num_layers):
            if kv_quant == "int8":
                self._layers.append(PagedLayer(
                    zeros(shape, torch.int8), zeros(shape, torch.int8),
                    zeros(sshape, torch.float32), zeros(sshape, torch.float32),
                    quant="int8", read=read))
            else:
                self._layers.append(PagedLayer(
                    zeros(shape, dtype), zeros(shape, dtype),
                    quant="none", read=read))
        # one min-heap of free pages per device (a sorted list is already
        # a heap); grants take the lowest global index across them, so an
        # unsharded pool has one heap and the reference's grant order
        self._free_by_dev: List[List[int]] = [
            list(range(d * self.pages_per_device,
                       (d + 1) * self.pages_per_device)) for d in range(n)]
        self._ref: List[int] = [0] * num_pages
        # rc==0 pages still carrying indexed prefix content, FIFO by
        # release order (deterministic reclaim under pressure)
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        # prefix index: full-prefix sha1 -> page holding its last whole
        # page of rows; parent hash -> [(page tokens, page)] for frontier
        # matches; _reg maps page -> its keys for O(children) unregister
        self._full_index: Dict[str, int] = {}
        self._children: Dict[str, List[Tuple[Tuple[int, ...], int]]] = {}
        self._reg: Dict[int, Tuple[Optional[str], str,
                                   Tuple[int, ...]]] = {}
        self.high_water_used = 0
        self.prefix_hits = 0
        self.prefix_lookups = 0
        self.cow_copies = 0
        self.alloc_total = 0
        # request tracing (obs.reqtrace), bound by the serving engine
        self._tracer = None
        self._now = None

    def bind_trace(self, tracer, now_fn) -> None:
        """Attach the engine's tracer (None disables) and ENGINE clock."""
        self._tracer = tracer
        self._now = now_fn

    # -- allocator --------------------------------------------------------
    @property
    def pages_free(self) -> int:
        """Allocatable pages: truly free + cached (reclaimable) ones."""
        return sum(map(len, self._free_by_dev)) + len(self._cached)

    @property
    def pages_used(self) -> int:
        return self.num_pages - self.pages_free

    @property
    def shared_pages(self) -> int:
        """Pages currently referenced by 2+ sequences."""
        return sum(1 for r in self._ref if r >= 2)

    def pages_needed(self, total_tokens: int) -> int:
        return pages_for(total_tokens, self.page_size)

    def page_device(self, page: int) -> int:
        """The device block (sp rank) a page lives in (0 unsharded)."""
        return page // self.pages_per_device

    def _pop_free(self) -> Optional[int]:
        """Pop the lowest global free index across the per-device heaps."""
        best = None
        for h in self._free_by_dev:
            if h and (best is None or h[0] < best[0]):
                best = h
        return heapq.heappop(best) if best is not None else None

    def alloc(self, n: int) -> Optional[List[int]]:
        """Grant ``n`` fresh pages at refcount 1 (all-or-nothing). Free
        pages go first, lowest index first; cached prefix pages are
        reclaimed FIFO (and unregistered) only when the heaps run dry."""
        if n > self.pages_free:
            return None
        grant: List[int] = []
        while len(grant) < n:
            page = self._pop_free()
            if page is None:
                page, _ = self._cached.popitem(last=False)
                self._unregister(page)
            grant.append(page)
        for p in grant:
            self._ref[p] = 1
        self.alloc_total += n
        self.high_water_used = max(self.high_water_used, self.pages_used)
        return grant

    def alloc_for_slots(self, devs: Sequence[int]) -> Optional[List[int]]:
        """Grant one page on each listed device, in order (all-or-nothing;
        None when any device is short): the sp prefill's striped prompt
        pages, block-table slot ``t`` on the device whose prompt shard
        writes its rows. Per device lowest index first; a device's cached
        pages are reclaimed FIFO, as in :meth:`alloc`."""
        for d, c in Counter(devs).items():
            avail = len(self._free_by_dev[d]) + sum(
                1 for p in self._cached if self.page_device(p) == d)
            if avail < c:
                return None
        grant: List[int] = []
        for d in devs:
            if self._free_by_dev[d]:
                p = heapq.heappop(self._free_by_dev[d])
            else:
                p = next(q for q in self._cached
                         if self.page_device(q) == d)
                del self._cached[p]
                self._unregister(p)
            self._ref[p] = 1
            grant.append(p)
        self.alloc_total += len(grant)
        self.high_water_used = max(self.high_water_used, self.pages_used)
        return grant

    def flat_block_table(self, bt) -> np.ndarray:
        """Page ids -> FLAT arena rows, the device programs' view: page
        ``p`` sits at ``p + p // pages_per_device`` (one trash row per
        preceding device), and the unassigned sentinel (``num_pages``)
        maps to the last row, the last device's trash. Identity for an
        unsharded pool."""
        bt = np.asarray(bt)
        return np.where(
            bt >= self.num_pages,
            self.sharded_devices * self._rows_local - 1,
            bt + bt // self.pages_per_device).astype(np.int32)

    def free(self, pages: List[int]) -> None:
        """Drop one reference per listed page; double-frees raise."""
        for p in pages:
            if self._ref[p] <= 0:
                raise ValueError(f"double-free of page {p} (refcount 0)")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                if p in self._reg:
                    self._cached[p] = None
                else:
                    heapq.heappush(self._free_by_dev[self.page_device(p)],
                                   p)

    def contiguous_pages_needed(self, slots: int, max_total: int) -> int:
        """What a contiguous per-slot allocator would preallocate for the
        same capacity -- the fragmentation comparison baseline."""
        return slots * self.pages_needed(max_total)

    # -- prefix index -----------------------------------------------------
    def share_prefix(self, prompt: np.ndarray,
                     rid: Optional[int] = None) -> PrefixMatch:
        """Map the longest resident prefix of ``prompt`` onto shared
        pages: whole-page hits by cumulative prefix hash, then one frontier
        page whose leading rows match the tail. Bumps refcounts; ``unshare``
        undoes it. A hit with ``rid`` and a bound tracer emits a
        ``prefix_hit`` span."""
        t0 = self._now() if self._now is not None else 0.0
        self.prefix_lookups += 1
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        ps = self.page_size
        pages: List[int] = []
        full = 0
        parent = _prefix_key(prompt[:0])
        while (full + 1) * ps <= prompt.size:
            key = _prefix_key(prompt[:(full + 1) * ps])
            page = self._full_index.get(key)
            if page is None:
                break
            self._retain(page)
            pages.append(page)
            full += 1
            parent = key
        cov = full * ps
        partial = False
        tail = tuple(int(t) for t in prompt[cov:])
        if tail:
            for content, page in self._children.get(parent, ()):
                if len(content) >= len(tail) \
                        and content[:len(tail)] == tail:
                    self._retain(page)
                    pages.append(page)
                    partial = True
                    cov += len(tail)
                    break
        self.prefix_hits += len(pages)
        if pages:
            self.high_water_used = max(self.high_water_used,
                                       self.pages_used)
        if pages and self._tracer is not None and rid is not None:
            tr = self._tracer
            tid, sid, par = tr.ids(rid, "prefix_hit")
            tr.ledger.emit("span", trace_id=tid, span_id=sid,
                           parent_id=par, name="prefix_hit", rid=rid,
                           start=round(t0, 6), end=round(self._now(), 6),
                           pages=len(pages), full=full, partial=partial,
                           cov=cov, **tr.attrs())
        return PrefixMatch(pages, full, partial, cov)

    def unshare(self, match: PrefixMatch) -> None:
        """Roll back ``share_prefix`` (admission failed downstream)."""
        self.free(match.pages)
        self.prefix_hits -= len(match.pages)

    def _retain(self, page: int) -> None:
        if self._ref[page] == 0:
            self._cached.pop(page, None)
        self._ref[page] += 1

    def register_prefix(self, prompt: np.ndarray, pages: List[int],
                        skip_slots: int = 0) -> None:
        """Index a freshly-prefilled prompt's pages for future sharing
        (whole pages under their cumulative prefix hash, every page as a
        child of its parent hash). ``skip_slots`` leading slots came from
        ``share_prefix`` and are already indexed."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        ps = self.page_size
        n_slots = pages_for(prompt.size, ps)
        for i in range(skip_slots, n_slots):
            page = pages[i]
            content = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            parent = _prefix_key(prompt[:i * ps])
            is_full = len(content) == ps
            full_key = _prefix_key(prompt[:(i + 1) * ps]) if is_full \
                else None
            if full_key is not None and full_key in self._full_index:
                continue         # identical prefix already indexed
            siblings = self._children.setdefault(parent, [])
            if any(c == content for c, _ in siblings):
                continue
            if page in self._reg:
                continue         # one page, one identity
            siblings.append((content, page))
            if full_key is not None:
                self._full_index[full_key] = page
            self._reg[page] = (full_key, parent, content)

    def _unregister(self, page: int) -> None:
        full_key, parent, content = self._reg.pop(page)
        if full_key is not None:
            self._full_index.pop(full_key, None)
        kids = self._children.get(parent)
        if kids:
            kids[:] = [(c, p) for c, p in kids if p != page]
            if not kids:
                del self._children[parent]

    def fork_page(self, src: int, dst: int,
                  rid: Optional[int] = None) -> None:
        """Copy-on-write fork: duplicate ``src``'s rows onto the already
        granted ``dst`` in every layer's arenas and drop the forking
        sequence's reference to ``src``. Over a sharded pool the owner of
        both copies locally; pages on two ranks go through one
        ``sum_bytes`` of every arena's page (module docstring). A
        ``cow_fork`` span with ``rid`` and a bound tracer."""
        from tpu_dist_torch.ops.paged_attention import cow_fork_pages
        from tpu_dist_torch.parallel.collectives import sum_bytes

        t0 = self._now() if self._now is not None else 0.0
        rows = self._rows_local
        s_row, d_row = (int(r) for r in self.flat_block_table([src, dst]))
        s_dev, d_dev = s_row // rows, d_row // rows
        me = self.sp_rank
        if s_dev == d_dev:
            if me == s_dev:
                cow_fork_pages(self._layers, [s_row % rows], [d_row % rows])
        else:
            arenas = [a for layer in self._layers for a in layer.arenas()]
            pages = [a[s_row % rows] if me == s_dev
                     else torch.zeros_like(a[0]) for a in arenas]
            pages = sum_bytes(pages, sp_axis(self.sp_mesh).group)
            if me == d_dev:
                for a, page in zip(arenas, pages):
                    a[d_row % rows] = page
        self.free([src])
        self.cow_copies += 1
        if self._tracer is not None and rid is not None:
            tr = self._tracer
            tid, sid, par = tr.ids(rid, "cow_fork")
            tr.ledger.emit("span", trace_id=tid, span_id=sid,
                           parent_id=par, name="cow_fork", rid=rid,
                           start=round(t0, 6), end=round(self._now(), 6),
                           src=src, dst=dst, **tr.attrs())

    # -- arena plumbing ---------------------------------------------------
    def layers(self) -> tuple:
        """The per-layer ``PagedLayer`` packs the page programs update."""
        return tuple(self._layers)

    def stats(self) -> dict:
        return {"pages_free": self.pages_free,
                "pages_used": self.pages_used,
                "pages_total": self.num_pages,
                "pages_cached": len(self._cached),
                "page_size": self.page_size,
                "sharded_devices": self.sharded_devices,
                "pages_per_device": self.pages_per_device,
                "high_water_used": self.high_water_used,
                "shared_pages": self.shared_pages,
                "prefix_hits": self.prefix_hits,
                "prefix_lookups": self.prefix_lookups,
                "cow_copies": self.cow_copies,
                "alloc_total": self.alloc_total,
                "kv_quant": self.kv_quant}
