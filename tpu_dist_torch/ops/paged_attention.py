"""Block-table (paged) KV attention for the port
(``tpu_dist/ops/paged_attention.py``, the unsharded part).

Arenas are ``[num_pages + 1, page_size, heads, head_dim]`` per layer (the
extra page is the trash page masked writes land on); a sequence owns a
block table of page indices. Unlike the reference's functional scatter,
:func:`paged_write` and :func:`cow_fork_pages` update the arenas IN PLACE
(``index_copy_``): the pool holds one tensor per arena and a write never
copies it.

The decode tick with int8 pages and ``read="flash"`` goes through
:func:`paged_decode_blocks`: for CUDA tensors the Hopper kernel
``csrc/paged_decode.cu`` (the port of the Pallas ``_paged_int8kv_kernel``),
which reads the arenas through the block table, for CPU tensors
:func:`paged_decode_blocks_plain`. The reference's gathered entry,
:func:`int8kv_paged_flash_attention_fn`, launches the same kernel.

sp-sharded arenas (``engine.kv_cache.PagedKVPool(mesh=)``): each rank of
the ``sp`` axis holds a block of ``rows_local = pages_per_device + 1``
rows, its own pages and a local trash row, and block tables hold FLAT
rows: row ``r`` belongs to rank ``r // rows_local``.
:func:`sp_paged_write` writes the rows a rank owns and sends the rest to
its local trash, with no communication; :func:`sp_gather_many` gathers
the owned pages, zeroes the foreign ones and sums the views over ``sp``
in one call of ``collectives.sum_bytes``, so every rank holds the whole
view, bit for bit. The int8 flash tick over a sharded pool runs the same
kernel on that view through its contiguous entry
(:func:`int8kv_paged_flash_attention_fn`). Over one rank both are the
unsharded write and gather.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch

from tpu_dist_torch import kernels
from tpu_dist_torch.ops.f32_product import matmul_f32
from tpu_dist_torch.ops.flash_attention import NEG_INF, masked_softmax_pv
from tpu_dist_torch.ops.quant import quantize_int8
from tpu_dist_torch.parallel.mesh import SP_AXIS


def pages_for(length: int, page_size: int) -> int:
    """Pages a sequence of ``length`` tokens occupies."""
    return -(-int(length) // int(page_size))


@dataclasses.dataclass
class PagedLayer:
    """One layer's KV page arenas: ``k``/``v`` (N+1, page_size, H, D);
    int8 arenas add fp32 ``k_scale``/``v_scale`` (N+1, page_size, H).
    ``quant`` is "none" | "int8", ``read`` is "exact" | "flash"."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    quant: str = "none"
    read: str = "exact"

    @property
    def num_pages(self) -> int:
        return self.k.shape[0] - 1               # minus the trash page

    @property
    def page_size(self) -> int:
        return self.k.shape[1]

    def arenas(self):
        return [a for a in (self.k, self.v, self.k_scale, self.v_scale)
                if a is not None]


# ---------------------------------------------------------------------------
# arena scatter / gather
# ---------------------------------------------------------------------------

def flat_slot_index(block_table, positions, page_size: int):
    """(B, L) global arena slot indices for per-row token positions.
    Positions past the table's reach (padding rows of a last prefill
    chunk) are clamped to its last entry; callers route such rows to the
    trash page through the write mask."""
    slot = torch.clamp(positions.long() // page_size,
                       max=block_table.shape[1] - 1)
    page = torch.gather(block_table.long(), 1, slot)
    return page * page_size + positions.long() % page_size


def paged_write(arena, block_table, positions, values, valid,
                trash_page: int):
    """Write ``values`` (B, L, ...) into ``arena`` (N+1, page_size, ...) at
    per-row ``positions`` (B, L); rows where ``valid`` is False land on the
    trash page. Updates ``arena`` in place and returns it (live sequences
    own disjoint pages, so live rows never collide; trash collisions are
    harmless)."""
    n1, page_size = arena.shape[0], arena.shape[1]
    flat = flat_slot_index(block_table, positions, page_size)
    flat = torch.where(valid, flat, trash_page * page_size)
    flat_arena = arena.view((n1 * page_size,) + tuple(arena.shape[2:]))
    flat_arena.index_copy_(
        0, flat.reshape(-1),
        values.reshape((-1,) + tuple(values.shape[2:])).to(arena.dtype))
    return arena


def gather_pages(arena, block_table):
    """Block table (B, P) -> (B, P * page_size, ...): each sequence's cache
    as one contiguous tensor."""
    g = arena[block_table.long()]                # (B, P, page_size, ...)
    b, p, s = g.shape[:3]
    return g.reshape((b, p * s) + tuple(g.shape[3:]))


# ---------------------------------------------------------------------------
# sp-sharded arenas (engine.kv_cache sharded pool)
# ---------------------------------------------------------------------------

def sp_axis(mesh):
    """The ``sp`` axis of ``mesh`` (a ``parallel.mesh.Mesh``); a mesh
    without it raises naming the axis."""
    shape = getattr(mesh, "shape", None)
    if not isinstance(shape, dict) or SP_AXIS not in shape:
        raise ValueError(f"an sp-sharded pool needs a mesh with the "
                         f"{SP_AXIS!r} axis (got {mesh!r})")
    return mesh.axis(SP_AXIS)


def _sp_local_bt(block_table, rows_local: int, me: int):
    """Flat rows -> (owner rank, this rank's local rows); foreign rows go
    to the LOCAL trash row (rows_local - 1), their owner serves them."""
    bt = block_table.long()
    owner = bt // rows_local
    local = torch.where(owner == me, bt % rows_local, rows_local - 1)
    return owner, local


def sp_gather_many(arenas, block_table, mesh):
    """:func:`gather_pages` of each of ``arenas`` (one rank's blocks, all
    of one page geometry) over an sp-sharded pool: each rank gathers the
    pages it owns, foreign ones masked to exact zeros, and one
    ``sum_bytes`` over ``sp`` gives every rank the whole views. Bit-exact:
    every page has one owner."""
    from tpu_dist_torch.parallel.collectives import sum_bytes

    ax = sp_axis(mesh)
    rows_local, page_size = arenas[0].shape[:2]
    owner, local = _sp_local_bt(block_table, rows_local, ax.index)
    foreign = (owner != ax.index).repeat_interleave(page_size, dim=1)
    views = []
    for arena in arenas:
        g = gather_pages(arena, local)               # (B, P*ps, ...)
        views.append(g.masked_fill(
            foreign.view(foreign.shape + (1,) * (g.dim() - 2)), 0))
    return sum_bytes(views, ax.group)


def sp_gather_pages(arena, block_table, mesh):
    """:func:`gather_pages` over an sp-sharded arena (one sum)."""
    return sp_gather_many([arena], block_table, mesh)[0]


def sp_paged_write(arena, block_table, positions, values, valid, mesh):
    """:func:`paged_write` over an sp-sharded arena: every rank holds the
    (replicated) values and writes exactly the rows whose page it owns;
    foreign and masked rows land on its local trash row. No
    communication: ownership is a function of the flat row."""
    rows_local = arena.shape[0]
    _, local = _sp_local_bt(block_table, rows_local, sp_axis(mesh).index)
    return paged_write(arena, local, positions, values, valid,
                       rows_local - 1)


def cow_fork_pages(layers, src_pages, dst_pages):
    """Copy-on-write fork: ``arena[dst] <- arena[src]`` for every arena of
    every layer (K, V and int8 scales), in place. ``index_select`` copies
    the sources first, so overlapping lists are safe."""
    src = torch.as_tensor(src_pages, dtype=torch.long)
    dst = torch.as_tensor(dst_pages, dtype=torch.long)
    for layer in layers:
        for arena in layer.arenas():
            s, d = src.to(arena.device), dst.to(arena.device)
            arena.index_copy_(0, d, arena.index_select(0, s))
    return tuple(layers)


# ---------------------------------------------------------------------------
# exact read path (per-row positions)
# ---------------------------------------------------------------------------

def masked_attention(q, k, v, q_positions):
    """``full_attention`` with a per-row causal horizon: row ``b`` of ``q``
    (B, Lq, H, D) sits at position ``q_positions[b]`` (+ the local offset)
    and attends to keys ``kpos <= qpos``; fp32 scores (the product ``full_attention``
    takes) and softmax."""
    d = q.shape[-1]
    scores = matmul_f32(q.transpose(1, 2),
                        k.transpose(1, 2).mT) / math.sqrt(d)
    qpos = (q_positions.long()[:, None]
            + torch.arange(q.shape[1], device=q.device)[None, :])  # (B, Lq)
    kpos = torch.arange(k.shape[1], device=q.device)                # (Lk,)
    mask = kpos[None, None, :] <= qpos[:, :, None]           # (B, Lq, Lk)
    scores = scores.masked_fill(~mask[:, None, :, :], float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


# ---------------------------------------------------------------------------
# int8-KV paged decode (per-row length mask): kernel 2
# ---------------------------------------------------------------------------

@kernels.plain_version
def paged_decode_plain(q, kq, ks, vq, vs, lengths):
    """The kernel's function in plain PyTorch: dequantize the gathered
    int8 K/V to fp32, mask keys at ``kpos >= lengths[b]``, fp32 softmax
    with the ``NEG_INF`` / ``p = 0`` rules; output in q's dtype."""
    d = q.shape[-1]
    kf = kq.float() * ks[..., None]
    vf = vq.float() * vs[..., None]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(d))
    kpos = torch.arange(kq.shape[1], device=q.device)
    live = kpos[None, None, None, :] < lengths.long()[:, None, None, None]
    o, _, _ = masked_softmax_pv(torch.where(live, s, NEG_INF),
                                vf.transpose(1, 2))          # (B, H, 1, D)
    return o.transpose(1, 2).to(q.dtype).contiguous()


@kernels.plain_version
def paged_decode_blocks_plain(q, layer, block_tables, lengths):
    """The block-table kernel's function in plain PyTorch: each row's
    pages gathered (:func:`gather_pages`), then :func:`paged_decode_plain`.
    For tests and CPU tensors."""
    g = lambda arena: gather_pages(arena, block_tables)
    return paged_decode_plain(q, g(layer.k), g(layer.k_scale), g(layer.v),
                              g(layer.v_scale), lengths)


# key positions per split block (csrc/paged_decode.cu SPLIT): the launch
# has ceil(P * page_size / PAGED_SPLIT) x B x H split blocks
PAGED_SPLIT = 128


def _check_blocks(q, k, ks, v, vs, block_tables, lengths):
    dev = q.device
    ts = (q, k, ks, v, vs, block_tables, lengths)
    if not (q.is_cuda and all(t.device == dev for t in ts)):
        raise ValueError("paged decode kernel: all inputs on one CUDA device")
    if q.dtype not in kernels.DTYPE_CODE:
        raise TypeError(f"paged decode kernel: q float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != torch.int8 or v.dtype != torch.int8 \
            or ks.dtype != torch.float32 or vs.dtype != torch.float32 \
            or block_tables.dtype != torch.int32 \
            or lengths.dtype != torch.int32:
        raise TypeError("paged decode kernel: int8 K/V, float32 scales, "
                        "int32 block tables and lengths")
    b, lq, h, d = q.shape
    if lq != 1:
        raise ValueError(f"paged decode kernel is one query per row "
                         f"(got Lq={lq})")
    n1, page_size = k.shape[:2]
    if k.shape != (n1, page_size, h, d) or v.shape != k.shape \
            or ks.shape != (n1, page_size, h) or vs.shape != ks.shape \
            or block_tables.dim() != 2 or block_tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError(f"paged decode kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, scale {tuple(ks.shape)}, "
                         f"block tables {tuple(block_tables.shape)}, "
                         f"lengths {tuple(lengths.shape)} do not agree")
    kernels.check_head_dim("paged decode kernel", d)
    if min(b, h, n1, page_size, block_tables.shape[1]) < 1:
        raise ValueError("paged decode kernel: empty input")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged decode kernel: inputs must be contiguous")


# tdt_paged_decode(q, k, ks, v, vs, block_tables, lengths, part_ml,
#                  part_acc, out, B, H, D, P, page_size, n_splits, scale,
#                  dtype, stream)
_PAGED_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _launch_blocks(fn, q, k, ks, v, vs, block_tables, lengths, stream):
    """Call the C entry ``fn`` (``tdt_paged_decode``) on checked tensors:
    allocate the output and the split partials, launch the split and the
    merge kernel on ``stream``, raise on a launch error."""
    b, _, h, d = q.shape
    p, page_size = block_tables.shape[1], k.shape[1]
    n_splits = -(-p * page_size // PAGED_SPLIT)
    out = torch.empty_like(q)
    part_ml = torch.empty((b, h, n_splits, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b, h, n_splits, d), dtype=torch.float32,
                           device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(),
             vs.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
             part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(), b, h,
             d, p, page_size, n_splits, 1.0 / math.sqrt(d),
             kernels.DTYPE_CODE[q.dtype], stream)
    if err == -2:
        raise ValueError(f"paged decode kernel: {b} x {h} (b, h) rows or "
                         f"{p} x {page_size} key positions out of range")
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed "
                           f"(cudaError {err})")
    return out


def _row_pages(q):
    """The block table of the gathered layout: (B, Lk, H, D) K/V seen as B
    pages of ``page_size = Lk``, row b on page b."""
    return torch.arange(q.shape[0], dtype=torch.int32,
                        device=q.device).view(-1, 1)


def _launch(fn, q, kq, ks, vq, vs, lengths, stream):
    """The gathered layout through ``fn`` (:func:`_launch_blocks`)."""
    return _launch_blocks(fn, q, kq, ks, vq, vs, _row_pages(q), lengths,
                          stream)


def _run(q, k, ks, v, vs, block_tables, lengths):
    _check_blocks(q, k, ks, v, vs, block_tables, lengths)
    fn = kernels.function("paged_decode", "tdt_paged_decode", _PAGED_ARGS)
    with torch.cuda.device(q.device):
        out = _launch_blocks(fn, q, k, ks, v, vs, block_tables, lengths,
                             torch.cuda.current_stream(q.device).cuda_stream)
    kernels.LAUNCHES["paged_decode"] += 1
    return out


def paged_decode_blocks_cuda(q, layer, block_tables, lengths):
    """Launch ``csrc/paged_decode.cu`` on the current stream over the
    int8 arenas of ``layer`` read through ``block_tables`` (B, P) int32:
    only the keys below ``lengths[b]`` are read. One call is two kernel
    launches (split, merge) and one count in
    ``kernels.LAUNCHES["paged_decode"]``."""
    return _run(q, layer.k, layer.k_scale, layer.v, layer.v_scale,
                block_tables, lengths)


def paged_decode_blocks(q, layer, block_tables, lengths):
    """The decode tick's attention over ``layer``'s int8 pages: the kernel
    for CUDA tensors, :func:`paged_decode_blocks_plain` for CPU tensors."""
    if q.device.type == "cpu":
        return paged_decode_blocks_plain(q, layer, block_tables, lengths)
    return paged_decode_blocks_cuda(
        q, layer, block_tables.to(torch.int32).contiguous(),
        lengths.to(torch.int32).contiguous())


def paged_decode_cuda(q, kq, ks, vq, vs, lengths):
    """Launch ``csrc/paged_decode.cu`` on the current stream over gathered
    (B, Lk, H, D) int8 K/V, seen as B pages of ``page_size = Lk`` (two
    kernel launches, one count)."""
    if kq.dim() != 4 or kq.shape[0] != q.shape[0]:
        raise ValueError(f"paged decode kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(kq.shape)} do not agree")
    return _run(q, kq, ks, vq, vs, _row_pages(q), lengths)


@functools.lru_cache(maxsize=None)
def int8kv_paged_flash_attention_fn(block_k: int = 512):
    """Returns ``attn(q, kq, ks, vq, vs, lengths)`` over gathered int8 KV
    pages: ``q`` (B, 1, H, D), ``kq``/``vq`` (B, L, H, D) int8 with
    per-(b, l, h) fp32 scales, ``lengths`` (B,) live tokens per row (keys
    at ``kpos >= length`` are masked -- the causal mask when ``length =
    position + 1``). The kernel for CUDA tensors, the plain version for CPU
    tensors. ``block_k`` is the TPU tile knob; the Hopper kernel does not
    read it."""

    def attn(q, kq, ks, vq, vs, lengths):
        if q.device.type == "cpu":
            if q.shape[1] != 1:
                raise ValueError(f"paged decode kernel is one query per row "
                                 f"(got Lq={q.shape[1]})")
            return paged_decode_plain(q, kq, ks, vq, vs, lengths)
        return paged_decode_cuda(q, kq, ks, vq, vs,
                                 lengths.to(torch.int32).contiguous())

    return attn


# ---------------------------------------------------------------------------
# the attend_maybe_cached delegate
# ---------------------------------------------------------------------------

def _quantize_rows(x):
    """(B, L, H, D) -> int8 values + per-(b, l, h) fp32 scales."""
    q, scale = quantize_int8(x, (-1,))
    return q, scale[..., 0]


def paged_attend(q, k, v, paged: dict, *, prefill: bool, attn_fn, dtype):
    """One layer's paged-cache attention step (the reference's contract):
    ``paged`` carries ``{"layer": PagedLayer, "block_tables": (B, P),
    "positions": (B,), "lengths": (B,)}``, an optional ``"valid"`` (B, Lq)
    write mask, an optional ``"sp_mesh"`` (a ``parallel.mesh.Mesh`` with
    the ``sp`` axis: the arenas are this rank's blocks of a sharded pool,
    the block tables hold flat rows, and writes and reads go through
    :func:`sp_paged_write` and :func:`sp_gather_many`) and an optional
    ``"attn_fn"`` that replaces the model's for the prefill (the sp
    prefill's ring attention). Prefill attends within the prompt through
    the model's ``attn_fn`` and writes the live rows; a tick writes Lq
    rows at ``positions[b]..`` and attends each query at its own position
    (Lq = 1 with int8 pages and ``read="flash"`` goes through the paged
    decode kernel). Returns ``(out, layer)``; the arenas were updated in
    place."""
    layer = paged["layer"]
    bt = paged["block_tables"]
    positions = paged["positions"]
    lengths = paged["lengths"]
    sp_mesh = paged.get("sp_mesh")               # None = unsharded arenas
    if sp_mesh is not None:
        sp_axis(sp_mesh)
    trash = layer.num_pages

    b, lq = q.shape[0], q.shape[1]
    write_pos = (positions[:, None].long()
                 + torch.arange(lq, device=q.device)[None, :])   # (B, Lq)
    if prefill:
        valid = write_pos < lengths.long()[:, None]
    else:
        valid = torch.ones((b, lq), dtype=torch.bool, device=q.device)
    if paged.get("valid") is not None:
        valid = valid & paged["valid"]

    if sp_mesh is None:
        def write(arena, vals):
            return paged_write(arena, bt, write_pos, vals, valid, trash)

        def read(*arenas):
            return [gather_pages(a, bt) for a in arenas]
    else:
        def write(arena, vals):
            return sp_paged_write(arena, bt, write_pos, vals, valid,
                                  sp_mesh)

        def read(*arenas):
            return sp_gather_many(arenas, bt, sp_mesh)

    if layer.quant == "int8":
        kq, ks = _quantize_rows(k)
        vq, vs = _quantize_rows(v)
        write(layer.k, kq)
        write(layer.v, vq)
        write(layer.k_scale, ks)
        write(layer.v_scale, vs)
    else:
        write(layer.k, k)
        write(layer.v, v)

    if prefill:
        # causal self-attention over the prompt itself: the model's attn_fn
        return (paged.get("attn_fn") or attn_fn)(q, k, v), layer

    if layer.quant == "int8" and layer.read == "flash" and lq == 1:
        if sp_mesh is None:
            # the pages are read through the block table: no gathered copy
            out = paged_decode_blocks(q.contiguous(), layer, bt,
                                      positions + 1)
        else:
            # the sum gives every rank the gathered view: the same kernel
            # through its contiguous entry, as the reference composes its
            # kernel over sp_gather_pages
            gk, gks, gv, gvs = read(layer.k, layer.k_scale, layer.v,
                                    layer.v_scale)
            out = int8kv_paged_flash_attention_fn()(
                q.contiguous(), gk, gks, gv, gvs, positions + 1)
        return out.to(q.dtype), layer

    if layer.quant == "int8":
        gk, gks, gv, gvs = read(layer.k, layer.k_scale, layer.v,
                                layer.v_scale)
        gk = (gk.float() * gks[..., None]).to(dtype)
        gv = (gv.float() * gvs[..., None]).to(dtype)
    else:
        gk, gv = read(layer.k, layer.v)
    return masked_attention(q, gk, gv, positions), layer
