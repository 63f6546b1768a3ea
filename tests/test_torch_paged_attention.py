"""Port paged-KV primitives (tpu_dist_torch.ops.paged_attention) against the
reference (tpu_dist.ops.paged_attention): the scatter/gather/fork array
ops and the exact read path match exactly in fp32, and kernel 2's plain
version matches the Pallas paged decode kernel (interpret mode off-TPU)
at ragged lengths within 2e-5: over gathered pages, through a shuffled
block table, and inside ``paged_attend``'s int8 flash tick, where the
emulated kernel source (``tools/cuda_emu.py``) runs too and the tick
gathers no page."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.ops import paged_attention as jpa  # noqa: E402
from tpu_dist_torch.ops import paged_attention as tpa  # noqa: E402

torch.set_num_threads(1)

N, PS, H, D = 6, 4, 2, 8          # pages (+1 trash), page size, heads, dim


def _arena(rng, *tail):
    return rng.standard_normal((N + 1, PS) + tail).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_paged_write_and_gather_match_exactly():
    rng = np.random.default_rng(0)
    arena = _arena(rng, H, D)
    bt = np.array([[3, 1, 5], [0, 2, N]], np.int32)
    pos = np.array([[2, 3, 4, 5, 6], [0, 1, 2, 3, 4]], np.int32)
    vals = rng.standard_normal((2, 5, H, D)).astype(np.float32)
    valid = np.array([[1, 1, 1, 0, 1], [1, 1, 1, 1, 0]], bool)
    ja = jpa.paged_write(jnp.asarray(arena), jnp.asarray(bt),
                         jnp.asarray(pos), jnp.asarray(vals),
                         jnp.asarray(valid), N)
    ta = tpa.paged_write(_t(arena), _t(bt), _t(pos), _t(vals), _t(valid), N)
    live = np.ones(N + 1, bool)
    live[N] = False                        # trash page contents: unspecified
    np.testing.assert_array_equal(np.asarray(ja)[live], ta.numpy()[live])
    np.testing.assert_array_equal(np.asarray(jpa.gather_pages(ja, bt)),
                                  tpa.gather_pages(ta, _t(bt)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jpa.flat_slot_index(jnp.asarray(bt), jnp.asarray(pos),
                                       PS)),
        tpa.flat_slot_index(_t(bt), _t(pos), PS).numpy())


def test_cow_fork_pages_matches_exactly():
    rng = np.random.default_rng(1)
    k, v = _arena(rng, H, D), _arena(rng, H, D)
    ks, vs = _arena(rng, H), _arena(rng, H)
    src, dst = np.array([1, 4], np.int32), np.array([2, 0], np.int32)
    (jl,) = jpa.cow_fork_pages(
        (jpa.PagedLayer(*map(jnp.asarray, (k, v, ks, vs)), quant="int8"),),
        jnp.asarray(src), jnp.asarray(dst))
    (tl,) = tpa.cow_fork_pages(
        (tpa.PagedLayer(*map(_t, (k, v, ks, vs)), quant="int8"),), src, dst)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(np.asarray(getattr(jl, name)),
                                      getattr(tl, name).numpy())


def test_masked_attention_matches_exactly():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 2, H, D)).astype(np.float32)
    k = rng.standard_normal((3, 12, H, D)).astype(np.float32)
    v = rng.standard_normal((3, 12, H, D)).astype(np.float32)
    pos = np.array([0, 5, 10], np.int32)
    jo = jpa.masked_attention(*map(jnp.asarray, (q, k, v, pos)))
    to = tpa.masked_attention(*map(_t, (q, k, v, pos)))
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("lengths", [[1, 17, 32], [32, 0, 9]])
def test_plain_paged_decode_matches_pallas_kernel(lengths):
    rng = np.random.default_rng(sum(lengths))
    b, lk = 3, 32
    q = rng.standard_normal((b, 1, H, D)).astype(np.float32)
    kq = rng.integers(-127, 128, (b, lk, H, D)).astype(np.int8)
    vq = rng.integers(-127, 128, (b, lk, H, D)).astype(np.int8)
    ks = (rng.random((b, lk, H)) * 0.05).astype(np.float32)
    vs = (rng.random((b, lk, H)) * 0.05).astype(np.float32)
    lens = np.array(lengths, np.int32)
    jo = jpa.int8kv_paged_flash_attention_fn(block_k=8)(
        *map(jnp.asarray, (q, kq, ks, vq, vs, lens)))
    to = tpa.int8kv_paged_flash_attention_fn()(
        *map(_t, (q, kq, ks, vq, vs, lens)))
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=2e-5,
                               atol=2e-5)
    dead = lens == 0
    assert np.all(to.numpy()[dead] == 0) and np.all(np.asarray(jo)[dead] == 0)


@pytest.mark.parametrize("quant,read,prefill", [
    ("none", "exact", True), ("none", "exact", False),
    ("int8", "exact", False), ("int8", "flash", False)])
def test_paged_attend_matches_reference(quant, read, prefill):
    rng = np.random.default_rng(3)
    b, lq = 2, (5 if prefill else 1)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = mk(b, lq, H, D), mk(b, lq, H, D), mk(b, lq, H, D)
    arenas = [mk(N + 1, PS, H, D), mk(N + 1, PS, H, D)]
    if quant == "int8":
        arenas = [np.clip(a * 20, -127, 127).astype(np.int8)
                  for a in arenas]
        arenas += [np.abs(mk(N + 1, PS, H)) * 0.05 for _ in range(2)]
    bt = np.array([[0, 3], [4, 1]], np.int32)
    pos = np.array([0, 0] if prefill else [3, 6], np.int32)
    lens = np.array([5, 3] if prefill else [4, 7], np.int32)
    full = lambda q_, k_, v_: jpa.masked_attention(
        q_, k_, v_, jnp.zeros((q_.shape[0],), jnp.int32))
    jl = jpa.PagedLayer(*map(jnp.asarray, arenas), quant=quant, read=read)
    jo, jl = jpa.paged_attend(
        *map(jnp.asarray, (q, k, v)),
        {"layer": jl, "block_tables": jnp.asarray(bt),
         "positions": jnp.asarray(pos), "lengths": jnp.asarray(lens)},
        prefill=prefill, attn_fn=full, dtype=jnp.float32)
    tfull = lambda q_, k_, v_: tpa.masked_attention(
        q_, k_, v_, torch.zeros((q_.shape[0],), dtype=torch.int32))
    tl = tpa.PagedLayer(*map(_t, arenas), quant=quant, read=read)
    to, tl = tpa.paged_attend(
        *map(_t, (q, k, v)),
        {"layer": tl, "block_tables": _t(bt), "positions": _t(pos),
         "lengths": _t(lens)},
        prefill=prefill, attn_fn=tfull, dtype=torch.float32)
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=2e-5,
                               atol=2e-5)
    live = np.ones(N + 1, bool)
    live[N] = False
    for name in ("k", "v", "k_scale", "v_scale"):
        ja = getattr(jl, name)
        if ja is not None:
            np.testing.assert_array_equal(np.asarray(ja)[live],
                                          getattr(tl, name).numpy()[live])


# the int8 flash tick through a shuffled table: page_size 4, 34 pages a row
# (136 positions, two 128-key splits), lengths = positions + 1 at 1, a
# page, a page + 1, a split boundary -1 / 0 / +1 and the full table
TICK_LENGTHS = (1, 4, 5, 127, 128, 129, 136)
TICK_PS, TICK_PAGES, TICK_H, TICK_D = 4, 34, 2, 64


def _emulated_tick(monkeypatch):
    """Route the CPU tick's attention through the kernel source built by
    the CUDA emulation (g++), and make any gather_pages call raise."""
    import shutil

    if not (shutil.which("g++") or shutil.which("clang++")):
        pytest.skip("no host C++ compiler for the CUDA emulation")
    from tpu_dist_torch.tools import cuda_emu

    fn = cuda_emu.function("paged_decode", "tdt_paged_decode",
                           tpa._PAGED_ARGS)

    def kernel(q, layer, bt, lengths):
        return tpa._launch_blocks(fn, q, layer.k, layer.k_scale, layer.v,
                                  layer.v_scale, bt, lengths, None)

    def no_gather(*args):
        raise AssertionError("the int8 flash tick gathered pages")

    monkeypatch.setattr(tpa, "paged_decode_blocks_plain", kernel)
    monkeypatch.setattr(tpa, "gather_pages", no_gather)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_paged_attend_int8_flash_tick_matches_reference(route, monkeypatch):
    """``paged_attend(int8, flash)``'s tick against the reference's (its
    Pallas kernel in interpret mode over gathered pages) within 2e-5:
    "plain" is the CPU dispatch (:func:`paged_decode_blocks_plain`),
    "kernel" the emulated ``csrc/paged_decode.cu`` reading the arenas
    through the table, with :func:`gather_pages` made to raise, which pins
    that the tick copies no page."""
    rng = np.random.default_rng(11)
    b = len(TICK_LENGTHS)
    n = b * TICK_PAGES + 3                     # 3 unowned pages
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = (mk(b, 1, TICK_H, TICK_D) for _ in range(3))
    arenas = [np.clip(mk(n + 1, TICK_PS, TICK_H, TICK_D) * 40, -127,
                      127).astype(np.int8) for _ in range(2)]
    arenas += [np.abs(mk(n + 1, TICK_PS, TICK_H)) * 0.05 for _ in range(2)]
    bt = rng.permutation(n)[:b * TICK_PAGES].reshape(b, TICK_PAGES)
    bt = bt.astype(np.int32)
    pos = np.array(TICK_LENGTHS, np.int32) - 1
    jl = jpa.PagedLayer(*map(jnp.asarray, arenas), quant="int8",
                        read="flash")
    jo, _ = jpa.paged_attend(
        *map(jnp.asarray, (q, k, v)),
        {"layer": jl, "block_tables": jnp.asarray(bt),
         "positions": jnp.asarray(pos), "lengths": jnp.asarray(pos + 1)},
        prefill=False, attn_fn=None, dtype=jnp.float32)
    if route == "kernel":
        _emulated_tick(monkeypatch)
    tl = tpa.PagedLayer(*map(_t, arenas), quant="int8", read="flash")
    to, _ = tpa.paged_attend(
        *map(_t, (q, k, v)),
        {"layer": tl, "block_tables": _t(bt), "positions": _t(pos),
         "lengths": _t(pos + 1)},
        prefill=False, attn_fn=None, dtype=torch.float32)
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_block_table_decode_matches_pallas_kernel(dtype):
    """``paged_decode_blocks`` (the tick's attention, CPU dispatch) over a
    shuffled table against the reference's Pallas kernel over the same
    pages gathered, with length 0 beside the tick's lengths: within 2e-5
    (fp32 q); with a bf16 q both round the same fp32 sums to bf16, so
    within one bf16 ulp (2^-7 relative at most) plus 2e-5. Length 0 gives
    exact zeros on both sides."""
    rng = np.random.default_rng(12)
    lengths = np.array((0,) + TICK_LENGTHS, np.int32)
    b = len(lengths)
    n = b * TICK_PAGES + 2
    q = rng.standard_normal((b, 1, TICK_H, TICK_D)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (n + 1, TICK_PS, TICK_H, TICK_D))
              .astype(np.int8) for _ in range(2))
    ks, vs = ((rng.random((n + 1, TICK_PS, TICK_H)) * 0.05)
              .astype(np.float32) for _ in range(2))
    bt = rng.permutation(n)[:b * TICK_PAGES].reshape(b, TICK_PAGES)
    bt = bt.astype(np.int32)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    g = lambda a: jpa.gather_pages(jnp.asarray(a), jnp.asarray(bt))
    jo = jpa.int8kv_paged_flash_attention_fn(block_k=8)(
        jnp.asarray(q, jdt), g(kq), g(ks), g(vq), g(vs),
        jnp.asarray(lengths))
    layer = tpa.PagedLayer(*map(_t, (kq, vq, ks, vs)), quant="int8",
                           read="flash")
    to = tpa.paged_decode_blocks(_t(q).to(tdt), layer, _t(bt), _t(lengths))
    assert to.dtype == tdt
    want = np.asarray(jo, np.float32)
    got = to.float().numpy()
    rtol = 2e-5 if dtype == "fp32" else 2.0 ** -7
    np.testing.assert_allclose(got, want, rtol=rtol, atol=2e-5)
    assert np.all(got[0] == 0) and np.all(want[0] == 0)


def test_sp_mesh_is_refused():
    """An ``sp_mesh`` without the ``sp`` axis is refused, naming the axis
    (the sharded pool itself: tests/test_torch_sp_serve.py)."""
    layer = tpa.PagedLayer(torch.zeros(N + 1, PS, H, D),
                           torch.zeros(N + 1, PS, H, D))
    x = torch.zeros(1, 1, H, D)
    with pytest.raises(ValueError, match="'sp' axis"):
        tpa.paged_attend(x, x, x, {"layer": layer, "sp_mesh": object(),
                                   "block_tables": None, "positions": None,
                                   "lengths": None},
                         prefill=False, attn_fn=None, dtype=torch.float32)
