"""The int8 matmul and optimizer kernel sources on the CPU:
``fused_quant.cu``, ``adamw.cu`` and ``sgd.cu`` compiled by the host C++
compiler against the emulation of ``tpu_dist_torch/tools/cuda_emu.py`` (a
fiber per CUDA thread) and driven through the wrappers' own launch code
with CPU tensors, against the plain versions. The AdamW and SGD kernels
within 1e-6 * (1 + |plain|) (fp32, the same operations; a bf16 p rounds
once, from the same fp32 value). The fused int8 matmul bit-equal (int32
sums are exact, the scales and the dequant the same fp32 operations).
Also the kernel library's name, which covers the headers a source
includes."""

import os
import shutil

import pytest
import torch

from tpu_dist_torch import kernels
from tpu_dist_torch.ops import pallas_adamw as adamw
from tpu_dist_torch.ops import pallas_quant as pq
from tpu_dist_torch.ops import pallas_sgd as sgd
from tpu_dist_torch.tools import cuda_emu

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emu():
    if not (shutil.which("g++") or shutil.which("clang++")):
        pytest.skip("no host C++ compiler for the CUDA emulation")
    return cuda_emu.entries("adamw", "sgd", "quant", "quant_ws", "quant_amax",
                            "quant_scaled", "quant_tiles")


def test_kernel_library_name_covers_included_headers(tmp_path, monkeypatch):
    headers = ("head_dim.cuh", "warp_mma.cuh")
    for f in ("flash_bwd_dq.cu", *headers):
        shutil.copy(os.path.join(kernels.CSRC, f), tmp_path / f)
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path))
    assert kernels.source_files("flash_bwd_dq") == [
        str(tmp_path / f) for f in ("flash_bwd_dq.cu", *headers)]
    for header in headers:
        before = kernels._lib_path("flash_bwd_dq")
        with open(tmp_path / header, "a") as f:
            f.write("// edited\n")
        assert kernels._lib_path("flash_bwd_dq") != before


@pytest.mark.parametrize("dtype,n", [(torch.float32, 1000),
                                     (torch.bfloat16, 777)], ids=str)
def test_adamw_kernel_source_matches_plain(emu, dtype, n):
    gen = torch.Generator().manual_seed(n)
    p = torch.randn(n, generator=gen).to(dtype)
    g = torch.randn(n, generator=gen)
    m = torch.randn(n, generator=gen) * 0.1
    v = torch.rand(n, generator=gen) * 0.1
    row = adamw.scalar_row(1e-3, 0.9, 0.95, 1e-8, 0.1, 3, torch.tensor(0.5))
    ref = [t.clone() for t in (p, m, v)]
    sgd.launch_groups(emu["adamw"], "adamw", ([p], [g], [m], [v]), row, None)
    adamw.fused_adamw_plain(ref[0], g, ref[1], ref[2], row)
    assert p.dtype == dtype
    for a, r in zip((p, m, v), ref):
        diff = (a.float() - r.float()).abs()
        assert bool((diff <= 1e-6 * (1 + r.float().abs())).all())


@pytest.mark.parametrize("dtype,n,offset", [
    (torch.float32, 1001, 0),     # 4-wide body and a ragged tail
    (torch.bfloat16, 777, 0),
    (torch.float32, 300, 1),      # unaligned: element by element
    (torch.bfloat16, 45, 3),
], ids=str)
def test_sgd_kernel_source_matches_plain(emu, dtype, n, offset):
    gen = torch.Generator().manual_seed(n + offset)
    buf = torch.randn(n + offset, generator=gen).to(dtype)
    p = buf[offset:]                       # contiguous, shifted start
    g = torch.randn(n, generator=gen)
    m = torch.randn(n, generator=gen) * 0.1
    row = sgd.scalar_row(0.1, 0.9, 1e-4, torch.tensor(0.3))
    ref = [p.clone(), m.clone()]
    sgd.launch_groups(emu["sgd"], "sgd", ([p], [g], [m]), row, None)
    sgd.fused_sgd_plain(ref[0], g, ref[1], row)
    assert p.dtype == dtype
    for a, r in zip((p, m), ref):
        diff = (a.float() - r.float()).abs()
        assert bool((diff <= 1e-6 * (1 + r.float().abs())).all())


# leaf sizes of the multi-leaf table, cycled: empty, ragged, a BatchNorm
# vector, one element past a 4096-element chunk, several chunks
SGD_SIZES = (0, 1, 3, 5, 64, 4097, 70_000)


@pytest.mark.parametrize("dtypes", [
    (torch.float32,), (torch.bfloat16,),
    (torch.float32, torch.bfloat16),    # two groups: one call each
], ids=str)
def test_sgd_multi_leaf_kernel_source_matches_plain(emu, dtypes):
    """About 200 leaves through the multi-leaf wrapper's grouping: one C
    call per p dtype, each with more rows than the 4 KB parameter space
    holds (the emulation builds the 96-leaf capacity of toolkits before
    CUDA 12.1, so a table goes out in two or three launches), sizes
    cycling through SGD_SIZES, every seventh leaf a view at an odd element
    offset (the element-by-element path). Each leaf within 1e-6 (1 +
    |plain|) of fused_sgd_plain, as the one-leaf case."""
    gen = torch.Generator().manual_seed(200)
    ps, gs, ms = [], [], []
    for i in range(203 * len(dtypes)):
        n = SGD_SIZES[i % len(SGD_SIZES)]
        if n > 4097 and i > 7:      # keep the emulated grid small
            n = 300
        off = 1 + i % 3 if i % 7 == 3 else 0
        dtype = dtypes[i % len(dtypes)]
        ps.append(torch.randn(n + off, generator=gen).to(dtype)[off:])
        gs.append(torch.randn(n, generator=gen))
        ms.append(torch.randn(n, generator=gen) * 0.1)
    row = sgd.scalar_row(0.1, 0.9, 1e-4, torch.tensor(0.3))
    ref = [[p.clone() for p in ps], [m.clone() for m in ms]]
    calls = sgd.launch_groups(emu["sgd"], "sgd", (ps, gs, ms), row, None)
    assert calls == len(dtypes)
    for i in range(len(ps)):
        sgd.fused_sgd_plain(ref[0][i], gs[i], ref[1][i], row)
        for a, r in ((ps[i], ref[0][i]), (ms[i], ref[1][i])):
            assert a.dtype == r.dtype
            diff = (a.float() - r.float()).abs()
            assert bool((diff <= 1e-6 * (1 + r.float().abs())).all()), i


@pytest.mark.parametrize("dtypes", [
    (torch.float32,), (torch.bfloat16,),
    (torch.float32, torch.bfloat16),    # two groups: one call each
], ids=str)
def test_adamw_multi_leaf_kernel_source_matches_plain(emu, dtypes):
    """About 200 leaves through the multi-leaf wrapper's grouping: one C
    call per p dtype, each with more rows than the 4 KB parameter space
    holds (the emulation builds the 92-leaf capacity of toolkits before
    CUDA 12.1, so a table goes out in two or three launches), sizes
    cycling through SGD_SIZES, every seventh leaf a view at an odd element
    offset (the element-by-element path). Each leaf within 1e-6 (1 +
    |plain|) of fused_adamw_plain, as the one-leaf case."""
    gen = torch.Generator().manual_seed(201)
    leaves = []
    for i in range(203 * len(dtypes)):
        n = SGD_SIZES[i % len(SGD_SIZES)]
        if n > 4097 and i > 7:      # keep the emulated grid small
            n = 300
        off = 1 + i % 3 if i % 7 == 3 else 0
        dtype = dtypes[i % len(dtypes)]
        leaves.append((torch.randn(n + off, generator=gen).to(dtype)[off:],
                       torch.randn(n, generator=gen),
                       torch.randn(n, generator=gen) * 0.1,
                       torch.rand(n, generator=gen) * 0.1))
    ps, gs, ms, vs = (list(t) for t in zip(*leaves))
    row = adamw.scalar_row(1e-3, 0.9, 0.95, 1e-8, 0.1, 3, torch.tensor(0.5))
    ref = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    calls = sgd.launch_groups(emu["adamw"], "adamw", (ps, gs, ms, vs), row,
                              None)
    assert calls == len(dtypes)
    for i in range(len(ps)):
        adamw.fused_adamw_plain(ref[0][i], gs[i], ref[1][i], ref[2][i], row)
        for a, r in zip((ps[i], ms[i], vs[i]), (ref[0][i], ref[1][i],
                                                 ref[2][i])):
            assert a.dtype == r.dtype
            diff = (a.float() - r.float()).abs()
            assert bool((diff <= 1e-6 * (1 + r.float().abs())).all()), i


TIE_AMAX, TIE_HALF = 0.84375, 0.421875   # exact in bf16 too


def plant_ties(x, w):
    """Row 0 of x and column 0 of w get amax 0.84375 and an element of
    half that: its quotient by the scale is exactly +-63.5 (rint: +-64),
    where the product with the scale's reciprocal is 63.499996 (63).
    The other elements of that row and column stay below the amax."""
    s = torch.tensor(TIE_AMAX) / torch.tensor(127.0)
    assert torch.round(TIE_HALF * (torch.tensor(1.0) / s)) == 63
    assert torch.round(torch.tensor(TIE_HALF) / s) == 64
    x[0] = x[0].clamp(-0.8, 0.8)
    x[0, 0], x[0, -1] = TIE_AMAX, -TIE_HALF
    w[:, 0] = w[:, 0].clamp(-0.8, 0.8)
    w[0, 0], w[-1, 0] = -TIE_AMAX, TIE_HALF


@pytest.mark.parametrize("dtype,m,k,n", [
    (torch.float32, 8, 16, 8),        # a decode tick's M, one tile
    (torch.float32, 130, 70, 136),    # ragged M, N and K (K % 4 != 0)
    (torch.bfloat16, 24, 128, 72),    # two K chunks
    # M <= 16: the split-K decode kernel (w as the mma's A operand); K in
    # 128-deep stages, split while the grid is small (the emulation plans
    # for a card of one SM: 8 blocks)
    (torch.bfloat16, 8, 300, 72),     # 3 splits, ragged K (not % 32)
    (torch.float32, 8, 256, 64),      # 2 splits
    (torch.bfloat16, 13, 260, 40),    # two 8-row n-tiles, ragged M and N
    (torch.bfloat16, 8, 1100, 72),    # splits of 2, 2, 2, 2, 1 stages
    (torch.bfloat16, 8, 520, 520),    # one split of 5 stages
    # M > 16: x and w quantized once into the workspace, then the GEMM
    (torch.bfloat16, 70, 200, 136),   # ragged M, N and K
    (torch.float32, 64, 130, 72),
    (torch.bfloat16, 40, 520, 72),    # 5 stages through the GEMM's ring
], ids=str)
def test_fused_quant_kernel_source_matches_plain(emu, dtype, m, k, n):
    """Bit-equal to the plain version, with an all-zero row of x and an
    all-zero column of w giving exact zeros, and half-integer quotients
    that a reciprocal multiply rounds the other way (plant_ties)."""
    gen = torch.Generator().manual_seed(m + k + n)
    x = (torch.randn((m, k), generator=gen) * 2).to(dtype)
    w = torch.randn((k, n), generator=gen).to(dtype)
    plant_ties(x, w)
    x[1] = 0                                   # an all-zero row: exact zeros
    w[:, n - 2] = 0                            # an all-zero column
    out = pq._launch(emu["quant"], emu["quant_ws"], x, w, None)
    ref = pq.fused_quant_matmul_plain(x, w)
    assert out.dtype == dtype and torch.equal(out, ref)
    assert bool((out[1] == 0).all()) and bool((out[:, n - 2] == 0).all())


@pytest.mark.parametrize("dtype,m,k,n", [
    (torch.bfloat16, 8, 300, 72),     # the split-K decode path
    (torch.float32, 70, 130, 136),    # the GEMM path, ragged
], ids=str)
def test_fused_quant_scaled_pair_matches_plain(emu, dtype, m, k, n):
    """The scales and product phases apart (the row-parallel product under
    tensor parallelism): the maxima bit-equal to the plain version's;
    scaled by them, the product bit-equal to the one-call kernel; scaled by
    larger (a group's) maxima, bit-equal to its plain version."""
    gen = torch.Generator().manual_seed(m * k + n)
    x = (torch.randn((m, k), generator=gen) * 2).to(dtype)
    w = torch.randn((k, n), generator=gen).to(dtype)
    plant_ties(x, w)
    x[1] = 0
    xa, wa = pq._launch_amax(emu["quant_amax"], x, w, None)
    pxa, pwa = pq.fused_quant_amax_plain(x, w)
    assert torch.equal(xa, pxa) and torch.equal(wa, pwa)
    out = pq._launch(emu["quant_scaled"], emu["quant_ws"], x, w, None,
                     (xa, wa))
    assert torch.equal(out, pq.fused_quant_matmul_plain(x, w))
    gxa = xa * torch.linspace(1.0, 3.0, m)
    gwa = wa * torch.linspace(2.0, 1.0, n)
    out = pq._launch(emu["quant_scaled"], emu["quant_ws"], x, w, None,
                     (gxa, gwa))
    ref = pq.fused_quant_scaled_plain(x, w, gxa, gwa)
    assert out.dtype == dtype and torch.equal(out, ref)
    assert bool((out[1] == 0).all())


def test_fused_quant_instantiated_tiles_match_the_wrapper(emu):
    """The C side's list of compiled tiles (TDT_FQ_TILES) is the wrapper's
    INSTANTIATED_TILES; a tile the plan IR allows outside them, (8, 128,
    0), runs on the general instance, bit-equal to the plain version; a
    tile the IR refuses is refused by the IR before any launch."""
    from tpu_dist_torch.plan.ir import PlanError

    assert pq.kernel_tiles(emu["quant_tiles"]) == pq.INSTANTIATED_TILES
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((24, 128), generator=gen)
    w = torch.randn((128, 136), generator=gen)
    out = pq._launch(emu["quant"], emu["quant_ws"], x, w, None,
                     tile=(8, 128, 0))
    assert torch.equal(out, pq.fused_quant_matmul_plain(x, w))
    with pytest.raises(PlanError, match="quant_block bm=12"):
        pq._launch(emu["quant"], emu["quant_ws"], x, w, None,
                   tile=(12, 128, 0))


@pytest.mark.parametrize("tile", [(256, 128, 0), (128, 256, 0),
                                  (64, 256, 0), (128, 128, 128),
                                  (64, 256, 256),
                                  # the general instance (phase 23d's)
                                  (8, 128, 0), (24, 384, 0), (64, 128, 0),
                                  (192, 256, 128), (512, 128, 0),
                                  (128, 640, 256)], ids=str)
def test_fused_quant_tiles_and_k_splits_are_bit_equal(emu, tile):
    """Every compiled GEMM tile, IR-legal tiles outside them (the general
    instance: bm 8 and 24 cut an m16 fragment, 512 and 640 outgrow the
    shape), and K split over blocks whose int32 sums are added before the
    one dequant (bk 128: three splits of one stage; bk 256: splits of two
    and one), give the default tile's bits and the plain version's, on a
    ragged shape; the scaled phase of the tensor-parallel pair takes the
    same tile."""
    gen = torch.Generator().manual_seed(sum(tile))
    m, k, n = 70, 300, 136
    x = (torch.randn((m, k), generator=gen) * 2).to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen).to(torch.bfloat16)
    plant_ties(x, w)
    ref = pq.fused_quant_matmul_plain(x, w)
    out = pq._launch(emu["quant"], emu["quant_ws"], x, w, None, tile=tile)
    assert torch.equal(out, ref)
    xa, wa = pq.fused_quant_amax_plain(x, w)
    out = pq._launch(emu["quant_scaled"], emu["quant_ws"], x, w, None,
                     (xa, wa), tile=tile)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("rows", [8, 1024], ids=str)
def test_optimizer_chunks_follow_block_rows_bit_for_bit(emu, rows):
    """``opt_block_rows`` sets the chunk a CTA of sgd.cu and adamw.cu
    updates (8 x rows elements); the update is elementwise, so 8 rows (64
    elements) and 1024 (8192) give the default 512's bits, over leaves of
    several chunks and ragged tails."""
    gen = torch.Generator().manual_seed(rows)
    sizes = (1, 63, 65, 4097, 9000)
    ps = [torch.randn(s, generator=gen) for s in sizes]
    gs = [torch.randn(s, generator=gen) for s in sizes]
    ms = [torch.randn(s, generator=gen) * 0.1 for s in sizes]
    vs = [torch.rand(s, generator=gen) * 0.1 for s in sizes]
    srow = sgd.scalar_row(0.1, 0.9, 1e-4, torch.tensor(0.3))
    arow = adamw.scalar_row(1e-3, 0.9, 0.95, 1e-8, 0.1, 3, torch.tensor(0.5))
    outs = {}
    try:
        for r in (512, rows):
            sgd.set_block_rows(r)
            st = [[t.clone() for t in ts] for ts in (ps, ms)]
            at = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
            sgd.launch_groups(emu["sgd"], "sgd", (st[0], gs, st[1]), srow,
                              None)
            sgd.launch_groups(emu["adamw"], "adamw", (at[0], gs, at[1],
                                                      at[2]), arow, None)
            outs[r] = st + at
    finally:
        sgd.set_block_rows()
    for a, b in zip(outs[512], outs[rows]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
