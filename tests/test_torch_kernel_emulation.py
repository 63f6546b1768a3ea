"""The CUDA kernel sources themselves, on the CPU: each ``csrc/*.cu`` is
compiled by the host C++ compiler against the emulation of
``tpu_dist_torch/tools/cuda_emu.py`` (a thread per CUDA thread) and driven
through the wrappers' own launch code with CPU tensors, against the plain
versions. fp32 within 1e-5 (summation order only); bf16 within
2e-2 * (1 + |plain|) (the forward kernel rounds p and the output to bf16;
the backward kernels round p and ds where their plain version does, so
summation order is all that is left before the bf16 outputs round). The
bf16 flash kernels run on the tensor cores through ``csrc/warp_mma.cuh``,
whose mma/ldmatrix/cp.async helpers the emulation supplies in software
(held against ``torch.matmul`` here on one tile, with the header's quad
reductions, bf16 split and int8 widening). The
AdamW and SGD kernels within 1e-6 * (1 + |plain|) (fp32, the same
operations; a bf16 p rounds once, from the same fp32 value). The fused
int8 matmul bit-equal (int32 sums are exact, the scales and the dequant
the same fp32 operations); the int8-K/V flash forward as the flash
forward, and its bf16 instance also within one bf16 ulp of the plain value
plus 1e-4 (it keeps p at about 16 bits, so the bf16 output's rounding
is nearly all that is left).
The hardware itself is checked by tests/test_torch_cuda.py on the card."""

import ctypes
import os
import shutil

import pytest
import torch

import chip_smoke
from tpu_dist_torch import kernels
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.ops import paged_attention as pa
from tpu_dist_torch.ops import pallas_adamw as adamw
from tpu_dist_torch.ops import pallas_quant as pq
from tpu_dist_torch.ops import pallas_sgd as sgd
from tpu_dist_torch.tools import cuda_emu

torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def emu():
    if not (shutil.which("g++") or shutil.which("clang++")):
        pytest.skip("no host C++ compiler for the CUDA emulation")
    return {"flash": cuda_emu.function("flash_fwd", "tdt_flash_fwd",
                                       fa._FLASH_ARGS),
            "paged": cuda_emu.function("paged_decode", "tdt_paged_decode",
                                       pa._PAGED_ARGS),
            "dq": cuda_emu.function("flash_bwd_dq", "tdt_flash_bwd_dq",
                                    fa._BWD_DQ_ARGS),
            "dkv": cuda_emu.function("flash_bwd_dkv", "tdt_flash_bwd_dkv",
                                     fa._BWD_DKV_ARGS),
            "adamw": cuda_emu.function("adamw", "tdt_adamw_multi",
                                       sgd.MULTI_ARGS),
            "sgd": cuda_emu.function("sgd", "tdt_sgd_multi",
                                     sgd.MULTI_ARGS),
            "quant": cuda_emu.function("fused_quant", "tdt_fused_quant",
                                       pq._FUSED_QUANT_ARGS),
            "quant_ws": cuda_emu.function("fused_quant",
                                          "tdt_fused_quant_workspace",
                                          pq._WORKSPACE_ARGS),
            "quant_amax": cuda_emu.function("fused_quant",
                                            "tdt_fused_quant_amax",
                                            pq._AMAX_ARGS),
            "quant_scaled": cuda_emu.function("fused_quant",
                                              "tdt_fused_quant_scaled",
                                              pq._SCALED_ARGS),
            "quant_tiles": cuda_emu.function("fused_quant",
                                             "tdt_fused_quant_tiles",
                                             pq._TILES_ARGS),
            "int8kv": cuda_emu.function("flash_fwd_int8kv",
                                        "tdt_flash_fwd_int8kv",
                                        fa._INT8KV_ARGS)}


def _close(out, ref, dtype):
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= TOL[dtype] * (1 + ref.float().abs())).all()), \
        diff.max().item()


@pytest.mark.parametrize("dtype,case", [
    # (b, lq, lk, h, d, causal, q_offset, kv_offset)
    (torch.float32, (1, 100, 100, 2, 64, True, 0, 0)),
    (torch.float32, (1, 70, 130, 1, 64, False, 0, 0)),
    (torch.float32, (1, 64, 64, 1, 128, True, 0, 40)),   # masked rows
    (torch.float32, (1, 40, 96, 1, 64, True, 56, 0)),
    (torch.bfloat16, (1, 80, 80, 1, 128, True, 0, 0)),
    # bf16 runs flash_fwd_kernel_mma through the emulated mma, ldmatrix and
    # cp.async helpers; Lq >= 130 gives several q tiles, run longest first
    (torch.bfloat16, (2, 130, 200, 2, 64, True, 0, 40)),  # dead rows
    (torch.bfloat16, (1, 70, 130, 1, 64, False, 0, 0)),   # ragged, full
    (torch.bfloat16, (1, 40, 96, 1, 128, True, 56, 0)),   # q after kv prefix
    (torch.bfloat16, (1, 130, 130, 1, 128, False, 24, 0)),
    (torch.bfloat16, (1, 192, 192, 1, 64, True, 0, 0)),
    # head dims 16 and 32 (their own instances), 48 and 80 (the true head
    # dim at run time on the 64 and 128 instances)
    (torch.float32, (1, 70, 130, 2, 16, True, 0, 0)),
    (torch.float32, (1, 64, 64, 1, 32, True, 0, 40)),    # masked rows
    (torch.float32, (1, 70, 100, 2, 48, False, 0, 0)),
    (torch.bfloat16, (2, 130, 200, 2, 16, True, 0, 40)),  # dead rows
    (torch.bfloat16, (1, 100, 100, 2, 32, True, 0, 0)),
    (torch.bfloat16, (1, 70, 130, 2, 48, False, 24, 0)),
    (torch.bfloat16, (1, 64, 96, 2, 80, True, 0, 0)),
], ids=str)
def test_flash_kernel_source_matches_plain(emu, dtype, case):
    b, lq, lk, h, d, causal, qo, ko = case
    gen = torch.Generator().manual_seed(lq + lk)
    q, k, v = (torch.randn((b, n, h, d), generator=gen).to(dtype)
               for n in (lq, lk, lk))
    out, lse = fa._launch(emu["flash"], q, k, v, causal, qo, ko, None)
    ref, ref_lse = fa.flash_forward_plain(q, k, v, causal, qo, ko)
    _close(out, ref, dtype)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    assert torch.equal((ref == 0).all(-1), (out == 0).all(-1))
    if ko > qo:   # rows that see no key: exact zeros
        dead = (qo + torch.arange(lq)) < ko
        assert dead.any() and bool((out[:, dead] == 0).all())


@pytest.mark.parametrize("d,causal", [(64, True), (128, False), (32, True),
                                      (16, False)], ids=str)
def test_flash_mma_kernel_source_matches_pallas_forward(emu, d, causal):
    """The same numpy inputs through the JAX package's Pallas forward
    (interpret mode) and the emulated bf16 tensor-core kernel: out within
    2e-2 * (1 + |ref|) (summation order, and p rounds to bf16 on both
    sides), lse within 1e-4."""
    pytest.importorskip("jax")
    pytest.importorskip("flax")   # the reference package needs both
    import jax.numpy as jnp
    import numpy as np

    from tpu_dist.ops import flash_attention as jfa

    b, lq, lk, h, qo = 1, 128, 128, 2, 0
    rng = np.random.default_rng(d + causal)
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32)
               for n in (lq, lk, lk))
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    jout, jlse = jfa._fa_forward(jq, jk, jv, causal, qo, 0, 64, 64, True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out, lse = fa._launch(emu["flash"], tq, tk, tv, causal, qo, 0, None)
    ref = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    _close(out, ref, torch.bfloat16)
    torch.testing.assert_close(
        lse, torch.from_numpy(np.array(jlse)[..., 0]), rtol=0, atol=1e-4)


def test_misaligned_bf16_views_are_named_before_and_at_the_launch(emu):
    """A contiguous bf16 view at an odd element offset (2-byte aligned), at
    2 elements (4 bytes) and at 4 (8 bytes): the C entries run it on the
    general instance (the wrappers no longer check alignment), whose rows
    go by byte loads
    or 4- and 8-byte cp.async; its output is bit-equal to that of an
    aligned copy on the exact instance (the same products; only the
    copies differ). Nothing is refused for alignment any more."""
    gen = torch.Generator().manual_seed(64)
    shape = (1, 40, 2, 64)
    x = [torch.randn(shape, generator=gen).to(torch.bfloat16)
         for _ in range(3)]
    kv = fa.quantize_kv(*(torch.randn(shape, generator=gen)
                          for _ in range(2)))
    want = fa._launch(emu["flash"], *x, True, 0, 0, None)
    want8 = fa._launch_int8kv(emu["int8kv"], x[0], kv, True, 0, 0, None)
    for off in (1, 2, 4):
        views = [chip_smoke.offset_view(torch, t, off) for t in x]
        assert views[0].data_ptr() % 16 == 2 * off
        got = fa._launch(emu["flash"], *views, True, 0, 0, None)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        kv_views = tuple(chip_smoke.offset_view(torch, t, off) for t in kv)
        got8 = fa._launch_int8kv(emu["int8kv"], views[0], kv_views, True,
                                 0, 0, None)
        assert torch.equal(got8, want8)


def _head_dim(d_model, num_heads):
    assert d_model % num_heads == 0
    return d_model // num_heads


def test_head_dim_rule_takes_every_reference_configuration():
    """The one head-dim rule (``kernels.head_dim_instance``, the rule of
    ``csrc/head_dim.cuh``) takes every head dim from 1 up: the head dim of
    every configuration the reference ships runs on its own instance
    (``tiny_lm`` 16, ``LMConfig`` 32, the LM convergence tool 32,
    ViT-CIFAR 32, ViT-B/16 64, the LM bench 128, and the bench at
    ``BENCH_HEADS=4`` 256), every other d up to 256 on the next instance
    up, and every d above 256 (the bench at ``BENCH_HEADS=2`` 512 and at
    1 head 1024) on the wide path; 0 and -1 are refused by name."""
    import inspect

    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.models import vit
    from tpu_dist_torch.models.transformer import tiny_lm
    from tpu_dist_torch.tools import decode_bench, lm_convergence

    tiny = inspect.signature(tiny_lm).parameters
    conv = lm_convergence.parser().parse_args([])
    bench = decode_bench.build_parser().parse_args([])
    dims = {
        "tiny_lm": _head_dim(tiny["d_model"].default,
                             tiny["num_heads"].default),
        "LMConfig": _head_dim(LMConfig().d_model, LMConfig().num_heads),
        "lm_convergence": _head_dim(conv.d_model, conv.num_heads),
        "vit_cifar": _head_dim(vit.ViTCifar.keywords["d_model"],
                               vit.ViTCifar.keywords["num_heads"]),
        "vit_b16": _head_dim(vit.ViTBase.keywords["d_model"],
                             vit.ViTBase.keywords["num_heads"]),
        "lm bench": _head_dim(bench.d_model, bench.num_heads),
        "lm bench, 4 heads": _head_dim(bench.d_model, 4),
        "lm bench, 2 heads": _head_dim(bench.d_model, 2),
        "lm bench, 1 head": _head_dim(bench.d_model, 1)}
    assert dims == {"tiny_lm": 16, "LMConfig": 32, "lm_convergence": 32,
                    "vit_cifar": 32, "vit_b16": 64, "lm bench": 128,
                    "lm bench, 4 heads": 256, "lm bench, 2 heads": 512,
                    "lm bench, 1 head": 1024}
    for d in dims.values():
        assert kernels.head_dim_instance(d) == (
            d if d <= 256 else kernels.HEAD_DIM_WIDE)
    assert {d: kernels.head_dim_instance(d)
            for d in (1, 8, 17, 24, 33, 48, 80, 96, 100, 112, 129, 136, 200,
                      255)} == {1: 16, 8: 16, 17: 32, 24: 32, 33: 64, 48: 64,
                                80: 128, 96: 128, 100: 128, 112: 128,
                                129: 256, 136: 256, 200: 256, 255: 256}
    assert all(kernels.head_dim_instance(d) is not None
               for d in range(1, 257))
    for d in (257, 264, 320, 512, 1024, 4096):
        assert kernels.head_dim_instance(d) == kernels.HEAD_DIM_WIDE
        assert kernels.check_head_dim("flash kernel", d) == "wide"
    for d in (0, -1):
        assert kernels.head_dim_instance(d) is None
        with pytest.raises(ValueError, match=rf"head_dim {d} is refused: "
                                             r"the kernels take every head "
                                             r"dim from 1 up"):
            kernels.check_head_dim("flash kernel", d)


@pytest.mark.parametrize("d", [0, -1], ids=str)
def test_attention_entries_refuse_what_the_rule_refuses(emu, d):
    """Past the wrappers' check, each of the five C entries returns -1 for
    a head dim the rule refuses, in both dtypes, and launches nothing."""
    x = torch.zeros((1, 4, 1, max(d, 1)))
    i8 = torch.zeros((1, 4, 1, max(d, 1)), dtype=torch.int8)
    scale = torch.ones((1, 4, 1))
    lens = torch.ones(1, dtype=torch.int32)
    table = torch.zeros((1, 1), dtype=torch.int32)
    ptr = lambda t: t.data_ptr()
    for dtype in (0, 1):
        common = (1, 1, 4, 4, d, 1, 0, 0, 1.0, dtype, None)
        assert emu["flash"](*(ptr(x),) * 5, *common) == -1
        assert emu["dq"](*(ptr(x),) * 7, *common) == -1
        assert emu["dkv"](*(ptr(x),) * 8, *common) == -1
        assert emu["int8kv"](ptr(x), ptr(i8), ptr(scale), ptr(i8),
                             ptr(scale), ptr(x), *common) == -1
        assert emu["paged"](ptr(x), ptr(i8), ptr(scale), ptr(i8),
                            ptr(scale), ptr(table), ptr(lens), ptr(x),
                            ptr(x), ptr(x), 1, 1, d, 1, 4, 1, 1.0, dtype,
                            None) == -1


def _five(emu, dtype, d, off=0, kv_offset=0):
    """``chip_smoke.five_at_head_dim`` (phase 3's sweep) through the
    emulated C entries: all five at head dim ``d`` against their plain
    versions, every output (and the paged decode's split partials)
    allocated NaN between SENTINEL elements, rows that see no key and the
    length-0 paged row exact zeros; with ``off`` > 0 again on views ``off``
    elements into their buffers, bit-equal to the aligned run. Above 128
    (the 256 instances) one head of 40 rows over 64 keys keeps the
    emulated tensor-core kernels within seconds."""
    shape = ((1, 70, 100, 2, kv_offset) if d <= 128
             else (1, 40, 64, 1, kv_offset))
    return chip_smoke.five_at_head_dim(torch, None, d, dtype, off, "cpu",
                                       emu, shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [48, 80], ids=str)
def test_runtime_head_dim_stores_nothing_past_d(emu, dtype, d):
    """At a head dim that runs on the next instance up, every kernel's
    outputs (and the paged decode's split partials) are allocated NaN with
    GUARD SENTINEL elements after them: each output element is written (it
    matches the plain version), and nothing lands past the end."""
    _five(emu, dtype, d)


# (head dim, element offset of the misaligned views): a row narrower than
# its instance (8 on 16, 24 on 32, 33 on 64, 100 on 128, 136 on 256), an
# odd d (33: 66-byte bf16 rows, 33-byte int8 rows), 100 (8-byte-aligned
# bf16 rows, 4-byte int8 rows), and the 256 instances
HEAD_DIM_CASES = [(8, 1), (24, 2), (33, 1), (100, 4), (136, 1), (256, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d,off", HEAD_DIM_CASES, ids=str)
def test_every_head_dim_runs_aligned_and_misaligned(emu, dtype, d, off):
    """The five C entries at head dims up to 256, with sentinel tails,
    dead rows and a length-0 paged row, once on the allocator's tensors
    and once on views ``off`` elements into their buffers (inputs and
    outputs): both runs match the plain versions, and they are bit-equal
    to each other (only the copies differ)."""
    rec, _ = _five(emu, dtype, d, off, 24)
    assert rec["bit_equal_misaligned"] and rec["misaligned_offset_elements"] \
        == off


# (head dim, element offset of the misaligned views) on the wide path: an
# odd d (257: byte loads, a lane's partial piece in the paged decode), 264
# (whole bf16 chunks, int8 rows not whole 16-byte chunks), 320 (a last
# 128-column chunk half live), 512 (four chunks) and 1024 (eight)
WIDE_HEAD_DIM_CASES = [(257, 1), (264, 2), (320, 4), (512, 2), (1024, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d,off", WIDE_HEAD_DIM_CASES, ids=str)
def test_wide_head_dims_run_aligned_and_misaligned(emu, dtype, d, off):
    """The five C entries above 256 (the wide path: output chunks over the
    grid's z axis, the scores summed over d in streamed slices), with
    sentinel tails, dead rows (8 rows see no key), dead keys and a
    length-0 paged row, on the allocator's tensors and on views ``off``
    elements into their buffers: both match the plain versions and are
    bit-equal to each other. One q tile and one k/v tile (Lq 24, Lk 40)
    keep the emulated tensor-core kernels, whose work grows as d^2 here,
    within a minute at 1024."""
    rec, _ = chip_smoke.five_at_head_dim(torch, None, d, dtype, off, "cpu",
                                         emu, (1, 24, 40, 1, 8))
    assert rec["bit_equal_misaligned"] and rec["sentinels_untouched"] \
        and rec["dead_exact_zero"]


@pytest.mark.parametrize("dtype,d,lengths", [
    (torch.float32, 128, [1, 200]),
    (torch.bfloat16, 64, [0, 37, 96]),
    (torch.float32, 16, [1, 200]),       # 8 dims a lane
    (torch.bfloat16, 16, [0, 37, 130]),
    (torch.float32, 32, [0, 129]),
    (torch.bfloat16, 32, [5, 96]),
    (torch.bfloat16, 48, [0, 37, 200]),  # the true head dim on 64
    (torch.float32, 80, [1, 130]),       # on 128
], ids=str)
def test_paged_kernel_source_matches_plain(emu, dtype, d, lengths):
    b, lk, h = len(lengths), max(lengths) + 4, 2
    gen = torch.Generator().manual_seed(d)
    q = torch.randn((b, 1, h, d), generator=gen).to(dtype)
    k, v = (torch.randn((b, lk, h, d), generator=gen) for _ in range(2))
    kq, ks, vq, vs = fa.quantize_kv(k, v)
    lens = torch.tensor(lengths, dtype=torch.int32)
    out = pa._launch(emu["paged"], q, kq, ks, vq, vs, lens, None)
    _close(out, pa.paged_decode_plain(q, kq, ks, vq, vs, lens), dtype)
    assert bool((out[lens == 0] == 0).all())


def shuffled_arenas(gen, lengths, h, d, page_size, pages_per_row, spare):
    """An int8 PagedLayer whose live pages are a random permutation of the
    pool, its (B, P) int32 block table (entries past a row's live pages on
    the trash page), and a copy of the layer whose scales are NaN on every
    key no row may read: the unowned pages, the trash page and the rows at
    or past the length in each last page."""
    b = len(lengths)
    live_pages = [-(-n // page_size) for n in lengths]
    n_pages = sum(live_pages) + spare
    trash = n_pages
    perm = torch.randperm(n_pages, generator=gen)
    bt = torch.full((b, pages_per_row), trash, dtype=torch.int32)
    readable = torch.zeros((n_pages + 1, page_size), dtype=torch.bool)
    used = 0
    for i, n in enumerate(lengths):
        pages = perm[used:used + live_pages[i]]
        used += live_pages[i]
        bt[i, :len(pages)] = pages.to(torch.int32)
        for j, page in enumerate(pages.tolist()):
            readable[page, :min(page_size, n - j * page_size)] = True
    k, v = (torch.randn((n_pages + 1, page_size, h, d), generator=gen)
            for _ in range(2))
    kq, ks, vq, vs = fa.quantize_kv(k, v)
    layer = pa.PagedLayer(kq, vq, ks, vs, quant="int8", read="flash")
    nan = torch.where(readable[..., None], 0.0, float("nan"))
    poisoned = pa.PagedLayer(kq, vq, ks + nan, vs + nan, quant="int8",
                             read="flash")
    return layer, poisoned, bt


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 16),
                                     (torch.float32, 32),
                                     (torch.bfloat16, 48),
                                     (torch.float32, 33),
                                     (torch.bfloat16, 256)], ids=str)
def test_paged_block_table_kernel_source_reads_only_live_keys(emu, dtype, d):
    """The kernel through a shuffled block table (page_size 16, 20 pages a
    row, three 128-key splits) at lengths 0, 1, a page, a page + 1, a
    split boundary -1 / 0 / +1 and the full table, on arenas whose scales
    are NaN wherever no row may read: equal to paged_decode_blocks_plain
    on the same arenas with those scales zeroed, within 1e-5 (1 + |plain|)
    in fp32 (summation order) and 2e-2 in bf16 (the output's rounding);
    exact zeros at length 0."""
    lengths = [0, 1, 16, 17, 127, 128, 129, 320]
    gen = torch.Generator().manual_seed(d + 7)
    layer, poisoned, bt = shuffled_arenas(gen, lengths, 2, d, 16, 20, 5)
    q = torch.randn((len(lengths), 1, 2, d), generator=gen).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32)
    out = pa._launch_blocks(emu["paged"], q, poisoned.k, poisoned.k_scale,
                            poisoned.v, poisoned.v_scale, bt, lens, None)
    assert bool(torch.isfinite(out.float()).all())
    zeroed = pa.PagedLayer(
        poisoned.k, poisoned.v, poisoned.k_scale.nan_to_num(0.0),
        poisoned.v_scale.nan_to_num(0.0), quant="int8", read="flash")
    ref = pa.paged_decode_blocks_plain(q, zeroed, bt, lens)
    _close(out, ref, dtype)
    assert bool((out[0] == 0).all())
    clean = pa._launch_blocks(emu["paged"], q, layer.k, layer.k_scale,
                              layer.v, layer.v_scale, bt, lens, None)
    assert torch.equal(out, clean)   # the NaN scales were never read


@pytest.mark.parametrize("dtype,case", [
    # (b, lq, lk, h, d, causal, q_offset, kv_offset)
    (torch.float32, (1, 100, 100, 2, 64, True, 0, 0)),
    (torch.float32, (1, 70, 130, 1, 64, False, 0, 0)),
    (torch.float32, (1, 64, 64, 1, 128, True, 0, 40)),   # dead rows, keys
    (torch.float32, (1, 40, 96, 1, 64, True, 56, 0)),
    (torch.bfloat16, (1, 80, 80, 1, 128, True, 0, 0)),
    # bf16 runs the tensor-core kernels through the emulated mma, ldmatrix
    # and cp.async helpers
    (torch.bfloat16, (1, 70, 130, 1, 64, False, 0, 0)),  # ragged
    (torch.bfloat16, (1, 100, 100, 2, 64, True, 0, 0)),
    (torch.bfloat16, (1, 64, 64, 1, 128, True, 0, 40)),  # dead rows, keys
    (torch.bfloat16, (1, 40, 96, 1, 64, True, 56, 0)),   # q after kv prefix
    # head dims 16, 32 (instances), 48 and 80 (the true head dim at run time)
    (torch.float32, (1, 70, 130, 2, 16, False, 0, 0)),
    (torch.float32, (1, 64, 64, 1, 32, True, 0, 40)),    # dead rows, keys
    (torch.float32, (1, 100, 100, 2, 48, True, 0, 0)),
    (torch.bfloat16, (1, 100, 100, 2, 16, True, 0, 0)),
    (torch.bfloat16, (1, 64, 64, 2, 32, True, 0, 40)),   # dead rows, keys
    (torch.bfloat16, (1, 70, 130, 2, 48, False, 0, 0)),
    (torch.bfloat16, (1, 40, 96, 2, 80, True, 56, 0)),
], ids=str)
def test_flash_backward_kernel_sources_match_plain(emu, dtype, case):
    b, lq, lk, h, d, causal, qo, ko = case
    gen = torch.Generator().manual_seed(lq * 3 + lk)
    q, k, v, g = (torch.randn((b, n, h, d), generator=gen).to(dtype)
                  for n in (lq, lk, lk, lq))
    out, lse = fa.flash_forward_plain(q, k, v, causal, qo, ko)
    got = fa._launch_backward(emu["dq"], emu["dkv"], q, k, v, out, lse, g,
                              causal, qo, ko, None)
    ref = fa.flash_backward_plain(q, k, v, out, lse, g, causal, qo, ko)
    for a, r in zip(got, ref):
        assert a.dtype == dtype
        _close(a, r, dtype)
    if ko > qo:   # rows that see no key: exact zero dq
        dead = (qo + torch.arange(lq)) < ko
        assert dead.any() and bool((got[0][:, dead] == 0).all())
    if causal:    # keys that no row sees: exact zero dk and dv
        dead = (ko + torch.arange(lk)) > qo + lq - 1
        for grad in got[1:]:
            assert bool((grad[:, dead] == 0).all())


# one warp: C (16 x 8, fp32) = A (16 x 16) . B through the emulated
# warp_mma.cuh helpers, then C's row max and sum by the quad reductions.
# mode 0: B stored n-major (8 x 16, read by ldmatrix, as K in S = Q K^T);
# 1: k-major (16 x 8, read by ldmatrix.trans, as V in p . V); 2: as 1 with
# an fp32 A split by split_bf16x2 into two mma (the int8-K/V kernel's p');
# 3: as 1 with B given as int8 and widened by widen_int8x4; 4: int8 A (16 x
# 32) and B stored n-major (8 x 32), the same bytes read as mode 0 reads
# them, through mma_s8_16832 (int32 sums, exact in fp32 at these sizes)
_MMA_TILE_SRC = r"""
#include <cuda_bf16.h>
#include <stdint.h>
#include "warp_mma.cuh"

__global__ void mma_tile_kernel(const void* a, const void* b, float* c,
                                float* stats, int mode) {
  extern __shared__ float smem[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + 16 * 16;
  const int lane = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  if (mode != 2)
    for (int i = lane; i < 16 * 16; i += 32)
      sa[i] = static_cast<const __nv_bfloat16*>(a)[i];
  if (mode == 3) {   // 4 int8 a lane -> 4 bf16
    uint32_t* d = reinterpret_cast<uint32_t*>(sb + 4 * lane);
    widen_int8x4(static_cast<const uint32_t*>(b)[lane], d[0], d[1]);
  } else {
    for (int i = lane; i < 16 * 8; i += 32)
      sb[i] = static_cast<const __nv_bfloat16*>(b)[i];
  }
  __syncthreads();
  uint32_t fa[4], fb[4];
  // matrices 0, 1: n rows 0-7 at k 0-7, then k 8-15 (int8: k 0-15, 16-31)
  if (mode == 0 || mode == 4)
    ldsm_x4(fb, sb + (lane % 8) * 16 + ((lane / 8) % 2) * 8);
  else             // matrices 0, 1: k rows 0-7, 8-15 (lanes 16-31 repeat)
    ldsm_x4_trans(fb, sb + (lane % 16) * 8);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (mode == 2) {  // A register i: row g + 8 (i % 2), cols 2t + 8 (i / 2)
    const float* a32 = static_cast<const float*>(a);
    uint32_t hi[4], lo[4];
    for (int i = 0; i < 4; ++i) {
      const int r = g + 8 * (i % 2), k = 2 * t + 8 * (i / 2);
      split_bf16x2(a32[r * 16 + k], a32[r * 16 + k + 1], hi[i], lo[i]);
    }
    mma_bf16_16816(acc, hi, fb[0], fb[1]);
    mma_bf16_16816(acc, lo, fb[0], fb[1]);
  } else if (mode == 4) {
    ldsm_x4(fa, sa + (lane % 16) * 16 + (lane / 16) * 8);
    int iacc[4] = {0, 0, 0, 0};
    mma_s8_16832(iacc, fa, fb[0], fb[1]);
    for (int i = 0; i < 4; ++i) acc[i] = (float)iacc[i];
  } else {
    ldsm_x4(fa, sa + (lane % 16) * 16 + (lane / 16) * 8);
    mma_bf16_16816(acc, fa, fb[0], fb[1]);
  }
  for (int i = 0; i < 4; ++i) c[(g + 8 * (i / 2)) * 8 + 2 * t + i % 2] = acc[i];
  for (int r = 0; r < 2; ++r) {
    const float mx = quad_max(fmaxf(acc[2 * r], acc[2 * r + 1]));
    const float sm = quad_sum(acc[2 * r] + acc[2 * r + 1]);
    if (t == 0) {
      stats[g + 8 * r] = mx;
      stats[16 + g + 8 * r] = sm;
    }
  }
}

extern "C" int tdt_mma_tile(const void* a, const void* b, void* c,
                            void* stats, int mode) {
  mma_tile_kernel<<<1, 32, 1024, nullptr>>>(
      a, b, static_cast<float*>(c), static_cast<float*>(stats), mode);
  return 0;
}
"""


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4], ids=[
    "ldmatrix", "ldmatrix.trans", "split_bf16x2", "widen_int8x4", "s8"])
def test_emulated_mma_helpers_match_matmul(emu, mode):
    fn = cuda_emu.build_source("mma_tile", _MMA_TILE_SRC).tdt_mma_tile
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    gen = torch.Generator().manual_seed(16 + mode)
    a = torch.randn((16, 16), generator=gen)
    b = torch.randn((16, 8), generator=gen).to(torch.bfloat16)
    if mode == 3:
        b = torch.randint(-128, 128, (16, 8), generator=gen,
                          dtype=torch.int8)
    if mode == 4:   # the full int8 range, -128 included
        a, b = (torch.randint(-128, 128, s, generator=gen, dtype=torch.int8)
                for s in ((16, 32), (32, 8)))
    elif mode != 2:
        a = a.to(torch.bfloat16)
    stored = b.t().contiguous() if mode in (0, 4) else b.contiguous()
    c = torch.full((16, 8), float("nan"))
    stats = torch.full((32,), float("nan"))
    assert fn(a.data_ptr(), stored.data_ptr(), c.data_ptr(),
              stats.data_ptr(), mode) == 0
    ref = a.float() @ b.float()
    if mode == 4:   # int32 sums, exact
        assert torch.equal(c, (a.int() @ b.int()).float())
    if mode == 2:
        # hi + lo carry about 16 bits of each fp32 element of A (one bf16
        # alone would leave about 2^-9 of |a| |b|)
        assert bool(((c - ref).abs() <= 2.0 ** -17 *
                     (a.abs() @ b.float().abs())).all())
    else:
        # bf16 (and widened int8) products are exact in fp32; only the
        # summation order differs
        torch.testing.assert_close(c, ref, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(stats[:16], c.amax(dim=1), rtol=0, atol=0)
    torch.testing.assert_close(stats[16:], c.sum(dim=1), rtol=1e-6,
                               atol=1e-5)


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


@pytest.mark.parametrize("dtype,case", [
    # (b, lq, lk, h, d, causal, q_offset, kv_offset)
    (torch.float32, (1, 100, 100, 2, 64, True, 0, 0)),
    (torch.float32, (1, 70, 130, 1, 64, False, 0, 0)),
    (torch.float32, (1, 64, 64, 1, 128, True, 0, 40)),   # masked rows
    (torch.float32, (1, 40, 96, 1, 64, True, 56, 0)),
    (torch.bfloat16, (1, 80, 80, 1, 128, True, 0, 0)),
    # bf16 q runs flash_fwd_int8kv_kernel_mma (emulated helpers)
    (torch.bfloat16, (2, 130, 200, 2, 64, True, 0, 40)),  # dead rows
    (torch.bfloat16, (1, 70, 130, 1, 64, False, 0, 0)),   # ragged, full
    (torch.bfloat16, (1, 40, 96, 1, 128, True, 56, 0)),   # q after kv prefix
    (torch.bfloat16, (1, 130, 130, 1, 128, False, 24, 0)),
    (torch.bfloat16, (1, 192, 192, 1, 64, True, 0, 0)),
    # head dims 16, 32 (instances), 48 and 80 (the true head dim at run time)
    (torch.float32, (1, 70, 130, 2, 16, True, 0, 0)),
    (torch.float32, (1, 64, 64, 1, 32, True, 0, 40)),    # masked rows
    (torch.float32, (1, 70, 100, 2, 48, False, 0, 0)),
    (torch.bfloat16, (2, 130, 200, 2, 16, True, 0, 40)),  # dead rows
    (torch.bfloat16, (1, 100, 100, 2, 32, True, 0, 0)),
    (torch.bfloat16, (1, 70, 130, 2, 48, False, 24, 0)),
    (torch.bfloat16, (1, 64, 96, 2, 80, True, 0, 0)),
], ids=str)
def test_int8kv_flash_kernel_source_matches_plain(emu, dtype, case):
    b, lq, lk, h, d, causal, qo, ko = case
    gen = torch.Generator().manual_seed(lq + 2 * lk)
    q = torch.randn((b, lq, h, d), generator=gen).to(dtype)
    kv = fa.quantize_kv(*(torch.randn((b, lk, h, d), generator=gen)
                          for _ in range(2)))
    out = fa._launch_int8kv(emu["int8kv"], q, kv, causal, qo, ko, None)
    ref = fa.int8kv_flash_plain(q, kv, causal, qo, ko)
    assert out.dtype == dtype
    _close(out, ref, dtype)
    assert torch.equal((ref == 0).all(-1), (out == 0).all(-1))
    if dtype == torch.bfloat16:   # one bf16 ulp of plain, plus the sums'
        diff = (out.float() - ref.float()).abs()
        assert bool((diff <= 2.0 ** -7 * ref.float().abs() + 1e-4).all())
    if ko > qo:   # rows that see no key: exact zeros
        dead = (qo + torch.arange(lq)) < ko
        assert dead.any() and bool((out[:, dead] == 0).all())
