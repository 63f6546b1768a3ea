"""The attention kernel sources on the CPU: each of ``flash_fwd.cu``,
``flash_bwd_dq.cu``, ``flash_bwd_dkv.cu``, ``flash_fwd_int8kv.cu`` and
``paged_decode.cu`` is compiled by the host C++ compiler against the
emulation of ``tpu_dist_torch/tools/cuda_emu.py`` (a fiber per CUDA
thread) and driven through the wrappers' own launch code with CPU
tensors, against the plain versions. fp32 within 1e-5 (summation order
only); bf16 within 2e-2 * (1 + |plain|) (the forward kernel rounds p and
the output to bf16; the backward kernels round p and ds where their plain
version does, so summation order is all that is left before the bf16
outputs round). The bf16 flash kernels run on the tensor cores through
``csrc/warp_mma.cuh``, whose mma/ldmatrix/cp.async helpers the emulation
supplies in software (held against ``torch.matmul`` here on one tile, with
the header's quad reductions, bf16 split and int8 widening). The int8-K/V
flash forward as the flash forward, and its bf16 instance also within one
bf16 ulp of the plain value plus 1e-4 (it keeps p at about 16 bits, so the
bf16 output's rounding is nearly all that is left). The head-dim sweeps
are in test_torch_emu_head_dims.py and test_torch_emu_wide.py. The
hardware itself is checked by tests/test_torch_cuda.py on the card."""

import ctypes
import shutil

import pytest
import torch

import chip_smoke
from tpu_dist_torch import kernels
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.ops import paged_attention as pa
from tpu_dist_torch.tools import cuda_emu

torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def emu():
    if not (shutil.which("g++") or shutil.which("clang++")):
        pytest.skip("no host C++ compiler for the CUDA emulation")
    return cuda_emu.entries(*cuda_emu.ATTENTION)


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
