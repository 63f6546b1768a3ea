"""The CUDA kernel sources themselves, on the CPU: each ``csrc/*.cu`` is
compiled by the host C++ compiler against the emulation of
``tpu_dist_torch/tools/cuda_emu.py`` (a thread per CUDA thread) and driven
through the wrappers' own launch code with CPU tensors, against the plain
versions. fp32 within 1e-5 (summation order only); bf16 within
2e-2 * (1 + |plain|) (the forward kernels round p and the output to bf16;
the backward kernels round p and ds where their plain version does, so
summation order is all that is left before the bf16 outputs round). The
bf16 backward kernels run on the tensor cores through ``csrc/warp_mma.cuh``,
whose mma/ldmatrix/cp.async helpers the emulation supplies in software
(held against ``torch.matmul`` here on one tile). The
AdamW and SGD kernels within 1e-6 * (1 + |plain|) (fp32, the same
operations; a bf16 p rounds once, from the same fp32 value). The fused
int8 matmul bit-equal (int32 sums are exact, the scales and the dequant
the same fp32 operations); the int8-K/V flash forward as the flash
forward (it keeps p in fp32, so bf16 rounds only the output).
The hardware itself is checked by tests/test_torch_cuda.py on the card."""

import ctypes
import os
import shutil

import pytest
import torch

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
            "adamw": cuda_emu.function("adamw", "tdt_adamw",
                                       adamw._ADAMW_ARGS),
            "sgd": cuda_emu.function("sgd", "tdt_sgd", sgd._SGD_ARGS),
            "quant": cuda_emu.function("fused_quant", "tdt_fused_quant",
                                       pq._FUSED_QUANT_ARGS),
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


@pytest.mark.parametrize("dtype,d,lengths", [
    (torch.float32, 128, [1, 200]),
    (torch.bfloat16, 64, [0, 37, 96]),
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
# warp_mma.cuh helpers. B is stored n-major (8 x 16, read by ldmatrix, as K
# in S = Q K^T) or k-major (16 x 8, read by ldmatrix.trans, as K in ds . K)
_MMA_TILE_SRC = r"""
#include <cuda_bf16.h>
#include <stdint.h>
#include "warp_mma.cuh"

__global__ void mma_tile_kernel(const __nv_bfloat16* a,
                                const __nv_bfloat16* b, float* c,
                                int k_major) {
  extern __shared__ float smem[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + 16 * 16;
  const int lane = threadIdx.x;
  for (int i = lane; i < 16 * 16; i += 32) sa[i] = a[i];
  for (int i = lane; i < 16 * 8; i += 32) sb[i] = b[i];
  __syncthreads();
  uint32_t fa[4], fb[4];
  ldsm_x4(fa, sa + (lane % 16) * 16 + (lane / 16) * 8);
  if (k_major)   // matrices 0, 1: k rows 0-7, 8-15 (lanes 16-31 repeat)
    ldsm_x4_trans(fb, sb + (lane % 16) * 8);
  else           // matrices 0, 1: n rows 0-7 at k 0-7, then k 8-15
    ldsm_x4(fb, sb + (lane % 8) * 16 + ((lane / 8) % 2) * 8);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16_16816(acc, fa, fb[0], fb[1]);
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) c[(g + 8 * (i / 2)) * 8 + 2 * t + i % 2] = acc[i];
}

extern "C" int tdt_mma_tile(const void* a, const void* b, void* c,
                            int k_major) {
  mma_tile_kernel<<<1, 32, 1024, nullptr>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(c), k_major);
  return 0;
}
"""


@pytest.mark.parametrize("k_major", [False, True], ids=["ldmatrix",
                                                         "ldmatrix.trans"])
def test_emulated_mma_helpers_match_matmul(emu, k_major):
    fn = cuda_emu.build_source("mma_tile", _MMA_TILE_SRC).tdt_mma_tile
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    gen = torch.Generator().manual_seed(16 + k_major)
    a = torch.randn((16, 16), generator=gen).to(torch.bfloat16)
    b = torch.randn((16, 8), generator=gen).to(torch.bfloat16)
    stored = b.contiguous() if k_major else b.t().contiguous()
    c = torch.full((16, 8), float("nan"))
    assert fn(a.data_ptr(), stored.data_ptr(), c.data_ptr(), int(k_major)) == 0
    # bf16 products are exact in fp32; only the summation order differs
    torch.testing.assert_close(c, a.float() @ b.float(), rtol=1e-6,
                               atol=1e-5)


def test_kernel_library_name_covers_included_headers(tmp_path, monkeypatch):
    for f in ("flash_bwd_dq.cu", "warp_mma.cuh"):
        shutil.copy(os.path.join(kernels.CSRC, f), tmp_path / f)
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path))
    assert kernels.source_files("flash_bwd_dq") == [
        str(tmp_path / "flash_bwd_dq.cu"), str(tmp_path / "warp_mma.cuh")]
    before = kernels._lib_path("flash_bwd_dq")
    with open(tmp_path / "warp_mma.cuh", "a") as f:
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
    adamw._launch(emu["adamw"], p, g, m, v, row, None)
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
    sgd._launch(emu["sgd"], p, g, m, row, None)
    sgd.fused_sgd_plain(ref[0], g, ref[1], row)
    assert p.dtype == dtype
    for a, r in zip((p, m), ref):
        diff = (a.float() - r.float()).abs()
        assert bool((diff <= 1e-6 * (1 + r.float().abs())).all())


@pytest.mark.parametrize("dtype,m,k,n", [
    (torch.float32, 8, 16, 8),        # a decode tick's M, one tile
    (torch.float32, 130, 70, 136),    # ragged M, N and K (K % 4 != 0)
    (torch.bfloat16, 24, 128, 72),    # two K chunks
], ids=str)
def test_fused_quant_kernel_source_matches_plain(emu, dtype, m, k, n):
    gen = torch.Generator().manual_seed(m + k + n)
    x = (torch.randn((m, k), generator=gen) * 2).to(dtype)
    w = torch.randn((k, n), generator=gen).to(dtype)
    x[1] = 0                                   # an all-zero row: exact zeros
    out = pq._launch(emu["quant"], x, w, None)
    ref = pq.fused_quant_matmul_plain(x, w)
    assert out.dtype == dtype and torch.equal(out, ref)
    assert bool((out[1] == 0).all())


@pytest.mark.parametrize("dtype,case", [
    # (b, lq, lk, h, d, causal, q_offset, kv_offset)
    (torch.float32, (1, 100, 100, 2, 64, True, 0, 0)),
    (torch.float32, (1, 70, 130, 1, 64, False, 0, 0)),
    (torch.float32, (1, 64, 64, 1, 128, True, 0, 40)),   # masked rows
    (torch.float32, (1, 40, 96, 1, 64, True, 56, 0)),
    (torch.bfloat16, (1, 80, 80, 1, 128, True, 0, 0)),
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
