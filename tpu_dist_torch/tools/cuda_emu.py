"""Run the port's CUDA kernels on the CPU, for rehearsal without a GPU.

A CUDA kernel has no interpret mode. This tool compiles a kernel source
from ``tpu_dist_torch/csrc`` with the host C++ compiler against a small
emulation of the CUDA features those kernels use: one ``std::thread``
per CUDA thread, ``std::barrier`` for ``__syncthreads`` and for warp
shuffles, function-level statics for ``__shared__`` arrays (blocks run
one after another), and a software bf16. The source is rewritten only
mechanically (includes, ``extern __shared__``, ``__shared__``, and the
``<<<...>>>`` launch); the local headers it includes (``csrc/*.cuh``) are
inlined. The library keeps the kernel's plain C entry point, so the same
Python wrapper code drives it with CPU tensors and ``stream=None``.

The tensor-core helpers of ``csrc/warp_mma.cuh`` hold their PTX under
``#ifndef TDT_CUDA_EMU``; this emulation defines that macro and gives
software versions with the PTX ISA's fragment layouts, warp-collective
through the per-warp barrier and scratch (as ``__shfl_xor_sync``):
``mma_bf16_16816`` (m16n8k16, bf16 operands, fp32 sums),
``mma_s8_16832`` (m16n8k32, int8 operands, int32 sums), ``ldsm_x4`` and
``ldsm_x4_trans`` (``ldmatrix`` x4), ``exp2_approx`` and
``pack_bf16x2`` (round to nearest even), and ``cp_async_*`` as plain
copies with the same zero fill (``commit``/``wait`` do nothing: the copy
has landed when it returns). ``atomicMax`` (unsigned) and ``atomicAdd``
(int) are ``std::atomic_ref`` operations, ``__threadfence`` a fence,
``__ldcg`` a load, ``__byte_perm`` a byte select and ``cudaMemsetAsync`` a
memset. The header's other helpers (``quad_max``, ``quad_sum``,
``split_bf16x2``, ``widen_int8x4``, ``cp_async_rows``,
``cp_async_rows_any``, ``store_bf16x2``) are built from
these and from intrinsics supplied here (``__shfl_xor_sync``,
``__uint_as_float``), so they run as written.

The emulated device reports one SM, so launch plans sized to the card
(``fused_quant.cu``'s K splits) reach every plan at small shapes; blocks
run one after another over the grid's x, y and z.

What it proves: the kernel's indexing, masking, online softmax,
reductions and fragment repacks, against the plain versions, at small
shapes. What it cannot: anything of the hardware (timing, shared-memory
limits, bank conflicts, register spills, the tensor cores' own summation
order).
Usage::

    lib = build_emulated("flash_fwd")   # ctypes.CDLL, built on first use
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

from tpu_dist_torch import kernels

FAKE_CUDA_H = r"""
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef int cudaError_t;
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
// a card of one SM, so that small shapes reach every launch plan
enum { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
inline int cudaGetLastError() { return 0; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx;
inline dim3 blockIdx;
inline dim3 blockDim;
inline dim3 gridDim;
inline std::barrier<>* g_block_bar = nullptr;
inline std::vector<std::barrier<>*> g_warp_bar;
inline float g_shfl[64][32];
inline std::vector<float> g_dyn_smem;
inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  g_shfl[w][lane] = v;
  g_warp_bar[w]->arrive_and_wait();
  const float r = g_shfl[w][lane ^ off];
  g_warp_bar[w]->arrive_and_wait();
  return r;
}
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 x) {
  uint32_t u = (uint32_t)x.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if (std::isnan(f)) return {0x7fc0};
  u += 0x7fff + ((u >> 16) & 1);  // round to nearest even
  return {(uint16_t)(u >> 16)};
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  return __float2bfloat16(f);
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// warp_mma.cuh's PTX helpers, in software with the PTX ISA's layouts
#define TDT_CUDA_EMU 1
inline uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__float2bfloat16(lo).bits |
         ((uint32_t)__float2bfloat16(hi).bits << 16);
}
inline float exp2_approx(float x) { return std::exp2(x); }
inline const uint16_t* g_ldsm_row[64][32];
inline uint32_t g_mma_a[64][32][4];
inline uint32_t g_mma_b[64][32][2];
inline float emu_bf16(uint32_t bits) {
  return __bfloat162float(__nv_bfloat16{(uint16_t)(bits & 0xffff)});
}
inline void emu_ldsm(uint32_t r[4], const void* p, bool trans) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  g_ldsm_row[w][lane] = static_cast<const uint16_t*>(p);
  g_warp_bar[w]->arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {  // matrix i: rows from lanes 8i .. 8i+7
    const uint16_t* const* row = &g_ldsm_row[w][8 * i];
    const uint16_t lo = trans ? row[2 * t][g] : row[g][2 * t];
    const uint16_t hi = trans ? row[2 * t + 1][g] : row[g][2 * t + 1];
    r[i] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  g_warp_bar[w]->arrive_and_wait();
}
inline void ldsm_x4(uint32_t r[4], const void* p) { emu_ldsm(r, p, false); }
inline void ldsm_x4_trans(uint32_t r[4], const void* p) {
  emu_ldsm(r, p, true);
}
inline void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                           uint32_t b1) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) g_mma_a[w][lane][i] = a[i];
  g_mma_b[w][lane][0] = b0;
  g_mma_b[w][lane][1] = b1;
  g_warp_bar[w]->arrive_and_wait();
  auto A = [&](int m, int k) {  // A (16 x 16): held by lane (m%8)*4 + (k%8)/2
    const uint32_t r = g_mma_a[w][(m % 8) * 4 + (k % 8) / 2][m / 8 + 2 * (k / 8)];
    return emu_bf16(k & 1 ? r >> 16 : r);
  };
  auto B = [&](int k, int n) {  // B (16 x 8): held by lane n*4 + (k%8)/2
    const uint32_t r = g_mma_b[w][n * 4 + (k % 8) / 2][k / 8];
    return emu_bf16(k & 1 ? r >> 16 : r);
  };
  const int g = lane >> 2, t = lane & 3;
  float out[4];
  for (int i = 0; i < 4; ++i) {  // C: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
    const int m = g + 8 * (i / 2), n = 2 * t + i % 2;
    float sum = 0.f;
    for (int k = 0; k < 16; ++k) sum += A(m, k) * B(k, n);
    out[i] = c[i] + sum;
  }
  g_warp_bar[w]->arrive_and_wait();
  for (int i = 0; i < 4; ++i) c[i] = out[i];
}
inline int g_mma_i[64][32][4];
inline void mma_s8_16832(int c[4], const uint32_t a[4], uint32_t b0,
                         uint32_t b1) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) g_mma_a[w][lane][i] = a[i];
  g_mma_b[w][lane][0] = b0;
  g_mma_b[w][lane][1] = b1;
  g_warp_bar[w]->arrive_and_wait();
  auto byte = [](uint32_t r, int k) {
    return (int)(int8_t)(r >> (8 * (k % 4)));
  };
  auto A = [&](int m, int k) {  // A (16 x 32): lane (m%8)*4 + (k%16)/4
    return byte(g_mma_a[w][(m % 8) * 4 + (k % 16) / 4][m / 8 + 2 * (k / 16)],
                k);
  };
  auto B = [&](int k, int n) {  // B (32 x 8): lane n*4 + (k%16)/4
    return byte(g_mma_b[w][n * 4 + (k % 16) / 4][k / 16], k);
  };
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {  // C: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
    const int m = g + 8 * (i / 2), n = 2 * t + i % 2;
    int sum = 0;
    for (int k = 0; k < 32; ++k) sum += A(m, k) * B(k, n);
    g_mma_i[w][lane][i] = c[i] + sum;
  }
  g_warp_bar[w]->arrive_and_wait();
  for (int i = 0; i < 4; ++i) c[i] = g_mma_i[w][lane][i];
}
inline void cp_async_16(void* dst, const void* src, int bytes) {
  std::memset(dst, 0, 16);
  if (bytes > 0) std::memcpy(dst, src, bytes);
}
inline void cp_async_8(void* dst, const void* src, int bytes) {
  std::memset(dst, 0, 8);
  if (bytes > 0) std::memcpy(dst, src, bytes);
}
inline void cp_async_4(void* dst, const void* src, int bytes) {
  std::memset(dst, 0, 4);
  if (bytes > 0) std::memcpy(dst, src, bytes);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline float __int2float_rn(int x) { return (float)x; }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = ((uint64_t)y << 32) | x;   // selector nibbles 0..7
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
// a block's threads are std::threads: atomics on device memory are real
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p);
  unsigned old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
template <class T> inline T __ldcg(const T* p) { return *p; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
inline int __dp4a(int a, int b, int c) {  // four signed int8 products
  for (int i = 0; i < 4; ++i)
    c += (int)(int8_t)(a >> (8 * i)) * (int)(int8_t)(b >> (8 * i));
  return c;
}
struct char4 { int8_t x, y, z, w; };
struct alignas(8) int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
struct char2 { int8_t x, y; };
inline void emu_launch(dim3 grid, dim3 block, size_t smem,
                       std::function<void()> fn) {
  g_dyn_smem.assign(smem / sizeof(float) + 1, std::nanf(""));
  const int nt = block.x;
  blockDim = block;
  gridDim = grid;
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by, bz);
      std::barrier<> bb(nt);
      g_block_bar = &bb;
      std::vector<std::barrier<>*> wb;
      for (int w = 0; w < nt / 32; ++w) wb.push_back(new std::barrier<>(32));
      g_warp_bar = wb;
      std::vector<std::thread> ts;
      for (int t = 0; t < nt; ++t)
        ts.emplace_back([t, &fn] { threadIdx = dim3(t, 0, 0); fn(); });
      for (auto& th : ts) th.join();
      for (auto* p : wb) delete p;
    }
}
"""


def _rewrite(src: str) -> str:
    src = kernels.LOCAL_INCLUDE.sub(
        lambda m: _read(os.path.join(kernels.CSRC, m.group(1))), src)
    src = src.replace("#include <cuda_bf16.h>", FAKE_CUDA_H)
    src = src.replace("#include <cuda_runtime.h>", "")
    src = src.replace("extern __shared__ float smem[];",
                      "float* smem = g_dyn_smem.data();")
    src = src.replace("__shared__", "static")

    def launch(m):
        grid, block, smem, _stream = (x.strip() for x in m.group(2).split(","))
        return (f"emu_launch(dim3({grid}), dim3({block}), {smem}, "
                f"[&]() {{ {m.group(1)}({m.group(3)}); }});")
    return re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", launch, src,
                  flags=re.S)


def cxx() -> str:
    for cand in (os.environ.get("CXX", ""), "g++", "clang++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no host C++ compiler (g++ / clang++) for the CUDA "
                       "emulation")


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def build_emulated(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` against the emulation (cached by source
    hash under ``<build_dir>/emu``) and load it."""
    return build_source(name, _read(os.path.join(kernels.CSRC,
                                                 kernels.SOURCES[name])))


def build_source(tag: str, source: str) -> ctypes.CDLL:
    """Compile CUDA ``source`` (which may include ``csrc/*.cuh`` headers)
    against the emulation, cached as ``<build_dir>/emu/<tag>.<hash>.so``,
    and load it."""
    src = _rewrite(source)
    digest = hashlib.sha1((src + FAKE_CUDA_H).encode()).hexdigest()[:12]
    out_dir = os.path.join(kernels.build_dir(), "emu")
    lib = os.path.join(out_dir, f"{tag}.{digest}.so")
    if not os.path.isfile(lib):
        os.makedirs(out_dir, exist_ok=True)
        cpp = f"{lib}.{os.getpid()}.cpp"      # per process: parallel builds
        with open(cpp, "w") as f:
            f.write(src)
        tmp = f"{lib}.{os.getpid()}.tmp"
        res = subprocess.run([cxx(), "-std=c++20", "-O1", "-shared", "-fPIC",
                              "-Wno-unknown-pragmas", "-o", tmp, cpp,
                              "-lpthread"], capture_output=True, text=True)
        os.remove(cpp)
        if res.returncode != 0:
            raise RuntimeError(f"emulated build of {tag} failed:\n"
                               f"{res.stderr}")
        os.replace(tmp, lib)
    return ctypes.CDLL(lib)


def function(name: str, symbol: str, argtypes):
    """The emulated C entry ``symbol`` of kernel ``name``, typed like
    :func:`tpu_dist_torch.kernels.function`'s."""
    fn = getattr(build_emulated(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
