"""Run the port's CUDA kernels on the CPU, for rehearsal without a GPU.

A CUDA kernel has no interpret mode. This tool compiles a kernel source
from ``tpu_dist_torch/csrc`` with the host C++ compiler against a small
emulation of the CUDA features those kernels use: one ``std::thread``
per CUDA thread, ``std::barrier`` for ``__syncthreads`` and for warp
shuffles, function-level statics for ``__shared__`` arrays (blocks run
one after another), and a software bf16. The source is rewritten only
mechanically (includes, ``extern __shared__``, ``__shared__``, and the
``<<<...>>>`` launch). The library keeps the kernel's plain C entry
point, so the same Python wrapper code drives it with CPU tensors and
``stream=None``.

What it proves: the kernel's indexing, masking, online softmax and
reductions, against the plain versions, at small shapes. What it cannot:
anything of the hardware (timing, shared-memory limits, bank conflicts,
PTX such as mma/wgmma, which a kernel using them cannot emulate).
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
#define __launch_bounds__(x)
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef int cudaError_t;
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
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
inline float __int2float_rn(int x) { return (float)x; }
inline int __dp4a(int a, int b, int c) {  // four signed int8 products
  for (int i = 0; i < 4; ++i)
    c += (int)(int8_t)(a >> (8 * i)) * (int)(int8_t)(b >> (8 * i));
  return c;
}
struct char4 { int8_t x, y, z, w; };
struct char2 { int8_t x, y; };
inline void emu_launch(dim3 grid, dim3 block, size_t smem,
                       std::function<void()> fn) {
  g_dyn_smem.assign(smem / sizeof(float) + 1, std::nanf(""));
  const int nt = block.x;
  blockDim = block;
  gridDim = grid;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by, 1);
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


def build_emulated(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` against the emulation (cached by source
    hash under ``<build_dir>/emu``) and load it."""
    with open(os.path.join(kernels.CSRC, kernels.SOURCES[name])) as f:
        src = _rewrite(f.read())
    digest = hashlib.sha1((src + FAKE_CUDA_H).encode()).hexdigest()[:12]
    out_dir = os.path.join(kernels.build_dir(), "emu")
    lib = os.path.join(out_dir, f"{name}.{digest}.so")
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
            raise RuntimeError(f"emulated build of {name} failed:\n"
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
