"""Run the port's CUDA kernels on the CPU, for rehearsal without a GPU.

A CUDA kernel has no interpret mode. This tool compiles a kernel source
from ``tpu_dist_torch/csrc`` with the host C++ compiler against a small
emulation of the CUDA features those kernels use: one fiber per CUDA
thread, all of a block's fibers run by a scheduler on the calling OS
thread, counter-and-generation barriers for ``__syncthreads`` and for
warp shuffles, function-level statics for ``__shared__`` arrays (blocks
run one after another), and a software bf16. The source is rewritten only
mechanically (includes, ``extern __shared__``, ``__shared__``, and the
``<<<...>>>`` launch); the local headers it includes (``csrc/*.cuh``) are
inlined. The library keeps the kernel's plain C entry point, so the same
Python wrapper code drives it with CPU tensors and ``stream=None``.

The scheduler. A launch takes one stack per CUDA thread (64 KiB with a
guard page below, mapped once and reused by later launches) and, block by
block, starts a fiber on each and resumes them round-robin until all have
returned; a returned fiber is never resumed. A fiber that reaches a
barrier counts itself in and yields; the scheduler resumes it once the
barrier's generation has moved, that is once every thread of the block
(``__syncthreads``) or of the warp (a warp collective) has arrived.
``threadIdx`` is a plain global that the scheduler sets before each
resume. A switch saves the callee-saved registers and the floating-point
control words in a few instructions (x86-64 only): no system call per
switch or barrier, and no OS thread. Between barriers the fibers run in
thread order (``order="forward"``) or in reverse (``order="reverse"``,
compiled into a library of its own): the run is deterministic, and a read
of shared memory that a later thread writes with no barrier between (a
race on the card) reads the stale value in one of the two orders on every
run. A block whose live fibers all wait on barriers that cannot fill (a
``__syncthreads`` that only some threads reach) stops the call: its entry
raises :class:`EmulationError`, naming the kernel and the block, and
launches nothing more.

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
shapes; that a block's threads meet at every barrier; and, through the two
orders, that no result depends on how threads interleave between
barriers. What it cannot: anything of the hardware (timing, shared-memory
limits, bank conflicts, register spills, the tensor cores' own summation
order), a race that only the card's memory model shows (a fiber runs
until its next barrier, so no two threads interleave inside a stretch of
code), or a race between blocks (they run one after another).
Usage::

    lib = build_emulated("flash_fwd")   # ctypes.CDLL, built on first use
    fns = entries("flash", "dq")        # typed C entries, built in parallel
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess

from tpu_dist_torch import kernels
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.ops import paged_attention as pa
from tpu_dist_torch.ops import pallas_quant as pq
from tpu_dist_torch.ops import pallas_sgd as sgd

# the scheduler's orders between barriers: thread 0 first, or the last first
ORDERS = ("forward", "reverse")

# entries() keys: (kernel, C entry, argtypes)
ENTRIES = {
    "flash": ("flash_fwd", "tdt_flash_fwd", fa._FLASH_ARGS),
    "dq": ("flash_bwd_dq", "tdt_flash_bwd_dq", fa._BWD_DQ_ARGS),
    "dkv": ("flash_bwd_dkv", "tdt_flash_bwd_dkv", fa._BWD_DKV_ARGS),
    "int8kv": ("flash_fwd_int8kv", "tdt_flash_fwd_int8kv", fa._INT8KV_ARGS),
    "paged": ("paged_decode", "tdt_paged_decode", pa._PAGED_ARGS),
    "adamw": ("adamw", "tdt_adamw_multi", sgd.MULTI_ARGS),
    "sgd": ("sgd", "tdt_sgd_multi", sgd.MULTI_ARGS),
    "quant": ("fused_quant", "tdt_fused_quant", pq._FUSED_QUANT_ARGS),
    "quant_ws": ("fused_quant", "tdt_fused_quant_workspace",
                 pq._WORKSPACE_ARGS),
    "quant_amax": ("fused_quant", "tdt_fused_quant_amax", pq._AMAX_ARGS),
    "quant_scaled": ("fused_quant", "tdt_fused_quant_scaled",
                     pq._SCALED_ARGS),
    "quant_tiles": ("fused_quant", "tdt_fused_quant_tiles", pq._TILES_ARGS),
}
# the five attention kernels' keys (chip_smoke.five_at_head_dim's entries)
ATTENTION = ("flash", "dq", "dkv", "int8kv", "paged")

FAKE_CUDA_H = r"""
#include <sys/mman.h>
#include <unistd.h>
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <memory>
#include <string>
#include <vector>
#if !defined(__x86_64__)
#error "the CUDA emulation's fiber switch is written for x86-64"
#endif
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
inline dim3 threadIdx;   // the running fiber's, set by the scheduler
inline dim3 blockIdx;
inline dim3 blockDim;
inline dim3 gridDim;
// One fiber per CUDA thread, on the calling OS thread. emu_switch saves the
// callee-saved registers and the SSE/x87 control words on the current
// stack, stores the stack pointer to *save and continues on stack `to`.
extern "C" __attribute__((visibility("hidden"))) void emu_switch(void** save,
                                                                 void* to);
asm(R"(
  .pushsection .text
  .p2align 4
  .globl emu_switch
  .hidden emu_switch
  .type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  subq $8, %rsp
  stmxcsr (%rsp)
  fnstcw 4(%rsp)
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  ldmxcsr (%rsp)
  fldcw 4(%rsp)
  addq $8, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_switch, .-emu_switch
  .popsection
)");
#ifdef TDT_EMU_REVERSE
constexpr bool kEmuReverse = true;   // between barriers: last thread first
#else
constexpr bool kEmuReverse = false;
#endif
// a fiber's stack: 14 times the deepest seen over every emulated test
// (4604 bytes, with the lazy binder's register save), beyond any frame
// g++ -fstack-usage reports here (4224 bytes)
constexpr size_t kEmuStack = 64 * 1024;
struct EmuBarrier { unsigned expected = 0, count = 0, gen = 0; };
struct EmuFiber {
  void* sp = nullptr;
  EmuBarrier* bar = nullptr;   // the barrier it waits on, or null
  unsigned gen = 0;            // that barrier's generation when it arrived
  bool done = false;
};
inline std::vector<EmuFiber> g_fiber;
inline int g_cur = 0;
inline void* g_sched_sp = nullptr;
inline const std::function<void()>* g_kernel = nullptr;
inline std::string g_emu_error;   // a failed launch, for the entry's caller
inline EmuBarrier g_block_bar;
inline std::vector<EmuBarrier> g_warp_bar;
inline float g_shfl[64][32];
inline std::vector<float> g_dyn_smem;
// count the fiber in and yield; the scheduler resumes it once b.gen moved
inline void emu_wait(EmuBarrier& b) {
  EmuFiber& f = g_fiber[g_cur];
  f.bar = &b;
  f.gen = b.gen;
  if (++b.count == b.expected) {
    b.count = 0;
    ++b.gen;
  }
  emu_switch(&f.sp, g_sched_sp);
}
inline void __syncthreads() { emu_wait(g_block_bar); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  g_shfl[w][lane] = v;
  emu_wait(g_warp_bar[w]);
  const float r = g_shfl[w][lane ^ off];
  emu_wait(g_warp_bar[w]);
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
  emu_wait(g_warp_bar[w]);
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {  // matrix i: rows from lanes 8i .. 8i+7
    const uint16_t* const* row = &g_ldsm_row[w][8 * i];
    const uint16_t lo = trans ? row[2 * t][g] : row[g][2 * t];
    const uint16_t hi = trans ? row[2 * t + 1][g] : row[g][2 * t + 1];
    r[i] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  emu_wait(g_warp_bar[w]);
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
  emu_wait(g_warp_bar[w]);
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
  emu_wait(g_warp_bar[w]);
  for (int i = 0; i < 4; ++i) c[i] = out[i];
}
inline int g_mma_i[64][32][4];
inline void mma_s8_16832(int c[4], const uint32_t a[4], uint32_t b0,
                         uint32_t b1) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) g_mma_a[w][lane][i] = a[i];
  g_mma_b[w][lane][0] = b0;
  g_mma_b[w][lane][1] = b1;
  emu_wait(g_warp_bar[w]);
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
  emu_wait(g_warp_bar[w]);
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
// a block's fibers share one OS thread, but a kernel's atomics stay atomic
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
[[noreturn]] inline void emu_fiber_main() {
  (*g_kernel)();
  g_fiber[g_cur].done = true;
  void* unused;
  emu_switch(&unused, g_sched_sp);
  __builtin_unreachable();
}
// the fiber stacks: one mapping, a guard page below each stack
struct EmuStacks {
  int n;
  size_t page, slot, bytes;
  char* base;
  explicit EmuStacks(int n)
      : n(n), page(sysconf(_SC_PAGESIZE)), slot(page + kEmuStack),
        bytes(n * slot) {
    void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    base = p == MAP_FAILED ? nullptr : static_cast<char*>(p);
    for (int t = 0; base && t < n; ++t)
      mprotect(base + t * slot, page, PROT_NONE);
  }
  ~EmuStacks() {
    if (base) munmap(base, bytes);
  }
  // a fresh fiber's stack: emu_switch's frame returning into emu_fiber_main
  void* start(int t) const {
    void** sp = reinterpret_cast<void**>(base + (t + 1) * slot);
    *--sp = nullptr;   // emu_fiber_main's return address: it never returns
    *--sp = reinterpret_cast<void*>(&emu_fiber_main);
    for (int i = 0; i < 6; ++i) *--sp = nullptr;   // rbp, rbx, r12-r15
    uint32_t ctl[2] = {0, 0};
    asm volatile("stmxcsr %0\n\tfnstcw %1" : "=m"(ctl[0]), "=m"(ctl[1]));
    --sp;
    std::memcpy(sp, ctl, sizeof ctl);
    return sp;
  }
};
// mapped on the first launch and again only for a larger block, so that a
// launch makes no system call and touches stack pages already faulted in
// (g++ makes this static one for every emulated library in the process)
inline const EmuStacks& emu_stacks(int n) {
  static std::unique_ptr<EmuStacks> stacks;
  if (!stacks || stacks->n < n) {
    stacks.reset();
    stacks = std::make_unique<EmuStacks>(n);
  }
  return *stacks;
}
// run one block's fibers round-robin until all have returned; false (and
// g_emu_error set) if the live ones all wait on barriers that cannot fill
inline bool emu_run_block(const char* kernel, int nt) {
  for (;;) {
    bool live = false, ran = false;
    for (int k = 0; k < nt; ++k) {
      const int t = kEmuReverse ? nt - 1 - k : k;
      EmuFiber& f = g_fiber[t];
      if (f.done) continue;
      live = true;
      if (f.bar && f.bar->gen == f.gen) continue;   // still waiting
      f.bar = nullptr;
      ran = true;
      g_cur = t;
      threadIdx = dim3(t, 0, 0);
      emu_switch(&g_sched_sp, f.sp);
    }
    if (!live) return true;
    if (!ran) break;
  }
  int done = 0, at_block = 0;
  for (const EmuFiber& f : g_fiber) {
    done += f.done;
    at_block += !f.done && f.bar == &g_block_bar;
  }
  char msg[512];
  std::snprintf(msg, sizeof msg,
                "emulated kernel %s, block (%u, %u, %u): deadlock: of its %d "
                "threads %d wait at __syncthreads, %d at a warp collective "
                "and %d have returned, so no barrier can fill",
                kernel, blockIdx.x, blockIdx.y, blockIdx.z, nt, at_block,
                nt - done - at_block, done);
  g_emu_error = msg;
  return false;
}
inline void emu_launch(const char* kernel, dim3 grid, dim3 block, size_t smem,
                       const std::function<void()>& fn) {
  if (!g_emu_error.empty()) return;   // a failed launch ends the call's work
  g_dyn_smem.assign(smem / sizeof(float) + 1, std::nanf(""));
  const int nt = block.x;
  blockDim = block;
  gridDim = grid;
  const EmuStacks& stacks = emu_stacks(nt);
  if (!stacks.base) {
    g_emu_error = std::string("emulated kernel ") + kernel +
                  ": no memory for its fiber stacks";
    return;
  }
  g_kernel = &fn;
  g_fiber.assign(nt, EmuFiber{});
  g_block_bar = EmuBarrier{(unsigned)nt};
  g_warp_bar.assign((nt + 31) / 32, EmuBarrier{});
  for (int w = 0; w < (int)g_warp_bar.size(); ++w)
    g_warp_bar[w].expected = std::min(32, nt - 32 * w);
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by, bz);
      for (int t = 0; t < nt; ++t) g_fiber[t] = EmuFiber{stacks.start(t)};
      if (!emu_run_block(kernel, nt)) return;
    }
}
// the failure of the last launches, if any, cleared as it is read
extern "C" const char* tdt_emu_take_error() {
  static std::string taken;
  taken.swap(g_emu_error);
  g_emu_error.clear();
  return taken.empty() ? nullptr : taken.c_str();
}
"""



class EmulationError(RuntimeError):
    """A launch that the emulation's scheduler could not finish."""


class _Library(ctypes.CDLL):
    """An emulated library whose C entries raise :class:`EmulationError`
    when one of their launches failed (and then launched nothing more)."""

    def __init__(self, path: str):
        super().__init__(path)
        self._take_error = super().__getitem__("tdt_emu_take_error")
        self._take_error.argtypes = []
        self._take_error.restype = ctypes.c_char_p

    def __getitem__(self, name):
        fn = super().__getitem__(name)
        fn.errcheck = self._check
        return fn

    def _check(self, result, fn, args):
        err = self._take_error()
        if err:
            raise EmulationError(err.decode())
        return result


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
        name = " ".join(m.group(1).split())
        return (f'emu_launch("{name}", dim3({grid}), dim3({block}), {smem}, '
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


def build_sources(sources: dict, order: str = "forward") -> dict:
    """Compile each CUDA source of ``{tag: source}`` (which may include
    ``csrc/*.cuh`` headers) against the emulation with the scheduler's
    ``order`` (one of ORDERS), the missing ones in parallel, each cached as
    ``<build_dir>/emu/<tag>.<hash>.so``; ``{tag: loaded library}``. A
    library is built once across processes: the one holding its
    ``.lock`` builds it, the others wait for it."""
    if order not in ORDERS:
        raise ValueError(f"order {order!r} is not one of {ORDERS}")
    out_dir = os.path.join(kernels.build_dir(), "emu")
    os.makedirs(out_dir, exist_ok=True)
    libs, todo = {}, {}
    for tag, source in sources.items():
        src = _rewrite(source)
        if order == "reverse":
            src = "#define TDT_EMU_REVERSE 1\n" + src
        digest = hashlib.sha1((src + FAKE_CUDA_H).encode()).hexdigest()[:12]
        libs[tag] = os.path.join(out_dir, f"{tag}.{digest}.so")
        todo[tag] = src
    while todo := {t: src for t, src in todo.items()
                   if not os.path.isfile(libs[t])}:
        procs, waiting = {}, []
        for tag, src in todo.items():
            fd = os.open(f"{libs[tag]}.lock", os.O_CREAT | os.O_RDWR)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except BlockingIOError:     # another process is building it
                waiting.append(fd)
                continue
            procs[tag] = (fd, None if os.path.isfile(libs[tag])
                          else _start_build(libs[tag], src))
        failed = []
        for tag, (fd, job) in procs.items():
            if job is not None:
                proc, cpp, tmp = job
                log, _ = proc.communicate()
                os.remove(cpp)
                if proc.returncode != 0:
                    failed.append(f"emulated build of {tag} failed:\n{log}")
                else:
                    os.replace(tmp, libs[tag])
            os.close(fd)                # releases the lock
        for fd in waiting:
            fcntl.flock(fd, fcntl.LOCK_EX)
            os.close(fd)
        if failed:
            raise RuntimeError("\n".join(failed))
    return {tag: _Library(lib) for tag, lib in libs.items()}


def _start_build(lib: str, src: str):
    cpp = f"{lib}.{os.getpid()}.cpp"      # per process: parallel builds
    with open(cpp, "w") as f:
        f.write(src)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [cxx(), "-std=c++20", "-O1", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-o", tmp, cpp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, cpp, tmp


def build_source(tag: str, source: str, order: str = "forward") -> ctypes.CDLL:
    """:func:`build_sources` of one source: its loaded library."""
    return build_sources({tag: source}, order)[tag]


def build_emulated(name: str, order: str = "forward") -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` against the emulation (cached by source
    hash under ``<build_dir>/emu``) and load it."""
    return build_source(name, _source(name), order)


def _source(name: str) -> str:
    return _read(os.path.join(kernels.CSRC, kernels.SOURCES[name]))


def _typed(lib: ctypes.CDLL, symbol: str, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def function(name: str, symbol: str, argtypes, order: str = "forward"):
    """The emulated C entry ``symbol`` of kernel ``name``, typed like
    :func:`tpu_dist_torch.kernels.function`'s."""
    return _typed(build_emulated(name, order), symbol, argtypes)


def entries(*keys: str, order: str = "forward") -> dict:
    """The typed emulated C entries of ``keys`` (of ENTRIES), their
    libraries built in parallel: ``{key: entry}``."""
    names = {ENTRIES[k][0] for k in keys}
    libs = build_sources({n: _source(n) for n in sorted(names)}, order)
    return {k: _typed(libs[ENTRIES[k][0]], *ENTRIES[k][1:]) for k in keys}
