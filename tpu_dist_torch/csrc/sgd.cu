// Fused SGD-momentum update for Hopper (sm_90a): kernel 7 of the port.
//
// Replaces: tpu_dist/ops/pallas_sgd.py:_sgd_kernel (Pallas, TPU), run by
// FusedSGD.apply once per parameter leaf per step (TrainConfig
// optimizer="fused_sgd", the image Trainer's apex fused-optimizer analog).
//
// What it computes, elementwise and in fp32 whatever p's type (exactly
// torch.optim.SGD with weight decay and momentum, plus the global-norm clip
// scale):
//   g' = g * cs + wd * p
//   m' = mu * m + g'
//   p' = p - lr * m'
// with the scalar row [lr, mu, wd, cs] in device memory (built on the
// device each step, so nothing syncs the host), p written back in its own
// type, m in fp32. p and m are updated in place (the reference donates
// them).
//
// Bound on an H100 SXM: bytes. It reads p, g, m and writes p, m: 20 bytes
// per fp32 element against 3.35 TB/s; five FLOP per element are far below
// the fp32 SIMT rate. A ResNet-50 step is 161 leaves, about 100 of them
// BatchNorm vectors of 64-2,048 elements, so one launch per leaf costs
// more in launches than in bytes.
//
// Design: one launch over every leaf of one p dtype (multi-tensor apply,
// csrc/multi_tensor.cuh: the host's table of {p, g, m, n} rows goes to the
// kernel by value, each block takes one chunk of `chunk` elements of one
// leaf, leaves with n = 0 own no chunk). The chunk is the plan's
// opt_block_rows times 8: 4096 at the default 512 rows; its 256 threads
// loop over it (64 elements at the least legal 8 rows). A leaf whose pointers are all
// 16-byte aligned (8 for a bf16 p) moves four elements per access, each
// thread issuing all of its 16-byte loads before the first update; the
// ragged tail (n mod 4) and unaligned leaves go element by element.
// Neighbouring threads touch neighbouring addresses either way, so every
// access is coalesced. CAP leaves a launch: 512 where the toolkit allows
// 32,764 bytes of kernel parameters, CUDA >= 12.1, else 96, inside the
// older 4 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "multi_tensor.cuh"

namespace {

constexpr int NT = 256;                // threads per block
constexpr int VPT = 4;                 // 4-element vectors per thread
// leaves per launch: 18,440 bytes of table, or inside the older 4 KB
constexpr int CAP = TDT_LARGE_PARAMS ? 512 : 96;

struct Leaf {                          // the host table's row: 32 bytes
  void* p;
  const float* g;
  float* m;
  long long n;
};

typedef LeafTable<Leaf, CAP> Table;

// one element's update, in the reference kernel's operation order
template <typename T>
__device__ __forceinline__ void step1(T& p, float g, float& m, float lr,
                                      float mu, float wd, float cs) {
  const float pf = to_f<T>(p);
  const float gf = g * cs + wd * pf;
  const float mf = mu * m + gf;
  p = from_f<T>(pf - lr * mf);
  m = mf;
}

template <typename T>
__global__ void __launch_bounds__(NT) sgd_kernel(const Table tab,
                                                 const float* __restrict__ scal,
                                                 int chunk) {
  typedef typename Vec<T>::type PV;
  const int c = blockIdx.x;
  const int li = leaf_of_chunk(tab, c);
  const Leaf leaf = tab.leaf[li];
  T* __restrict__ p = static_cast<T*>(leaf.p);
  const float* __restrict__ g = leaf.g;
  float* __restrict__ m = leaf.m;
  const long long base = (long long)(c - tab.start[li]) * chunk;
  const long long rest = leaf.n - base;
  const int len = (int)(rest < chunk ? rest : chunk);   // elements here
  const float lr = scal[0], mu = scal[1], wd = scal[2], cs = scal[3];
  const bool vec = (((uintptr_t)g | (uintptr_t)m) % 16 == 0) &&
                   ((uintptr_t)p % sizeof(PV) == 0);
  int done = 0;
  if (vec) {
    const int n4 = len / 4;
    PV* p4 = reinterpret_cast<PV*>(p + base);
    const F4* g4 = reinterpret_cast<const F4*>(g + base);
    F4* m4 = reinterpret_cast<F4*>(m + base);
    PV pv[VPT];
    F4 gv[VPT], mv[VPT];
    for (int j0 = threadIdx.x; j0 < n4; j0 += NT * VPT) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {   // every load before the first use
        const int j = j0 + k * NT;
        if (j < n4) {
          pv[k] = p4[j];
          gv[k] = g4[j];
          mv[k] = m4[j];
        }
      }
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int j = j0 + k * NT;
        if (j < n4) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            step1<T>(pv[k].v[e], gv[k].v[e], mv[k].v[e], lr, mu, wd, cs);
          p4[j] = pv[k];
          m4[j] = mv[k];
        }
      }
    }
    done = n4 * 4;
  }
  for (int j = done + threadIdx.x; j < len; j += NT) {
    float mf = m[base + j];
    step1<T>(p[base + j], g[base + j], mf, lr, mu, wd, cs);
    m[base + j] = mf;
  }
}

template <typename T>
int launch(const Leaf* rows, int n_leaves, const float* scal, int chunk,
           cudaStream_t stream) {
  return for_each_table<CAP>(
      rows, n_leaves, chunk, [&](const Table& tab, unsigned chunks) {
        sgd_kernel<T><<<chunks, NT, 0, stream>>>(tab, scal, chunk);
        return (int)cudaGetLastError();
      });
}

}  // namespace

// One update of every leaf in the host table `table` (n_leaves rows of
// {p, g, m, n}: pointers to p, fp32 g and fp32 m, and the element count;
// rows with n = 0 are skipped) with the 4-float fp32 scalar row
// [lr, mu, wd, cs] in device memory, `chunk` elements a block. p_dtype: 0
// = float32, 1 = bfloat16, for every row. Returns the first failed
// launch's cudaError_t (0 = every launch went out, or nothing to do); -1
// for an unknown dtype, a negative count, a chunk that is not a positive
// multiple of 64, or more than 2^31 - 1 chunks in one launch.
extern "C" int tdt_sgd_multi(const void* table, int n_leaves,
                             const void* scalars, int p_dtype, int chunk,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Leaf* rows = static_cast<const Leaf*>(table);
  const float* scal = static_cast<const float*>(scalars);
  if (p_dtype == 0) return launch<float>(rows, n_leaves, scal, chunk, s);
  if (p_dtype == 1)
    return launch<__nv_bfloat16>(rows, n_leaves, scal, chunk, s);
  return -1;
}
