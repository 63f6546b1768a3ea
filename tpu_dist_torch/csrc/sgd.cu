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
// the fp32 SIMT rate.
//
// Design: one grid-stride launch per flat leaf (the TPU kernel's
// (rows, 128) blocking is a VMEM artifact, not part of the function), 256
// threads a block and at most 8 blocks per SM, each thread loading the
// scalar row once. When every pointer is 16-byte aligned (8 for a bf16 p)
// the body moves four elements a thread with one 16-byte load of g and m
// and one 16- or 8-byte access of p; the ragged tail (n mod 4) and
// unaligned leaves go element by element. Neighbouring threads touch
// neighbouring addresses either way, so every access is coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_BLOCKS = 132 * 8;

struct alignas(16) F4 { float v[4]; };
struct alignas(8) B4 { __nv_bfloat16 v[4]; };

template <typename T> struct Vec;
template <> struct Vec<float> { typedef F4 type; };
template <> struct Vec<__nv_bfloat16> { typedef B4 type; };

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

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

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT) sgd_kernel(
    T* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
    const float* __restrict__ scal, long long n) {
  const float lr = scal[0], mu = scal[1], wd = scal[2], cs = scal[3];
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (VEC) {
    typedef typename Vec<T>::type PV;
    const long long n4 = n / 4;
    PV* p4 = reinterpret_cast<PV*>(p);
    const F4* g4 = reinterpret_cast<const F4*>(g);
    F4* m4 = reinterpret_cast<F4*>(m);
    for (long long j = i; j < n4; j += stride) {
      PV pv = p4[j];
      const F4 gv = g4[j];
      F4 mv = m4[j];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        step1<T>(pv.v[k], gv.v[k], mv.v[k], lr, mu, wd, cs);
      p4[j] = pv;
      m4[j] = mv;
    }
    done = n4 * 4;
  }
  for (long long j = done + i; j < n; j += stride) {
    float mf = m[j];
    step1<T>(p[j], g[j], mf, lr, mu, wd, cs);
    m[j] = mf;
  }
}

template <typename T>
int launch(void* p, const void* g, void* m, const void* scal, long long n,
           cudaStream_t stream) {
  const bool vec = ((uintptr_t)g % 16 == 0) && ((uintptr_t)m % 16 == 0) &&
                   ((uintptr_t)p % sizeof(typename Vec<T>::type) == 0);
  const long long work = vec ? (n + 3) / 4 : n;
  const long long want = (work + NT - 1) / NT;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  T* pt = static_cast<T*>(p);
  const float* gt = static_cast<const float*>(g);
  float* mt = static_cast<float*>(m);
  const float* st = static_cast<const float*>(scal);
  if (vec)
    sgd_kernel<T, true><<<blocks, NT, 0, stream>>>(pt, gt, mt, st, n);
  else
    sgd_kernel<T, false><<<blocks, NT, 0, stream>>>(pt, gt, mt, st, n);
  return (int)cudaGetLastError();
}

}  // namespace

// p_dtype: 0 = float32, 1 = bfloat16; g, m and the 4-float scalar row
// [lr, mu, wd, cs] are float32. Returns the launch's cudaError_t
// (0 = launched); -1 for an unknown dtype; 0 without a launch for n = 0.
extern "C" int tdt_sgd(void* p, const void* g, void* m, const void* scalars,
                       long long n, int p_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (p_dtype == 0) return launch<float>(p, g, m, scalars, n, s);
  if (p_dtype == 1) return launch<__nv_bfloat16>(p, g, m, scalars, n, s);
  return -1;
}
