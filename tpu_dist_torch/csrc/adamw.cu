// Fused AdamW update for Hopper (sm_90a): kernel 8 of the port.
//
// Replaces: tpu_dist/ops/pallas_adamw.py:_adamw_kernel (Pallas, TPU), run by
// FusedAdamW.apply once per parameter leaf per step (LMConfig
// optimizer="fused_adamw").
//
// What it computes, elementwise and in fp32 whatever p's type (optax.adamw
// with eps_root = 0, plus the global-norm clip scale):
//   g  <- g * cs
//   m' = b1 m + (1 - b1) g;   v' = b2 v + (1 - b2) g g
//   p' = p - lr ((m' / c1) / (sqrt(v' / c2) + eps) + wd p)
// with the scalar row [lr, b1, b2, eps, wd, c1 = 1-b1^t, c2 = 1-b2^t, cs] in
// device memory (built on the device each step, so nothing syncs the host),
// p written back in its own type, m and v in fp32. p, m and v are updated in
// place (the reference donates them).
//
// Bound on an H100 SXM: bytes. It reads p, g, m, v and writes p, m, v: 28
// bytes per fp32 element against 3.35 TB/s; a dozen FLOP per element is far
// below the fp32 SIMT rate.
//
// Design: one grid-stride launch per leaf, 256 threads a block and at most
// 8 blocks per SM, each thread loading the scalar row once; neighbouring
// threads touch neighbouring elements, so every access is coalesced. No
// vector loads yet (the leaves need no 16-byte alignment of their length).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_BLOCKS = 132 * 8;

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

template <typename T>
__global__ void __launch_bounds__(NT) adamw_kernel(
    T* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
    float* __restrict__ v, const float* __restrict__ scal, long long n) {
  const float lr = scal[0], b1 = scal[1], b2 = scal[2], eps = scal[3];
  const float wd = scal[4], c1 = scal[5], c2 = scal[6], cs = scal[7];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float pf = to_f<T>(p[i]);
    const float gf = g[i] * cs;
    const float mf = b1 * m[i] + (1.f - b1) * gf;
    const float vf = b2 * v[i] + (1.f - b2) * gf * gf;
    const float upd = (mf / c1) / (sqrtf(vf / c2) + eps) + wd * pf;
    p[i] = from_f<T>(pf - lr * upd);
    m[i] = mf;
    v[i] = vf;
  }
}

template <typename T>
int launch(void* p, const void* g, void* m, void* v, const void* scal,
           long long n, cudaStream_t stream) {
  const long long want = (n + NT - 1) / NT;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  adamw_kernel<T><<<blocks, NT, 0, stream>>>(
      static_cast<T*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const float*>(scal), n);
  return (int)cudaGetLastError();
}

}  // namespace

// p_dtype: 0 = float32, 1 = bfloat16; g, m, v and the 8-float scalar row are
// float32. Returns the launch's cudaError_t (0 = launched); -1 for an unknown
// dtype; 0 without a launch for n = 0.
extern "C" int tdt_adamw(void* p, const void* g, void* m, void* v,
                         const void* scalars, long long n, int p_dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (p_dtype == 0) return launch<float>(p, g, m, v, scalars, n, s);
  if (p_dtype == 1) return launch<__nv_bfloat16>(p, g, m, v, scalars, n, s);
  return -1;
}
