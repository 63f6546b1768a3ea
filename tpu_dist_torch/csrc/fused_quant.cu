// Fused int8 matmul for Hopper (sm_90a): quantize -> int8 dot -> dequant in
// one launch. Kernel 6 of the port.
//
// Replaces: tpu_dist/ops/pallas_quant.py:_fused_quant_kernel (Pallas, TPU),
// reached through fused_quant_matmul behind ops/quant.py:quant_matmul(mode=
// "int8"): every QuantDense of the LM (qkv, proj, mlp_in, mlp_out, lm_head)
// under ServeConfig(quant="int8") and LMTrainer(quant="int8").
//
// What it computes: out (M, N) = dequant(q(x) . q(w)) for x (M, K) and w
// (K, N) of one float type (fp32 or bf16), with the reference's numerics:
// per-row scales of x and per-column scales of w, scale = max(amax, 1e-8) /
// 127 (amax over the whole of K); q = clamp(rint(v / scale), -127, 127) with
// an IEEE division and rint's half-to-even; int32 accumulation; then
// float(acc) * (sx * sw), rounded once to the output type. int32 sums are
// exact, so the result is bit-equal to the plain version.
//
// Bound on an H100 SXM: at the LM's shapes, bytes. x, w and out cross HBM
// once each at best (a decode tick's M = 8 does 16 int8 operations per
// weight byte, far below the 1979 TOP/s : 3.35 TB/s ridge); a prefill's
// M = 1024 lm_head sits near the ridge.
//
// Design (first version: right and simple, not fast). Like the TPU kernel
// it keeps every int8 value and the int32 accumulator out of device memory:
// one launch, one block of 256 threads per 64 x 64 output tile. The block
// first reduces, over the whole of K, the amax of its 64 rows of x (a warp
// per row) and of its 64 columns of w (four threads per column), exactly as
// the TPU kernel recomputes them per tile. Then it walks K in chunks of 64:
// it quantizes the x chunk and the w chunk into shared memory, w transposed
// so that four consecutive k of one column pack into one int, and each
// thread accumulates a 4 x 4 micro-tile with __dp4a (four int8 products
// into an int32 per instruction). K = 4096 does not fit a whole (64, K)
// tile in shared memory, so the amax pass and the quantize pass each stream
// K: x and w are read twice per block, and w once more for every 64 rows of
// M. That is this kernel's price; int8 tensor cores (mma/wgmma s8) with
// TMA-fed tiles are the later performance step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 64;       // k per chunk
constexpr int KW = BK / 4;   // packed int8x4 words per row per chunk
constexpr int NT = 256;      // threads per block: a 16 x 16 grid of 4 x 4 tiles
constexpr float EPS = 1e-8f;
constexpr float QMAX = 127.0f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// clamp(rint(v / s), -127, 127): IEEE division, round half to even
__device__ __forceinline__ int quant1(float v, float s) {
  return (int)fminf(fmaxf(rintf(v / s), -QMAX), QMAX);
}

__device__ __forceinline__ int pack4(const int* q) {
  return (int)(((uint32_t)q[0] & 0xffu) | (((uint32_t)q[1] & 0xffu) << 8) |
               (((uint32_t)q[2] & 0xffu) << 16) |
               (((uint32_t)q[3] & 0xffu) << 24));
}

template <typename T>
__global__ void __launch_bounds__(NT) fused_quant_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int M, int K, int N) {
  __shared__ int sX[BM][KW + 1];   // quantized x chunk, 4 k per word
  __shared__ int sW[BN][KW + 1];   // quantized w chunk, transposed
  __shared__ float sSx[BM];        // per-row scales of x
  __shared__ float sSw[BN];        // per-column scales of w
  __shared__ float sRed[NT];       // partial column maxima

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  // row amax of x over all of K: one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BM; r += NT / 32) {
    float mx = 0.f;
    if (m0 + r < M) {
      const T* row = x + (long)(m0 + r) * K;
      for (int k = lane; k < K; k += 32) mx = fmaxf(mx, fabsf(to_f<T>(row[k])));
    }
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) sSx[r] = fmaxf(mx, EPS) / QMAX;
  }
  // column amax of w over all of K: four threads per column, rows strided
  {
    const int c = tid % BN, part = tid / BN;
    float mx = 0.f;
    if (n0 + c < N) {
#pragma unroll 8
      for (int k = part; k < K; k += NT / BN)
        mx = fmaxf(mx, fabsf(to_f<T>(w[(long)k * N + n0 + c])));
    }
    sRed[tid] = mx;
  }
  __syncthreads();
  if (tid < BN) {
    const float mx = fmaxf(fmaxf(sRed[tid], sRed[tid + BN]),
                           fmaxf(sRed[tid + 2 * BN], sRed[tid + 3 * BN]));
    sSw[tid] = fmaxf(mx, EPS) / QMAX;
  }
  __syncthreads();

  const int ty = tid / 16, tx = tid % 16;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x chunk: rows of BM, 4 consecutive k per word; ragged M and K are zeros
    for (int i = tid; i < BM * KW; i += NT) {
      const int r = i / KW, kw = i % KW, k = k0 + 4 * kw;
      int q[4] = {0, 0, 0, 0};
      if (m0 + r < M) {
        const T* row = x + (long)(m0 + r) * K;
        const float s = sSx[r];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < K) q[j] = quant1(to_f<T>(row[k + j]), s);
      }
      sX[r][kw] = pack4(q);
    }
    // w chunk, transposed: neighbouring threads read neighbouring columns
    for (int i = tid; i < BN * KW; i += NT) {
      const int c = i % BN, kw = i / BN, k = k0 + 4 * kw;
      int q[4] = {0, 0, 0, 0};
      if (n0 + c < N) {
        const float s = sSw[c];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < K) q[j] = quant1(to_f<T>(w[(long)(k + j) * N + n0 + c]), s);
      }
      sW[c][kw] = pack4(q);
    }
    __syncthreads();
#pragma unroll 4
    for (int kw = 0; kw < KW; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sX[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sW[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the chunk's readers are done before the next write
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (m0 + r >= M) continue;
    T* orow = out + (long)(m0 + r) * N + n0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (n0 + c < N)
        orow[c] = from_f<T>(__int2float_rn(acc[i][j]) * (sSx[r] * sSw[c]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int M, int K, int N,
           cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_quant_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike). Returns the
// launch's cudaError_t (0 = launched); -1 for a dtype this build lacks.
extern "C" int tdt_fused_quant(const void* x, const void* w, void* out, int M,
                               int K, int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, M, K, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, M, K, N, s);
  return -1;
}
