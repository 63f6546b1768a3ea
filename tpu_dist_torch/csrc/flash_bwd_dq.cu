// FlashAttention-2 backward, dq pass, for Hopper (sm_90a): kernel 3 of the port.
//
// Replaces: tpu_dist/ops/flash_attention.py:_fa_bwd_dq_kernel (Pallas, TPU),
// reached through _fa_backward / flash_attention_fn's custom_vjp. LM training
// runs it once per layer per step (model attn_fn = flash_attention_fn()).
//
// What it computes, per (batch, head) and q row i:
//   dq_i = sum_j ds_ij K_j,  ds_ij = p_ij (dO_i . V_j - delta_i) * scale,
//   p_ij = exp(s_ij - lse_i) with s_ij = scale * q_i . k_j,
// with the forward's causal rule over global positions (q_offset + i,
// kv_offset + j) and the forward's p = 0 guard for masked scores, so a fully
// masked row gets an exact zero gradient. lse (B*H, Lq) comes from the
// forward kernel, delta = rowsum(out * dO) (B*H, Lq) from plain PyTorch, as
// the reference computes it outside Pallas. Rounding point: ds is rounded to
// K's storage type before the ds.K product (the TPU kernel's
// ds.astype(k.dtype)); the product accumulates in fp32 and dq is written in
// q's type.
//
// Bound on an H100 SXM: operations. Three products of 2*Lq*Lk*D FLOP per
// (batch, head) (about half when causal) against 989 TFLOP/s of bf16 tensor
// cores; q, k, v, dO, dq are read or written once.
//
// Design (first version: right and simple, not fast): one block of 256
// threads per (b*h, 64-row q tile); the loop over 64-row k/v tiles runs
// inside the block, so every output tile has one owner and no atomics are
// needed (the reference's two-pass split). Q and dO stay in shared memory
// for the whole loop; V, then K, pass through one padded buffer (stride
// D+1: the column reads of the 16x16 thread grid hit distinct banks). Each
// thread owns a 4x4 micro-tile of S and dP and a 4 x D/16 slice of the dq
// accumulator in registers. Tiles wholly above the causal diagonal are never
// loaded; ragged edges are masked, so any length works. The products run on
// the fp32 SIMT pipes: mma/wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // k/v rows per tile
constexpr int NT = 256;   // threads per block: a 16 x 16 grid
constexpr float NEG_INF = -1e30f;

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

template <int D>
constexpr size_t smem_floats() {
  return 2 * (size_t)BQ * (D + 1)  // Q tile, dO tile
         + (size_t)BK * (D + 1)    // V tile, then K tile
         + (size_t)BQ * (BK + 1)   // ds, rounded to K's type
         + 2 * (size_t)BQ;         // lse, delta
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int Lq,
    int Lk, int causal, int q_offset, int kv_offset, float scale) {
  constexpr int DP = D + 1;
  constexpr int SP = BK + 1;
  constexpr int NJ = D / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + BQ * DP;
  float* sKV = sG + BQ * DP;
  float* sS = sKV + BK * DP;
  float* sLse = sS + BQ * SP;
  float* sDelta = sLse + BQ;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long rs = (long)H * D;  // stride between sequence positions
  const T* qb = q + (long)b * Lq * rs + (long)h * D;
  const T* gb = g + (long)b * Lq * rs + (long)h * D;
  const T* kb = k + (long)b * Lk * rs + (long)h * D;
  const T* vb = v + (long)b * Lk * rs + (long)h * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < Lq;
    sQ[r * DP + c] = in ? to_f<T>(qb[(long)(q0 + r) * rs + c]) : 0.f;
    sG[r * DP + c] = in ? to_f<T>(gb[(long)(q0 + r) * rs + c]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    // rows past Lq: zero Q and dO give ds = 0, and they are never written
    const bool in = q0 + r < Lq;
    sLse[r] = in ? lse[(long)bh * Lq + q0 + r] : 0.f;
    sDelta[r] = in ? delta[(long)bh * Lq + q0 + r] : 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // live k/v tiles: with a causal mask, none past the diagonal of this tile
  int n_kt = (Lk + BK - 1) / BK;
  if (causal) {
    const long last_row = (long)q_offset + min(q0 + BQ, Lq) - 1;
    const long lim = last_row - kv_offset;  // highest key index any row sees
    n_kt = lim < 0 ? 0 : min(n_kt, (int)(lim / BK) + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with sKV / sS
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      sKV[r * DP + c] = (k0 + r < Lk) ? to_f<T>(vb[(long)(k0 + r) * rs + c]) : 0.f;
    }
    __syncthreads();

    float dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ga[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ga[i] = sG[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) va[j] = sKV[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(ga[i], va[j], dp[i][j]);
    }
    __syncthreads();  // dP complete; V no longer needed

    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      sKV[r * DP + c] = (k0 + r < Lk) ? to_f<T>(kb[(long)(k0 + r) * rs + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sKV[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        bool live = k0 + c < Lk;
        if (causal) live = live && (kv_offset + k0 + c <= q_offset + q0 + r);
        const float sv = live ? s[i][j] * scale : NEG_INF;
        const float p = (sv <= 0.5f * NEG_INF) ? 0.f : expf(sv - sLse[r]);
        const float ds = p * (dp[i][j] - sDelta[r]) * scale;
        sS[r * SP + c] = to_f<T>(from_f<T>(ds));  // ds.K takes ds in K's type
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float da[4], ka[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = sS[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) ka[j] = sKV[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(da[i], ka[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Lq) continue;
    T* row = dq + ((long)b * Lq + q0 + r) * rs + (long)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* g,
           const void* lse, const void* delta, void* dq, int B, int H,
           int Lq, int Lk, int causal, int q_offset, int kv_offset,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Lq, Lk, causal, q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and dq share it). Returns
// the launch's cudaError_t (0 = launched); -1 for a (dtype, D) this build
// has no instance for.
extern "C" int tdt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* g, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int Lq, int Lk, int D, int causal,
                                int q_offset, int kv_offset, float scale,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, g, lse, delta, dq, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, g, lse, delta, dq, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, g, lse, delta, dq, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, g, lse, delta, dq, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  return -1;
}
