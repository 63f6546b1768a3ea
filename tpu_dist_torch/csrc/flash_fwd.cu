// FlashAttention-2 forward for Hopper (sm_90a): kernel 1 of the serving path.
//
// Replaces: tpu_dist/ops/flash_attention.py:_fa_fwd_kernel (Pallas, TPU),
// reached through _fa_forward / flash_attention_fn. The serving engine runs
// it in every prefill (model attn_fn = flash_attention_fn()).
//
// What it computes, per (batch, head): causal (or full) softmax attention
// of q (B, Lq, H, D) over k/v (B, Lk, H, D) with global row positions
// q_offset + i and key positions kv_offset + j; scores and the online
// softmax in fp32; p rounded to v's storage type before the p.V product
// (the TPU kernel's p.astype(v.dtype)); masked scores give exactly zero
// probability (NEG_INF plus the p = 0 guard), so a fully masked row writes
// exact zeros. Outputs: out (B, Lq, H, D) in v's type and the per-row
// logsumexp lse (B*H, Lq) fp32 (the TPU's 8-lane stat layout is not kept).
//
// Bound on an H100 SXM: operations. 4*B*H*Lq*Lk*D FLOP (about half of it
// when causal) against 989 TFLOP/s of bf16 tensor cores; the bytes (q, k,
// v, out once each) are far smaller at prefill lengths.
//
// Design (first version: right and simple, not fast): one block of 256
// threads per (b*h, 64-row q tile). A loop over 64-row k/v tiles stages K,
// then V, through one padded shared buffer (stride D+1: the column reads of
// the 16x16 thread grid hit distinct banks). Each thread owns a 4x4
// micro-tile of S = Q K^T and a 4 x D/16 slice of the output accumulator in
// registers; four threads per row run the online-softmax row statistics
// with warp shuffles. Tiles wholly above the causal diagonal are never
// loaded. The products run on the fp32 SIMT pipes, not the tensor cores:
// mma/wgmma with TMA-fed tiles is the later performance step.

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
  return (size_t)BQ * (D + 1)      // Q tile
         + (size_t)BK * (D + 1)    // K tile, then V tile
         + (size_t)BQ * (BK + 1)   // scores, then p
         + 3 * (size_t)BQ;         // running max, running sum, rescale
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk,
    int causal, int q_offset, int kv_offset, float scale) {
  constexpr int DP = D + 1;
  constexpr int SP = BK + 1;
  constexpr int NJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sKV = sQ + BQ * DP;
  float* sS = sKV + BK * DP;
  float* sM = sS + BQ * SP;
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long rs = (long)H * D;  // stride between sequence positions
  const T* qb = q + (long)b * Lq * rs + (long)h * D;
  const T* kb = k + (long)b * Lk * rs + (long)h * D;
  const T* vb = v + (long)b * Lk * rs + (long)h * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    sQ[r * DP + c] = (q0 + r < Lq) ? to_f<T>(qb[(long)(q0 + r) * rs + c]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    sM[r] = NEG_INF;
    sL[r] = 0.f;
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
        sS[r * SP + c] = live ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();  // S complete; K no longer needed

    // V into the same buffer, while four threads per row take the row stats
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      sKV[r * DP + c] = (k0 + r < Lk) ? to_f<T>(vb[(long)(k0 + r) * rs + c]) : 0.f;
    }
    {
      const int r = tid >> 2, part = tid & 3;
      float mx = NEG_INF;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, sS[r * SP + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float sv = sS[r * SP + c];
        const float p = (sv <= 0.5f * NEG_INF) ? 0.f : expf(sv - m_new);
        sum += p;                                  // the row sum takes p in fp32
        sS[r * SP + c] = to_f<T>(from_f<T>(p));    // p.V takes p in v's type
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
        sA[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[4], va[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sS[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) va[j] = sKV[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Lq) continue;
    const float inv = 1.f / fmaxf(sL[r], 1e-30f);
    T* orow = out + ((long)b * Lq + q0 + r) * rs + (long)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
  for (int r = tid; r < BQ; r += NT) {
    if (q0 + r < Lq)
      lse[(long)bh * Lq + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int Lq, int Lk, int causal, int q_offset,
           int kv_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, Lq, Lk, causal, q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t
// (0 = launched); -1 for a (dtype, D) this build has no instance for.
extern "C" int tdt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int H, int Lq,
                             int Lk, int D, int causal, int q_offset,
                             int kv_offset, float scale, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, lse, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, lse, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, lse, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, lse, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  return -1;
}
