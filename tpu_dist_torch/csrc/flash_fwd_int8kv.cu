// Flash attention forward over pre-quantized int8 K/V for Hopper (sm_90a):
// kernel 5 of the port.
//
// Replaces: tpu_dist/ops/flash_attention.py:_fa_fwd_int8kv_kernel (Pallas,
// TPU), behind int8kv_flash_attention_fn. No path of the JAX package calls
// it; the port keeps it as int8kv_flash_attention_fn for callers that hold
// a quantize_kv pack.
//
// What it computes, per (batch, head): causal (or full) softmax attention
// of q (B, Lq, H, D) over int8 k/v (B, Lk, H, D) with one fp32 scale per
// (b, position, h) row, the dequant k * ks and v * vs taken on the tile in
// shared memory (no fp copy of K/V in device memory); global row positions
// q_offset + i and key positions kv_offset + j; scores, p and the online
// softmax all in fp32 (the TPU kernel's p stays fp32 for the p.V product,
// unlike flash_fwd.cu's p in v's type); masked scores give exactly zero
// probability, and out = acc / max(l, 1e-30), so a fully masked row writes
// exact zeros. Output in q's type; no logsumexp (forward only).
//
// Bound on an H100 SXM: operations at prefill lengths, as flash_fwd.cu
// (4*B*H*Lq*Lk*D FLOP, about half when causal); the int8 K/V halve the
// bytes, which are far smaller anyway.
//
// Design: flash_fwd.cu's (right and simple, not fast): one block of 256
// threads per (b*h, 64-row q tile), a loop over 64-row k/v tiles staged
// through one padded shared buffer, dequantized as they are staged; a 4x4
// score micro-tile and a 4 x D/16 output slice per thread; four threads per
// row for the online-softmax statistics; tiles wholly above the causal
// diagonal never loaded; fp32 SIMT products.

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
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1)      // Q tile
         + (size_t)BK * (D + 1)    // dequantized K tile, then V tile
         + (size_t)BQ * (BK + 1)   // scores, then p
         + 3 * (size_t)BQ;         // running max, running sum, rescale
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_int8kv_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k,
    const float* __restrict__ ks, const int8_t* __restrict__ v,
    const float* __restrict__ vs, T* __restrict__ out, int H, int Lq, int Lk,
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
  const int8_t* kb = k + (long)b * Lk * rs + (long)h * D;
  const int8_t* vb = v + (long)b * Lk * rs + (long)h * D;
  const float* ksb = ks + (long)b * Lk * H + h;  // scale of row j: ksb[j * H]
  const float* vsb = vs + (long)b * Lk * H + h;

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
      const long j = k0 + r;
      sKV[r * DP + c] = (j < Lk) ? (float)kb[j * rs + c] * ksb[j * H] : 0.f;
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
      const long j = k0 + r;
      sKV[r * DP + c] = (j < Lk) ? (float)vb[j * rs + c] * vsb[j * H] : 0.f;
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
        sum += p;
        sS[r * SP + c] = p;                        // p stays fp32
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
    const float l = fmaxf(sL[r], 1e-30f);
    T* orow = out + ((long)b * Lq + q0 + r) * rs + (long)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, void* out, int B, int H, int Lq, int Lk,
           int causal, int q_offset, int kv_offset, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_int8kv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_fwd_int8kv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v),
      static_cast<const float*>(vs), static_cast<T*>(out), H, Lq, Lk, causal,
      q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16. Returns the launch's
// cudaError_t (0 = launched); -1 for a (dtype, D) this build has no
// instance for.
extern "C" int tdt_flash_fwd_int8kv(const void* q, const void* k,
                                    const void* ks, const void* v,
                                    const void* vs, void* out, int B, int H,
                                    int Lq, int Lk, int D, int causal,
                                    int q_offset, int kv_offset, float scale,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, ks, v, vs, out, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, ks, v, vs, out, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, ks, v, vs, out, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, ks, v, vs, out, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  return -1;
}
