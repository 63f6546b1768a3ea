// FlashAttention-2 backward, dk/dv pass, for Hopper (sm_90a): kernel 4 of the
// port.
//
// Replaces: tpu_dist/ops/flash_attention.py:_fa_bwd_dkv_kernel (Pallas, TPU),
// reached through _fa_backward / flash_attention_fn's custom_vjp. LM training
// runs it once per layer per step (model attn_fn = flash_attention_fn()).
//
// What it computes, per (batch, head) and key row j:
//   dv_j = sum_i p_ij dO_i,   dk_j = sum_i ds_ij q_i,
//   p_ij = exp(s_ij - lse_i), ds_ij = p_ij (dO_i . V_j - delta_i) * scale,
// with the forward's causal rule over global positions (q_offset + i,
// kv_offset + j) and the p = 0 guard for masked scores, so a key no row may
// see gets exact zero gradients. Rounding points, as the TPU kernel: p is
// rounded to dO's storage type before p^T.dO, ds to Q's before ds^T.Q; both
// products accumulate in fp32; dk, dv are written in k's and v's type.
//
// Bound on an H100 SXM: operations. Four products of 2*Lq*Lk*D FLOP per
// (batch, head) (about half when causal) against 989 TFLOP/s of bf16 tensor
// cores; q, k, v, dO, dk, dv are read or written once.
//
// Design (first version: right and simple, not fast): one block of 256
// threads per (b*h, 64-row k/v tile), which keeps its K and V tiles and its
// dk/dv accumulators for the whole loop over 64-row q tiles: each output
// tile has one owner, no atomics (the reference's two-pass split). Per q
// tile, Q and dO come into padded shared buffers (stride D+1); each thread
// computes a 4x4 micro-tile of S and dP, writes the rounded p and ds tiles
// to shared memory, and then accumulates a 4 x D/16 slice of dk and dv from
// them. The finalize rule is the reference's: every causal kv tile's last
// live q tile is the final one, so the accumulators are written once, after
// the loop. q tiles wholly before the diagonal are skipped; ragged edges are
// masked, so any length works. fp32 SIMT products: mma/wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // q rows per tile
constexpr int BK = 64;    // k/v rows per block
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
  return 2 * (size_t)BK * (D + 1)    // K tile, V tile
         + 2 * (size_t)BQ * (D + 1)  // Q tile, dO tile
         + 2 * (size_t)BQ * (BK + 1) // p (dO's type), ds (Q's type)
         + 2 * (size_t)BQ;           // lse, delta
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int Lq, int Lk, int causal, int q_offset, int kv_offset,
    float scale) {
  constexpr int DP = D + 1;
  constexpr int SP = BK + 1;
  constexpr int NJ = D / 16;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * DP;
  float* sQ = sV + BK * DP;
  float* sG = sQ + BQ * DP;
  float* sP = sG + BQ * DP;
  float* sDS = sP + BQ * SP;
  float* sLse = sDS + BQ * SP;
  float* sDelta = sLse + BQ;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long rs = (long)H * D;  // stride between sequence positions
  const T* qb = q + (long)b * Lq * rs + (long)h * D;
  const T* gb = g + (long)b * Lq * rs + (long)h * D;
  const T* kb = k + (long)b * Lk * rs + (long)h * D;
  const T* vb = v + (long)b * Lk * rs + (long)h * D;

  for (int i = tid; i < BK * D; i += NT) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < Lk;
    sK[r * DP + c] = in ? to_f<T>(kb[(long)(k0 + r) * rs + c]) : 0.f;
    sV[r * DP + c] = in ? to_f<T>(vb[(long)(k0 + r) * rs + c]) : 0.f;
  }

  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // live q tiles: with a causal mask, none that ends before this tile's
  // first key position (kv_offset + k0)
  const int n_qt = (Lq + BQ - 1) / BQ;
  int first_qt = 0;
  if (causal) {
    const long d0 = (long)kv_offset + k0 - q_offset;  // first row that sees key k0
    first_qt = d0 <= 0 ? 0 : (int)min((long)n_qt, d0 / BQ);
  }

  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done with sQ..sDelta
    for (int i = tid; i < BQ * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool in = q0 + r < Lq;
      sQ[r * DP + c] = in ? to_f<T>(qb[(long)(q0 + r) * rs + c]) : 0.f;
      sG[r * DP + c] = in ? to_f<T>(gb[(long)(q0 + r) * rs + c]) : 0.f;
    }
    for (int r = tid; r < BQ; r += NT) {
      const bool in = q0 + r < Lq;
      sLse[r] = in ? lse[(long)bh * Lq + q0 + r] : 0.f;
      sDelta[r] = in ? delta[(long)bh * Lq + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], ga[4], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = sQ[(ty + 16 * i) * DP + d];
        ga[i] = sG[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = sK[(tx + 16 * j) * DP + d];
        va[j] = sV[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], va[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;  // q row of the tile
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;  // key row of the block
        bool live = q0 + r < Lq && k0 + c < Lk;
        if (causal) live = live && (kv_offset + k0 + c <= q_offset + q0 + r);
        const float sv = live ? s[i][j] * scale : NEG_INF;
        const float p = (sv <= 0.5f * NEG_INF) ? 0.f : expf(sv - sLse[r]);
        const float ds = p * (dp[i][j] - sDelta[r]) * scale;
        sP[r * SP + c] = to_f<T>(from_f<T>(p));    // p^T.dO takes p in dO's type
        sDS[r * SP + c] = to_f<T>(from_f<T>(ds));  // ds^T.Q takes ds in Q's type
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pa[4], da[4], ga[NJ], qa[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = sP[r * SP + ty + 16 * i];
        da[i] = sDS[r * SP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        ga[j] = sG[r * DP + tx + 16 * j];
        qa[j] = sQ[r * DP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc_v[i][j] = fmaf(pa[i], ga[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(da[i], qa[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (k0 + r >= Lk) continue;
    const long off = ((long)b * Lk + k0 + r) * rs + (long)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + tx + 16 * j] = from_f<T>(acc_k[i][j]);
      dv[off + tx + 16 * j] = from_f<T>(acc_v[i][j]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* g,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int H, int Lq, int Lk, int causal, int q_offset, int kv_offset,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lk + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Lq, Lk, causal, q_offset,
      kv_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dk and dv share it).
// Returns the launch's cudaError_t (0 = launched); -1 for a (dtype, D) this
// build has no instance for.
extern "C" int tdt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int H, int Lq, int Lk, int D, int causal,
                                 int q_offset, int kv_offset, float scale,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, g, lse, delta, dk, dv, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, g, lse, delta, dk, dv, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, g, lse, delta, dk, dv, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, g, lse, delta, dk, dv, B, H, Lq, Lk, causal, q_offset, kv_offset, scale, s);
  return -1;
}
