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
// (4*B*H*Lq*Lk*D FLOP, about half when causal, counted as the reference's
// work); the int8 K/V halve the bytes, which are far smaller anyway.
//
// Both instances: one block per (b*h, 64-row q tile) loops over the live
// 64-row k/v tiles; tiles wholly above the causal diagonal are never
// loaded, and ragged edges are masked.
//
// bf16 q (flash_fwd_int8kv_kernel_mma), on the tensor cores: flash_fwd.cu's
// bf16 design (4 warps of 16 q rows, Q's A fragments held in registers,
// mma.sync m16n8k16, the online softmax on the C fragments, longest causal
// tiles first) with int8 K/V. The int8 tiles and their per-row scales
// stream through a 2-stage cp.async ring (16-byte copies of the values,
// 4-byte copies of the scales); each tile is widened in shared memory to
// bf16 (exact: |x| <= 128 < 2^8) and its scales copied beside it, then read
// by ldmatrix. Scores: S = q . kq^T on the tensor cores, then column j
// times ks_j in registers (the scale is per key row, so it factors out of
// the dot product): the reference's q . (kq ks) up to fp32 rounding, with
// no bf16 rounding of a dequantized K. p . V keeps the reference's fp32 p:
// p'_j = p_j vs_j is split into hi = bf16(p') and lo = bf16(p' - hi), and
// acc += hi . vq + lo . vq takes two mma against the exact bf16 vq, so
// about 16 significant bits of p' reach the fp32 sums (relative error
// about 2^-17 per term, far below the bf16 output's 2^-9). The row sum
// takes the fp32 p. 1.5x the tensor-core work of flash_fwd.cu's bf16 path.
// fp32 q (flash_fwd_int8kv_kernel) keeps full-fp32 SIMT products: one block
// of 256 threads, K then V dequantized as staged into one padded fp32
// shared buffer, a 4x4 score micro-tile and a 4 x D/16 output slice per
// thread, S and p through shared memory.
//
// Head dims (head_dim.cuh): every d from 1 up, both dtypes. Up to 256
// the exact instances at D = 16, 32, 64, 128 and 256 (the head dim a
// compile-time constant) run d == D on 16-byte-aligned tensors; every other
// d up to 256 runs on the general instance of the next D up (8 on 16, 24
// on 32, 33 and 48 on 64, 100 on 128, 136 and 200 on 256) with the true d
// at run time: rows
// strided by H * d, columns past d zero in shared memory, nothing stored
// past d, so no tensor is copied or padded. Where its rows are whole
// 16-byte chunks on 16-byte boundaries (d a multiple of 16 for the int8
// rows, the tensors aligned) it copies as the exact instance does; any
// other row (an odd d, a d not a multiple of 16, a misaligned view) runs
// on a third instance (ANY, chosen on the host) that copies by
// cp_async_rows_any: 16-byte cp.async for whole aligned chunks, 8- or
// 4-byte cp.async where the source allows, byte loads for the rest, and
// element stores.
//
// At D = 256 q's A fragments are read from shared memory at each k-step,
// as in flash_fwd.cu; the bf16 Q and widened K, V tiles and the int8 ring
// take 169 KB of shared memory, one block of 4 warps an SM. ptxas (sm_90a,
// on the H100 build): 255 registers and 84 bytes of spill stores for the
// exact and the general bf16 instances, 72 with ANY (the hi/lo split of
// p' adds 8 registers a k-step to the forward's); the fp32 instance takes
// 145 KB and 126 registers.
//
// Above 256 every d runs on the wide path (the end of this file):
// flash_fwd.cu's wide design over the int8 K/V, each int8 slice and V
// chunk widened to bf16 in shared memory; ceil(d / 128) x the S products.
// 75,264 bytes of shared memory at any d; ptxas (sm_90a, on the H100
// build): 236 registers, 226 with ANY, no spill; the fp32 twin 83,712
// bytes and 128 registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "head_dim.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // k/v rows per tile
constexpr int NT = 256;   // threads per block: a 16 x 16 grid
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1)      // Q tile
         + (size_t)BK * (D + 1)    // dequantized K tile, then V tile
         + (size_t)BQ * (BK + 1)   // scores, then p
         + 3 * (size_t)BQ;         // running max, running sum, rescale
}

template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(NT) flash_fwd_int8kv_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k,
    const float* __restrict__ ks, const int8_t* __restrict__ v,
    const float* __restrict__ vs, T* __restrict__ out, int H, int d_true,
    int Lq, int Lk, int causal, int q_offset, int kv_offset, float scale) {
  const int dh = PAD ? d_true : D;  // the true head dim (head_dim.cuh)
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
  const long rs = (long)H * dh;  // stride between sequence positions
  const T* qb = q + (long)b * Lq * rs + (long)h * dh;
  const int8_t* kb = k + (long)b * Lk * rs + (long)h * dh;
  const int8_t* vb = v + (long)b * Lk * rs + (long)h * dh;
  const float* ksb = ks + (long)b * Lk * H + h;  // scale of row j: ksb[j * H]
  const float* vsb = vs + (long)b * Lk * H + h;

  // columns past dh stay zero in shared memory: they add nothing to S or
  // to the output, which stores none of them
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    sQ[r * DP + c] = (q0 + r < Lq && (!PAD || c < dh))
                         ? to_f<T>(qb[(long)(q0 + r) * rs + c])
                         : 0.f;
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
      sKV[r * DP + c] = (j < Lk && (!PAD || c < dh))
                            ? (float)kb[j * rs + c] * ksb[j * H]
                            : 0.f;
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
      sKV[r * DP + c] = (j < Lk && (!PAD || c < dh))
                            ? (float)vb[j * rs + c] * vsb[j * H]
                            : 0.f;
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
    T* orow = out + ((long)b * Lq + q0 + r) * rs + (long)h * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (!PAD || tx + 16 * j < dh) orow[tx + 16 * j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T, int D, bool PAD>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, void* out, int B, int H, int d, int Lq, int Lk,
           int causal, int q_offset, int kv_offset, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_int8kv_kernel<T, D, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_fwd_int8kv_kernel<T, D, PAD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v),
      static_cast<const float*>(vs), static_cast<T*>(out), H, d, Lq, Lk,
      causal, q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

// ---- bf16 q on the tensor cores -------------------------------------------

constexpr int NTM = 128;  // threads per block: 4 warps x 16 q rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes_mma() {
  // bf16 Q, and bf16 K and V widened from the int8 tiles, rows padded to
  // D + 8; the int8 K and V tiles (rows padded to D + 16 bytes) and their
  // scales in a 2-stage ring; the widened tile's scales
  return (size_t)(BQ + 2 * BK) * (D + 8) * sizeof(__nv_bfloat16) +
         (size_t)4 * BK * (D + 16) + (size_t)6 * BK * sizeof(float);
}

template <int D, bool PAD, bool ANY>
__global__ void __launch_bounds__(NTM, D <= 128 ? 2 : 1)
    flash_fwd_int8kv_kernel_mma(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
    const float* __restrict__ ks, const int8_t* __restrict__ v,
    const float* __restrict__ vs, __nv_bfloat16* __restrict__ out, int H,
    int d_true, int Lq, int Lk, int causal, int q_offset, int kv_offset,
    float scale) {
  const int dh = PAD ? d_true : D;  // the true head dim (head_dim.cuh)
  constexpr int RS = D + 8;    // padded bf16 row stride (elements)
  constexpr int RS8 = D + 16;  // padded int8 row stride (bytes)
  constexpr int NB = BK / 8;   // key n-tiles of S
  constexpr int ND = D / 8;    // d n-tiles of the output
  constexpr int KD = D / 16;   // k-steps of S = q kq^T
  // q's A fragments held in registers up to D = 128, read from shared
  // memory at each k-step above (flash_fwd.cu)
  constexpr bool QREG = D <= 128;
  extern __shared__ float smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sKb = sQ + BQ * RS;   // this tile's K, widened
  __nv_bfloat16* sVb = sKb + BK * RS;  // this tile's V, widened
  int8_t* sK8 = reinterpret_cast<int8_t*>(sVb + BK * RS);  // [2][BK * RS8]
  int8_t* sV8 = sK8 + 2 * BK * RS8;                         // [2][BK * RS8]
  float* sKs8 = reinterpret_cast<float*>(sV8 + 2 * BK * RS8);  // [2][BK]
  float* sVs8 = sKs8 + 2 * BK;                                  // [2][BK]
  float* sKs = sVs8 + 2 * BK;  // this tile's scales
  float* sVs = sKs + BK;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last (longest) first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long rs = (long)H * dh;  // stride between sequence positions
  const __nv_bfloat16* qb = q + (long)b * Lq * rs + (long)h * dh;
  const int8_t* kb = k + (long)b * Lk * rs + (long)h * dh;
  const int8_t* vb = v + (long)b * Lk * rs + (long)h * dh;
  const float* ksb = ks + (long)b * Lk * H + h;  // scale of row j: ksb[j * H]
  const float* vsb = vs + (long)b * Lk * H + h;

  // k/v tile kt into ring stage st: int8 rows and their scales, rows past
  // Lk and columns past dh as zeros
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * BK;
    if constexpr (ANY) {
      cp_async_rows_any<64, D, RS8, NTM>(sK8 + st * BK * RS8, kb, rs, k0, Lk,
                                         tid, dh);
      cp_async_rows_any<64, D, RS8, NTM>(sV8 + st * BK * RS8, vb, rs, k0, Lk,
                                         tid, dh);
    } else {
      cp_async_rows<64, D, RS8, NTM>(sK8 + st * BK * RS8, kb, rs, k0, Lk,
                                     tid, dh);
      cp_async_rows<64, D, RS8, NTM>(sV8 + st * BK * RS8, vb, rs, k0, Lk,
                                     tid, dh);
    }
    const int j = tid % BK;  // threads 0-63: ks, 64-127: vs
    const bool in = k0 + j < Lk;
    cp_async_4((tid < BK ? sKs8 : sVs8) + st * BK + j,
               (tid < BK ? ksb : vsb) + (in ? (long)(k0 + j) * H : 0),
               in ? 4 : 0);
  };
  // ring stage st widened to bf16 (8 values a step) with its scales
  auto widen = [&](int st) {
    for (int i = tid; i < 2 * BK * (D / 8); i += NTM) {
      const int t = i / (BK * (D / 8)), c = i % (BK * (D / 8));
      const int r = c / (D / 8), d = (c % (D / 8)) * 8;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          (t ? sV8 : sK8) + st * BK * RS8 + r * RS8 + d);
      uint32_t* dst = reinterpret_cast<uint32_t*>((t ? sVb : sKb) + r * RS + d);
      widen_int8x4(src[0], dst[0], dst[1]);
      widen_int8x4(src[1], dst[2], dst[3]);
    }
    if (tid < BK) sKs[tid] = sKs8[st * BK + tid];
    else sVs[tid - BK] = sVs8[st * BK + tid - BK];
  };

  // live k/v tiles: with a causal mask, none past the diagonal of this tile
  int n_kt = (Lk + BK - 1) / BK;
  if (causal) {
    const long last_row = (long)q_offset + min(q0 + BQ, Lq) - 1;
    const long lim = last_row - kv_offset;  // highest key index any row sees
    n_kt = lim < 0 ? 0 : min(n_kt, (int)(lim / BK) + 1);
  }

  if constexpr (ANY)
    cp_async_rows_any<64, D, RS, NTM>(sQ, qb, rs, q0, Lq, tid, dh);
  else
    cp_async_rows<64, D, RS, NTM>(sQ, qb, rs, q0, Lq, tid, dh);
  cp_async_commit();
  if (n_kt > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // this lane's rows of the C fragments: q0 + warp*16 + lane/4 (+ 8)
  const int gq = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;
  uint32_t qa[QREG ? KD : 1][4];  // q's A fragments (QREG: the whole loop)
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(qa[kk], sQ + (wr + lane % 16) * RS + kk * 16 + (lane / 16) * 8);
  }

  const float scale2 = scale * LOG2E;  // exp(x scale) = 2^(x scale log2 e)
  float m[2] = {NEG_INF, NEG_INF};     // running max of the unscaled scores
  float l[2] = {0.f, 0.f};             // this lane's part of the row sums
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) load_kv(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();     // and every warp is done with the widened tile
    widen(st);
    __syncthreads();

    // S = q kq^T for this warp's 16 rows, 16 d at a step
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t* a = qa[QREG ? kk : 0];
      if constexpr (!QREG)
        ldsm_x4(a, sQ + (wr + lane % 16) * RS + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NB / 2; ++j) {  // key n-tiles 2j, 2j+1
        uint32_t bk[4];
        ldsm_x4(bk, sKb + (16 * j + lane % 8 + (lane / 16) * 8) * RS +
                        kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16_16816(s[2 * j], a, bk[0], bk[1]);
        mma_bf16_16816(s[2 * j + 1], a, bk[2], bk[3]);
      }
    }

    // column j times its key's scale; masks only where the tile straddles
    // the diagonal or Lk; then p in s, and p' = p vs (fp32) for p . V
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sKs[8 * j + 2 * tq + (e & 1)];
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Lk ||
                      (causal && kv_offset + k0 + BK - 1 > q_offset + q0 + wr);
    online_softmax_tile(s, acc, m, l, scale2, edge, k0, Lk, causal, kv_offset,
                        (long)q_offset + q0 + wr, NEG_INF);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sVs[8 * j + 2 * tq + (e & 1)];

    // acc += p' . vq as (hi + lo) . vq, 16 keys at a step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) {  // d n-tiles 2j, 2j+1
        uint32_t bv[4];
        ldsm_x4_trans(bv, sVb + (kk * 16 + lane % 16) * RS + 16 * j +
                              (lane / 16) * 8);
        mma_bf16_16816(acc[2 * j], hi, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * j], lo, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * j + 1], hi, bv[2], bv[3]);
        mma_bf16_16816(acc[2 * j + 1], lo, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = fmaxf(quad_sum(l[r]), 1e-30f);
    const int row = q0 + wr + gq + 8 * r;
    if (row >= Lq) continue;
    __nv_bfloat16* orow = out + ((long)b * Lq + row) * rs + (long)h * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store_bf16x2<PAD, ANY>(orow, 8 * j + 2 * tq, dh, acc[j][2 * r] / lr,
                             acc[j][2 * r + 1] / lr);
  }
}

template <int D, bool PAD, bool ANY>
int launch_mma(const void* q, const void* k, const void* ks, const void* v,
               const void* vs, void* out, int B, int H, int d, int Lq, int Lk,
               int causal, int q_offset, int kv_offset, float scale,
               cudaStream_t stream) {
  const size_t smem = smem_bytes_mma<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_int8kv_kernel_mma<D, PAD, ANY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  flash_fwd_int8kv_kernel_mma<D, PAD, ANY><<<grid, NTM, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v),
      static_cast<const float*>(vs), static_cast<__nv_bfloat16*>(out), H, d,
      Lq, Lk, causal, q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

// ---- the wide path (head_dim.cuh: d above 256) -----------------------------
//
// flash_fwd.cu's wide design over int8 K/V: a block owns output columns c0
// .. c0 + WDC - 1 (c0 = WDC * blockIdx.z) of its 64 q rows; per k/v tile,
// S = q . kq^T is summed over d in WDS-column slices streamed through
// shared memory, in the same order in every chunk, then scaled by each
// key's ks; acc += p' . vq[:, chunk]. Neither registers nor shared memory
// grow with d; the S work is ceil(d / WDC) x the narrow kernels'.

constexpr int WDS = 64;   // d columns a slice of S
constexpr int WDC = 128;  // output columns a block

constexpr size_t smem_floats_wide() {
  return (size_t)BQ * (WDS + 1)    // Q slice
         + (size_t)BK * (WDS + 1)  // kq slice
         + (size_t)BK * (WDC + 1)  // dequantized V chunk
         + (size_t)BQ * (BK + 1)   // scores, then p
         + 3 * (size_t)BQ;         // running max, running sum, rescale
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_fwd_int8kv_kernel_wide(
    const T* __restrict__ q, const int8_t* __restrict__ k,
    const float* __restrict__ ks, const int8_t* __restrict__ v,
    const float* __restrict__ vs, T* __restrict__ out, int H, int dh, int Lq,
    int Lk, int causal, int q_offset, int kv_offset, float scale) {
  constexpr int DP = WDS + 1;
  constexpr int CP = WDC + 1;
  constexpr int SP = BK + 1;
  constexpr int NJ = WDC / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sS = sV + BK * CP;
  float* sM = sS + BQ * SP;
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.z * WDC;  // this block's output columns
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long rs = (long)H * dh;  // stride between sequence positions
  const T* qb = q + (long)b * Lq * rs + (long)h * dh;
  const int8_t* kb = k + (long)b * Lk * rs + (long)h * dh;
  const int8_t* vb = v + (long)b * Lk * rs + (long)h * dh;
  const float* ksb = ks + (long)b * Lk * H + h;  // scale of row j: ksb[j * H]
  const float* vsb = vs + (long)b * Lk * H + h;

  for (int r = tid; r < BQ; r += NT) {
    sM[r] = NEG_INF;
    sL[r] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int n_kt = (Lk + BK - 1) / BK;
  if (causal) {
    const long last_row = (long)q_offset + min(q0 + BQ, Lq) - 1;
    const long lim = last_row - kv_offset;  // highest key index any row sees
    n_kt = lim < 0 ? 0 : min(n_kt, (int)(lim / BK) + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += WDS) {
      __syncthreads();  // the previous readers are done with the slices
      for (int i = tid; i < BQ * WDS; i += NT) {
        const int r = i / WDS, c = i % WDS;
        const bool in = d0 + c < dh;
        sQ[r * DP + c] = (q0 + r < Lq && in)
                             ? to_f<T>(qb[(long)(q0 + r) * rs + d0 + c])
                             : 0.f;
        const long j = k0 + r;
        sK[r * DP + c] = (j < Lk && in)
                             ? (float)kb[j * rs + d0 + c] * ksb[j * H]
                             : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < WDS; ++d) {
        float qa[4], ka[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) ka[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }
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
    __syncthreads();  // S complete

    // V's chunk dequantized, while four threads per row take the row stats
    for (int i = tid; i < BK * WDC; i += NT) {
      const int r = i / WDC, c = i % WDC;
      const long j = k0 + r;
      sV[r * CP + c] = (j < Lk && c0 + c < dh)
                           ? (float)vb[j * rs + c0 + c] * vsb[j * H]
                           : 0.f;
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
      for (int j = 0; j < NJ; ++j) va[j] = sV[c * CP + tx + 16 * j];
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
    T* orow = out + ((long)b * Lq + q0 + r) * rs + (long)h * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (c0 + tx + 16 * j < dh)
        orow[c0 + tx + 16 * j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* ks, const void* v,
                const void* vs, void* out, int B, int H, int d, int Lq,
                int Lk, int causal, int q_offset, int kv_offset, float scale,
                cudaStream_t stream) {
  const size_t smem = smem_floats_wide() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_int8kv_kernel_wide<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H, (d + WDC - 1) / WDC);
  flash_fwd_int8kv_kernel_wide<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v),
      static_cast<const float*>(vs), static_cast<T*>(out), H, d, Lq, Lk,
      causal, q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

// bf16 q on the tensor cores: flash_fwd.cu's wide units (a WDS-column
// slice of q and of the int8 K a unit, in a 2-stage cp.async ring; the
// tile's int8 V chunk and its scales with the tile's first unit, in a
// 2-stage ring of their own), each int8 slice or chunk widened to bf16 in
// shared memory before ldmatrix reads it, as in the narrow kernel; S then
// scaled by ks, p' = p vs split into hi + lo for two products against the
// exact bf16 vq. 75,264 bytes of shared memory at any d.

constexpr int WRS = WDS + 8;    // padded bf16 slice row stride (elements)
constexpr int WRC = WDC + 8;    // padded bf16 chunk row stride (elements)
constexpr int WRS8 = WDS + 16;  // padded int8 slice row stride (bytes)
constexpr int WRC8 = WDC + 16;  // padded int8 chunk row stride (bytes)

constexpr size_t smem_bytes_wide_mma() {
  return ((size_t)2 * BQ * WRS + (size_t)BK * WRS + (size_t)BK * WRC) *
             sizeof(__nv_bfloat16) +
         (size_t)2 * BK * WRS8 + (size_t)2 * BK * WRC8 +
         (size_t)4 * BK * sizeof(float);
}

// the bf16 widening of rows x W int8 (row stride RS8 bytes) into dst (row
// stride RS elements), 8 values a step
template <int ROWS, int W, int RS8, int RS>
__device__ __forceinline__ void widen_rows(__nv_bfloat16* dst,
                                           const int8_t* src, int tid) {
  for (int i = tid; i < ROWS * (W / 8); i += NTM) {
    const int r = i / (W / 8), d = (i % (W / 8)) * 8;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src + r * RS8 + d);
    uint32_t* o = reinterpret_cast<uint32_t*>(dst + r * RS + d);
    widen_int8x4(s[0], o[0], o[1]);
    widen_int8x4(s[1], o[2], o[3]);
  }
}

template <bool ANY>
__global__ void __launch_bounds__(NTM, 2) flash_fwd_int8kv_kernel_wide_mma(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
    const float* __restrict__ ks, const int8_t* __restrict__ v,
    const float* __restrict__ vs, __nv_bfloat16* __restrict__ out, int H,
    int dh, int Lq, int Lk, int causal, int q_offset, int kv_offset,
    float scale) {
  constexpr int NB = BK / 8;   // key n-tiles of S
  constexpr int ND = WDC / 8;  // d n-tiles of the output chunk
  extern __shared__ float smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BQ*WRS]
  __nv_bfloat16* sKb = sQ + 2 * BQ * WRS;   // this unit's K slice, widened
  __nv_bfloat16* sVb = sKb + BK * WRS;      // this tile's V chunk, widened
  int8_t* sK8 = reinterpret_cast<int8_t*>(sVb + BK * WRC);  // [2][BK*WRS8]
  int8_t* sV8 = sK8 + 2 * BK * WRS8;                         // [2][BK*WRC8]
  float* sKs = reinterpret_cast<float*>(sV8 + 2 * BK * WRC8);  // [2][BK]
  float* sVs = sKs + 2 * BK;                                    // [2][BK]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last (longest) first
  const int c0 = blockIdx.z * WDC;  // this block's output columns
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long rs = (long)H * dh;  // stride between sequence positions
  const __nv_bfloat16* qb = q + (long)b * Lq * rs + (long)h * dh;
  const int8_t* kb = k + (long)b * Lk * rs + (long)h * dh;
  const int8_t* vb = v + (long)b * Lk * rs + (long)h * dh;
  const float* ksb = ks + (long)b * Lk * H + h;  // scale of row j: ksb[j * H]
  const float* vsb = vs + (long)b * Lk * H + h;

  int n_kt = (Lk + BK - 1) / BK;
  if (causal) {
    const long last_row = (long)q_offset + min(q0 + BQ, Lq) - 1;
    const long lim = last_row - kv_offset;  // highest key index any row sees
    n_kt = lim < 0 ? 0 : min(n_kt, (int)(lim / BK) + 1);
  }
  const int ns = (dh + WDS - 1) / WDS;  // slices a tile
  const int units = n_kt * ns;
  // unit u: slice u % ns of tile u / ns into stage u & 1, and with a
  // tile's first slice its int8 V chunk and both scales
  auto issue = [&](int u) {
    const int kt = u / ns, d0 = (u % ns) * WDS, st = u & 1, k0 = kt * BK;
    cp_async_cols<64, WDS, WRS, NTM, ANY>(sQ + st * BQ * WRS, qb, rs, q0, Lq,
                                          d0, dh, tid);
    cp_async_cols<64, WDS, WRS8, NTM, ANY>(sK8 + st * BK * WRS8, kb, rs, k0,
                                           Lk, d0, dh, tid);
    if (d0 == 0) {
      const int tc = kt & 1;
      cp_async_cols<64, WDC, WRC8, NTM, ANY>(sV8 + tc * BK * WRC8, vb, rs, k0,
                                             Lk, c0, dh, tid);
      const int j = tid % BK;  // threads 0-63: ks, 64-127: vs
      const bool in = k0 + j < Lk;
      cp_async_4((tid < BK ? sKs : sVs) + tc * BK + j,
                 (tid < BK ? ksb : vsb) + (in ? (long)(k0 + j) * H : 0),
                 in ? 4 : 0);
    }
  };
  if (units > 0) issue(0);
  cp_async_commit();

  const int gq = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;
  const float scale2 = scale * LOG2E;  // exp(x scale) = 2^(x scale log2 e)
  float m[2] = {NEG_INF, NEG_INF};     // running max of the unscaled scores
  float l[2] = {0.f, 0.f};             // this lane's part of the row sums
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int tc = kt & 1;
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int u = kt * ns; u < (kt + 1) * ns; ++u) {
      if (u + 1 < units) issue(u + 1);
      cp_async_commit();
      cp_async_wait<1>();  // unit u (and this tile's V chunk) has landed
      __syncthreads();
      const int st = u & 1;
      widen_rows<BK, WDS, WRS8, WRS>(sKb, sK8 + st * BK * WRS8, tid);
      __syncthreads();
      warp_mma_abt<NB, WDS / 16, WRS>(s, sQ + st * BQ * WRS + wr * WRS, sKb);
      __syncthreads();  // every warp is done with stage st and sKb
    }
    widen_rows<BK, WDC, WRC8, WRC>(sVb, sV8 + tc * BK * WRC8, tid);

    // column j times its key's scale; masks only where the tile straddles
    // the diagonal or Lk; then p in s, and p' = p vs (fp32) for p . V
    const float* cKs = sKs + tc * BK;
    const float* cVs = sVs + tc * BK;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= cKs[8 * j + 2 * tq + (e & 1)];
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Lk ||
                      (causal && kv_offset + k0 + BK - 1 > q_offset + q0 + wr);
    online_softmax_tile(s, acc, m, l, scale2, edge, k0, Lk, causal, kv_offset,
                        (long)q_offset + q0 + wr, NEG_INF);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= cVs[8 * j + 2 * tq + (e & 1)];
    __syncthreads();  // sVb widened

    // acc += p' . vq as (hi + lo) . vq, 16 keys at a step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) {  // d n-tiles 2j, 2j+1
        uint32_t bv[4];
        ldsm_x4_trans(bv, sVb + (kk * 16 + lane % 16) * WRC + 16 * j +
                              (lane / 16) * 8);
        mma_bf16_16816(acc[2 * j], hi, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * j], lo, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * j + 1], hi, bv[2], bv[3]);
        mma_bf16_16816(acc[2 * j + 1], lo, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with sVb and this tile's scales
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = fmaxf(quad_sum(l[r]), 1e-30f);
    const int row = q0 + wr + gq + 8 * r;
    if (row >= Lq) continue;
    __nv_bfloat16* orow = out + ((long)b * Lq + row) * rs + (long)h * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store_bf16x2<true, ANY>(orow, c0 + 8 * j + 2 * tq, dh,
                              acc[j][2 * r] / lr, acc[j][2 * r + 1] / lr);
  }
}

template <bool ANY>
int launch_wide_mma(const void* q, const void* k, const void* ks,
                    const void* v, const void* vs, void* out, int B, int H,
                    int d, int Lq, int Lk, int causal, int q_offset,
                    int kv_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_wide_mma();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_int8kv_kernel_wide_mma<ANY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Lq + BQ - 1) / BQ, (d + WDC - 1) / WDC);
  flash_fwd_int8kv_kernel_wide_mma<ANY><<<grid, NTM, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v),
      static_cast<const float*>(vs), static_cast<__nv_bfloat16*>(out), H, d,
      Lq, Lk, causal, q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16. Returns the launch's
// cudaError_t (0 = launched); -1 for a dtype this build has no instance for
// or a head dim D below 1 (head_dim.cuh). q, out and the int8 values may
// have any alignment (a misaligned one runs on the general instance or the
// wide path's ANY one); the fp32
// scales, copied by 4 bytes, are 4-byte aligned as every fp32 tensor is.
extern "C" int tdt_flash_fwd_int8kv(const void* q, const void* k,
                                    const void* ks, const void* v,
                                    const void* vs, void* out, int B, int H,
                                    int Lq, int Lk, int D, int causal,
                                    int q_offset, int kv_offset, float scale,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return with_head_dim(D, true, true, [&](auto hd) {
      using HD = decltype(hd);
      return launch<float, HD::value, HD::pad>(
          q, k, ks, v, vs, out, B, H, D, Lq, Lk, causal, q_offset, kv_offset,
          scale, s);
    }, [&](auto) {
      return launch_wide<float>(q, k, ks, v, vs, out, B, H, D, Lq, Lk,
                                causal, q_offset, kv_offset, scale, s);
    });
  if (dtype == 1)
    return with_head_dim(D, tdt_aligned16(q, k, v, out), D % 16 == 0,
                         [&](auto hd) {
      using HD = decltype(hd);
      return launch_mma<HD::value, HD::pad, HD::any>(
          q, k, ks, v, vs, out, B, H, D, Lq, Lk, causal, q_offset, kv_offset,
          scale, s);
    }, [&](auto wd) {
      return launch_wide_mma<decltype(wd)::any>(
          q, k, ks, v, vs, out, B, H, D, Lq, Lk, causal, q_offset, kv_offset,
          scale, s);
    });
  return -1;
}
