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
// cores; q, k, v, dO, dq are read or written once. At B8 L2048 H8 D128
// causal: 103 GFLOP, 0.104 ms.
//
// Both instances keep the reference's two-pass split: one block per (b*h,
// 64-row q tile) loops over the live 64-row k/v tiles, so every dq tile has
// one owner and no atomics are needed; tiles wholly above the causal
// diagonal are never loaded, and ragged edges are masked, so any length
// works.
//
// bf16 (flash_bwd_dq_kernel_mma), on the tensor cores: 4 warps, each owning
// 16 q rows. Q and dO stay in shared memory as bf16 for the whole loop; K
// and V tiles stream through a 2-stage cp.async ring (the next tile's
// copies are in flight while this one's products run). Rows are padded to
// D + 8 elements, so the 16-byte copies and ldmatrix reads hit distinct
// banks; about 102 KB at D = 128, two blocks per SM. Per k/v tile a warp
// computes S = Q K^T and dP = dO V^T with mma.sync m16n8k16 (operands by
// ldmatrix), applies the masks, lse and delta to the fp32 fragments in
// registers, rounds ds to bf16 and repacks it as the A operand of
// dq += ds . K (K by ldmatrix.trans); the dq accumulator stays in
// registers. Blocks run the longest causal q tiles (the last) first.
// fp32 (flash_bwd_dq_kernel) keeps full-fp32 SIMT products: one block of
// 256 threads, each owning a 4x4 micro-tile of S and dP and a 4 x D/16
// slice of dq; Q, dO and one V-then-K tile in padded fp32 shared memory.
//
// Head dims (head_dim.cuh): every d from 1 up, both dtypes. Up to 256
// the exact instances at D = 16, 32, 64, 128 and 256 (the head dim a
// compile-time constant) run d == D on 16-byte-aligned tensors; every other
// d up to 256 runs on the general instance of the next D up (8 on 16, 24
// on 32, 33 and 48 on 64, 100 on 128, 136 and 200 on 256) with the true d
// at run time: rows
// strided by H * d, columns past d zero in shared memory, nothing stored
// past d, so no tensor is copied or padded. Where its rows are whole
// 16-byte chunks on 16-byte boundaries (d a multiple of 8, the tensors
// aligned) it copies as the exact instance does; any other row (an odd d,
// a d not a multiple of 8, a misaligned view) runs on a third instance
// (ANY, chosen on the host) that copies by cp_async_rows_any: 16-byte
// cp.async for whole aligned chunks, 8- or 4-byte cp.async where the
// source allows, byte loads for the rest, and element stores.
//
// At D = 256 the dq accumulator alone is D/2 = 128 fp32 registers a lane,
// so a k/v tile is taken 32 keys at a step (the S, dP fragments 32
// registers instead of 64); Q, dO and the K, V rings take 198 KB of shared
// memory, one block of 4 warps an SM. ptxas (sm_90a, on the H100 build):
// 255 registers and 36 bytes of spill stores for the exact bf16
// instance, 255 and 254 and none for the general one and ANY; the fp32
// instance at 256 takes 210 KB and 128 registers.
//
// Above 256 every d runs on the wide path (the end of this file): a block
// owns 128 dq columns (chunk blockIdx.z) of its 64 q rows and sums S and
// dP over d in 64-column slices of Q, dO, K and V streamed through a
// 2-stage cp.async ring, the same bits in every chunk; ceil(d / 128) x the
// S and dP products. 108,544 bytes of shared memory at any d, two blocks
// an SM; ptxas (sm_90a, on the H100 build): 244 registers, 240 with ANY,
// no spill; the fp32 twin 116,736 bytes and 128 registers.

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
  return 2 * (size_t)BQ * (D + 1)  // Q tile, dO tile
         + (size_t)BK * (D + 1)    // V tile, then K tile
         + (size_t)BQ * (BK + 1)   // ds, rounded to K's type
         + 2 * (size_t)BQ;         // lse, delta
}

template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int d_true,
    int Lq, int Lk, int causal, int q_offset, int kv_offset, float scale) {
  const int dh = PAD ? d_true : D;  // the true head dim (head_dim.cuh)
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
  const long rs = (long)H * dh;  // stride between sequence positions
  const T* qb = q + (long)b * Lq * rs + (long)h * dh;
  const T* gb = g + (long)b * Lq * rs + (long)h * dh;
  const T* kb = k + (long)b * Lk * rs + (long)h * dh;
  const T* vb = v + (long)b * Lk * rs + (long)h * dh;

  // columns past dh stay zero in shared memory: they add nothing to S, dP
  // or dq, which stores none of them
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < Lq && (!PAD || c < dh);
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
      sKV[r * DP + c] = (k0 + r < Lk && (!PAD || c < dh))
                            ? to_f<T>(vb[(long)(k0 + r) * rs + c])
                            : 0.f;
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
      sKV[r * DP + c] = (k0 + r < Lk && (!PAD || c < dh))
                            ? to_f<T>(kb[(long)(k0 + r) * rs + c])
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
    T* row = dq + ((long)b * Lq + q0 + r) * rs + (long)h * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (!PAD || tx + 16 * j < dh) row[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

template <typename T, int D, bool PAD>
int launch(const void* q, const void* k, const void* v, const void* g,
           const void* lse, const void* delta, void* dq, int B, int H,
           int d, int Lq, int Lk, int causal, int q_offset, int kv_offset,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<T, D, PAD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, d, Lq, Lk, causal, q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int NTM = 128;  // threads per block: 4 warps x 16 q rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes_mma() {
  // Q, dO resident; K, V in a 2-stage ring; bf16 rows padded to D + 8
  return (size_t)(2 * BQ + 4 * BK) * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D, bool PAD, bool ANY>
__global__ void __launch_bounds__(NTM, D <= 128 ? 2 : 1)
    flash_bwd_dq_kernel_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int H, int d_true, int Lq, int Lk,
    int causal, int q_offset, int kv_offset, float scale) {
  const int dh = PAD ? d_true : D;  // the true head dim (head_dim.cuh)
  constexpr int RS = D + 8;  // padded row stride (elements)
  // keys per inner step: above D = 128 a k/v tile is taken 32 keys at a
  // step, so that the S, dP fragments fit beside the D/2 fp32 registers of
  // the dq accumulator
  constexpr int KS = D <= 128 ? BK : 32;
  constexpr int NB = KS / 8; // key n-tiles of S and dP
  constexpr int ND = D / 8;  // d n-tiles of dq
  extern __shared__ float smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sG = sQ + BQ * RS;
  __nv_bfloat16* sK = sG + BQ * RS;      // [2][BK * RS]
  __nv_bfloat16* sV = sK + 2 * BK * RS;  // [2][BK * RS]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last (longest) first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long rs = (long)H * dh;  // stride between sequence positions
  const __nv_bfloat16* qb = q + (long)b * Lq * rs + (long)h * dh;
  const __nv_bfloat16* gb = g + (long)b * Lq * rs + (long)h * dh;
  const __nv_bfloat16* kb = k + (long)b * Lk * rs + (long)h * dh;
  const __nv_bfloat16* vb = v + (long)b * Lk * rs + (long)h * dh;

  // 64 rows from r0 of src (length L) into dst; rows past L and columns
  // past dh read as zeros
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                       int L) {
    if constexpr (ANY)
      cp_async_rows_any<64, D, RS, NTM>(dst, src, rs, r0, L, tid, dh);
    else
      cp_async_rows<64, D, RS, NTM>(dst, src, rs, r0, L, tid, dh);
  };

  // live k/v tiles: with a causal mask, none past the diagonal of this tile
  int n_kt = (Lk + BK - 1) / BK;
  if (causal) {
    const long last_row = (long)q_offset + min(q0 + BQ, Lq) - 1;
    const long lim = last_row - kv_offset;  // highest key index any row sees
    n_kt = lim < 0 ? 0 : min(n_kt, (int)(lim / BK) + 1);
  }

  load_tile(sQ, qb, q0, Lq);
  load_tile(sG, gb, q0, Lq);
  if (n_kt > 0) {
    load_tile(sK, kb, 0, Lk);
    load_tile(sV, vb, 0, Lk);
  }
  cp_async_commit();

  // this lane's rows of the C fragments: q0 + warp*16 + lane/4 (+ 8)
  const int gq = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + gq + 8 * r;
    const bool in = row < Lq;  // rows past Lq: zero Q, dO give ds = 0
    lse2[r] = in ? lse[(long)bh * Lq + row] * LOG2E : 0.f;
    del[r] = in ? delta[(long)bh * Lq + row] : 0.f;
  }
  const float scale2 = scale * LOG2E;  // exp(x) = 2^(x log2 e)

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile(sK + (st ^ 1) * BK * RS, kb, (kt + 1) * BK, Lk);
      load_tile(sV + (st ^ 1) * BK * RS, vb, (kt + 1) * BK, Lk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and Q, dO) have landed
    __syncthreads();
    const __nv_bfloat16* cK = sK + st * BK * RS;
    const __nv_bfloat16* cV = sV + st * BK * RS;

    const int k0 = kt * BK;
    const bool edge = k0 + BK > Lk ||
                      (causal && kv_offset + k0 + BK - 1 > q_offset + q0 + wr);
#pragma unroll
    for (int ks = 0; ks < BK; ks += KS) {
      // S = Q K^T and dP = dO V^T for this warp's 16 rows and keys ks ..
      // ks + KS - 1 of the tile, 16 d at a step
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t aq[4], ag[4];
        const int a_off = (wr + lane % 16) * RS + kk * 16 + (lane / 16) * 8;
        ldsm_x4(aq, sQ + a_off);
        ldsm_x4(ag, sG + a_off);
#pragma unroll
        for (int j = 0; j < NB / 2; ++j) {  // key n-tiles 2j, 2j+1
          uint32_t bk[4], bv[4];
          const int b_off = (ks + 16 * j + lane % 8 + (lane / 16) * 8) * RS +
                            kk * 16 + ((lane / 8) % 2) * 8;
          ldsm_x4(bk, cK + b_off);
          ldsm_x4(bv, cV + b_off);
          mma_bf16_16816(s[2 * j], aq, bk[0], bk[1]);
          mma_bf16_16816(s[2 * j + 1], aq, bk[2], bk[3]);
          mma_bf16_16816(dp[2 * j], ag, bv[0], bv[1]);
          mma_bf16_16816(dp[2 * j + 1], ag, bv[2], bv[3]);
        }
      }

      // p and ds in the accumulator layout; ds overwrites dP
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          bool live = true;
          if (edge) {
            const int key = k0 + ks + 8 * j + 2 * tq + (e & 1);
            live = key < Lk;
            if (causal)
              live = live &&
                     (kv_offset + key <= q_offset + q0 + wr + gq + 8 * r);
          }
          const float p =
              live ? exp2_approx(s[j][e] * scale2 - lse2[r]) : 0.f;
          dp[j][e] = p * (dp[j][e] - del[r]) * scale;
        }

      // dq += bf16(ds) . K, 16 keys at a step; ds repacked as the A operand
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
        a[1] = pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
        a[2] = pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        a[3] = pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < ND / 2; ++j) {  // d n-tiles 2j, 2j+1
          uint32_t bk[4];
          ldsm_x4_trans(bk, cK + (ks + kk * 16 + lane % 16) * RS + 16 * j +
                                (lane / 16) * 8);
          mma_bf16_16816(acc[2 * j], a, bk[0], bk[1]);
          mma_bf16_16816(acc[2 * j + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // all warps are done with this stage before its refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + gq + 8 * r;
    if (row >= Lq) continue;
    __nv_bfloat16* out = dq + ((long)b * Lq + row) * rs + (long)h * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store_bf16x2<PAD, ANY>(out, 8 * j + 2 * tq, dh, acc[j][2 * r],
                             acc[j][2 * r + 1]);
  }
}

template <int D, bool PAD, bool ANY>
int launch_mma(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, void* dq, int B, int H,
               int d, int Lq, int Lk, int causal, int q_offset,
               int kv_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_mma<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel_mma<D, PAD, ANY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  flash_bwd_dq_kernel_mma<D, PAD, ANY><<<grid, NTM, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, d, Lq, Lk, causal, q_offset,
      kv_offset, scale);
  return (int)cudaGetLastError();
}

// ---- the wide path (head_dim.cuh: d above 256) -----------------------------
//
// A block owns dq columns c0 .. c0 + WDC - 1 (c0 = WDC * blockIdx.z) of its
// 64 q rows. Per k/v tile, S = Q K^T and dP = dO V^T are summed over d in
// WDS-column slices of Q, dO, K and V streamed through shared memory, in
// the same order in every chunk; then dq[:, chunk] += ds . K[:, chunk].
// Neither registers nor shared memory grow with d; the S and dP work is
// ceil(d / WDC) x the narrow kernels'.

constexpr int WDS = 64;   // d columns a slice of S and dP
constexpr int WDC = 128;  // dq columns a block

constexpr size_t smem_floats_wide() {
  return 2 * (size_t)BQ * (WDS + 1)   // Q slice, dO slice
         + 2 * (size_t)BK * (WDS + 1) // K slice, V slice
         + (size_t)BK * (WDC + 1)     // K chunk
         + (size_t)BQ * (BK + 1)      // ds, rounded to K's type
         + 2 * (size_t)BQ;            // lse, delta
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel_wide(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int dh,
    int Lq, int Lk, int causal, int q_offset, int kv_offset, float scale) {
  constexpr int DP = WDS + 1;
  constexpr int CP = WDC + 1;
  constexpr int SP = BK + 1;
  constexpr int NJ = WDC / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + BQ * DP;
  float* sK = sG + BQ * DP;
  float* sV = sK + BK * DP;
  float* sKc = sV + BK * DP;
  float* sS = sKc + BK * CP;
  float* sLse = sS + BQ * SP;
  float* sDelta = sLse + BQ;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.z * WDC;  // this block's dq columns
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long rs = (long)H * dh;  // stride between sequence positions
  const T* qb = q + (long)b * Lq * rs + (long)h * dh;
  const T* gb = g + (long)b * Lq * rs + (long)h * dh;
  const T* kb = k + (long)b * Lk * rs + (long)h * dh;
  const T* vb = v + (long)b * Lk * rs + (long)h * dh;

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

  int n_kt = (Lk + BK - 1) / BK;
  if (causal) {
    const long last_row = (long)q_offset + min(q0 + BQ, Lq) - 1;
    const long lim = last_row - kv_offset;  // highest key index any row sees
    n_kt = lim < 0 ? 0 : min(n_kt, (int)(lim / BK) + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += WDS) {
      __syncthreads();  // the previous readers are done with the slices
      for (int i = tid; i < BQ * WDS; i += NT) {
        const int r = i / WDS, c = i % WDS;
        const bool inq = q0 + r < Lq && d0 + c < dh;
        const bool ink = k0 + r < Lk && d0 + c < dh;
        const long oq = (long)(q0 + r) * rs + d0 + c;
        const long ok = (long)(k0 + r) * rs + d0 + c;
        sQ[r * DP + c] = inq ? to_f<T>(qb[oq]) : 0.f;
        sG[r * DP + c] = inq ? to_f<T>(gb[oq]) : 0.f;
        sK[r * DP + c] = ink ? to_f<T>(kb[ok]) : 0.f;
        sV[r * DP + c] = ink ? to_f<T>(vb[ok]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < WDS; ++d) {
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
    }
    // K's chunk (sKc's readers of the previous tile are past the slices'
    // barriers), and ds
    for (int i = tid; i < BK * WDC; i += NT) {
      const int r = i / WDC, c = i % WDC;
      sKc[r * CP + c] = (k0 + r < Lk && c0 + c < dh)
                            ? to_f<T>(kb[(long)(k0 + r) * rs + c0 + c])
                            : 0.f;
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
      for (int j = 0; j < NJ; ++j) ka[j] = sKc[c * CP + tx + 16 * j];
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
    T* row = dq + ((long)b * Lq + q0 + r) * rs + (long)h * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (c0 + tx + 16 * j < dh) row[c0 + tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, void* dq, int B, int H,
                int d, int Lq, int Lk, int causal, int q_offset,
                int kv_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats_wide() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel_wide<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H, (d + WDC - 1) / WDC);
  flash_bwd_dq_kernel_wide<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, d, Lq, Lk, causal, q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

// bf16 on the tensor cores: 4 warps of 16 q rows. A k/v tile is taken as
// units, one a WDS-column slice of Q, dO, K and V, streamed through a
// 2-stage cp.async ring (the next unit's copies, the next tile's first
// slice included, in flight while this one's products run); K's chunk of
// each tile goes with the tile's first unit into a 2-stage ring of its
// own. S and dP stay in registers over the slices; ds and dq[:, chunk] +=
// ds . K[:, chunk] then run as in the narrow kernel. 108,544 bytes of
// shared memory at any d, two blocks an SM.

constexpr int WRS = WDS + 8;  // padded slice row stride (elements)
constexpr int WRC = WDC + 8;  // padded chunk row stride (elements)

constexpr size_t smem_bytes_wide_mma() {
  return ((size_t)4 * (BQ + BK) * WRS + (size_t)2 * BK * WRC) *
         sizeof(__nv_bfloat16);
}

template <bool ANY>
__global__ void __launch_bounds__(NTM, 2) flash_bwd_dq_kernel_wide_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int H, int dh, int Lq, int Lk,
    int causal, int q_offset, int kv_offset, float scale) {
  constexpr int NB = BK / 8;   // key n-tiles of S and dP
  constexpr int ND = WDC / 8;  // d n-tiles of the dq chunk
  extern __shared__ float smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BQ*WRS]
  __nv_bfloat16* sG = sQ + 2 * BQ * WRS;                        // [2][BQ*WRS]
  __nv_bfloat16* sK = sG + 2 * BQ * WRS;                        // [2][BK*WRS]
  __nv_bfloat16* sV = sK + 2 * BK * WRS;                        // [2][BK*WRS]
  __nv_bfloat16* sKc = sV + 2 * BK * WRS;                       // [2][BK*WRC]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last (longest) first
  const int c0 = blockIdx.z * WDC;  // this block's dq columns
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long rs = (long)H * dh;  // stride between sequence positions
  const __nv_bfloat16* qb = q + (long)b * Lq * rs + (long)h * dh;
  const __nv_bfloat16* gb = g + (long)b * Lq * rs + (long)h * dh;
  const __nv_bfloat16* kb = k + (long)b * Lk * rs + (long)h * dh;
  const __nv_bfloat16* vb = v + (long)b * Lk * rs + (long)h * dh;

  int n_kt = (Lk + BK - 1) / BK;
  if (causal) {
    const long last_row = (long)q_offset + min(q0 + BQ, Lq) - 1;
    const long lim = last_row - kv_offset;  // highest key index any row sees
    n_kt = lim < 0 ? 0 : min(n_kt, (int)(lim / BK) + 1);
  }
  const int ns = (dh + WDS - 1) / WDS;  // slices a tile
  const int units = n_kt * ns;
  // unit u: slice u % ns of tile u / ns into stage u & 1, and with a
  // tile's first slice its K chunk
  auto issue = [&](int u) {
    const int kt = u / ns, d0 = (u % ns) * WDS, st = u & 1;
    cp_async_cols<64, WDS, WRS, NTM, ANY>(sQ + st * BQ * WRS, qb, rs, q0, Lq,
                                          d0, dh, tid);
    cp_async_cols<64, WDS, WRS, NTM, ANY>(sG + st * BQ * WRS, gb, rs, q0, Lq,
                                          d0, dh, tid);
    cp_async_cols<64, WDS, WRS, NTM, ANY>(sK + st * BK * WRS, kb, rs,
                                          kt * BK, Lk, d0, dh, tid);
    cp_async_cols<64, WDS, WRS, NTM, ANY>(sV + st * BK * WRS, vb, rs,
                                          kt * BK, Lk, d0, dh, tid);
    if (d0 == 0)
      cp_async_cols<64, WDC, WRC, NTM, ANY>(sKc + (kt & 1) * BK * WRC, kb,
                                            rs, kt * BK, Lk, c0, dh, tid);
  };
  if (units > 0) issue(0);
  cp_async_commit();

  const int gq = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + gq + 8 * r;
    const bool in = row < Lq;  // rows past Lq: zero Q, dO give ds = 0
    lse2[r] = in ? lse[(long)bh * Lq + row] * LOG2E : 0.f;
    del[r] = in ? delta[(long)bh * Lq + row] : 0.f;
  }
  const float scale2 = scale * LOG2E;  // exp(x) = 2^(x log2 e)

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int u = kt * ns; u < (kt + 1) * ns; ++u) {
      if (u + 1 < units) issue(u + 1);
      cp_async_commit();
      cp_async_wait<1>();  // unit u (and this tile's K chunk) has landed
      __syncthreads();
      const int st = u & 1;
      warp_mma_abt<NB, WDS / 16, WRS>(s, sQ + st * BQ * WRS + wr * WRS,
                                      sK + st * BK * WRS);
      warp_mma_abt<NB, WDS / 16, WRS>(dp, sG + st * BQ * WRS + wr * WRS,
                                      sV + st * BK * WRS);
      __syncthreads();  // every warp is done with stage st before its refill
    }

    // p and ds in the accumulator layout; ds overwrites dP
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Lk ||
                      (causal && kv_offset + k0 + BK - 1 > q_offset + q0 + wr);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        bool live = true;
        if (edge) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          live = key < Lk;
          if (causal)
            live = live && (kv_offset + key <= q_offset + q0 + wr + gq + 8 * r);
        }
        const float p = live ? exp2_approx(s[j][e] * scale2 - lse2[r]) : 0.f;
        dp[j][e] = p * (dp[j][e] - del[r]) * scale;
      }
    warp_mma_pv<BK / 16, ND, WRC>(acc, dp, sKc + (kt & 1) * BK * WRC);
    __syncthreads();  // every warp is done with this K chunk
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + gq + 8 * r;
    if (row >= Lq) continue;
    __nv_bfloat16* out = dq + ((long)b * Lq + row) * rs + (long)h * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store_bf16x2<true, ANY>(out, c0 + 8 * j + 2 * tq, dh, acc[j][2 * r],
                              acc[j][2 * r + 1]);
  }
}

template <bool ANY>
int launch_wide_mma(const void* q, const void* k, const void* v,
                    const void* g, const void* lse, const void* delta,
                    void* dq, int B, int H, int d, int Lq, int Lk, int causal,
                    int q_offset, int kv_offset, float scale,
                    cudaStream_t stream) {
  const size_t smem = smem_bytes_wide_mma();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel_wide_mma<ANY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Lq + BQ - 1) / BQ, (d + WDC - 1) / WDC);
  flash_bwd_dq_kernel_wide_mma<ANY><<<grid, NTM, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, d, Lq, Lk, causal, q_offset,
      kv_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and dq share it). Returns
// the launch's cudaError_t (0 = launched); -1 for a dtype this build has
// no instance for or a head dim D below 1 (head_dim.cuh). A bf16 tensor of
// any alignment runs (a misaligned one on the general instance or the wide
// path's ANY one).
extern "C" int tdt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* g, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int Lq, int Lk, int D, int causal,
                                int q_offset, int kv_offset, float scale,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return with_head_dim(D, true, true, [&](auto hd) {
      using HD = decltype(hd);
      return launch<float, HD::value, HD::pad>(
          q, k, v, g, lse, delta, dq, B, H, D, Lq, Lk, causal, q_offset,
          kv_offset, scale, s);
    }, [&](auto) {
      return launch_wide<float>(q, k, v, g, lse, delta, dq, B, H, D, Lq, Lk,
                                causal, q_offset, kv_offset, scale, s);
    });
  if (dtype == 1)
    return with_head_dim(D, tdt_aligned16(q, k, v, g, dq), D % 8 == 0,
                         [&](auto hd) {
      using HD = decltype(hd);
      return launch_mma<HD::value, HD::pad, HD::any>(
          q, k, v, g, lse, delta, dq, B, H, D, Lq, Lk, causal, q_offset,
          kv_offset, scale, s);
    }, [&](auto wd) {
      return launch_wide_mma<decltype(wd)::any>(
          q, k, v, g, lse, delta, dq, B, H, D, Lq, Lk, causal, q_offset,
          kv_offset, scale, s);
    });
  return -1;
}
