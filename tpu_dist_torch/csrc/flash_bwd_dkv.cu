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
// cores; q, k, v, dO, dk, dv are read or written once. At B8 L2048 H8 D128
// causal: 137 GFLOP, 0.139 ms.
//
// Both instances keep the reference's two-pass split: one block per (b*h,
// 64-row k/v tile) keeps its K and V tiles and its dk/dv accumulators for
// the whole loop over 64-row q tiles, so each output tile has one owner and
// no atomics are needed. The finalize rule is the reference's: every causal
// kv tile's last live q tile is the final one, so the accumulators are
// written once, after the loop. q tiles wholly before the diagonal are
// skipped; ragged edges are masked, so any length works.
//
// bf16 (flash_bwd_dkv_kernel_mma), on the tensor cores: 4 warps, each
// owning 16 keys. K and V stay in shared memory as bf16; Q, dO, lse and
// delta tiles stream through a 2-stage cp.async ring. Rows are padded to
// D + 8 elements (conflict-free 16-byte copies and ldmatrix); about 103 KB
// at D = 128, two blocks per SM. A warp computes S^T = K Q^T and
// dP^T = V dO^T with mma.sync m16n8k16, so its rows are keys and p^T, ds^T
// come out of the masks, lse and delta already in the A layout of
// dv += p^T . dO and dk += ds^T . Q (dO, Q by ldmatrix.trans): rounded to
// bf16 and repacked in registers. The dk and dv accumulators stay in
// registers; at D = 128 a q tile is taken 32 rows at a step so that they
// and the S^T, dP^T fragments fit without spills. Blocks run the low k
// tiles, which see the most q tiles under causal, first.
// fp32 (flash_bwd_dkv_kernel) keeps full-fp32 SIMT products: one block of
// 256 threads, each computing a 4x4 micro-tile of S and dP, writing the
// rounded p and ds tiles to shared memory and accumulating a 4 x D/16 slice
// of dk and dv from them.
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
// At D = 256 the dk and dv accumulators would be 2 x D/2 = 256 fp32
// registers a lane: the output columns are split into 128-column chunks
// over the grid's z axis, each block recomputing S^T and dP^T over all of
// d (1.5x the products) and accumulating its chunk of dk and dv, as the
// 128 instance does; Q, dO, K and V take 199 KB of shared memory, one
// block of 4 warps an SM. ptxas (sm_90a, on the H100 build): 242 registers
// for the exact and the general bf16 instances, 240 with ANY, no spill. The
// fp32 instance at 256 takes q tiles of 32 rows (K, V, Q and dO in fp32
// fit 209 KB) and 246 registers, no spill.
//
// Above 256 every d runs on the wide path (the end of this file): the 256
// design's 128-column chunks for any d, with S^T and dP^T summed over d in
// 64-column slices of K, V, Q and dO streamed through a 2-stage cp.async
// ring (q tiles of 32 rows), the same bits in every chunk; ceil(d / 128) x
// the S^T and dP^T products. 90,624 bytes of shared memory at any d;
// ptxas (sm_90a, on the H100 build): 253 registers, 255 with ANY, no
// spill; the fp32 twin 166,400 bytes and 128 registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "head_dim.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int BQ = 64;    // q rows per tile
constexpr int BK = 64;    // k/v rows per block
constexpr int NT = 256;   // threads per block: a 16 x 16 grid
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// q rows per tile of the fp32 instance: 32 above D = 128, so that K, V, Q
// and dO in fp32 fit the 227 KB of shared memory
template <int D>
__host__ __device__ constexpr int fp32_bq() {
  return D <= 128 ? BQ : 32;
}

template <int D>
constexpr size_t smem_floats() {
  return 2 * (size_t)BK * (D + 1)             // K tile, V tile
         + 2 * (size_t)fp32_bq<D>() * (D + 1)  // Q tile, dO tile
         + 2 * (size_t)fp32_bq<D>() * (BK + 1) // p (dO's type), ds (Q's type)
         + 2 * (size_t)fp32_bq<D>();           // lse, delta
}

template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int d_true, int Lq, int Lk, int causal, int q_offset,
    int kv_offset, float scale) {
  const int dh = PAD ? d_true : D;  // the true head dim (head_dim.cuh)
  constexpr int DP = D + 1;
  constexpr int SP = BK + 1;
  constexpr int NJ = D / 16;  // dk/dv columns per thread
  constexpr int BQF = fp32_bq<D>();  // q rows per tile
  constexpr int QI = BQF / 16;       // q rows per thread of S and dP
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * DP;
  float* sQ = sV + BK * DP;
  float* sG = sQ + BQF * DP;
  float* sP = sG + BQF * DP;
  float* sDS = sP + BQF * SP;
  float* sLse = sDS + BQF * SP;
  float* sDelta = sLse + BQF;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long rs = (long)H * dh;  // stride between sequence positions
  const T* qb = q + (long)b * Lq * rs + (long)h * dh;
  const T* gb = g + (long)b * Lq * rs + (long)h * dh;
  const T* kb = k + (long)b * Lk * rs + (long)h * dh;
  const T* vb = v + (long)b * Lk * rs + (long)h * dh;

  // columns past dh stay zero in shared memory: they add nothing to S, dP,
  // dk or dv, which store none of them
  for (int i = tid; i < BK * D; i += NT) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < Lk && (!PAD || c < dh);
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
  const int n_qt = (Lq + BQF - 1) / BQF;
  int first_qt = 0;
  if (causal) {
    const long d0 = (long)kv_offset + k0 - q_offset;  // first row that sees key k0
    first_qt = d0 <= 0 ? 0 : (int)min((long)n_qt, d0 / BQF);
  }

  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * BQF;
    __syncthreads();  // the previous tile's readers are done with sQ..sDelta
    for (int i = tid; i < BQF * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool in = q0 + r < Lq && (!PAD || c < dh);
      sQ[r * DP + c] = in ? to_f<T>(qb[(long)(q0 + r) * rs + c]) : 0.f;
      sG[r * DP + c] = in ? to_f<T>(gb[(long)(q0 + r) * rs + c]) : 0.f;
    }
    for (int r = tid; r < BQF; r += NT) {
      const bool in = q0 + r < Lq;
      sLse[r] = in ? lse[(long)bh * Lq + q0 + r] : 0.f;
      sDelta[r] = in ? delta[(long)bh * Lq + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[QI][4], dp[QI][4];
#pragma unroll
    for (int i = 0; i < QI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[QI], ga[QI], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        qa[i] = sQ[(ty + 16 * i) * DP + d];
        ga[i] = sG[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = sK[(tx + 16 * j) * DP + d];
        va[j] = sV[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < QI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], va[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < QI; ++i) {
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
    for (int r = 0; r < BQF; ++r) {
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
    const long off = ((long)b * Lk + k0 + r) * rs + (long)h * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (PAD && tx + 16 * j >= dh) continue;
      dk[off + tx + 16 * j] = from_f<T>(acc_k[i][j]);
      dv[off + tx + 16 * j] = from_f<T>(acc_v[i][j]);
    }
  }
}

template <typename T, int D, bool PAD>
int launch(const void* q, const void* k, const void* v, const void* g,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int H, int d, int Lq, int Lk, int causal, int q_offset,
           int kv_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lk + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<T, D, PAD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, d, Lq, Lk, causal,
      q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int NTM = 128;  // threads per block: 4 warps x 16 keys
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes_mma() {
  // K, V resident; Q, dO in a 2-stage ring (bf16 rows padded to D + 8);
  // lse, delta in a 2-stage ring (fp32)
  return (size_t)(2 * BK + 4 * BQ) * (D + 8) * sizeof(__nv_bfloat16) +
         4 * (size_t)BQ * sizeof(float);
}

// output columns a block accumulates: all of D up to 128; above, dk and dv
// (2 x D/2 fp32 registers a lane) are split into 128-column chunks over
// the grid's z axis, each block recomputing p and ds over all of D
template <int D>
__host__ __device__ constexpr int dkv_chunk() {
  return D <= 128 ? D : 128;
}

template <int D, bool PAD, bool ANY>
__global__ void __launch_bounds__(NTM, D <= 128 ? 2 : 1)
    flash_bwd_dkv_kernel_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
    int d_true, int Lq, int Lk, int causal, int q_offset, int kv_offset,
    float scale) {
  const int dh = PAD ? d_true : D;  // the true head dim (head_dim.cuh)
  constexpr int RS = D + 8;        // padded row stride (elements)
  // q rows per inner step: the S^T, dP^T fragments beside the dk, dv
  // accumulators (D/2 + D/2 fp32 registers) stay within the register budget
  constexpr int QS = D >= 128 ? 32 : 64;
  constexpr int NB = QS / 8;       // q n-tiles of S^T and dP^T
  constexpr int DC = dkv_chunk<D>();  // this block's columns of dk, dv
  constexpr int ND = DC / 8;       // d n-tiles of dk, dv
  extern __shared__ float smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BK * RS;
  __nv_bfloat16* sQ = sV + BK * RS;      // [2][BQ * RS]
  __nv_bfloat16* sG = sQ + 2 * BQ * RS;  // [2][BQ * RS]
  float* sL = reinterpret_cast<float*>(sG + 2 * BQ * RS);  // [2][BQ]
  float* sD = sL + 2 * BQ;                                 // [2][BQ]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * BK;
  const int c0 = D > DC ? (int)blockIdx.z * DC : 0;  // first column of dk, dv
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
  // q tile qt into ring stage st: Q, dO, and lse, delta (zeros past Lq)
  auto load_q_tile = [&](int st, int qt) {
    const int q0 = qt * BQ;
    load_tile(sQ + st * BQ * RS, qb, q0, Lq);
    load_tile(sG + st * BQ * RS, gb, q0, Lq);
    for (int i = tid; i < BQ; i += NTM) {
      const bool in = q0 + i < Lq;
      const long off = (long)bh * Lq + (in ? q0 + i : 0);
      cp_async_4(sL + st * BQ + i, lse + off, in ? 4 : 0);
      cp_async_4(sD + st * BQ + i, delta + off, in ? 4 : 0);
    }
  };

  // live q tiles: with a causal mask, none that ends before this tile's
  // first key position (kv_offset + k0)
  const int n_qt = (Lq + BQ - 1) / BQ;
  int first_qt = 0;
  if (causal) {
    const long d0 = (long)kv_offset + k0 - q_offset;  // first row that sees key k0
    first_qt = d0 <= 0 ? 0 : (int)min((long)n_qt, d0 / BQ);
  }

  load_tile(sK, kb, k0, Lk);
  load_tile(sV, vb, k0, Lk);
  if (first_qt < n_qt) load_q_tile(0, first_qt);
  cp_async_commit();

  // this lane's keys (rows of the C fragments): k0 + warp*16 + lane/4 (+ 8)
  const int gq = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;
  const float scale2 = scale * LOG2E;  // exp(x) = 2^(x log2 e)

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int st = (qt - first_qt) & 1;
    if (qt + 1 < n_qt) load_q_tile(st ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and K, V) have landed
    __syncthreads();
    const __nv_bfloat16* cQ = sQ + st * BQ * RS;
    const __nv_bfloat16* cG = sG + st * BQ * RS;
    const float* cL = sL + st * BQ;
    const float* cD = sD + st * BQ;
    const int q0 = qt * BQ;

#pragma unroll 1
    for (int qs = 0; qs < BQ; qs += QS) {
      // every row of this step is before this warp's first key: p = 0
      if (causal && kv_offset + k0 + wr > q_offset + q0 + qs + QS - 1)
        continue;
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        const int a_off = (wr + lane % 16) * RS + kk * 16 + (lane / 16) * 8;
        ldsm_x4(ak, sK + a_off);
        ldsm_x4(av, sV + a_off);
#pragma unroll
        for (int j = 0; j < NB / 2; ++j) {  // q n-tiles 2j, 2j+1
          uint32_t bq[4], bg[4];
          const int b_off = (qs + 16 * j + lane % 8 + (lane / 16) * 8) * RS +
                            kk * 16 + ((lane / 8) % 2) * 8;
          ldsm_x4(bq, cQ + b_off);
          ldsm_x4(bg, cG + b_off);
          mma_bf16_16816(s[2 * j], ak, bq[0], bq[1]);
          mma_bf16_16816(s[2 * j + 1], ak, bq[2], bq[3]);
          mma_bf16_16816(dp[2 * j], av, bg[0], bg[1]);
          mma_bf16_16816(dp[2 * j + 1], av, bg[2], bg[3]);
        }
      }

      // p^T into s, ds^T into dp, in the accumulator layout
      const bool edge =
          q0 + qs + QS > Lq || k0 + BK > Lk ||
          (causal && kv_offset + k0 + wr + 15 > q_offset + q0 + qs);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = qs + 8 * j + 2 * tq + (e & 1);  // q row of the tile
          bool live = true;
          if (edge) {
            const int key = k0 + wr + gq + 8 * (e / 2);
            live = q0 + i < Lq && key < Lk;
            if (causal) live = live && (kv_offset + key <= q_offset + q0 + i);
          }
          const float p =
              live ? exp2_approx(s[j][e] * scale2 - cL[i] * LOG2E) : 0.f;
          dp[j][e] = p * (dp[j][e] - cD[i]) * scale;
          s[j][e] = p;
        }

      // dv += bf16(p^T) . dO and dk += bf16(ds^T) . Q, 16 q rows at a step
#pragma unroll
      for (int kk = 0; kk < QS / 16; ++kk) {
        uint32_t ap[4], ad[4];
        ap[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        ap[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        ap[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        ap[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        ad[0] = pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
        ad[1] = pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
        ad[2] = pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        ad[3] = pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < ND / 2; ++j) {  // d n-tiles 2j, 2j+1
          uint32_t bg[4], bq[4];
          const int b_off = (qs + kk * 16 + lane % 16) * RS + c0 + 16 * j +
                            (lane / 16) * 8;
          ldsm_x4_trans(bg, cG + b_off);
          ldsm_x4_trans(bq, cQ + b_off);
          mma_bf16_16816(acc_v[2 * j], ap, bg[0], bg[1]);
          mma_bf16_16816(acc_v[2 * j + 1], ap, bg[2], bg[3]);
          mma_bf16_16816(acc_k[2 * j], ad, bq[0], bq[1]);
          mma_bf16_16816(acc_k[2 * j + 1], ad, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // all warps are done with this stage before its refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wr + gq + 8 * r;
    if (key >= Lk) continue;
    const long off = ((long)b * Lk + key) * rs + (long)h * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int col = c0 + 8 * j + 2 * tq;
      store_bf16x2<PAD, ANY>(dk + off, col, dh, acc_k[j][2 * r],
                             acc_k[j][2 * r + 1]);
      store_bf16x2<PAD, ANY>(dv + off, col, dh, acc_v[j][2 * r],
                             acc_v[j][2 * r + 1]);
    }
  }
}

template <int D, bool PAD, bool ANY>
int launch_mma(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int d, int Lq, int Lk, int causal, int q_offset,
               int kv_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_mma<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel_mma<D, PAD, ANY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Lk + BK - 1) / BK, D / dkv_chunk<D>());
  flash_bwd_dkv_kernel_mma<D, PAD, ANY><<<grid, NTM, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, d,
      Lq, Lk, causal, q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

// ---- the wide path (head_dim.cuh: d above 256) -----------------------------
//
// As at 256, but for every d: a block owns dk and dv columns c0 .. c0 +
// WDC - 1 (c0 = WDC * blockIdx.z) of its 64 keys. Per q tile, S^T = K Q^T
// and dP^T = V dO^T are summed over d in WDS-column slices of K, V, Q and
// dO streamed through shared memory, in the same order in every chunk;
// then dv[:, chunk] += p^T . dO[:, chunk] and dk[:, chunk] += ds^T .
// Q[:, chunk]. Neither registers nor shared memory grow with d; the S and
// dP work is ceil(d / WDC) x the narrow kernels'.

constexpr int WDS = 64;   // d columns a slice of S^T and dP^T
constexpr int WDC = 128;  // dk, dv columns a block

constexpr size_t smem_floats_wide() {
  return 2 * (size_t)BK * (WDS + 1)    // K slice, V slice
         + 2 * (size_t)BQ * (WDS + 1)  // Q slice, dO slice
         + 2 * (size_t)BQ * (WDC + 1)  // Q chunk, dO chunk
         + 2 * (size_t)BQ * (BK + 1)   // p (dO's type), ds (Q's type)
         + 2 * (size_t)BQ;             // lse, delta
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel_wide(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int dh, int Lq, int Lk, int causal, int q_offset, int kv_offset,
    float scale) {
  constexpr int DP = WDS + 1;
  constexpr int CP = WDC + 1;
  constexpr int SP = BK + 1;
  constexpr int NJ = WDC / 16;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * DP;
  float* sQ = sV + BK * DP;
  float* sG = sQ + BQ * DP;
  float* sQc = sG + BQ * DP;
  float* sGc = sQc + BQ * CP;
  float* sP = sGc + BQ * CP;
  float* sDS = sP + BQ * SP;
  float* sLse = sDS + BQ * SP;
  float* sDelta = sLse + BQ;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int c0 = blockIdx.z * WDC;  // this block's dk, dv columns
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long rs = (long)H * dh;  // stride between sequence positions
  const T* qb = q + (long)b * Lq * rs + (long)h * dh;
  const T* gb = g + (long)b * Lq * rs + (long)h * dh;
  const T* kb = k + (long)b * Lk * rs + (long)h * dh;
  const T* vb = v + (long)b * Lk * rs + (long)h * dh;

  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_qt = (Lq + BQ - 1) / BQ;
  int first_qt = 0;
  if (causal) {
    const long d0 = (long)kv_offset + k0 - q_offset;  // first row that sees key k0
    first_qt = d0 <= 0 ? 0 : (int)min((long)n_qt, d0 / BQ);
  }

  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done with shared
    for (int i = tid; i < BQ * WDC; i += NT) {
      const int r = i / WDC, c = i % WDC;
      const bool in = q0 + r < Lq && c0 + c < dh;
      const long o = (long)(q0 + r) * rs + c0 + c;
      sQc[r * CP + c] = in ? to_f<T>(qb[o]) : 0.f;
      sGc[r * CP + c] = in ? to_f<T>(gb[o]) : 0.f;
    }
    for (int r = tid; r < BQ; r += NT) {
      const bool in = q0 + r < Lq;
      sLse[r] = in ? lse[(long)bh * Lq + q0 + r] : 0.f;
      sDelta[r] = in ? delta[(long)bh * Lq + q0 + r] : 0.f;
    }

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += WDS) {
      __syncthreads();  // the previous readers are done with the slices
      for (int i = tid; i < BK * WDS; i += NT) {
        const int r = i / WDS, c = i % WDS;
        const bool ink = k0 + r < Lk && d0 + c < dh;
        const bool inq = q0 + r < Lq && d0 + c < dh;
        const long ok = (long)(k0 + r) * rs + d0 + c;
        const long oq = (long)(q0 + r) * rs + d0 + c;
        sK[r * DP + c] = ink ? to_f<T>(kb[ok]) : 0.f;
        sV[r * DP + c] = ink ? to_f<T>(vb[ok]) : 0.f;
        sQ[r * DP + c] = inq ? to_f<T>(qb[oq]) : 0.f;
        sG[r * DP + c] = inq ? to_f<T>(gb[oq]) : 0.f;
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
        ga[j] = sGc[r * CP + tx + 16 * j];
        qa[j] = sQc[r * CP + tx + 16 * j];
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
    const long off = ((long)b * Lk + k0 + r) * rs + (long)h * dh + c0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (c0 + tx + 16 * j >= dh) continue;
      dk[off + tx + 16 * j] = from_f<T>(acc_k[i][j]);
      dv[off + tx + 16 * j] = from_f<T>(acc_v[i][j]);
    }
  }
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, void* dk, void* dv,
                int B, int H, int d, int Lq, int Lk, int causal, int q_offset,
                int kv_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats_wide() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel_wide<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lk + BK - 1) / BK, B * H, (d + WDC - 1) / WDC);
  flash_bwd_dkv_kernel_wide<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, d, Lq, Lk, causal,
      q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

// bf16 on the tensor cores: 4 warps of 16 keys, q tiles of WBQ = 32 rows
// (the dk and dv accumulators take 2 x WDC/2 fp32 registers a lane, so S^T
// and dP^T are 32 q rows wide, as at 128 and 256). A q tile is taken as
// units, one a WDS-column slice of K, V, Q and dO, streamed through a
// 2-stage cp.async ring (the next unit's copies, the next tile's first
// slice included, in flight while this one's products run); Q's and dO's
// chunks and lse, delta of each tile go with its first unit into 2-stage
// rings of their own. 90,624 bytes of shared memory at any d.

constexpr int WBQ = 32;       // q rows a tile
constexpr int WRS = WDS + 8;  // padded slice row stride (elements)
constexpr int WRC = WDC + 8;  // padded chunk row stride (elements)

constexpr size_t smem_bytes_wide_mma() {
  return ((size_t)2 * (2 * BK + 2 * WBQ) * WRS +
          (size_t)4 * WBQ * WRC) * sizeof(__nv_bfloat16) +
         (size_t)4 * WBQ * sizeof(float);
}

template <bool ANY>
__global__ void __launch_bounds__(NTM, 2) flash_bwd_dkv_kernel_wide_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
    int dh, int Lq, int Lk, int causal, int q_offset, int kv_offset,
    float scale) {
  constexpr int NB = WBQ / 8;  // q n-tiles of S^T and dP^T
  constexpr int ND = WDC / 8;  // d n-tiles of the dk, dv chunks
  extern __shared__ float smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BK*WRS]
  __nv_bfloat16* sV = sK + 2 * BK * WRS;                        // [2][BK*WRS]
  __nv_bfloat16* sQ = sV + 2 * BK * WRS;                        // [2][WBQ*WRS]
  __nv_bfloat16* sG = sQ + 2 * WBQ * WRS;                       // [2][WBQ*WRS]
  __nv_bfloat16* sQc = sG + 2 * WBQ * WRS;                      // [2][WBQ*WRC]
  __nv_bfloat16* sGc = sQc + 2 * WBQ * WRC;                     // [2][WBQ*WRC]
  float* sL = reinterpret_cast<float*>(sGc + 2 * WBQ * WRC);    // [2][WBQ]
  float* sD = sL + 2 * WBQ;                                     // [2][WBQ]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * BK;
  const int c0 = blockIdx.z * WDC;  // this block's dk, dv columns
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long rs = (long)H * dh;  // stride between sequence positions
  const __nv_bfloat16* qb = q + (long)b * Lq * rs + (long)h * dh;
  const __nv_bfloat16* gb = g + (long)b * Lq * rs + (long)h * dh;
  const __nv_bfloat16* kb = k + (long)b * Lk * rs + (long)h * dh;
  const __nv_bfloat16* vb = v + (long)b * Lk * rs + (long)h * dh;

  const int n_qt = (Lq + WBQ - 1) / WBQ;
  int first_qt = 0;
  if (causal) {
    const long d0 = (long)kv_offset + k0 - q_offset;  // first row that sees key k0
    first_qt = d0 <= 0 ? 0 : (int)min((long)n_qt, d0 / WBQ);
  }
  const int ns = (dh + WDS - 1) / WDS;  // slices a q tile
  const int units = (n_qt - first_qt) * ns;
  // unit u: slice u % ns of q tile first_qt + u / ns into stage u & 1, and
  // with a tile's first slice its Q and dO chunks and lse, delta
  auto issue = [&](int u) {
    const int t = u / ns, d0 = (u % ns) * WDS, st = u & 1;
    const int q0 = (first_qt + t) * WBQ;
    cp_async_cols<64, WDS, WRS, NTM, ANY>(sK + st * BK * WRS, kb, rs, k0, Lk,
                                          d0, dh, tid);
    cp_async_cols<64, WDS, WRS, NTM, ANY>(sV + st * BK * WRS, vb, rs, k0, Lk,
                                          d0, dh, tid);
    cp_async_cols<WBQ, WDS, WRS, NTM, ANY>(sQ + st * WBQ * WRS, qb, rs, q0,
                                           Lq, d0, dh, tid);
    cp_async_cols<WBQ, WDS, WRS, NTM, ANY>(sG + st * WBQ * WRS, gb, rs, q0,
                                           Lq, d0, dh, tid);
    if (d0 == 0) {
      const int tc = t & 1;
      cp_async_cols<WBQ, WDC, WRC, NTM, ANY>(sQc + tc * WBQ * WRC, qb, rs, q0,
                                             Lq, c0, dh, tid);
      cp_async_cols<WBQ, WDC, WRC, NTM, ANY>(sGc + tc * WBQ * WRC, gb, rs, q0,
                                             Lq, c0, dh, tid);
      for (int i = tid; i < WBQ; i += NTM) {
        const bool in = q0 + i < Lq;
        const long off = (long)bh * Lq + (in ? q0 + i : 0);
        cp_async_4(sL + tc * WBQ + i, lse + off, in ? 4 : 0);
        cp_async_4(sD + tc * WBQ + i, delta + off, in ? 4 : 0);
      }
    }
  };
  if (units > 0) issue(0);
  cp_async_commit();

  const int gq = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;
  const float scale2 = scale * LOG2E;  // exp(x) = 2^(x log2 e)

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int t = qt - first_qt, tc = t & 1;
    const int q0 = qt * WBQ;
    // every row of this tile is before this warp's first key: p = 0
    const bool dead = causal && kv_offset + k0 + wr > q_offset + q0 + WBQ - 1;
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int u = t * ns; u < (t + 1) * ns; ++u) {
      if (u + 1 < units) issue(u + 1);
      cp_async_commit();
      cp_async_wait<1>();  // unit u (and this tile's chunks) has landed
      __syncthreads();
      const int st = u & 1;
      if (!dead) {
        warp_mma_abt<NB, WDS / 16, WRS>(s, sK + st * BK * WRS + wr * WRS,
                                        sQ + st * WBQ * WRS);
        warp_mma_abt<NB, WDS / 16, WRS>(dp, sV + st * BK * WRS + wr * WRS,
                                        sG + st * WBQ * WRS);
      }
      __syncthreads();  // every warp is done with stage st before its refill
    }

    if (!dead) {
      // p^T into s, ds^T into dp, in the accumulator layout
      const float* cL = sL + tc * WBQ;
      const float* cD = sD + tc * WBQ;
      const bool edge =
          q0 + WBQ > Lq || k0 + BK > Lk ||
          (causal && kv_offset + k0 + wr + 15 > q_offset + q0);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * j + 2 * tq + (e & 1);  // q row of the tile
          bool live = true;
          if (edge) {
            const int key = k0 + wr + gq + 8 * (e / 2);
            live = q0 + i < Lq && key < Lk;
            if (causal) live = live && (kv_offset + key <= q_offset + q0 + i);
          }
          const float p =
              live ? exp2_approx(s[j][e] * scale2 - cL[i] * LOG2E) : 0.f;
          dp[j][e] = p * (dp[j][e] - cD[i]) * scale;
          s[j][e] = p;
        }
      warp_mma_pv<WBQ / 16, ND, WRC>(acc_v, s, sGc + tc * WBQ * WRC);
      warp_mma_pv<WBQ / 16, ND, WRC>(acc_k, dp, sQc + tc * WBQ * WRC);
    }
    __syncthreads();  // every warp is done with this tile's chunks
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wr + gq + 8 * r;
    if (key >= Lk) continue;
    const long off = ((long)b * Lk + key) * rs + (long)h * dh;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int col = c0 + 8 * j + 2 * tq;
      store_bf16x2<true, ANY>(dk + off, col, dh, acc_k[j][2 * r],
                              acc_k[j][2 * r + 1]);
      store_bf16x2<true, ANY>(dv + off, col, dh, acc_v[j][2 * r],
                              acc_v[j][2 * r + 1]);
    }
  }
}

template <bool ANY>
int launch_wide_mma(const void* q, const void* k, const void* v,
                    const void* g, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int H, int d, int Lq, int Lk,
                    int causal, int q_offset, int kv_offset, float scale,
                    cudaStream_t stream) {
  const size_t smem = smem_bytes_wide_mma();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel_wide_mma<ANY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Lk + BK - 1) / BK, (d + WDC - 1) / WDC);
  flash_bwd_dkv_kernel_wide_mma<ANY><<<grid, NTM, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, d,
      Lq, Lk, causal, q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dk and dv share it).
// Returns the launch's cudaError_t (0 = launched); -1 for a dtype this build
// has no instance for or a head dim D below 1 (head_dim.cuh). A bf16
// tensor of any alignment runs (a misaligned one on the general instance
// or the wide path's ANY one).
extern "C" int tdt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int H, int Lq, int Lk, int D, int causal,
                                 int q_offset, int kv_offset, float scale,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return with_head_dim(D, true, true, [&](auto hd) {
      using HD = decltype(hd);
      return launch<float, HD::value, HD::pad>(
          q, k, v, g, lse, delta, dk, dv, B, H, D, Lq, Lk, causal, q_offset,
          kv_offset, scale, s);
    }, [&](auto) {
      return launch_wide<float>(q, k, v, g, lse, delta, dk, dv, B, H, D, Lq,
                                Lk, causal, q_offset, kv_offset, scale, s);
    });
  if (dtype == 1)
    return with_head_dim(D, tdt_aligned16(q, k, v, g, dk, dv), D % 8 == 0,
                         [&](auto hd) {
      using HD = decltype(hd);
      return launch_mma<HD::value, HD::pad, HD::any>(
          q, k, v, g, lse, delta, dk, dv, B, H, D, Lq, Lk, causal, q_offset,
          kv_offset, scale, s);
    }, [&](auto wd) {
      return launch_wide_mma<decltype(wd)::any>(
          q, k, v, g, lse, delta, dk, dv, B, H, D, Lq, Lk, causal, q_offset,
          kv_offset, scale, s);
    });
  return -1;
}
