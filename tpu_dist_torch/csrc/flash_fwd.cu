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
// v, out once each) are far smaller at prefill lengths. At B1 L2048 H8 D128
// causal: 8.6 GFLOP, 0.0087 ms; at the training shape B8: 0.0695 ms.
//
// Both instances: one block per (b*h, 64-row q tile) loops over the live
// 64-row k/v tiles; tiles wholly above the causal diagonal are never
// loaded, and ragged edges are masked, so any length works.
//
// bf16 (flash_fwd_kernel_mma), on the tensor cores: 4 warps, each owning
// 16 q rows. Q is staged once by cp.async and its A fragments are read by
// ldmatrix once and held in registers for the whole loop; K and V stream
// through separate 2-stage cp.async rings (the next tile's copies are in
// flight while this one's products run), rows padded to D + 8 elements so
// the 16-byte copies and ldmatrix reads hit distinct banks: 87 KB at
// D = 128, two blocks per SM. Per k/v tile a warp computes S = Q K^T with
// mma.sync m16n8k16 (K by ldmatrix), masks only tiles that straddle the
// diagonal or Lk, and runs the online softmax on the fp32 C fragments in
// registers (row max and sum over each quad by shuffles, exp in base 2
// with scale * log2 e folded into one multiply-add). p is rounded to bf16
// and repacked in registers as the A operand of acc += p . V (V by
// ldmatrix.trans), so S and p never touch shared memory; the row sum takes
// the fp32 p. Blocks run the longest causal q tiles (the last) first.
// fp32 (flash_fwd_kernel) keeps full-fp32 SIMT products, for exactness in
// the small fp32 card-vs-CPU checks: one block of 256 threads, a 4x4
// micro-tile of S and a 4 x D/16 slice of the output per thread, K then V
// through one padded fp32 shared buffer, S and p through shared memory.
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
// At D = 256 Q's A fragments (D/4 = 64 registers a lane) no longer fit
// beside the D/2 = 128 fp32 registers of the output accumulator and S's
// 32, so they are read from shared memory by ldmatrix at each k-step (FA-2's
// choice at 256); K and V keep their 2-stage rings: 165 KB of shared
// memory (rows padded to 264), one block of 4 warps an SM. ptxas (sm_90a,
// on the H100 build): 253 registers for the exact and the general bf16
// instances, 249 with ANY, no spill; the fp32 instance at 256 takes 145
// KB and 128 registers.
//
// Above 256 every d runs on the wide path (the end of this file): a block
// owns 128 output columns (chunk blockIdx.z) of its 64 q rows and sums S
// over d in 64-column slices of Q and K streamed through a 2-stage
// cp.async ring, so S, the softmax and lse are the same bits in every
// chunk; ceil(d / 128) x the S products. 71,680 bytes of shared memory at
// any d; ptxas (sm_90a, on the H100 build): 212 registers, 197 with ANY,
// no spill; the fp32 twin 83,712 bytes and 112 registers.

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
         + (size_t)BK * (D + 1)    // K tile, then V tile
         + (size_t)BQ * (BK + 1)   // scores, then p
         + 3 * (size_t)BQ;         // running max, running sum, rescale
}

template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int H, int d_true, int Lq,
    int Lk, int causal, int q_offset, int kv_offset, float scale) {
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
  const T* kb = k + (long)b * Lk * rs + (long)h * dh;
  const T* vb = v + (long)b * Lk * rs + (long)h * dh;

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
        sS[r * SP + c] = live ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();  // S complete; K no longer needed

    // V into the same buffer, while four threads per row take the row stats
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      sKV[r * DP + c] = (k0 + r < Lk && (!PAD || c < dh))
                            ? to_f<T>(vb[(long)(k0 + r) * rs + c])
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
    T* orow = out + ((long)b * Lq + q0 + r) * rs + (long)h * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (!PAD || tx + 16 * j < dh) orow[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
  for (int r = tid; r < BQ; r += NT) {
    if (q0 + r < Lq)
      lse[(long)bh * Lq + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
  }
}

template <typename T, int D, bool PAD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int d, int Lq, int Lk, int causal, int q_offset,
           int kv_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D, PAD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, d, Lq, Lk, causal, q_offset, kv_offset,
      scale);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int NTM = 128;  // threads per block: 4 warps x 16 q rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes_mma() {
  // Q resident; K, V in a 2-stage ring; bf16 rows padded to D + 8
  return (size_t)(BQ + 4 * BK) * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D, bool PAD, bool ANY>
__global__ void __launch_bounds__(NTM, D <= 128 ? 2 : 1) flash_fwd_kernel_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int H, int d_true, int Lq, int Lk, int causal,
    int q_offset, int kv_offset, float scale) {
  const int dh = PAD ? d_true : D;  // the true head dim (head_dim.cuh)
  constexpr int RS = D + 8;   // padded row stride (elements)
  constexpr int NB = BK / 8;  // key n-tiles of S
  constexpr int ND = D / 8;   // d n-tiles of the output
  constexpr int KD = D / 16;  // k-steps of S = Q K^T
  // Q's A fragments held in registers (D/4 a lane) up to D = 128; above,
  // beside the D/2 of the output accumulator, they are read from shared
  // memory by ldmatrix at each k-step
  constexpr bool QREG = D <= 128;
  extern __shared__ float smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * RS;      // [2][BK * RS]
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
  cp_async_commit();
  if (n_kt > 0) {
    load_tile(sK, kb, 0, Lk);
    load_tile(sV, vb, 0, Lk);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // this lane's rows of the C fragments: q0 + warp*16 + lane/4 (+ 8)
  const int gq = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;
  uint32_t qa[QREG ? KD : 1][4];  // Q's A fragments (QREG: the whole loop)
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
    if (kt + 1 < n_kt) {
      load_tile(sK + (st ^ 1) * BK * RS, kb, (kt + 1) * BK, Lk);
      load_tile(sV + (st ^ 1) * BK * RS, vb, (kt + 1) * BK, Lk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const __nv_bfloat16* cK = sK + st * BK * RS;
    const __nv_bfloat16* cV = sV + st * BK * RS;

    // S = Q K^T for this warp's 16 rows, 16 d at a step
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
        ldsm_x4(bk, cK + (16 * j + lane % 8 + (lane / 16) * 8) * RS +
                        kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16_16816(s[2 * j], a, bk[0], bk[1]);
        mma_bf16_16816(s[2 * j + 1], a, bk[2], bk[3]);
      }
    }

    // masks only where the tile straddles the diagonal or Lk; then p in s
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Lk ||
                      (causal && kv_offset + k0 + BK - 1 > q_offset + q0 + wr);
    online_softmax_tile(s, acc, m, l, scale2, edge, k0, Lk, causal, kv_offset,
                        (long)q_offset + q0 + wr, NEG_INF);

    // acc += bf16(p) . V, 16 keys at a step; p repacked as the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) {  // d n-tiles 2j, 2j+1
        uint32_t bv[4];
        ldsm_x4_trans(bv, cV + (kk * 16 + lane % 16) * RS + 16 * j +
                              (lane / 16) * 8);
        mma_bf16_16816(acc[2 * j], a, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * j + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // all warps are done with this stage before its refill
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
    if (tq == 0)  // a row with no live key: NEG_INF, as the plain version
      lse[(long)bh * Lq + row] =
          (m[r] <= 0.5f * NEG_INF ? NEG_INF : m[r] * scale) + logf(lr);
  }
}

template <int D, bool PAD, bool ANY>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int H, int d, int Lq, int Lk, int causal,
               int q_offset, int kv_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_mma<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_mma<D, PAD, ANY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  flash_fwd_kernel_mma<D, PAD, ANY><<<grid, NTM, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, d, Lq, Lk, causal, q_offset, kv_offset,
      scale);
  return (int)cudaGetLastError();
}

// ---- the wide path (head_dim.cuh: d above 256) -----------------------------
//
// A block owns output columns c0 .. c0 + WDC - 1 (c0 = WDC * blockIdx.z) of
// its 64 q rows. Per k/v tile, S = Q K^T is summed over d in WDS-column
// slices of Q and K streamed through shared memory, in the same order in
// every chunk, so every chunk computes the same S, softmax and lse (chunk
// 0 writes lse); then acc += p . V[:, chunk]. Neither registers nor shared
// memory grow with d; the S work is ceil(d / WDC) x the narrow kernels'.

constexpr int WDS = 64;   // d columns a slice of S
constexpr int WDC = 128;  // output columns a block

constexpr size_t smem_floats_wide() {
  return (size_t)BQ * (WDS + 1)    // Q slice
         + (size_t)BK * (WDS + 1)  // K slice
         + (size_t)BK * (WDC + 1)  // V chunk
         + (size_t)BQ * (BK + 1)   // scores, then p
         + 3 * (size_t)BQ;         // running max, running sum, rescale
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_fwd_kernel_wide(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int H, int dh, int Lq,
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
  const T* kb = k + (long)b * Lk * rs + (long)h * dh;
  const T* vb = v + (long)b * Lk * rs + (long)h * dh;

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
        sK[r * DP + c] = (k0 + r < Lk && in)
                             ? to_f<T>(kb[(long)(k0 + r) * rs + d0 + c])
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

    // V's chunk, while four threads per row take the row stats
    for (int i = tid; i < BK * WDC; i += NT) {
      const int r = i / WDC, c = i % WDC;
      sV[r * CP + c] = (k0 + r < Lk && c0 + c < dh)
                           ? to_f<T>(vb[(long)(k0 + r) * rs + c0 + c])
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
    const float inv = 1.f / fmaxf(sL[r], 1e-30f);
    T* orow = out + ((long)b * Lq + q0 + r) * rs + (long)h * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (c0 + tx + 16 * j < dh)
        orow[c0 + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
  if (blockIdx.z == 0)
    for (int r = tid; r < BQ; r += NT)
      if (q0 + r < Lq)
        lse[(long)bh * Lq + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int H, int d, int Lq, int Lk, int causal,
                int q_offset, int kv_offset, float scale,
                cudaStream_t stream) {
  const size_t smem = smem_floats_wide() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H, (d + WDC - 1) / WDC);
  flash_fwd_kernel_wide<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, d, Lq, Lk, causal, q_offset, kv_offset,
      scale);
  return (int)cudaGetLastError();
}

// bf16 on the tensor cores: 4 warps of 16 q rows. A k/v tile is taken as
// units, one a WDS-column slice of Q and of K, streamed through a 2-stage
// cp.async ring (the next unit's copies, the next tile's first slice
// included, are in flight while this one's products run); V's chunk of
// each tile goes with the tile's first unit into a 2-stage ring of its
// own. S stays in registers over the slices; the online softmax and
// acc += p . V[:, chunk] then run as in the narrow kernel. 71,680 bytes
// of shared memory at any d.

constexpr int WRS = WDS + 8;  // padded slice row stride (elements)
constexpr int WRC = WDC + 8;  // padded chunk row stride (elements)

constexpr size_t smem_bytes_wide_mma() {
  return ((size_t)2 * (BQ + BK) * WRS + (size_t)2 * BK * WRC) *
         sizeof(__nv_bfloat16);
}

template <bool ANY>
__global__ void __launch_bounds__(NTM, 2) flash_fwd_kernel_wide_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int H, int dh, int Lq, int Lk, int causal,
    int q_offset, int kv_offset, float scale) {
  constexpr int NB = BK / 8;   // key n-tiles of S
  constexpr int ND = WDC / 8;  // d n-tiles of the output chunk
  extern __shared__ float smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BQ*WRS]
  __nv_bfloat16* sK = sQ + 2 * BQ * WRS;                        // [2][BK*WRS]
  __nv_bfloat16* sV = sK + 2 * BK * WRS;                        // [2][BK*WRC]

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
  // tile's first slice its V chunk
  auto issue = [&](int u) {
    const int kt = u / ns, d0 = (u % ns) * WDS, st = u & 1;
    cp_async_cols<64, WDS, WRS, NTM, ANY>(sQ + st * BQ * WRS, qb, rs, q0, Lq,
                                          d0, dh, tid);
    cp_async_cols<64, WDS, WRS, NTM, ANY>(sK + st * BK * WRS, kb, rs,
                                          kt * BK, Lk, d0, dh, tid);
    if (d0 == 0)
      cp_async_cols<64, WDC, WRC, NTM, ANY>(sV + (kt & 1) * BK * WRC, vb, rs,
                                            kt * BK, Lk, c0, dh, tid);
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
      warp_mma_abt<NB, WDS / 16, WRS>(s, sQ + st * BQ * WRS + wr * WRS,
                                      sK + st * BK * WRS);
      __syncthreads();  // every warp is done with stage st before its refill
    }
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Lk ||
                      (causal && kv_offset + k0 + BK - 1 > q_offset + q0 + wr);
    online_softmax_tile(s, acc, m, l, scale2, edge, k0, Lk, causal, kv_offset,
                        (long)q_offset + q0 + wr, NEG_INF);
    warp_mma_pv<BK / 16, ND, WRC>(acc, s, sV + (kt & 1) * BK * WRC);
    __syncthreads();  // every warp is done with this V chunk
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
    if (tq == 0 && blockIdx.z == 0)
      lse[(long)bh * Lq + row] =
          (m[r] <= 0.5f * NEG_INF ? NEG_INF : m[r] * scale) + logf(lr);
  }
}

template <bool ANY>
int launch_wide_mma(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int H, int d, int Lq, int Lk,
                    int causal, int q_offset, int kv_offset, float scale,
                    cudaStream_t stream) {
  const size_t smem = smem_bytes_wide_mma();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_wide_mma<ANY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Lq + BQ - 1) / BQ, (d + WDC - 1) / WDC);
  flash_fwd_kernel_wide_mma<ANY><<<grid, NTM, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, d, Lq, Lk, causal, q_offset, kv_offset,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t
// (0 = launched); -1 for a dtype this build has no instance for or a head
// dim D below 1 (head_dim.cuh). A bf16 tensor of any alignment runs (a
// misaligned one on the general instance or the wide path's ANY one).
extern "C" int tdt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int H, int Lq,
                             int Lk, int D, int causal, int q_offset,
                             int kv_offset, float scale, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return with_head_dim(D, true, true, [&](auto hd) {
      using HD = decltype(hd);
      return launch<float, HD::value, HD::pad>(
          q, k, v, out, lse, B, H, D, Lq, Lk, causal, q_offset, kv_offset,
          scale, s);
    }, [&](auto) {
      return launch_wide<float>(q, k, v, out, lse, B, H, D, Lq, Lk, causal,
                                q_offset, kv_offset, scale, s);
    });
  if (dtype == 1)
    return with_head_dim(D, tdt_aligned16(q, k, v, out), D % 8 == 0,
                         [&](auto hd) {
      using HD = decltype(hd);
      return launch_mma<HD::value, HD::pad, HD::any>(
          q, k, v, out, lse, B, H, D, Lq, Lk, causal, q_offset, kv_offset,
          scale, s);
    }, [&](auto wd) {
      return launch_wide_mma<decltype(wd)::any>(
          q, k, v, out, lse, B, H, D, Lq, Lk, causal, q_offset, kv_offset,
          scale, s);
    });
  return -1;
}
