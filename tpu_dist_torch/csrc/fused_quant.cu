// Fused int8 matmul for Hopper (sm_90a): quantize -> int8 dot -> dequant.
// Kernel 6 of the port.
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
// exact in any order (the caller keeps K <= (2^31 - 1) / 127^2), so the
// result is bit-equal to the plain version.
//
// Bound on an H100 SXM: bytes at a decode tick's M = 8 (16 int8 operations
// per weight byte, far below the 1979 TOP/s : 3.35 TB/s ridge); a
// prefill's M = 1024 sits near the ridge.
//
// Design. The TPU kernel re-quantizes w per tile because K is whole in
// VMEM; here each operand is quantized once, into a workspace the wrapper
// allocates (tdt_fused_quant_workspace), and the product runs on the int8
// tensor cores (mma.sync m16n8k32, csrc/warp_mma.cuh). One call is a memset
// and two launches (M <= 16) or three (M > 16) on the caller's stream:
//   1. fq_scales_kernel: one block per row of x takes its amax, writes sx and
//      the row's int8 values (qx, K padded to KP, a multiple of 128, with
//      zeros); the other blocks take a column strip of w over a slice of K
//      (coalesced: a warp reads consecutive columns of one row, 16 bytes a
//      lane) and combine their column maxima with atomicMax on the bits of
//      a non-negative float, which is order-free. At least 4 blocks an SM.
//   2a. M <= 16 (decode): fq_decode_kernel, split-K. w is the A operand (16
//      columns a warp) and qx the B operand (8 rows an n-tile), so M <= 8
//      pads nothing. Each block takes 64 columns and a range of 128-deep K
//      stages through a ring of two raw w tiles filled by cp.async, so the
//      next stage's loads are in flight while it quantizes one into the
//      int8 tile (w crosses HBM twice in all: here and in stage 1); qx's
//      fragments come from the workspace (L2). K is split until about two
//      blocks an SM run, or every stage is a split of its own. With one
//      split the block dequantizes; else each split writes its int32 sums
//      and counts itself done (atomicAdd), and the last of a column tile
//      adds the splits' sums in split order and dequantizes.
//   2b. M > 16 (prefill, training): fq_quant_w_kernel quantizes w once into
//      qw (N, KP), transposed so k is contiguous; fq_gemm_kernel is a plain
//      int8 GEMM over qx and qw (a ring of two cp.async stages of 128 k)
//      with the dequant in its epilogue. Its tile is the plan's quant_block
//      (bm, bn, bk): a (bm, bn) output tile, 8 warps of 64 x (bm bn / 512),
//      instantiated for the tiles in TDT_FQ_TILES (128 x 128, the default,
//      two blocks an SM; 256 x 128 and 128 x 256, 98,304 bytes of shared
//      memory, one; 64 x 256). Every other tile the plan IR accepts (bm a
//      multiple of 8, bn of 128) runs on fq_gemm_any_kernel, the tile a
//      run-time parameter: a block owns its (bm, bn) output tile and walks
//      it in 64 x 128 sub-tiles of the compiled 64 x 128 warp grid, each
//      over the whole of its K range, rows and columns past the tile
//      masked (inside an m16 fragment where bm is not a multiple of 16).
//      bk = 0 keeps the whole of K in one block (the instance without
//      SPLIT: at 128 x 128, the kernel before the knob); bk > 0 splits K
//      over ceil(K / bk) blocks (grid z, the SPLIT instance) that write
//      their int32 sums to the workspace, and fq_split_sum_kernel adds
//      them in split order and dequantizes once: integer sums are exact,
//      so every tile is bit-equal to the default. A tile the IR refuses
//      returns -2.
// The same two phases are also exposed apart, for a product whose K is
// sharded over a tensor-parallel group and whose scales must be the whole
// K's: tdt_fused_quant_amax runs stage 1's maxima only (each row's amax of
// x, each column's of w), the caller takes their max over the group, and
// tdt_fused_quant_scaled runs stage 1 (x quantized by the given row maxima,
// no w strips) and stage 2 with the given column maxima. With the local
// maxima the pair computes exactly what tdt_fused_quant does.
// Shared-memory int8 tiles are [rows][128] and swizzled (swz_off): the 8
// rows that one ldmatrix phase reads, and the 8 rows that one packed store
// of the w tile writes, fall in 8 distinct 16-byte chunks, all 32 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr float EPS = 1e-8f;
constexpr float QMAX = 127.0f;
constexpr int KT = 128;            // k per stage: one 128-byte row of int8
constexpr int WN = 64;             // columns of a quantized w tile
constexpr int SMALL_M = 16;        // at or below: the split-K decode kernel
constexpr int SCALE_NT = 256;      // scales kernel: 8 warps
constexpr int QW_NT = 256;         // w-quantize kernel
constexpr int DEC_NT = 2 * WN;     // decode kernel: a warp per 16 columns
constexpr int GEMM_NT = 256;       // GEMM: 8 warps, each 64 rows
constexpr int STAGES = 2;          // cp.async ring of the GEMM
constexpr int SUM_NT = 256;        // split-sum kernel

// the GEMM's (bm, bn) output tiles, as the plan's quant_block names them
#define TDT_FQ_TILES(X) X(128, 128) X(256, 128) X(128, 256) X(64, 256)

// a (BM, BN) tile's warp grid: BM / 64 (m) x the rest (n), each warp 64 x
// WTN; its shared memory; and the blocks an SM its registers allow
template <int BM, int BN>
struct GemmTile {
  static constexpr int WARPS_M = BM / 64;
  static constexpr int WARPS_N = GEMM_NT / 32 / WARPS_M;
  static constexpr int WTN = BN / WARPS_N;          // a warp's columns
  static constexpr int JN = WTN / 8;                // its 8-column n-tiles
  static constexpr int SMEM = STAGES * (BM + BN) * KT;
  static constexpr int MIN_BLOCKS = JN <= 4 ? 2 : 1;
  static_assert(BM % 64 == 0 && WARPS_M * WARPS_N * 32 == GEMM_NT &&
                    WTN * WARPS_N == BN && JN % 2 == 0,
                "GEMM tile and warps do not match");
};

struct alignas(16) Chunk { uint32_t v[4]; };   // 16 bytes
template <typename T> struct alignas(2 * sizeof(T)) Two { T v[2]; };

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

// q = clamp(rint(v / s), -127, 127) with v / s the IEEE quotient and
// rint's half-to-even, as the low byte of the word returned. The scales keep
// |v / s| <= 127 (1 + 2^-24), so rint lies in [-127, 127] and the clamp
// changes nothing. rint: adding 1.5 x 2^23 leaves no fraction bits, the
// addition rounds half to even, and the low byte of the sum's bits is then
// rint as an int8 (two's complement, 2^22 being a multiple of 256). The
// quotient: y = v r with r = 1 / s lies within 2.3e-5 of it (two roundings
// of 2^-24 relative and the quotient's own; 1.5e-5 if the compiler fuses
// v r into the addition), so where y sits 1e-4 or more from a
// half-integer both round to the same integer. Nearer (about 2 in 10^4
// values) the division decides: the reciprocal alone is one step off for
// about 2 in 10^6.
constexpr float MAGIC = 12582912.0f;   // 1.5 x 2^23
__device__ __forceinline__ uint32_t quant1(float v, float s, float r) {
  const float y = v * r;
  float t = y + MAGIC;
  if (fabsf(y - (t - MAGIC)) > 0.5f - 1e-4f) t = v / s + MAGIC;
  return __float_as_uint(t);
}

// the low bytes of four words, lowest first
__device__ __forceinline__ uint32_t pack4(uint32_t q0, uint32_t q1,
                                          uint32_t q2, uint32_t q3) {
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040),
                     0x5410);
}

// a column's scale from its amax's bits (stage 1's atomicMax)
__device__ __forceinline__ float w_scale(uint32_t amax_bits) {
  return fmaxf(__uint_as_float(amax_bits), EPS) / QMAX;
}

// byte offset of 16-byte chunk c of row r in a swizzled [rows][128] tile
__device__ __forceinline__ int swz_off(int r, int c) {
  return r * KT + ((c ^ ((r ^ (r >> 3)) & 7)) << 4);
}

// row[n .. n + 16 / sizeof(T)) as 16 bytes, zeros past N: one 16-byte load
// when every row starts on a 16-byte boundary and the chunk is whole
template <typename T>
__device__ __forceinline__ Chunk load_chunk(const T* row, int n, int N,
                                            bool aligned) {
  constexpr int E = 16 / sizeof(T);
  if (aligned && n + E <= N) return *reinterpret_cast<const Chunk*>(row + n);
  Chunk u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < E; ++j) e[j] = n + j < N ? row[n + j] : from_f<T>(0.f);
  return u;
}

// v[0 .. 16) = row[k .. k + 16) as floats, zeros past K
template <typename T>
__device__ __forceinline__ void load16(const T* row, int k, int K,
                                       bool aligned, float v[16]) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < 16 / E; ++c) {
    const Chunk u = load_chunk(row, k + c * E, K, aligned);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < E; ++j) v[c * E + j] = to_f<T>(e[j]);
  }
}

template <typename T>
__device__ __forceinline__ bool rows_aligned(const T* p, int row_len) {
  return (uintptr_t)p % 16 == 0 && ((long)row_len * sizeof(T)) % 16 == 0;
}

// A KT x WN tile of w (rows k0 .., columns n0 ..) quantized by its column
// scales into a swizzled [WN][KT] int8 tile (n rows, k contiguous). Unit u
// of a thread: E columns at n0 + E (u % G) and four rows at k0 + 4 (u / G),
// four 16-byte loads whose quantized values pack column by column into one
// word of four k. A thread's columns are the same in every unit and stage,
// so it keeps their scales in registers (sc).
template <typename T, int NT>
struct WTile {
  static constexpr int E = 16 / sizeof(T);        // columns a load
  static constexpr int G = WN / E;                // column groups
  static constexpr int U = G * (KT / 4) / NT;     // units a thread
  static_assert(NT % G == 0 && U >= 1, "tile and threads do not match");
  Chunk r[U][4];
  float sc[E], rc[E];                             // scales, reciprocals

  __device__ __forceinline__ void scales(const uint32_t* sw_amax, int n0,
                                         int N) {
#pragma unroll
    for (int c = 0; c < E; ++c) {
      const int n = n0 + E * (threadIdx.x % G) + c;
      sc[c] = n < N ? w_scale(sw_amax[n]) : 1.f;   // padding: zeros / 1
      rc[c] = 1.f / sc[c];
    }
  }

  __device__ __forceinline__ void load(const T* w, int k0, int K, int n0,
                                       int N, bool aligned) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = threadIdx.x + u * NT;
      const int n = n0 + E * (i % G), k = k0 + 4 * (i / G);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[u][j] = k + j < K ? load_chunk(w + (long)(k + j) * N, n, N, aligned)
                            : Chunk{};
    }
  }

  // the same units from a raw [KT][WN] tile of T in shared memory
  __device__ __forceinline__ void gather(const T* raw) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = threadIdx.x + u * NT;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[u][j] = *reinterpret_cast<const Chunk*>(
            raw + (4 * (i / G) + j) * WN + E * (i % G));
    }
  }

  // a warp's stores for one column c meet the 8 rows c + E g (g = 0..7)
  // at one chunk: 8 distinct swizzled chunks (bf16)
  __device__ __forceinline__ void store(int8_t* tile) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = threadIdx.x + u * NT;
      const int c0 = E * (i % G), kq = i / G;
#pragma unroll
      for (int c = 0; c < E; ++c) {
        uint32_t q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          q[j] = quant1(to_f<T>(reinterpret_cast<const T*>(&r[u][j])[c]),
                        sc[c], rc[c]);
        *reinterpret_cast<uint32_t*>(tile + swz_off(c0 + c, kq / 4) +
                                     4 * (kq % 4)) =
            pack4(q[0], q[1], q[2], q[3]);
      }
    }
  }
};

// Stage 1 (header). Blocks [0, xb = M): a row of x each; the rest: column
// strip b % ctiles of w over rows [(b / ctiles) rb, + rb). A row block takes
// its amax from x_amax_in where given; with x_amax_out it writes the amax
// there and stops (tdt_fused_quant_amax).
template <typename T>
__global__ void __launch_bounds__(SCALE_NT) fq_scales_kernel(
    const T* __restrict__ x, const T* __restrict__ w, int M, int K, int N,
    int KP, int xb, int ctiles, int rb, float* __restrict__ sx,
    int8_t* __restrict__ qx, uint32_t* __restrict__ sw_amax,
    const float* __restrict__ x_amax_in, float* __restrict__ x_amax_out) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CW = 32 * E;                 // columns a strip
  constexpr int NW = SCALE_NT / 32;
  __shared__ float red[NW][CW];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if ((int)blockIdx.x < xb) {               // row m = blockIdx.x of x
    const int m = blockIdx.x;
    const T* row = x + (long)m * K;
    const bool al = rows_aligned(x, K);
    float v[16], mx = 0.f;
    if (x_amax_in) {
      mx = x_amax_in[m];
    } else {
      for (int k = 16 * threadIdx.x; k < K; k += 16 * SCALE_NT) {
        load16(row, k, K, al, v);
#pragma unroll
        for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fabsf(v[j]));
      }
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) red[0][warp] = mx;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NW; ++i) mx = fmaxf(mx, red[0][i]);
    }
    if (x_amax_out) {
      if (threadIdx.x == 0) x_amax_out[m] = mx;
      return;
    }
    const float s = fmaxf(mx, EPS) / QMAX, r = 1.f / s;
    if (threadIdx.x == 0) sx[m] = s;
    for (int k = 16 * threadIdx.x; k < KP; k += 16 * SCALE_NT) {  // 0 past K
      load16(row, k, K, al, v);
      Chunk q;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        q.v[c] = pack4(quant1(v[4 * c], s, r), quant1(v[4 * c + 1], s, r),
                       quant1(v[4 * c + 2], s, r), quant1(v[4 * c + 3], s, r));
      *reinterpret_cast<Chunk*>(qx + (long)m * KP + k) = q;
    }
    return;
  }
  const int b = blockIdx.x - xb;
  const int n0 = (b % ctiles) * CW;
  const int k0 = (b / ctiles) * rb, k1 = min(K, k0 + rb);
  const bool al = rows_aligned(w, N);
  float mx[E];
#pragma unroll
  for (int j = 0; j < E; ++j) mx[j] = 0.f;
#pragma unroll 4
  for (int k = k0 + warp; k < k1; k += NW) {
    const Chunk u = load_chunk(w + (long)k * N, n0 + E * lane, N, al);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < E; ++j) mx[j] = fmaxf(mx[j], fabsf(to_f<T>(e[j])));
  }
#pragma unroll
  for (int j = 0; j < E; ++j) red[warp][E * lane + j] = mx[j];
  __syncthreads();
  if ((int)threadIdx.x < CW && n0 + (int)threadIdx.x < N) {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) m = fmaxf(m, red[i][threadIdx.x]);
    atomicMax(sw_amax + n0 + threadIdx.x, __float_as_uint(m));
  }
}

// Rows k0 .. k0 + KT (zeros past K) and columns n0 .. n0 + WN (zeros past
// N) of w into a raw [KT][WN] tile of T: 16-byte cp.async copies where the
// rows are aligned and the chunk is whole, plain loads and stores at a
// ragged edge
template <typename T, int NT>
__device__ __forceinline__ void fill_raw(T* raw, const T* w, int k0, int K,
                                         int n0, int N, bool aligned) {
  constexpr int E = 16 / sizeof(T), CPR = WN / E;   // chunks a row
  for (int i = threadIdx.x; i < KT * CPR; i += NT) {
    const int k = k0 + i / CPR, n = n0 + E * (i % CPR);
    T* dst = raw + (i / CPR) * WN + E * (i % CPR);
    if (aligned && n + E <= N)
      cp_async_16(dst, k < K ? w + (long)k * N + n : w, k < K ? 16 : 0);
    else
      *reinterpret_cast<Chunk*>(dst) =
          k < K ? load_chunk(w + (long)k * N, n, N, aligned) : Chunk{};
  }
}

constexpr int DEC_STAGES = 2;      // cp.async ring of raw w tiles
template <typename T>
constexpr int dec_smem() {         // the ring, then the int8 tile
  return DEC_STAGES * KT * WN * (int)sizeof(T) + WN * KT;
}

// Stage 2a (header): grid (column tiles of WN, K splits of sps stages).
// part == nullptr: one split, write out. Else each split writes its int32
// sums to part and counts itself in count[tile]; the last to arrive adds
// the splits' sums in split order and writes out.
template <typename T, int MT>
__global__ void __launch_bounds__(DEC_NT) fq_decode_kernel(
    const T* __restrict__ w, const int8_t* __restrict__ qx,
    const float* __restrict__ sx, const uint32_t* __restrict__ sw_amax,
    T* __restrict__ out, int* __restrict__ part, int* __restrict__ count,
    int M, int K, int N, int KP, int sps) {
  extern __shared__ float smem[];
  T* raw = reinterpret_cast<T*>(smem);                      // [3][KT][WN]
  int8_t* tile = reinterpret_cast<int8_t*>(raw + DEC_STAGES * KT * WN);
  __shared__ int last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * WN;
  const int s0 = blockIdx.y * sps, s1 = min(KP / KT, s0 + sps);
  const bool al = rows_aligned(w, N);
  for (int i = 0; i < DEC_STAGES - 1; ++i) {
    if (s0 + i < s1)
      fill_raw<T, DEC_NT>(raw + i * KT * WN, w, (s0 + i) * KT, K, n0, N, al);
    cp_async_commit();
  }
  WTile<T, DEC_NT> wt;
  wt.scales(sw_amax, n0, N);
  int acc[MT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  // this lane's A rows (w columns) for ldmatrix: matrices 0..3 = rows
  // 0-7 / 8-15 at k 0-15, then at k 16-31
  const int ar = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int ac = lane >> 4;
  for (int s = s0; s < s1; ++s) {
    uint32_t b[MT][4][2];          // qx: k 4t.. and 4t+16.., row 8j + g
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int m = 8 * j + g;
      const int8_t* q = qx + (long)m * KP + s * KT + 4 * t;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          b[j][ks][h] = m < M ? *reinterpret_cast<const uint32_t*>(
                                    q + 32 * ks + 16 * h)
                              : 0u;
    }
    cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();      // stage s landed; stage s - 1's reads all done
    const int f = s + DEC_STAGES - 1;        // into stage s - 1's buffer
    if (f < s1)
      fill_raw<T, DEC_NT>(raw + ((f - s0) % DEC_STAGES) * KT * WN, w, f * KT,
                          K, n0, N, al);
    cp_async_commit();
    wt.gather(raw + ((s - s0) % DEC_STAGES) * KT * WN);
    wt.store(tile);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, tile + swz_off(ar, 2 * ks + ac));
#pragma unroll
      for (int j = 0; j < MT; ++j)
        mma_s8_16832(acc[j], a, b[j][ks][0], b[j][ks][1]);
    }
  }
  // C (16 columns x 8 rows an n-tile): (column g (+8), rows 2t, 2t+1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + 16 * warp + g + 8 * h;
    if (n >= N) continue;
    const float swn = part ? 0.f : w_scale(sw_amax[n]);
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * j + 2 * t + e;
        if (m >= M) continue;
        const int a = acc[j][2 * h + e];
        if (part)
          part[((long)blockIdx.y * M + m) * N + n] = a;
        else
          out[(long)m * N + n] = from_f<T>(__int2float_rn(a) * (sx[m] * swn));
      }
  }
  if (!part) return;
  __threadfence();                 // this split's sums, then its count
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(count + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < M * WN; i += DEC_NT) {
    const int m = i / WN, n = n0 + i % WN;
    if (n >= N) continue;
    int sum = 0;
#pragma unroll 8
    for (int sp = 0; sp < (int)gridDim.y; ++sp)   // split order
      sum += __ldcg(part + ((long)sp * M + m) * N + n);
    out[(long)m * N + n] =
        from_f<T>(__int2float_rn(sum) * (sx[m] * w_scale(sw_amax[n])));
  }
}

// Stage 2b (header), first half: qw (N, KP) int8, zeros past K. Grid
// (column tiles of WN, stages of KT).
template <typename T>
__global__ void __launch_bounds__(QW_NT) fq_quant_w_kernel(
    const T* __restrict__ w, int K, int N, int KP,
    const uint32_t* __restrict__ sw_amax, int8_t* __restrict__ qw) {
  __shared__ Chunk tile_mem[WN * KT / 16];
  int8_t* tile = reinterpret_cast<int8_t*>(tile_mem);
  const int n0 = blockIdx.x * WN, k0 = blockIdx.y * KT;
  WTile<T, QW_NT> wt;
  wt.scales(sw_amax, n0, N);
  wt.load(w, k0, K, n0, N, rows_aligned(w, N));
  wt.store(tile);
  __syncthreads();
  for (int i = threadIdx.x; i < WN * KT / 16; i += QW_NT) {
    const int r = i / (KT / 16), c = i % (KT / 16);
    if (n0 + r < N)
      *reinterpret_cast<Chunk*>(qw + (long)(n0 + r) * KP + k0 + 16 * c) =
          *reinterpret_cast<const Chunk*>(tile + swz_off(r, c));
  }
}

// ROWS rows (r0 .., zeros past L) of KT bytes at stage s of a (L, KP) int8
// matrix into a swizzled tile, as 16-byte cp.async copies
template <int ROWS, int NT>
__device__ __forceinline__ void fill_tile(int8_t* tile, const int8_t* src,
                                          int KP, int r0, int L, int s) {
  for (int i = threadIdx.x; i < ROWS * KT / 16; i += NT) {
    const int r = i / (KT / 16), c = i % (KT / 16);
    const bool in = r0 + r < L;
    cp_async_16(tile + swz_off(r, c),
                src + (long)(in ? r0 + r : 0) * KP + s * KT + 16 * c,
                in ? 16 : 0);
  }
}

// Stage 2b, second half: out = dequant(qx . qw^T) over the (BM, BN) tile
// at (m0, n0), of a block's 8 warps: rows at or past mlim and columns at or
// past nlim are outside it (zeros in, nothing out). Without SPLIT: the
// whole of K, dequantized into out (part and sps unused). With SPLIT:
// split blockIdx.z's stages, its int32 sums written to part[blockIdx.z] for
// fq_split_sum_kernel. M and N are out's (and part's) row count and stride.
template <typename T, int BM, int BN, bool SPLIT>
__device__ __forceinline__ void gemm_tile(
    const int8_t* __restrict__ qx, const int8_t* __restrict__ qw,
    const float* __restrict__ sx, const uint32_t* __restrict__ sw_amax,
    T* __restrict__ out, int* __restrict__ part, int M, int N, int KP,
    int sps, int m0, int n0, int mlim, int nlim, int8_t* sa) {
  typedef GemmTile<BM, BN> G;
  constexpr int JN = G::JN;
  int8_t* sb = sa + STAGES * BM * KT;              // [STAGES][BN][KT]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % G::WARPS_M, wn = warp / G::WARPS_M;
  const int s0 = SPLIT ? blockIdx.z * sps : 0;
  const int s1 = SPLIT ? min(KP / KT, s0 + sps) : KP / KT;
  int acc[4][JN][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  // ldmatrix rows: A matrices rows 0-7 / 8-15 at k 0-15, then k 16-31; B
  // matrices n 0-7 at k 0-15 / 16-31, then n 8-15
  const int ar = 64 * wm + (lane & 7) + 8 * ((lane >> 3) & 1), ac = lane >> 4;
  const int br = G::WTN * wn + (lane & 7) + 8 * (lane >> 4);
  const int bc = (lane >> 3) & 1;
  // ring of STAGES buffers, one commit group a stage (empty past the end),
  // so waiting for all but the newest group lands stage s
  for (int i = 0; i < STAGES - 1; ++i) {
    if (s0 + i < s1) {
      fill_tile<BM, GEMM_NT>(sa + i * BM * KT, qx, KP, m0, mlim, s0 + i);
      fill_tile<BN, GEMM_NT>(sb + i * BN * KT, qw, KP, n0, nlim, s0 + i);
    }
    cp_async_commit();
  }
  for (int s = s0; s < s1; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();          // stage s landed; stage s - 1's reads done
    const int f = s + STAGES - 1;              // into stage s - 1's buffer
    if (f < s1) {
      const int fb = (f - s0) % STAGES;
      fill_tile<BM, GEMM_NT>(sa + fb * BM * KT, qx, KP, m0, mlim, f);
      fill_tile<BN, GEMM_NT>(sb + fb * BN * KT, qw, KP, n0, nlim, f);
    }
    cp_async_commit();
    const int8_t* at = sa + ((s - s0) % STAGES) * BM * KT;
    const int8_t* bt = sb + ((s - s0) % STAGES) * BN * KT;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4][4], b[JN][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(a[i], at + swz_off(ar + 16 * i, 2 * ks + ac));
#pragma unroll
      for (int jj = 0; jj < JN / 2; ++jj) {
        uint32_t r[4];
        ldsm_x4(r, bt + swz_off(br + 16 * jj, 2 * ks + bc));
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j)
          mma_s8_16832(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  // C (16 x 8 a tile): (row g (+8), columns 2t, 2t+1), stored as a pair
  // where every row starts on the pair's boundary (N even)
  const bool pairs = N % 2 == 0;
  if constexpr (SPLIT) {
    int* prow0 = part + (long)blockIdx.z * M * N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * wm + 16 * i + g + 8 * h;
        if (m >= mlim) continue;
        int* prow = prow0 + (long)m * N;
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          const int n = n0 + G::WTN * wn + 8 * j + 2 * t;   // even
          if (pairs && n + 1 < nlim) {
            *reinterpret_cast<int2*>(prow + n) =
                make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (n + e < nlim) prow[n + e] = acc[i][j][2 * h + e];
          }
        }
      }
    return;
  }
  float swc[JN][2];
#pragma unroll
  for (int j = 0; j < JN; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + G::WTN * wn + 8 * j + 2 * t + e;
      swc[j][e] = n < nlim ? w_scale(sw_amax[n]) : 0.f;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wm + 16 * i + g + 8 * h;
      if (m >= mlim) continue;
      const float sxm = sx[m];
      T* orow = out + (long)m * N;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int n = n0 + G::WTN * wn + 8 * j + 2 * t;   // even
        Two<T> o;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o.v[e] = from_f<T>(__int2float_rn(acc[i][j][2 * h + e]) *
                             (sxm * swc[j][e]));
        if (pairs && n + 1 < nlim)
          *reinterpret_cast<Two<T>*>(orow + n) = o;
        else
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < nlim) orow[n + e] = o.v[e];
      }
    }
}


// Stage 2b's GEMM at an instantiated tile: grid (row tiles of BM, column
// tiles of BN, K splits of sps stages), neighbouring blocks sharing one qw
// tile
template <typename T, int BM, int BN, bool SPLIT>
__global__ void __launch_bounds__(GEMM_NT, (GemmTile<BM, BN>::MIN_BLOCKS))
    fq_gemm_kernel(const int8_t* __restrict__ qx,
                   const int8_t* __restrict__ qw, const float* __restrict__ sx,
                   const uint32_t* __restrict__ sw_amax, T* __restrict__ out,
                   int* __restrict__ part, int M, int N, int KP, int sps) {
  extern __shared__ float smem[];
  gemm_tile<T, BM, BN, SPLIT>(qx, qw, sx, sw_amax, out, part, M, N, KP, sps,
                              blockIdx.x * BM, blockIdx.y * BN, M, N,
                              reinterpret_cast<int8_t*>(smem));
}

// Stage 2b's GEMM at any other tile the plan IR accepts (bm a multiple of
// 8, bn of 128; the tile a run-time parameter): a block owns its (bm, bn)
// output tile (grid as above) and walks it in GB_M x GB_N sub-tiles of a
// compiled warp grid, each over the whole of its K range; rows and columns
// past the block's tile (or past M, N) are masked, inside an m16 fragment
// too where bm is not a multiple of 16. The int32 sums are exact, so every
// tile is bit-equal to the default.
constexpr int GB_M = 64, GB_N = 128;

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(GEMM_NT, (GemmTile<GB_M, GB_N>::MIN_BLOCKS))
    fq_gemm_any_kernel(const int8_t* __restrict__ qx,
                       const int8_t* __restrict__ qw,
                       const float* __restrict__ sx,
                       const uint32_t* __restrict__ sw_amax,
                       T* __restrict__ out, int* __restrict__ part, int M,
                       int N, int KP, int sps, int bm, int bn) {
  extern __shared__ float smem[];
  const int m0 = blockIdx.x * bm, n0 = blockIdx.y * bn;
  const int mlim = min(m0 + bm, M), nlim = min(n0 + bn, N);
  for (int sm = m0; sm < mlim; sm += GB_M)
    for (int sn = n0; sn < nlim; sn += GB_N) {
      __syncthreads();  // the previous sub-tile's reads of the ring are done
      gemm_tile<T, GB_M, GB_N, SPLIT>(qx, qw, sx, sw_amax, out, part, M, N,
                                      KP, sps, sm, sn, mlim, nlim,
                                      reinterpret_cast<int8_t*>(smem));
    }
}

// The K splits' int32 sums (part: splits x (M, N)) added in split order,
// then the GEMM epilogue's dequant: grid-stride over the M x N outputs
template <typename T>
__global__ void __launch_bounds__(SUM_NT) fq_split_sum_kernel(
    const int* __restrict__ part, const float* __restrict__ sx,
    const uint32_t* __restrict__ sw_amax, T* __restrict__ out, int M, int N,
    int splits) {
  const long long total = (long long)M * N;
  for (long long i = (long long)blockIdx.x * SUM_NT + threadIdx.x; i < total;
       i += (long long)gridDim.x * SUM_NT) {
    const int m = (int)(i / N), n = (int)(i % N);
    int sum = 0;
    for (int sp = 0; sp < splits; ++sp) sum += part[sp * total + i];
    out[i] = from_f<T>(__int2float_rn(sum) * (sx[m] * w_scale(sw_amax[n])));
  }
}

// ---- host ------------------------------------------------------------------

struct Plan {
  int KP, stages;
  bool small;                 // M <= SMALL_M: stage 2a, else 2b
  int splits, sps;            // K splits of sps stages (2a; 2b: bk)
  int xb, ctiles, rb, wb;     // stage 1: x blocks, w strips, rows, w blocks
  long long off_sw, off_count, off_sx, off_qx, off_qw, off_part, bytes;
};

long long align256(long long b) { return (b + 255) / 256 * 256; }

// the current device's SMs, which the launch plans fill
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != 0)
    return 132;                    // an H100's
  return sms;
}

// bk: the GEMM's K split (0: none; else a multiple of KT)
Plan make_plan(int M, int K, int N, int elem, int bk) {
  const int sms = sm_count();
  Plan p;
  p.KP = (K + KT - 1) / KT * KT;
  p.stages = p.KP / KT;
  p.small = M <= SMALL_M;
  p.splits = 1;
  p.sps = p.stages;
  if (p.small) {             // about 2 blocks an SM, no split left empty
    const int tiles = (N + WN - 1) / WN;
    const int want = (2 * sms + tiles - 1) / tiles;
    p.sps = p.stages / want > 1 ? p.stages / want : 1;
    p.splits = (p.stages + p.sps - 1) / p.sps;
  } else if (bk > 0 && bk / KT < p.stages) {   // ceil(K / bk) splits
    p.sps = bk / KT;
    p.splits = (p.stages + p.sps - 1) / p.sps;
  }
  p.xb = M;
  const int cw = 32 * (16 / elem);
  p.ctiles = (N + cw - 1) / cw;
  int ks = (4 * sms + p.ctiles - 1) / p.ctiles;   // at least 4 blocks an SM
  ks = ks < (K + 7) / 8 ? ks : (K + 7) / 8;       // at least 8 rows a block
  p.rb = ((K + ks - 1) / ks + 7) / 8 * 8;
  p.wb = p.ctiles * ((K + p.rb - 1) / p.rb);
  long long off = 0;
  p.off_sw = off;                  // zeroed: column maxima, split counts
  p.off_count = off + 4LL * N;
  off = align256(p.off_count + 4LL * ((N + WN - 1) / WN));
  p.off_sx = off;
  off = align256(off + 4LL * M);
  p.off_qx = off;
  off = align256(off + (long long)M * p.KP);
  p.off_qw = off;
  if (!p.small) off = align256(off + (long long)N * p.KP);
  p.off_part = off;
  if (p.splits > 1) off = align256(off + 4LL * p.splits * M * N);
  p.bytes = off;
  return p;
}

// tdt_fused_quant_amax: x's row maxima into x_amax (M floats) and w's
// column maxima into w_amax (N floats, as the bits atomicMax combines)
template <typename T>
int launch_amax(const T* x, const T* w, float* x_amax, uint32_t* w_amax,
                int M, int K, int N, cudaStream_t stream) {
  const Plan p = make_plan(M, K, N, (int)sizeof(T), 0);
  int err = (int)cudaMemsetAsync(w_amax, 0, 4 * (size_t)N, stream);
  if (err != 0) return err;
  fq_scales_kernel<T><<<p.xb + p.wb, SCALE_NT, 0, stream>>>(
      x, w, M, K, N, p.KP, p.xb, p.ctiles, p.rb, nullptr, nullptr, w_amax,
      nullptr, x_amax);
  return (int)cudaGetLastError();
}

// Stage 2b's product at the (BM, BN) tile: the GEMM, then the split sum
// where K is split
template <typename T, int BM, int BN>
int launch_gemm(const int8_t* qx, const int8_t* qw, const float* sx,
                const uint32_t* sw_amax, T* out, int* part, const Plan& p,
                int M, int N, cudaStream_t stream) {
  typedef GemmTile<BM, BN> G;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, p.splits);
  int err;
  if (p.splits == 1) {
    err = (int)cudaFuncSetAttribute(
        fq_gemm_kernel<T, BM, BN, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != 0) return err;
    fq_gemm_kernel<T, BM, BN, false><<<grid, GEMM_NT, G::SMEM, stream>>>(
        qx, qw, sx, sw_amax, out, nullptr, M, N, p.KP, p.sps);
    return (int)cudaGetLastError();
  }
  err = (int)cudaFuncSetAttribute(fq_gemm_kernel<T, BM, BN, true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  G::SMEM);
  if (err != 0) return err;
  fq_gemm_kernel<T, BM, BN, true><<<grid, GEMM_NT, G::SMEM, stream>>>(
      qx, qw, sx, sw_amax, out, part, M, N, p.KP, p.sps);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const long long total = (long long)M * N;
  const long long want = (total + SUM_NT - 1) / SUM_NT;
  const int blocks = (int)(want < 8 * sm_count() ? want : 8 * sm_count());
  fq_split_sum_kernel<T><<<blocks, SUM_NT, 0, stream>>>(part, sx, sw_amax, out,
                                                       M, N, p.splits);
  return (int)cudaGetLastError();
}

// Stage 2b's product at a tile outside TDT_FQ_TILES: fq_gemm_any_kernel,
// then the split sum where K is split
template <typename T>
int launch_gemm_any(const int8_t* qx, const int8_t* qw, const float* sx,
                    const uint32_t* sw_amax, T* out, int* part, const Plan& p,
                    int M, int N, int bm, int bn, cudaStream_t stream) {
  typedef GemmTile<GB_M, GB_N> G;
  const dim3 grid((M + bm - 1) / bm, (N + bn - 1) / bn, p.splits);
  int err;
  if (p.splits == 1) {
    err = (int)cudaFuncSetAttribute(
        fq_gemm_any_kernel<T, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != 0) return err;
    fq_gemm_any_kernel<T, false><<<grid, GEMM_NT, G::SMEM, stream>>>(
        qx, qw, sx, sw_amax, out, nullptr, M, N, p.KP, p.sps, bm, bn);
    return (int)cudaGetLastError();
  }
  err = (int)cudaFuncSetAttribute(fq_gemm_any_kernel<T, true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  G::SMEM);
  if (err != 0) return err;
  fq_gemm_any_kernel<T, true><<<grid, GEMM_NT, G::SMEM, stream>>>(
      qx, qw, sx, sw_amax, out, part, M, N, p.KP, p.sps, bm, bn);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const long long total = (long long)M * N;
  const long long want = (total + SUM_NT - 1) / SUM_NT;
  const int blocks = (int)(want < 8 * sm_count() ? want : 8 * sm_count());
  fq_split_sum_kernel<T><<<blocks, SUM_NT, 0, stream>>>(part, sx, sw_amax, out,
                                                       M, N, p.splits);
  return (int)cudaGetLastError();
}

// the plan IR's rule (plan/ir.py validate_quant_block): bm a positive
// multiple of 8, bn of 128, bk 0 or a positive multiple of 128
bool tile_legal(int bm, int bn, int bk) {
  return bm >= 8 && bm % 8 == 0 && bn >= 128 && bn % 128 == 0 && bk >= 0 &&
         bk % KT == 0;
}

// The product; x_amax_in / w_amax_in: the row and column maxima to scale
// by (tdt_fused_quant_scaled), or null to take them from x and w here.
// (bm, bn, bk): the GEMM's tile and K split (M > 16); -2 for a tile the
// plan IR refuses.
template <typename T>
int launch(const T* x, const T* w, T* out, char* ws, int M, int K, int N,
           int bm, int bn, int bk, cudaStream_t stream,
           const float* x_amax_in = nullptr,
           const uint32_t* w_amax_in = nullptr) {
  if (!tile_legal(bm, bn, bk)) return -2;
  const Plan p = make_plan(M, K, N, (int)sizeof(T), bk);
  uint32_t* sw_amax = w_amax_in ? const_cast<uint32_t*>(w_amax_in)
                                : reinterpret_cast<uint32_t*>(ws + p.off_sw);
  float* sx = reinterpret_cast<float*>(ws + p.off_sx);
  int8_t* qx = reinterpret_cast<int8_t*>(ws + p.off_qx);
  int* count = reinterpret_cast<int*>(ws + p.off_count);
  int err = (int)cudaMemsetAsync(ws, 0, (size_t)(p.off_sx - p.off_sw),
                                 stream);
  if (err != 0) return err;
  fq_scales_kernel<T><<<p.xb + (w_amax_in ? 0 : p.wb), SCALE_NT, 0,
                        stream>>>(x, w, M, K, N, p.KP, p.xb, p.ctiles, p.rb,
                                  sx, qx, sw_amax, x_amax_in, nullptr);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if (p.small) {
    int* part = p.splits > 1 ? reinterpret_cast<int*>(ws + p.off_part)
                             : nullptr;
    const dim3 grid((N + WN - 1) / WN, p.splits);
    const int smem = dec_smem<T>();
    if (M <= 8) {
      err = (int)cudaFuncSetAttribute(
          fq_decode_kernel<T, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != 0) return err;
      fq_decode_kernel<T, 1><<<grid, DEC_NT, smem, stream>>>(
          w, qx, sx, sw_amax, out, part, count, M, K, N, p.KP, p.sps);
    } else {
      err = (int)cudaFuncSetAttribute(
          fq_decode_kernel<T, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != 0) return err;
      fq_decode_kernel<T, 2><<<grid, DEC_NT, smem, stream>>>(
          w, qx, sx, sw_amax, out, part, count, M, K, N, p.KP, p.sps);
    }
    return (int)cudaGetLastError();
  }
  int8_t* qw = reinterpret_cast<int8_t*>(ws + p.off_qw);
  const dim3 qgrid((N + WN - 1) / WN, p.stages);
  fq_quant_w_kernel<T><<<qgrid, QW_NT, 0, stream>>>(w, K, N, p.KP, sw_amax, qw);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  int* part = reinterpret_cast<int*>(ws + p.off_part);
#define TDT_FQ_GEMM(BM, BN)                                              \
  if (bm == BM && bn == BN)                                              \
    return launch_gemm<T, BM, BN>(qx, qw, sx, sw_amax, out, part, p, M, N, \
                                  stream);
  TDT_FQ_TILES(TDT_FQ_GEMM)
#undef TDT_FQ_GEMM
  return launch_gemm_any<T>(qx, qw, sx, sw_amax, out, part, p, M, N, bm, bn,
                            stream);
}

}  // namespace

// The GEMM tiles this build instantiates with a compiled warp grid (every
// other legal tile runs on the general one): up to cap (bm, bn) pairs into
// tiles (2 cap ints); returns their number.
extern "C" int tdt_fused_quant_tiles(int* tiles, int cap) {
  int n = 0;
#define TDT_FQ_LIST(BM, BN)              \
  if (n < cap) {                         \
    tiles[2 * n] = BM;                   \
    tiles[2 * n + 1] = BN;               \
  }                                      \
  ++n;
  TDT_FQ_TILES(TDT_FQ_LIST)
#undef TDT_FQ_LIST
  return n;
}

// Bytes of device workspace tdt_fused_quant needs for (M, K) x (K, N) under
// the K split bk, in *bytes. Returns 0, or -1 for an empty shape or a bk
// that is not 0 or a positive multiple of 128.
extern "C" int tdt_fused_quant_workspace(int M, int K, int N, int bk,
                                         long long* bytes) {
  if (M < 1 || K < 1 || N < 1 || bk < 0 || bk % KT) return -1;
  *bytes = make_plan(M, K, N, 4, bk).bytes;
  return 0;
}

// out (M, N) = dequant(q(x) . q(w)) for row-major x (M, K), w (K, N) and
// out, all of one dtype: 0 = float32, 1 = bfloat16. ws: device workspace of
// tdt_fused_quant_workspace bytes, 256-byte aligned. (bm, bn, bk): the
// GEMM's output tile and K split, used where M > 16. Returns the first
// failed call's cudaError_t (0 = every launch went out); -1 for a dtype
// this build lacks or an empty shape, -2 for a tile the plan IR refuses.
extern "C" int tdt_fused_quant(const void* x, const void* w, void* out,
                               void* ws, int M, int K, int N, int dtype,
                               int bm, int bn, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* wsp = static_cast<char*>(ws);
  if (M < 1 || K < 1 || N < 1) return -1;
  if (dtype == 0)
    return launch(static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<float*>(out), wsp, M, K, N, bm, bn, bk, s);
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(w),
                  static_cast<__nv_bfloat16*>(out), wsp, M, K, N, bm, bn, bk,
                  s);
  return -1;
}

// The scales phase of tdt_fused_quant alone: x_amax (M floats) gets each
// row's max |x| over K, w_amax (N floats) each column's max |w| over K.
// Returns as tdt_fused_quant does.
extern "C" int tdt_fused_quant_amax(const void* x, const void* w,
                                    void* x_amax, void* w_amax, int M, int K,
                                    int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xa = static_cast<float*>(x_amax);
  uint32_t* wa = static_cast<uint32_t*>(w_amax);
  if (M < 1 || K < 1 || N < 1) return -1;
  if (dtype == 0)
    return launch_amax(static_cast<const float*>(x),
                       static_cast<const float*>(w), xa, wa, M, K, N, s);
  if (dtype == 1)
    return launch_amax(static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(w), xa, wa, M, K, N,
                       s);
  return -1;
}

// tdt_fused_quant with the scales taken from the given maxima: x_amax (M
// floats) and w_amax (N non-negative floats), e.g. tdt_fused_quant_amax's
// maxed over a group that shares the product's K. ws, tile and returns: as
// tdt_fused_quant.
extern "C" int tdt_fused_quant_scaled(const void* x, const void* w,
                                      const void* x_amax, const void* w_amax,
                                      void* out, void* ws, int M, int K,
                                      int N, int dtype, int bm, int bn,
                                      int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* wsp = static_cast<char*>(ws);
  const float* xa = static_cast<const float*>(x_amax);
  const uint32_t* wa = static_cast<const uint32_t*>(w_amax);
  if (M < 1 || K < 1 || N < 1) return -1;
  if (dtype == 0)
    return launch(static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<float*>(out), wsp, M, K, N, bm, bn, bk, s, xa,
                  wa);
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(w),
                  static_cast<__nv_bfloat16*>(out), wsp, M, K, N, bm, bn, bk,
                  s, xa, wa);
  return -1;
}
