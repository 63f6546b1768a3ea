// int8-KV paged decode attention for Hopper (sm_90a): kernel 2 of the
// serving path.
//
// Replaces: tpu_dist/ops/paged_attention.py:_paged_int8kv_kernel (Pallas,
// TPU), reached through int8kv_paged_flash_attention_fn from paged_attend
// on every decode tick when kv_quant="int8" and attn_read="flash".
//
// What it computes: one query per row (the decode tick), q (B, 1, H, D),
// over that row's int8 K/V with one fp32 scale per (position, head); keys
// at positions >= lengths[b] are masked (length = position + 1 is the
// causal mask). Dequantization happens in registers, softmax in fp32, and
// the output (B, 1, H, D) is in q's type. A row with length 0 writes exact
// zeros.
//
// Where the keys live: the page arenas k, v (N+1, page_size, H, D) int8
// and k_scale, v_scale (N+1, page_size, H) fp32, read through the block
// table bt (B, P) int32: key j of row b is arena row
// bt[b, j / page_size] * page_size + j % page_size. Only keys below
// lengths[b] are read: no page past the live length, no stale row of the
// last page, never the trash page. The TPU kernel reads a gathered copy of
// every row's whole table instead; here the gathered layout (B, Lk, H, D)
// is the same arenas seen as B pages of page_size = Lk with bt = [[0],
// [1], ...], so one kernel serves both entries.
//
// Bound on an H100 SXM: bytes. Every live key costs D int8 of K, D of V
// and two fp32 scales per head, read once, against 3.35 TB/s; the FLOPs
// (4*D per key and head) are two orders of magnitude below the fp32 rate.
// At a decode tick's sizes the bytes take a few microseconds, so what
// costs time is memory latency and idle SMs.
//
// Design (split-key decode, "flash-decoding"), two launches per call:
// 1. paged_split_kernel, grid (splits, B * H): each block owns SPLIT
//    consecutive key positions of one (b, h), fixed from P * page_size so
//    the host reads no length; a split past its row's length writes an
//    empty partial (m = NEG_INF, l = 0) and exits. A lane takes PW = 16
//    dims of a K or V row (8 at D = 16, so that a block's 256 threads
//    still spread over at most SPLIT keys), so a warp reads 32 / (D/PW)
//    keys per load instruction (D/PW lanes per K row, coalesced),
//    and every thread issues all of its K and V rows and scales before
//    their first use, so a block costs about two memory latencies (block
//    table, then K/V) rather than one latency chain per key. Scores are
//    reduced across a row's lanes by shuffles, the split's max and sum are
//    taken over shared memory, and the p-weighted V sums of the key groups
//    are added in shared memory in a fixed order. Out: (m, l) and acc[d]
//    per (b, h, split).
// 2. paged_merge_kernel, one block of D threads per (b, h) (and per
//    256-dim chunk on the wide path): M = max m_s,
//    L = sum l_s e^(m_s - M), out = sum acc_s e^(m_s - M) / max(L, 1e-30),
//    over the row's live splits in order. No atomics anywhere, so the
//    result is deterministic.
// Head dims (head_dim.cuh): every d from 1 up. Up to 256 exact instances
// at D = 16, 32, 64, 128 and 256 run d == D on 16-byte-aligned arenas; every
// other d, and a misaligned arena, runs on the general instance of the
// next D up with the true d at run time: the arena rows keep the model's
// width (stride H * d), a lane past d loads nothing and adds zeros, and no
// dim past d is stored. Where d is not a multiple of 16 or an arena is
// misaligned, that instance is compiled with ANY (head_dim.cuh): the tail
// lane's piece reads zeros past d, and a piece that is whole and aligned
// goes by one load and any other by byte loads (load_piece). A lane's
// piece stays PW = 16 dims (8 at D = 16), so at D = 256 a key row takes 16
// lanes, a warp load 2 keys, a thread 8 of a split's 128: whole keys a
// thread, as the static_assert holds; ptxas (sm_90a, on the H100 build):
// 122 registers for the exact split kernel at 256, 16.5 KB of shared
// memory, no spill.
// Above 256 every d runs on the wide path (paged_split_kernel_wide): 256's
// lane layout, the scores summed over d in 256-dim slices (each lane's
// pieces in order, then the shuffle reduction, so every chunk has the same
// scores), and a block a 256-dim chunk of V (grid z), the merge one block
// a chunk; K is read ceil(d / 256) times. 16.9 KB of shared memory at any
// d; ptxas (sm_90a, on the H100 build): 128 registers and 4 bytes of spill
// stores, 150 and none with ANY.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "head_dim.cuh"

namespace {

constexpr int NT = 256;      // threads per split block
constexpr int NW = NT / 32;  // warps per split block
constexpr int SPLIT = 128;   // key positions per split block
constexpr float NEG_INF = -1e30f;

// 4 * N int8 values, loaded by one instruction (N = 4: 16 bytes)
template <int N>
struct alignas(4 * N) I8Words { uint32_t w[N]; };

// a lane's piece of a K or V row: one 4 * N-byte load; on an instance for
// rows of any width and alignment (ANY, head_dim.cuh) the same load where
// all `live` bytes are there and the address is aligned, else byte loads
// with zeros past live
template <int N, bool ANY>
__device__ __forceinline__ I8Words<N> load_piece(const int8_t* p, int live) {
  if (!ANY || (live == 4 * N && reinterpret_cast<uintptr_t>(p) % (4 * N) == 0))
    return *reinterpret_cast<const I8Words<N>*>(p);
  I8Words<N> x;
#pragma unroll
  for (int t = 0; t < N; ++t) {
    uint32_t w = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * t + e < live) w |= (uint32_t)(uint8_t)p[4 * t + e] << (8 * e);
    x.w[t] = w;
  }
  return x;
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float i8(uint32_t w, int e) {
  return (float)(int8_t)(w >> (8 * e));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D, bool PAD, bool ANY>
__global__ void __launch_bounds__(NT) paged_split_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k,
    const float* __restrict__ ks, const int8_t* __restrict__ v,
    const float* __restrict__ vs, const int* __restrict__ bt,
    const int* __restrict__ lengths, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int H, int d_true, int P, int page_size,
    float scale) {
  const int dh = PAD ? d_true : D;          // the true head dim (head_dim.cuh)
  // dims a lane takes: 16 (one 16-byte load) from D = 32 on; 8 at D = 16,
  // so that a block still spreads its 256 threads over at most SPLIT keys
  constexpr int PW = D >= 32 ? 16 : 8;
  constexpr int NWD = PW / 4;               // 32-bit words a lane loads
  constexpr int PIECES = D / PW;            // lanes per key row
  constexpr int RPW = 32 / PIECES;          // keys per warp load
  constexpr int GROUPS = NW * RPW;          // keys per block load
  constexpr int KPT = SPLIT / GROUPS;       // keys per thread
  static_assert(KPT >= 1 && KPT * GROUPS == SPLIT,
                "a split block must give every thread a whole number of keys");
  __shared__ float s_score[SPLIT];
  __shared__ float s_red[GROUPS][D];

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r = lane / PIECES;
  const int c = lane % PIECES;
  // the dims of this lane's piece below the true head dim (PAD): a lane
  // past it loads and adds nothing; with ANY the tail lane's piece reads
  // zeros past dh (without, d is a multiple of 16: pieces are whole)
  const int live_dims = !PAD ? PW
                        : ANY ? min(PW, max(dh - c * PW, 0))
                              : (c * PW < dh ? PW : 0);
  const bool lane_live = live_dims > 0;
  const long long part = (long long)bh * gridDim.x + split;
  int len = lengths[b];
  const int cap = P * page_size;
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int j0 = split * SPLIT;
  if (j0 >= len) {           // nothing live here: an empty partial
    if (threadIdx.x == 0) {
      part_ml[2 * part] = NEG_INF;
      part_ml[2 * part + 1] = 0.f;
    }
    return;
  }

  // issue every load of this thread before the first use: q's PW dims,
  // then the block-table entries, then K, V and their scales
  float qv[PW];
  {
    const T* qr = q + (long long)bh * dh + c * PW;
#pragma unroll
    for (int e = 0; e < PW; ++e) qv[e] = e < live_dims ? to_f<T>(qr[e]) : 0.f;
  }
  const long long rs = (long long)H * dh;   // arena row stride (bytes)
  long long row[KPT];
  bool live[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int j = j0 + (i * NW + w) * RPW + r;
    live[i] = j < len;
    row[i] = live[i] ? (long long)bt[(long long)b * P + j / page_size] *
                               page_size + j % page_size
                     : 0;
  }
  I8Words<NWD> kr[KPT], vr[KPT];
  float ksc[KPT], vsc[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    if (live[i]) {
      const long long off = row[i] * rs + (long long)h * dh + c * PW;
      if (lane_live) {
        kr[i] = load_piece<NWD, ANY>(k + off, live_dims);
        vr[i] = load_piece<NWD, ANY>(v + off, live_dims);
      }
      ksc[i] = ks[row[i] * H + h];
      vsc[i] = vs[row[i] * H + h];
    }
  }

  // scores: a row's PIECES lanes each dot PW dims, then shuffle-reduce
  float s[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    float d = 0.f;
    if (live[i] && lane_live) {
#pragma unroll
      for (int t = 0; t < NWD; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d = fmaf(qv[4 * t + e], i8(kr[i].w[t], e), d);
    }
#pragma unroll
    for (int off = PIECES / 2; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    s[i] = live[i] ? d * ksc[i] * scale : NEG_INF;
    if (c == 0) s_score[(i * NW + w) * RPW + r] = s[i];
  }
  __syncthreads();

  // the split's max and sum, every warp on its own from shared memory
  float m = NEG_INF;
  for (int t = lane; t < SPLIT; t += 32) m = fmaxf(m, s_score[t]);
  m = warp_max(m);                           // finite: key j0 is live
  float l = 0.f;
  for (int t = lane; t < SPLIT; t += 32) {
    const float sc = s_score[t];
    l += (sc <= 0.5f * NEG_INF) ? 0.f : expf(sc - m);
  }
  l = warp_sum(l);

  // p-weighted V over this thread's keys, then over the key groups
  float acc[PW];
#pragma unroll
  for (int e = 0; e < PW; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    if (live[i] && lane_live) {
      const float pv = expf(s[i] - m) * vsc[i];
#pragma unroll
      for (int t = 0; t < NWD; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * t + e] = fmaf(pv, i8(vr[i].w[t], e), acc[4 * t + e]);
    }
  }
#pragma unroll
  for (int e = 0; e < PW; ++e) s_red[w * RPW + r][c * PW + e] = acc[e];
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += NT) {
    float a = 0.f;
#pragma unroll 8
    for (int g = 0; g < GROUPS; ++g) a += s_red[g][d];
    part_acc[part * dh + d] = a;
  }
  if (threadIdx.x == 0) {
    part_ml[2 * part] = m;
    part_ml[2 * part + 1] = l;
  }
}

// grid (B * H, ceil(d / D)): block y merges dims D y .. D y + D - 1 (one
// block in y on an instance; the wide path's chunks above 256)
template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(D) paged_merge_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int d_true,
    int n_splits, int cap) {
  const int dh = PAD ? d_true : D;  // the true head dim (head_dim.cuh)
  const int bh = blockIdx.x;
  const int d = blockIdx.y * D + threadIdx.x;
  if (PAD && d >= dh) return;
  int len = lengths[bh / H];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int n = (len + SPLIT - 1) / SPLIT;   // live splits, in order
  const float* ml = part_ml + 2LL * bh * n_splits;
  const float* acc = part_acc + (long long)bh * n_splits * dh;
  float M = NEG_INF;
  for (int s = 0; s < n; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n; ++s) {
    const float f = expf(ml[2 * s] - M);
    L = fmaf(ml[2 * s + 1], f, L);
    A = fmaf(acc[(long long)s * dh + d], f, A);
  }
  out[(long long)bh * dh + d] = from_f<T>(A / fmaxf(L, 1e-30f));
}

template <typename T, int D, bool PAD, bool ANY>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, const void* bt, const void* lengths,
           void* part_ml, void* part_acc, void* out, int B, int H, int d,
           int P, int page_size, int n_splits, float scale,
           cudaStream_t stream) {
  const dim3 grid(n_splits, B * H);
  paged_split_kernel<T, D, PAD, ANY><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(lengths), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), H, d, P, page_size, scale);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  paged_merge_kernel<T, D, PAD><<<B * H, D, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, d, n_splits,
      P * page_size);
  return (int)cudaGetLastError();
}

// ---- the wide path (head_dim.cuh: d above 256) -----------------------------
//
// paged_split_kernel at 256's lane layout (PW = 16 dims a lane, 16 lanes a
// key row, two keys a warp load, 8 keys a thread) for any d: block z owns
// dims c0 .. c0 + WD - 1 (c0 = WD * blockIdx.z) of the split's p-weighted V
// sum. A key's score is summed over d in WD-dim slices, each lane adding
// its piece of every slice in order before the shuffle reduction, so every
// chunk computes the same scores, max and sum (chunk 0 writes them). K is
// read ceil(d / WD) times, V once; the merge runs one block a chunk.

constexpr int WD = 256;  // dims a slice of the scores and a chunk of V

template <typename T, bool ANY>
__global__ void __launch_bounds__(NT) paged_split_kernel_wide(
    const T* __restrict__ q, const int8_t* __restrict__ k,
    const float* __restrict__ ks, const int8_t* __restrict__ v,
    const float* __restrict__ vs, const int* __restrict__ bt,
    const int* __restrict__ lengths, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int H, int dh, int P, int page_size,
    float scale) {
  constexpr int PW = 16;                    // dims a lane takes
  constexpr int NWD = PW / 4;               // 32-bit words a lane loads
  constexpr int PIECES = WD / PW;           // lanes per key row
  constexpr int RPW = 32 / PIECES;          // keys per warp load
  constexpr int GROUPS = NW * RPW;          // keys per block load
  constexpr int KPT = SPLIT / GROUPS;       // keys per thread
  static_assert(KPT >= 1 && KPT * GROUPS == SPLIT,
                "a split block must give every thread a whole number of keys");
  __shared__ float s_score[SPLIT];
  __shared__ float s_red[GROUPS][WD];

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int c0 = blockIdx.z * WD;  // this block's dims of the V sum
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r = lane / PIECES;
  const int c = lane % PIECES;
  // the live dims of this lane's piece at dim offset o: with ANY the tail
  // lane's piece reads zeros past dh (without, d is a multiple of 16)
  auto live_dims = [&](int o) {
    return ANY ? min(PW, max(dh - o - c * PW, 0))
               : (o + c * PW < dh ? PW : 0);
  };
  const long long part = (long long)bh * gridDim.x + split;
  int len = lengths[b];
  const int cap = P * page_size;
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int j0 = split * SPLIT;
  if (j0 >= len) {           // nothing live here: an empty partial
    if (threadIdx.x == 0 && blockIdx.z == 0) {
      part_ml[2 * part] = NEG_INF;
      part_ml[2 * part + 1] = 0.f;
    }
    return;
  }

  const long long rs = (long long)H * dh;   // arena row stride (bytes)
  long long row[KPT];
  bool live[KPT];
  float ksc[KPT], vsc[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int j = j0 + (i * NW + w) * RPW + r;
    live[i] = j < len;
    row[i] = live[i] ? (long long)bt[(long long)b * P + j / page_size] *
                               page_size + j % page_size
                     : 0;
    if (live[i]) {
      ksc[i] = ks[row[i] * H + h];
      vsc[i] = vs[row[i] * H + h];
    }
  }

  // scores: each lane dots its piece of every slice, then shuffle-reduce
  float dsum[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) dsum[i] = 0.f;
  for (int o = 0; o < dh; o += WD) {
    const int n = live_dims(o);
    float qv[PW];
    const T* qr = q + (long long)bh * dh + o + c * PW;
#pragma unroll
    for (int e = 0; e < PW; ++e) qv[e] = e < n ? to_f<T>(qr[e]) : 0.f;
    I8Words<NWD> kr[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      if (live[i] && n > 0)
        kr[i] = load_piece<NWD, ANY>(
            k + row[i] * rs + (long long)h * dh + o + c * PW, n);
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      if (live[i] && n > 0) {
#pragma unroll
        for (int t = 0; t < NWD; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dsum[i] = fmaf(qv[4 * t + e], i8(kr[i].w[t], e), dsum[i]);
      }
  }
  float s[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    float d = dsum[i];
#pragma unroll
    for (int off = PIECES / 2; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    s[i] = live[i] ? d * ksc[i] * scale : NEG_INF;
    if (c == 0) s_score[(i * NW + w) * RPW + r] = s[i];
  }
  __syncthreads();

  // the split's max and sum, every warp on its own from shared memory
  float m = NEG_INF;
  for (int t = lane; t < SPLIT; t += 32) m = fmaxf(m, s_score[t]);
  m = warp_max(m);                           // finite: key j0 is live
  float l = 0.f;
  for (int t = lane; t < SPLIT; t += 32) {
    const float sc = s_score[t];
    l += (sc <= 0.5f * NEG_INF) ? 0.f : expf(sc - m);
  }
  l = warp_sum(l);

  // p-weighted V over this thread's keys in this block's chunk, then over
  // the key groups
  const int nv = live_dims(c0);
  float acc[PW];
#pragma unroll
  for (int e = 0; e < PW; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    if (live[i] && nv > 0) {
      const I8Words<NWD> vr = load_piece<NWD, ANY>(
          v + row[i] * rs + (long long)h * dh + c0 + c * PW, nv);
      const float pv = expf(s[i] - m) * vsc[i];
#pragma unroll
      for (int t = 0; t < NWD; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * t + e] = fmaf(pv, i8(vr.w[t], e), acc[4 * t + e]);
    }
  }
#pragma unroll
  for (int e = 0; e < PW; ++e) s_red[w * RPW + r][c * PW + e] = acc[e];
  __syncthreads();
  for (int d = threadIdx.x; d < min(WD, dh - c0); d += NT) {
    float a = 0.f;
#pragma unroll 8
    for (int g = 0; g < GROUPS; ++g) a += s_red[g][d];
    part_acc[part * dh + c0 + d] = a;
  }
  if (threadIdx.x == 0 && blockIdx.z == 0) {
    part_ml[2 * part] = m;
    part_ml[2 * part + 1] = l;
  }
}

template <typename T, bool ANY>
int launch_wide(const void* q, const void* k, const void* ks, const void* v,
                const void* vs, const void* bt, const void* lengths,
                void* part_ml, void* part_acc, void* out, int B, int H, int d,
                int P, int page_size, int n_splits, float scale,
                cudaStream_t stream) {
  const int chunks = (d + WD - 1) / WD;
  const dim3 grid(n_splits, B * H, chunks), merge_grid(B * H, chunks);
  paged_split_kernel_wide<T, ANY><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(lengths), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), H, d, P, page_size, scale);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  paged_merge_kernel<T, WD, true><<<merge_grid, WD, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, d, n_splits,
      P * page_size);
  return (int)cudaGetLastError();
}

}  // namespace

// q and out (B, 1, H, D) of dtype 0 = float32, 1 = bfloat16; k, v int8
// arenas (N+1, page_size, H, D) and k_scale, v_scale fp32 (N+1, page_size,
// H), of any alignment (a misaligned arena runs on the general
// instance); block_tables (B, P) and lengths (B,) int32; fp32
// scratch part_ml (B, H, n_splits, 2) and part_acc (B, H, n_splits, D),
// n_splits = ceil(P * page_size / 128). Two launches (split, merge) on
// `stream`. Returns the first failed launch's cudaError_t (0 = both
// launched); -1 for a dtype this build has no instance for or a head dim D
// below 1 (head_dim.cuh), -2 for a wrong n_splits or more than 65,535 (b,
// h) rows.
extern "C" int tdt_paged_decode(const void* q, const void* k, const void* ks,
                                const void* v, const void* vs,
                                const void* block_tables,
                                const void* lengths, void* part_ml,
                                void* part_acc, void* out, int B, int H,
                                int D, int P, int page_size, int n_splits,
                                float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long keys = (long long)P * page_size;
  if (n_splits != (keys + SPLIT - 1) / SPLIT || n_splits < 1 ||
      (long long)B * H > 65535 || keys > 0x7fffffffLL)
    return -2;
  const bool aligned = tdt_aligned16(k, v);
  if (dtype == 0)
    return with_head_dim(D, aligned, D % 16 == 0, [&](auto hd) {
      using HD = decltype(hd);
      return launch<float, HD::value, HD::pad, HD::any>(
          q, k, ks, v, vs, block_tables, lengths, part_ml, part_acc, out, B,
          H, D, P, page_size, n_splits, scale, s);
   }, [&](auto wd) {
      return launch_wide<float, decltype(wd)::any>(
          q, k, ks, v, vs, block_tables, lengths, part_ml, part_acc, out, B,
          H, D, P, page_size, n_splits, scale, s);
    });
  if (dtype == 1)
    return with_head_dim(D, aligned, D % 16 == 0, [&](auto hd) {
      using HD = decltype(hd);
      return launch<__nv_bfloat16, HD::value, HD::pad, HD::any>(
          q, k, ks, v, vs, block_tables, lengths, part_ml, part_acc, out, B,
          H, D, P, page_size, n_splits, scale, s);
   }, [&](auto wd) {
      return launch_wide<__nv_bfloat16, decltype(wd)::any>(
          q, k, ks, v, vs, block_tables, lengths, part_ml, part_acc, out, B,
          H, D, P, page_size, n_splits, scale, s);
    });
  return -1;
}
