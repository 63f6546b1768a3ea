// Warp-level tensor-core helpers for the bf16 and int8 kernels (sm_80
// instructions, built for sm_90a): mma.sync m16n8k16 bf16 -> fp32 and
// m16n8k32 s8 -> s32, ldmatrix x4 (plain and .trans), cp.async with zero
// fill (16, 8 and 4 bytes; row copies for aligned rows and for rows of any
// width and alignment), and the register-level pieces around them (quad
// reductions over a C-fragment row, a two-term bf16 split, int8
// widening). Include after <cuda_bf16.h> and <stdint.h>.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 operands), with
// g = lane >> 2 and t = lane & 3; each 32-bit register holds two bf16, the
// lower column (or k) in its low half:
//   A (16 x 16, row-major): reg 0 = (g, 2t..2t+1), reg 1 = (g+8, 2t..2t+1),
//                           reg 2 = (g, 2t+8..2t+9), reg 3 = (g+8, 2t+8..)
//   B (16 x 8, k x n):      reg 0 = (k 2t..2t+1, n g), reg 1 = (k 2t+8.., n g)
//   C (16 x 8, fp32):       c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// so a C fragment pair (n-tiles 2j, 2j+1) rounded to bf16 is the A fragment
// of k-step j of a following product: the repack stays in registers.
// With .s8 operands (mma.m16n8k32) each register holds four int8, the lowest
// k in its low byte: A reg 0 = (g, 4t..4t+3), reg 1 = (g+8, 4t..), reg 2 =
// (g, 4t+16..), reg 3 = (g+8, 4t+16..); B reg 0 = (k 4t..4t+3, n g), reg 1
// = (k 4t+16.., n g); C as above in int32. Byte for byte that is the bf16
// layout, so ldsm_x4 loads both operands from k-contiguous int8 rows (an
// 8 x 8 b16 matrix is 8 rows of 16 int8).
//
// tools/cuda_emu.py defines TDT_CUDA_EMU and supplies software versions of
// the helpers below (the warp-collective ones with these layouts), so the
// kernels' indexing, masks and repacks run on the CPU.

#ifndef TDT_WARP_MMA_CUH
#define TDT_WARP_MMA_CUH

#ifndef TDT_CUDA_EMU
// two floats rounded to bf16 (nearest even, as astype) by one
// cvt.rn.bf16x2.f32, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp; results below 2^-126 flush
// to zero, far under a bf16 p's resolution)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the 16-byte row
// (l % 8) of matrix l / 8. r[i] gets matrix i's (row g, cols 2t, 2t+1);
// with .trans, its (rows 2t, 2t+1, col g).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8) += a (16 x 16) . b (16 x 8) on the tensor cores, fp32 sums
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8) += a (16 x 32) . b (32 x 8) on the tensor cores, int8
// operands, int32 sums (exact; they wrap past 2^31, which the callers'
// bound on K rules out)
__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 (8, 4) bytes global -> shared without passing through registers;
// `bytes` below the size zero-fills the rest (0: zeros, src is not read)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif  // TDT_CUDA_EMU

// The helpers below are built from the ones above and from CUDA
// intrinsics that tools/cuda_emu.py also supplies, so they need no twin.

// Rows r0 .. r0+ROWS-1 of an (L, D) matrix of T (bf16 or int8) with row
// stride `stride` into shared dst (row stride RS elements), as 16-byte
// cp.async copies spread over NT threads; rows past L, and the columns
// from `cols` on (a multiple of 16 bytes' elements; D: none), read as
// zeros.
template <int ROWS, int D, int RS, int NT, typename T>
__device__ __forceinline__ void cp_async_rows(T* dst, const T* src,
                                              long stride, int r0, int L,
                                              int tid, int cols = D) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = D / E;          // chunks per row
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * E;
    const bool in = r0 + r < L && (cols >= D || c < cols);
    cp_async_16(dst + r * RS + c, src + (in ? r0 + r : 0) * stride + c,
                in ? 16 : 0);
  }
}

// n (0 .. 16) bytes from src into the 16-byte shared chunk dst, the rest
// zeros, for a source of any alignment: the widest cp.async (8 or 4 bytes)
// that src's alignment allows for each whole piece, a zero-filling one for
// a piece past n (src not read), and byte loads for a piece that n cuts
// or that src's alignment rules out.
__device__ __forceinline__ void cp_async_chunk_any(void* dst, const void* src,
                                                   int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int w = a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 1;
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  for (int o = 0; o < 16; o += w) {
    const int live = n - o < 0 ? 0 : (n - o > w ? w : n - o);
    if (w > 1 && (live == w || live == 0)) {
      if (w == 8) cp_async_8(d + o, live ? s + o : s, live);
      else cp_async_4(d + o, live ? s + o : s, live);
    } else {
      for (int e = 0; e < w; ++e) d[o + e] = e < live ? s[o + e] : 0;
    }
  }
}

// cp_async_rows for rows of any width and alignment (head_dim.cuh's ANY
// instances): `cols` (1 .. D) elements of each row are live. A chunk whose
// 16 bytes are all live and whose source is 16-byte aligned takes one
// 16-byte cp.async; a chunk past cols or past L a zero-filling one; any
// other (the row's last partial chunk, or a misaligned source) goes by
// cp_async_chunk_any. Everything past cols reads as zeros.
template <int ROWS, int D, int RS, int NT, typename T>
__device__ __forceinline__ void cp_async_rows_any(T* dst, const T* src,
                                                  long stride, int r0, int L,
                                                  int tid, int cols) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = D / E;          // chunks per row
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * E;
    const int n = r0 + r < L ? min(E, cols - c) : 0;  // live elements
    T* d = dst + r * RS + c;
    if (n <= 0) {
      cp_async_16(d, src, 0);
      continue;
    }
    const T* s = src + (long)(r0 + r) * stride + c;
    if (n == E && reinterpret_cast<uintptr_t>(s) % 16 == 0)
      cp_async_16(d, s, 16);
    else
      cp_async_chunk_any(d, s, n * (int)sizeof(T));
  }
}

// row[c], row[c + 1] = bf16(lo), bf16(hi) (nearest even), c even: one
// 32-bit store on an exact instance, and on a general one (PAD,
// head_dim.cuh) whose rows are whole 16-byte chunks on 16-byte boundaries
// (d even: the pair is all below d or all past it); with ANY each element
// alone. None at or past d.
template <bool PAD, bool ANY>
__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* row, int c,
                                             int d, float lo, float hi) {
  if constexpr (ANY) {
    if (c < d) row[c] = __float2bfloat16(lo);
    if (c + 1 < d) row[c + 1] = __float2bfloat16(hi);
  } else if (!PAD || c < d) {
    *reinterpret_cast<uint32_t*>(row + c) = pack_bf16x2(lo, hi);
  }
}

// max and sum over the quad of lanes 4g .. 4g+3, which hold one row of a
// C fragment between them
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// (a, b) = hi + lo to about 16 significant bits: hi = bf16(a), bf16(b) as
// pack_bf16x2 packs them, lo = the bf16 of what hi leaves over. Two mma
// against one bf16 B operand then take an fp32 A at that precision.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  hi = pack_bf16x2(a, b);
  lo = pack_bf16x2(a - __uint_as_float(hi << 16),
                   b - __uint_as_float(hi & 0xffff0000u));
}

// four int8 (the bytes of x, lowest first) as two bf16 pairs, exactly
// (|x| <= 128 < 2^8 fits bf16's 8-bit significand)
__device__ __forceinline__ void widen_int8x4(uint32_t x, uint32_t& lo,
                                             uint32_t& hi) {
  lo = pack_bf16x2((float)(int8_t)(x & 0xffu),
                   (float)(int8_t)((x >> 8) & 0xffu));
  hi = pack_bf16x2((float)(int8_t)((x >> 16) & 0xffu),
                   (float)(int8_t)(x >> 24));
}

// One k/v tile of the flash forward kernels' online softmax, on a warp's
// 16 x 8*NB score tile s in the C-fragment layout (this lane: rows g and
// g + 8 in e = 0, 1 and e = 2, 3; keys 8j + 2t + (e & 1) of the tile).
// With `edge`, scores whose key is past Lk or, causal, past its row's
// diagonal are masked first: key positions kv_offset + k0 + key, row
// positions qpos + g (+ 8), where qpos is the global position of the
// warp's first row. m: the rows' running max of the unscaled scores
// (neg_inf before any live key), l: this lane's part of their sums, acc:
// the output accumulator of the same rows. On return s holds
// p = 2^(s scale2 - m scale2) in fp32, exactly 0 for a masked score
// whatever m is, and acc and l are rescaled to the new max, l with p
// added (a row with no live key yet keeps alpha = 1: neg_inf - neg_inf =
// 0).
template <int NB, int ND>
__device__ __forceinline__ void online_softmax_tile(
    float (&s)[NB][4], float (&acc)[ND][4], float (&m)[2], float (&l)[2],
    float scale2, bool edge, int k0, int Lk, bool causal, int kv_offset,
    long qpos, float neg_inf) {
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  if (edge) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        bool live = key < Lk;
        if (causal)
          live = live && (kv_offset + key <= qpos + g + 8 * (e / 2));
        if (!live) s[j][e] = neg_inf;
      }
  }
  float msc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < NB; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = quad_max(mx);
    const float alpha = exp2_approx((m[r] - mx) * scale2);
    m[r] = mx;
    msc[r] = mx * scale2;
    l[r] *= alpha;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][2 * r] *= alpha;
      acc[j][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = (edge && s[j][e] <= 0.5f * neg_inf)
                          ? 0.f
                          : exp2_approx(fmaf(s[j][e], scale2, -msc[e / 2]));
      l[e / 2] += p;
      s[j][e] = p;
    }
}

// ---- the wide path (head_dim.cuh: d above 256) ----------------------------

// cp_async_rows (ANY: cp_async_rows_any) of the W columns from c0 of an
// (L, d) matrix's rows r0 .. r0+ROWS-1: columns at or past d, and rows at
// or past L, read as zeros. c0 < d, a multiple of 16 bytes' elements.
template <int ROWS, int W, int RS, int NT, bool ANY, typename T>
__device__ __forceinline__ void cp_async_cols(T* dst, const T* src,
                                              long stride, int r0, int L,
                                              int c0, int d, int tid) {
  if constexpr (ANY)
    cp_async_rows_any<ROWS, W, RS, NT>(dst, src + c0, stride, r0, L, tid,
                                       d - c0);
  else
    cp_async_rows<ROWS, W, RS, NT>(dst, src + c0, stride, r0, L, tid,
                                   d - c0);
}

// c (16 x 8 NB) += a (16 x 16 KS) . b (8 NB x 16 KS)^T for one warp: a's
// 16 rows and b's 8 NB rows k-contiguous in shared memory (row stride RS),
// both read by ldmatrix
template <int NB, int KS, int RS>
__device__ __forceinline__ void warp_mma_abt(float (&c)[NB][4],
                                             const __nv_bfloat16* a,
                                             const __nv_bfloat16* b) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * RS + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) {  // n-tiles 2j, 2j+1
      uint32_t bf[4];
      ldsm_x4(bf, b + (16 * j + lane % 8 + (lane / 16) * 8) * RS + kk * 16 +
                      ((lane / 8) % 2) * 8);
      mma_bf16_16816(c[2 * j], af, bf[0], bf[1]);
      mma_bf16_16816(c[2 * j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x 8 ND) += bf16(p) (16 x 16 KS) . v (16 KS x 8 ND) for one warp:
// p in C fragments (n-tiles 2kk, 2kk+1 rounded to bf16 and repacked in
// registers as k-step kk's A operand), v's rows k-major in shared memory
// (row stride RS) read by ldmatrix.trans
template <int KS, int ND, int RS>
__device__ __forceinline__ void warp_mma_pv(float (&acc)[ND][4],
                                            const float (&p)[2 * KS][4],
                                            const __nv_bfloat16* v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16x2(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16x2(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int j = 0; j < ND / 2; ++j) {  // n-tiles 2j, 2j+1
      uint32_t bv[4];
      ldsm_x4_trans(bv, v + (kk * 16 + lane % 16) * RS + 16 * j +
                            (lane / 16) * 8);
      mma_bf16_16816(acc[2 * j], a, bv[0], bv[1]);
      mma_bf16_16816(acc[2 * j + 1], a, bv[2], bv[3]);
    }
  }
}

#endif  // TDT_WARP_MMA_CUH
