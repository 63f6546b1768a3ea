// int8-KV paged decode attention for Hopper (sm_90a): kernel 2 of the
// serving path.
//
// Replaces: tpu_dist/ops/paged_attention.py:_paged_int8kv_kernel (Pallas,
// TPU), reached through int8kv_paged_flash_attention_fn from paged_attend
// on every decode tick when kv_quant="int8" and attn_read="flash".
//
// What it computes: one query per row (the decode tick) over that row's
// gathered int8 K/V, q (B, 1, H, D), kq/vq (B, Lk, H, D) int8 with one
// fp32 scale per (b, position, h) in ks/vs (B, Lk, H); keys at positions
// >= lengths[b] are masked (length = position + 1 is the causal mask).
// Dequantization happens in registers, softmax in fp32, and the output
// (B, 1, H, D) is in q's type. A row with length 0 writes exact zeros.
//
// Bound on an H100 SXM: bytes. Every live key costs D int8 of K, D of V
// and two fp32 scales per head, read once, against 3.35 TB/s; the FLOPs
// (4*D per key and head) are two orders of magnitude below the fp32 rate.
//
// Design (first version: right and simple): one block of 8 warps per
// (b, h). Each warp walks its own stride of live keys, four keys at a time;
// a lane holds D/32 dimensions, so one key's K row is one coalesced
// 128-byte warp load at D=128, reduced with shuffles. Each warp keeps its
// own online softmax (max, sum, D/32 accumulators per lane); a final merge
// across warps in shared memory rescales the eight partial states. Only
// keys below lengths[b] are read at all. Reading the pages through the
// block table (no gathered copy) is a later performance step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int KU = 4;        // keys per warp per step
constexpr float NEG_INF = -1e30f;

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

// DPL consecutive int8 values as floats (one 4- or 2-byte load)
template <int DPL> __device__ __forceinline__ void load_i8(const int8_t* p, float* o);
template <> __device__ __forceinline__ void load_i8<4>(const int8_t* p, float* o) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  o[0] = (float)c.x; o[1] = (float)c.y; o[2] = (float)c.z; o[3] = (float)c.w;
}
template <> __device__ __forceinline__ void load_i8<2>(const int8_t* p, float* o) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  o[0] = (float)c.x; o[1] = (float)c.y;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ kq,
    const float* __restrict__ ks, const int8_t* __restrict__ vq,
    const float* __restrict__ vs, const int* __restrict__ lengths,
    T* __restrict__ out, int H, int Lk, float scale) {
  constexpr int DPL = D / 32;  // dimensions per lane
  __shared__ float s_m[NW], s_l[NW];
  __shared__ float s_acc[NW][D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > Lk ? Lk : len);

  float qv[DPL];
  {
    const T* qr = q + (long)bh * D + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) qv[i] = to_f<T>(qr[i]);
  }
  const long rs = (long)H * D;                         // K/V position stride
  const int8_t* kb = kq + (long)b * Lk * rs + (long)h * D + lane * DPL;
  const int8_t* vb = vq + (long)b * Lk * rs + (long)h * D + lane * DPL;
  const float* ksb = ks + (long)b * Lk * H + h;        // scale position stride H
  const float* vsb = vs + (long)b * Lk * H + h;

  float m = NEG_INF, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int j0 = w * KU; j0 < len; j0 += NW * KU) {
    float s[KU];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      s[u] = 0.f;
      const int j = j0 + u;
      if (j < len) {
        float kf[DPL];
        load_i8<DPL>(kb + (long)j * rs, kf);
#pragma unroll
        for (int i = 0; i < DPL; ++i) s[u] = fmaf(qv[i], kf[i], s[u]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < KU; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    float mx = NEG_INF;
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int j = j0 + u;
      s[u] = (j < len) ? s[u] * ksb[(long)j * H] * scale : NEG_INF;
      mx = fmaxf(mx, s[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int j = j0 + u;
      const float p = (s[u] <= 0.5f * NEG_INF) ? 0.f : expf(s[u] - m_new);
      l += p;
      if (j < len) {
        float vf[DPL];
        load_i8<DPL>(vb + (long)j * rs, vf);
        const float pv = p * vsb[(long)j * H];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] = fmaf(pv, vf[i], acc[i]);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    s_m[w] = m;
    s_l[w] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) s_acc[w][lane * DPL + i] = acc[i];
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += NT) {
    float M = NEG_INF;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, s_m[ww]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) {
      const float f = expf(s_m[ww] - M);  // a warp with no live key has l = acc = 0
      L = fmaf(s_l[ww], f, L);
      A = fmaf(s_acc[ww][d], f, A);
    }
    out[(long)bh * D + d] = from_f<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* lengths, void* out, int B, int H,
           int Lk, float scale, cudaStream_t stream) {
  paged_decode_kernel<T, D><<<B * H, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const int*>(lengths),
      static_cast<T*>(out), H, Lk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16. Returns the launch's
// cudaError_t (0 = launched); -1 for a (dtype, D) this build has no
// instance for.
extern "C" int tdt_paged_decode(const void* q, const void* kq, const void* ks,
                                const void* vq, const void* vs,
                                const void* lengths, void* out, int B, int H,
                                int Lk, int D, float scale, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, kq, ks, vq, vs, lengths, out, B, H, Lk, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, kq, ks, vq, vs, lengths, out, B, H, Lk, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, kq, ks, vq, vs, lengths, out, B, H, Lk, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, kq, ks, vq, vs, lengths, out, B, H, Lk, scale, s);
  return -1;
}
