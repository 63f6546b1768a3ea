// The head dims the five attention kernels take, one rule for all of them
// (flash_fwd, flash_bwd_dq, flash_bwd_dkv, flash_fwd_int8kv, paged_decode)
// and for tpu_dist_torch/kernels.head_dim_instance: every d from 1 to 256,
// as the reference's kernels take each head's whole d as one block.
//
// Each source instantiates its kernels at head dims 16, 32, 64, 128 and
// 256, the head dim a compile-time constant D: the exact instance (PAD =
// false) runs d == D when every tensor its copies read or write starts on
// a 16-byte boundary, which is every tensor the allocator makes; the
// general instance (PAD = true) runs every other d up to D (8 on 16, 24
// on 32, 33 and 48 on 64, 100 on 128, 136 and 200 on 256) and any
// misaligned view. It takes the true d at run time: rows are strided by
// H * d, a row's columns past d read as zeros in shared memory, the
// products run over all D columns (the zeros add nothing, so mma.sync's
// k-steps of 16 stay whole) and nothing is stored past d. Where every row
// is whole 16-byte chunks on 16-byte boundaries (a bf16 d a multiple of
// 8, an int8 one of 16, the tensors aligned) it copies by 16-byte
// cp.async as the exact instance does; the tensor-core kernels also have
// it with ANY = true for any other row (a row's last partial chunk, an odd
// d, a misaligned base), copied by cp_async_rows_any (warp_mma.cuh): a
// whole, 16-byte-aligned chunk by one 16-byte cp.async, the rest by 8- or
// 4-byte cp.async where the source's alignment allows and byte loads where
// it does not, and stored element by element. No tensor is copied or
// padded on the host, and a paged pool keeps the model's own width. The
// exact instances compile the masks out. The C entries return -1
// for d < 1 or d > 256; above 256 a head's accumulators outgrow a warp's
// registers in every design here (ROADMAP Queue 3).

#ifndef TDT_HEAD_DIM_CUH
#define TDT_HEAD_DIM_CUH

// the instance that runs head dim d (16, 32, 64, 128 or 256), 0 where
// none does
inline int tdt_head_dim_instance(int d) {
  if (d < 1 || d > 256) return 0;
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// an instance's head dim, whether the true d may be smaller (PAD: the
// general instance), and whether its rows may be of any width and
// alignment (ANY: the general instance's copies by cp_async_rows_any;
// otherwise every row is whole 16-byte chunks on 16-byte boundaries)
template <int D, bool PAD, bool ANY = false>
struct HeadDim {
  static constexpr int value = D;
  static constexpr bool pad = PAD;
  static constexpr bool any = ANY;
};

// f(HeadDim<D, PAD, ANY>{}) for the instance that runs head dim d: the
// exact one where d == D and `aligned` (every tensor the kernel copies by
// 16 bytes starts on a 16-byte boundary); else the general one, with
// ANY where a row is not whole 16-byte chunks on 16-byte boundaries
// (`whole`: the caller's test of d's row bytes, with `aligned`); -1 where
// none does. A kernel that copies element by element (the fp32 SIMT
// ones) reads only D and PAD, so ANY adds no instance of it.
template <class F>
int with_head_dim(int d, bool aligned, bool whole, F&& f) {
  const int inst = tdt_head_dim_instance(d);
  const int mode = aligned && d == inst ? 0 : aligned && whole ? 1 : 2;
#define TDT_HEAD_DIM_CASE(D)                                      \
  case D:                                                         \
    return mode == 0   ? f(HeadDim<D, false>{})                   \
           : mode == 1 ? f(HeadDim<D, true>{})                    \
                       : f(HeadDim<D, true, true>{});
  switch (inst) {
    TDT_HEAD_DIM_CASE(16)
    TDT_HEAD_DIM_CASE(32)
    TDT_HEAD_DIM_CASE(64)
    TDT_HEAD_DIM_CASE(128)
    TDT_HEAD_DIM_CASE(256)
  }
#undef TDT_HEAD_DIM_CASE
  return -1;
}

// whether every pointer starts on a 16-byte boundary
template <class... P>
inline bool tdt_aligned16(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

#endif  // TDT_HEAD_DIM_CUH
