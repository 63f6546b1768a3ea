// The head dims the five attention kernels take, one rule for all of them
// (flash_fwd, flash_bwd_dq, flash_bwd_dkv, flash_fwd_int8kv, paged_decode)
// and for tpu_dist_torch/kernels.head_dim_instance: every d from 1 up, as
// the reference's kernels take each head's whole d as one block.
//
// Up to 256 each source instantiates its kernels at head dims 16, 32, 64,
// 128 and 256, the head dim a compile-time constant D: the exact instance
// (PAD = false) runs d == D when every tensor its copies read or write
// starts on a 16-byte boundary, which is every tensor the allocator makes;
// the general instance (PAD = true) runs every other d up to D (8 on 16,
// 24 on 32, 33 and 48 on 64, 100 on 128, 136 and 200 on 256) and any
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
// exact instances compile the masks out.
//
// Above 256 a head's output accumulators outgrow a warp's registers, and
// its Q and K/V tiles the shared memory, in every design that holds all of
// d at once, so every d > 256 runs on the wide path (WideHead): the true d
// at run time, no compiled head dim and no ceiling. A block owns one
// chunk of the output's columns (128 in the tensor-core and SIMT flash
// kernels, 256 in paged_decode), the chunks over the grid's z axis; the
// scores (and the backward's dP) are summed over d in slices streamed
// through shared memory, in the same order in every chunk, so every chunk
// sees the same bits of S, p and the softmax statistics. The cost is
// ceil(d / chunk) x the score work. Rows, alignment and the ANY copies are
// as on the general instance. The C entries return -1 for d < 1.

#ifndef TDT_HEAD_DIM_CUH
#define TDT_HEAD_DIM_CUH

// the largest compiled head dim; every d above it runs on the wide path
constexpr int TDT_HEAD_DIM_NARROW = 256;
constexpr int TDT_HEAD_DIM_WIDE = 0;

// the instance that runs head dim d: 16, 32, 64, 128 or 256 up to 256,
// TDT_HEAD_DIM_WIDE above; -1 where none does (d < 1)
inline int tdt_head_dim_instance(int d) {
  if (d < 1) return -1;
  if (d > TDT_HEAD_DIM_NARROW) return TDT_HEAD_DIM_WIDE;
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

// the wide path (d > 256, the true d at run time), with ANY as HeadDim's
template <bool ANY>
struct WideHead {
  static constexpr bool any = ANY;
};

// f(HeadDim<D, PAD, ANY>{}) for the instance that runs head dim d: the
// exact one where d == D and `aligned` (every tensor the kernel copies by
// 16 bytes starts on a 16-byte boundary); else the general one, with
// ANY where a row is not whole 16-byte chunks on 16-byte boundaries
// (`whole`: the caller's test of d's row bytes, with `aligned`);
// wide(WideHead<ANY>{}) above 256, ANY by the same test; -1 where none
// does. A kernel that copies element by element (the fp32 SIMT ones)
// reads only D and PAD, and passes aligned and whole, so ANY adds no
// instance of it.
template <class F, class W>
int with_head_dim(int d, bool aligned, bool whole, F&& f, W&& wide) {
  const int inst = tdt_head_dim_instance(d);
  if (inst == TDT_HEAD_DIM_WIDE)
    return aligned && whole ? wide(WideHead<false>{}) : wide(WideHead<true>{});
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
