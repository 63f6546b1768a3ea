// The head dims the five attention kernels take, one rule for all of them
// (flash_fwd, flash_bwd_dq, flash_bwd_dkv, flash_fwd_int8kv, paged_decode)
// and for tpu_dist_torch/kernels.head_dim_instance: a multiple of 16 from 16
// to 128. Each source instantiates its kernels at head dims 16, 32, 64 and
// 128 with the head dim as a compile-time constant. Another head dim d runs
// on the next instance up, D, with the true d beside it at run time (48 on
// 64; 80, 96 and 112 on 128; the PAD instances): rows are strided by H * d,
// a row's copies past d are zero-filled (16-byte cp.async with a source
// size of 0, or a zero store), the products run over all D columns (the
// zeros add nothing) and nothing is stored past d. No tensor is copied or
// padded, and a paged pool keeps the model's own width. Multiples of 16
// keep every 16-byte copy of a bf16 or int8 row whole, so a copy is read
// entirely or not at all. The C entries return -1 for any other head dim.

#ifndef TDT_HEAD_DIM_CUH
#define TDT_HEAD_DIM_CUH

// the instance that runs head dim d (16, 32, 64 or 128), 0 where none does
inline int tdt_head_dim_instance(int d) {
  if (d < 16 || d > 128 || d % 16) return 0;
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

// an instance's head dim and whether the true d is smaller (PAD)
template <int D, bool PAD>
struct HeadDim {
  static constexpr int value = D;
  static constexpr bool pad = PAD;
};

// f(HeadDim<D, PAD>{}) for the instance that runs head dim d; -1 where
// none does
template <class F>
int with_head_dim(int d, F&& f) {
  switch (tdt_head_dim_instance(d)) {
    case 16:
      return f(HeadDim<16, false>{});
    case 32:
      return f(HeadDim<32, false>{});
    case 64:
      return d == 64 ? f(HeadDim<64, false>{}) : f(HeadDim<64, true>{});
    case 128:
      return d == 128 ? f(HeadDim<128, false>{}) : f(HeadDim<128, true>{});
  }
  return -1;
}

#endif  // TDT_HEAD_DIM_CUH
