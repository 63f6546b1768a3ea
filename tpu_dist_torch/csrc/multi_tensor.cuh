// Multi-tensor apply for the elementwise optimizer kernels (sgd.cu,
// adamw.cu): one launch over every leaf of one p dtype. Include after
// <cuda_bf16.h>, <cuda_runtime.h> and <stdint.h>.
//
// The host passes a table of rows, one per leaf (pointers and the element
// count `n`); for_each_table() adds each leaf's first chunk index and hands
// the table to the kernel BY VALUE as its parameter, so nothing is copied
// host to device and a CUDA-graph capture records the launch as it is.
// Each block takes one chunk of `chunk` elements of one leaf (a launch
// argument: the plan's opt_block_rows times 8, 4096 at the default 512
// rows; any multiple of 64 keeps every chunk's start on a 256-byte
// boundary of a 16-byte-aligned leaf), found by leaf_of_chunk(), a binary
// search over the chunk starts (leaves with n = 0 own no chunk, so no
// per-block table caps the grid). A table longer than
// one launch's capacity CAP is split into launches of at most CAP leaves:
// CUDA >= 12.1 allows 32,764 bytes of kernel parameters (TDT_LARGE_PARAMS),
// older toolkits 4 KB, and each kernel states both capacities.

#ifndef TDT_MULTI_TENSOR_CUH
#define TDT_MULTI_TENSOR_CUH

#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
#define TDT_LARGE_PARAMS 1
#else
#define TDT_LARGE_PARAMS 0
#endif

template <typename Row, int CAP>
struct LeafTable {                   // the kernel's parameter
  Row leaf[CAP];
  int start[CAP + 1];                // first chunk of each leaf; last: total
  int n_leaves;
};

// the leaf owning chunk c: the last with start <= c
template <typename Row, int CAP>
__device__ __forceinline__ int leaf_of_chunk(const LeafTable<Row, CAP>& tab,
                                             int c) {
  int lo = 0, hi = tab.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tab.start[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Split `rows` into tables of at most CAP leaves with their starts in
// chunks of `chunk` elements and call launch(table, chunks) for each that
// owns a chunk. Returns the first non-zero result of launch (a
// cudaError_t), -1 for a negative count, a chunk that is not a positive
// multiple of 64, or more than 2^31 - 1 chunks in one table, else 0.
template <int CAP, typename Row, typename Launch>
int for_each_table(const Row* rows, int n_leaves, int chunk, Launch launch) {
  if (n_leaves < 0 || chunk < 64 || chunk % 64) return -1;
  for (int i = 0; i < n_leaves; ++i)
    if (rows[i].n < 0) return -1;
  for (int first = 0; first < n_leaves; first += CAP) {
    LeafTable<Row, CAP> tab;
    tab.n_leaves = 0;
    long long chunks = 0;
    for (int i = first; i < n_leaves && i < first + CAP; ++i) {
      tab.start[tab.n_leaves] = (int)chunks;
      tab.leaf[tab.n_leaves++] = rows[i];
      chunks += (rows[i].n + chunk - 1) / chunk;
    }
    if (chunks > 0x7fffffffLL) return -1;
    tab.start[tab.n_leaves] = (int)chunks;
    if (chunks == 0) continue;
    const int err = launch(tab, (unsigned)chunks);
    if (err != 0) return err;
  }
  return 0;
}

// fp32 math on fp32 or bf16 storage, and the 16-byte vectors of both
struct alignas(16) F4 { float v[4]; };
struct alignas(8) B4 { __nv_bfloat16 v[4]; };

template <typename T> struct Vec;
template <> struct Vec<float> { typedef F4 type; };
template <> struct Vec<__nv_bfloat16> { typedef B4 type; };

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

#endif  // TDT_MULTI_TENSOR_CUH
