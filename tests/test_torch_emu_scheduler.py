"""The CUDA emulation's fiber scheduler (``tpu_dist_torch/tools/cuda_emu.py``):
a block's fibers run in thread order (``order="forward"``) or in reverse
between barriers, and the two orders give the same bits on real kernels
(they are race-free, and each thread sums in its own order); a read of a
``__shared__`` value that another thread writes with no barrier between is
caught in one order on every run; and a barrier that only part of a block
reaches raises an error naming the kernel and the block at once, where it
would hang a schedule that waits for it."""

import ctypes
import itertools
import shutil
import time

import pytest
import torch

from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.ops import pallas_quant as pq
from tpu_dist_torch.tools import cuda_emu

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def compiler():
    if not (shutil.which("g++") or shutil.which("clang++")):
        pytest.skip("no host C++ compiler for the CUDA emulation")


@pytest.fixture(scope="module")
def by_order(compiler):
    return {order: cuda_emu.entries("flash", "quant", "quant_ws",
                                    order=order)
            for order in cuda_emu.ORDERS}


def test_orders_are_bit_equal_on_flash_forward(by_order):
    """A bf16 causal case with dead rows (the tensor-core kernel, its warp
    collectives and block barriers): bit-equal in both orders, and within
    the emulation tests' bf16 tolerance of the plain version."""
    gen = torch.Generator().manual_seed(70)
    q, k, v = (torch.randn((1, n, 2, 64), generator=gen).to(torch.bfloat16)
               for n in (70, 130, 130))
    got = {order: fa._launch(fns["flash"], q, k, v, True, 0, 40, None)
           for order, fns in by_order.items()}
    (out, lse), (rout, rlse) = got["forward"], got["reverse"]
    assert torch.equal(out, rout) and torch.equal(lse, rlse)
    ref, _ = fa.flash_forward_plain(q, k, v, True, 0, 40)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= 2e-2 * (1 + ref.float().abs())).all())


@pytest.mark.parametrize("m,k,n", [(8, 300, 72), (70, 200, 136)], ids=str)
def test_orders_are_bit_equal_on_fused_quant(by_order, m, k, n):
    """The split-K decode path and the GEMM path: bit-equal in both orders
    and to the plain version."""
    gen = torch.Generator().manual_seed(m + k + n)
    x = (torch.randn((m, k), generator=gen) * 2).to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen).to(torch.bfloat16)
    got = {order: pq._launch(fns["quant"], fns["quant_ws"], x, w, None)
           for order, fns in by_order.items()}
    assert torch.equal(got["forward"], got["reverse"])
    assert torch.equal(got["forward"], pq.fused_quant_matmul_plain(x, w))


# thread 31 stores a value that thread 0 loads: a race unless a barrier
# stands between them
_RACE_SRC = r"""
#include <cuda_bf16.h>

__global__ void race_kernel(const int* in, int* out, int sync) {
  __shared__ int s;
  if (threadIdx.x == 31) s = *in;
  if (sync) __syncthreads();
  if (threadIdx.x == 0) *out = s;
}

extern "C" int tdt_race(const void* in, void* out, int sync) {
  race_kernel<<<1, 32, 0, nullptr>>>(static_cast<const int*>(in),
                                     static_cast<int*>(out), sync);
  return 0;
}
"""


def test_a_planted_race_is_caught_in_one_order(compiler):
    """Without the barrier, thread 0 reads the stale value when the fibers
    run in thread order and the stored one in reverse, on every run; with
    it, both orders read the stored value."""
    fns = {}
    for order in cuda_emu.ORDERS:
        fns[order] = cuda_emu.build_source("race", _RACE_SRC, order).tdt_race
        fns[order].argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    values = itertools.count(1000)

    def reads_stored(order, sync):
        stored = torch.tensor([next(values)], dtype=torch.int32)
        out = torch.full((1,), -1, dtype=torch.int32)
        assert fns[order](stored.data_ptr(), out.data_ptr(), sync) == 0
        return bool(out == stored)

    for _ in range(3):
        assert {order: reads_stored(order, 0) for order in fns} == {
            "forward": False, "reverse": True}
        assert all(reads_stored(order, 1) for order in fns)


# mode 0: only the first of two warps reaches __syncthreads; 1: only half
# of a warp reaches a shuffle; 2: every thread reaches both
_PARTIAL_SRC = r"""
#include <cuda_bf16.h>

__global__ void partial_barrier_kernel(float* out, int mode) {
  float v = threadIdx.x;
  if (mode != 0 || threadIdx.x < 32) {
    if (mode != 1 || threadIdx.x % 32 < 16) v = __shfl_xor_sync(~0u, v, 1);
    if (mode != 1) __syncthreads();
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = v;
}

extern "C" int tdt_partial_barrier(void* out, int mode) {
  partial_barrier_kernel<<<2, 64, 0, nullptr>>>(static_cast<float*>(out),
                                                mode);
  return 0;
}
"""


@pytest.mark.parametrize("mode,waiting", [
    (0, "32 wait at __syncthreads, 0 at a warp collective and 32 have "
        "returned"),
    (1, "0 wait at __syncthreads, 32 at a warp collective and 32 have "
        "returned")], ids=["__syncthreads", "__shfl_xor_sync"])
def test_a_barrier_part_of_a_block_reaches_raises_at_once(compiler, mode,
                                                           waiting):
    """The first block's live fibers all wait on a barrier that cannot
    fill: the entry raises within a second, naming the kernel and the
    block, and the second block never runs. The library then runs a whole
    launch as before."""
    fn = cuda_emu.build_source("partial_barrier",
                               _PARTIAL_SRC).tdt_partial_barrier
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = torch.full((2, 64), float("nan"))
    t0 = time.perf_counter()
    with pytest.raises(cuda_emu.EmulationError) as err:
        fn(out.data_ptr(), mode)
    assert time.perf_counter() - t0 < 1.0
    assert str(err.value) == (
        "emulated kernel partial_barrier_kernel, block (0, 0, 0): deadlock: "
        f"of its 64 threads {waiting}, so no barrier can fill")
    assert bool(out[1].isnan().all())
    assert fn(out.data_ptr(), 2) == 0
    lane = torch.arange(64.0)
    assert torch.equal(out, (lane + 1 - 2 * (lane % 2)).expand(2, 64))
