"""The five attention kernel sources above head dim 256 (the wide path)
on the CPU, through the emulation of ``tpu_dist_torch/tools/cuda_emu.py``
(a fiber per CUDA thread), by ``chip_smoke.five_at_head_dim`` with its
tolerances (fp32 ATTN_FP32_TOL, bf16 BF16_TOL, the int8-K/V forward
INT8KV_ULP and INT8KV_ATOL)."""

import shutil

import pytest
import torch

import chip_smoke
from tpu_dist_torch.tools import cuda_emu

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emu():
    if not (shutil.which("g++") or shutil.which("clang++")):
        pytest.skip("no host C++ compiler for the CUDA emulation")
    return cuda_emu.entries(*cuda_emu.ATTENTION)


# (head dim, element offset of the misaligned views) on the wide path: an
# odd d (257: byte loads, a lane's partial piece in the paged decode), 264
# (whole bf16 chunks, int8 rows not whole 16-byte chunks), 320 (a last
# 128-column chunk half live), 512 (four chunks) and 1024 (eight)
WIDE_HEAD_DIM_CASES = [(257, 1), (264, 2), (320, 4), (512, 2), (1024, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d,off", WIDE_HEAD_DIM_CASES, ids=str)
def test_wide_head_dims_run_aligned_and_misaligned(emu, dtype, d, off):
    """The five C entries above 256 (the wide path: output chunks over the
    grid's z axis, the scores summed over d in streamed slices), with
    sentinel tails, dead rows (8 rows see no key), dead keys and a
    length-0 paged row, on the allocator's tensors and on views ``off``
    elements into their buffers: both match the plain versions and are
    bit-equal to each other. One q tile and one k/v tile (Lq 24, Lk 40)
    keep the emulated tensor-core kernels, whose work grows as d^2 here,
    within a minute at 1024."""
    rec, _ = chip_smoke.five_at_head_dim(torch, None, d, dtype, off, "cpu",
                                         emu, (1, 24, 40, 1, 8))
    assert rec["bit_equal_misaligned"] and rec["sentinels_untouched"] \
        and rec["dead_exact_zero"]
