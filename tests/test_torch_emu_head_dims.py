"""The five attention kernel sources at every head dim up to 256 on the
CPU, through the emulation of ``tpu_dist_torch/tools/cuda_emu.py`` (a
fiber per CUDA thread): ``chip_smoke.five_at_head_dim`` (phase 3's sweep)
drives all five C entries against their plain versions, with sentinel
tails, dead rows and a length-0 paged row, on the allocator's tensors and
on misaligned views, bit-equal to each other. Tolerances are
chip_smoke's: fp32 ATTN_FP32_TOL, bf16 BF16_TOL, the int8-K/V forward
INT8KV_ULP and INT8KV_ATOL."""

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


def _five(emu, dtype, d, off=0, kv_offset=0):
    """``chip_smoke.five_at_head_dim`` (phase 3's sweep) through the
    emulated C entries: all five at head dim ``d`` against their plain
    versions, every output (and the paged decode's split partials)
    allocated NaN between SENTINEL elements, rows that see no key and the
    length-0 paged row exact zeros; with ``off`` > 0 again on views ``off``
    elements into their buffers, bit-equal to the aligned run. Above 128
    (the 256 instances) one head of 40 rows over 64 keys keeps the
    emulated tensor-core kernels within seconds."""
    shape = ((1, 70, 100, 2, kv_offset) if d <= 128
             else (1, 40, 64, 1, kv_offset))
    return chip_smoke.five_at_head_dim(torch, None, d, dtype, off, "cpu",
                                       emu, shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [48, 80], ids=str)
def test_runtime_head_dim_stores_nothing_past_d(emu, dtype, d):
    """At a head dim that runs on the next instance up, every kernel's
    outputs (and the paged decode's split partials) are allocated NaN with
    GUARD SENTINEL elements after them: each output element is written (it
    matches the plain version), and nothing lands past the end."""
    _five(emu, dtype, d)


# (head dim, element offset of the misaligned views): a row narrower than
# its instance (8 on 16, 24 on 32, 33 on 64, 100 on 128, 136 on 256), an
# odd d (33: 66-byte bf16 rows, 33-byte int8 rows), 100 (8-byte-aligned
# bf16 rows, 4-byte int8 rows), and the 256 instances
HEAD_DIM_CASES = [(8, 1), (24, 2), (33, 1), (100, 4), (136, 1), (256, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d,off", HEAD_DIM_CASES, ids=str)
def test_every_head_dim_runs_aligned_and_misaligned(emu, dtype, d, off):
    """The five C entries at head dims up to 256, with sentinel tails,
    dead rows and a length-0 paged row, once on the allocator's tensors
    and once on views ``off`` elements into their buffers (inputs and
    outputs): both runs match the plain versions, and they are bit-equal
    to each other (only the copies differ)."""
    rec, _ = _five(emu, dtype, d, off, 24)
    assert rec["bit_equal_misaligned"] and rec["misaligned_offset_elements"] \
        == off
