"""The port's CUDA kernels on the card against their plain versions, at
small and ragged shapes (``chip_smoke.py`` covers the full-width ones).

Marked ``cuda``: a CUDA kernel has no interpret mode, so without an NVIDIA
GPU these skip. On the card (no flax there, and ``tests/conftest.py``
configures JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu_dist_torch import kernels
from tpu_dist_torch.ops import flash_attention as fa
from tpu_dist_torch.ops import paged_attention as pa

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# fp32: the kernels and the plain versions differ in summation order only;
# bf16: the kernels round p (flash) and the output to bf16
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "interpret mode")
    return torch.device("cuda")


def _close(out, ref, dtype):
    tol = TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= tol * (1 + ref.float().abs())).all()), \
        diff.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("case", [
    # (b, lq, lk, h, d, causal, q_offset, kv_offset)
    (2, 100, 100, 2, 64, True, 0, 0),
    (1, 70, 130, 3, 128, False, 0, 0),
    (1, 64, 64, 2, 128, True, 0, 40),     # fully masked rows: exact zeros
    (2, 40, 96, 1, 64, True, 56, 0),
    (1, 1, 1, 1, 128, True, 0, 0),
], ids=str)
def test_flash_kernel_matches_plain(cuda, dtype, case):
    b, lq, lk, h, d, causal, qo, ko = case
    gen = torch.Generator(device=cuda).manual_seed(lq * 7 + lk)
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=cuda)
               .to(dtype) for n in (lq, lk, lk))
    out, lse = fa.flash_forward_cuda(q, k, v, causal, qo, ko)
    ref, ref_lse = fa.flash_forward_plain(q, k, v, causal, qo, ko)
    _close(out, ref, dtype)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    dead = (ref == 0).all(dim=-1)
    assert torch.equal(dead, (out == 0).all(dim=-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("d", [64, 128])
def test_paged_kernel_matches_plain(cuda, dtype, d):
    b, lk, h = 5, 300, 3
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn((b, 1, h, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, lk, h, d), generator=gen, device=cuda)
            for _ in range(2))
    kq, ks, vq, vs = fa.quantize_kv(k, v)
    lengths = torch.tensor([0, 1, 37, 299, 300], dtype=torch.int32,
                           device=cuda)
    out = pa.paged_decode_cuda(q, kq, ks, vq, vs, lengths)
    ref = pa.paged_decode_plain(q, kq, ks, vq, vs, lengths)
    _close(out, ref, dtype)
    assert bool((out[0] == 0).all())       # length 0: exact zeros


def test_wrappers_count_launches_and_refuse_bad_input(cuda):
    x = torch.randn((1, 8, 1, 64), device=cuda)
    kernels.reset_launches()
    fa.flash_attention_fn()(x, x, x)
    assert kernels.LAUNCHES["flash_fwd"] == 1
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_forward_cuda(*(torch.zeros((1, 8, 1, 32), device=cuda),) * 3)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.randn((1, 2, 8, 64), device=cuda).transpose(1, 2)
        fa.flash_forward_cuda(y, y, y)
    with pytest.raises(TypeError):
        fa.flash_forward_cuda(*(x.half(),) * 3)
    assert kernels.LAUNCHES["flash_fwd"] == 1


@pytest.mark.parametrize("kw", [
    dict(kv_quant="int8", attn_read="flash"),       # the slice: both kernels
    dict(),                                          # fp pool, exact read
    dict(kv_quant="int8", attn_read="flash", prefill_chunk=8),
    dict(kv_quant="int8", attn_read="flash", prefix_cache=True),
    dict(quant="int8_wo"),
], ids=str)
def test_serving_on_the_card_equals_the_cpu_path(cuda, kw):
    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.models.transformer import tiny_lm

    geom = dict(vocab_size=64, num_layers=2, d_model=128, num_heads=2,
                max_len=48, attn_fn=fa.flash_attention_fn())
    cpu_lm = tiny_lm(device="cpu", seed=5, **geom)
    gpu_lm = tiny_lm(device=cuda, seed=None, **geom)
    gpu_lm.load_state_dict(cpu_lm.state_dict())
    cfg = ServeConfig(max_slots=2, page_size=8, num_pages=24, **kw)
    # requests 0 and 3 repeat a prompt: the prefix cache forks a page
    prompts = [np.arange(n, dtype=np.int32) * 5 % 64 for n in (3, 17, 9, 3)]
    reqs = lambda: [DecodeRequest(i, p, 12) for i, p in enumerate(prompts)]
    got = {}
    for dev, lm in (("cpu", cpu_lm), (cuda, gpu_lm)):
        kernels.reset_launches()
        eng = ServeEngine(lm, cfg, device=dev)
        got[dev] = {c.rid: c.tokens for c in eng.run(reqs())}
    chunk = kw.get("prefill_chunk", 0)
    monolithic = sum(1 for p in prompts if not chunk or p.size <= chunk)
    assert kernels.LAUNCHES["flash_fwd"] == 2 * monolithic   # 2 layers
    if kw.get("attn_read") == "flash":
        assert kernels.LAUNCHES["paged_decode"] == 2 * eng.ticks
    for rid, toks in got["cpu"].items():
        np.testing.assert_array_equal(toks, got[cuda][rid])
