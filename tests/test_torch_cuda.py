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
from tpu_dist_torch.ops import pallas_adamw as adamw
from tpu_dist_torch.ops import pallas_quant as pq

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# fp32: the kernels and the plain versions differ in summation order only;
# bf16: the forward kernels round p and the output to bf16 (the backward
# kernels round p and ds where their plain version does, then the outputs)
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
    (2, 130, 200, 2, 64, True, 0, 40),    # several q tiles, dead rows
    (1, 1000, 1000, 2, 128, False, 24, 0),
    # head dims 16, 32 and, on the 64 and 128 instances at run time, 48
    # and 80
    (2, 130, 200, 2, 16, True, 0, 40),
    (1, 70, 130, 3, 32, False, 0, 0),
    (2, 100, 100, 2, 48, True, 0, 0),
    (1, 130, 130, 2, 80, True, 24, 0),
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
@pytest.mark.parametrize("d", [64, 128, 16, 32, 48, 80])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("d", [64, 128, 16, 32, 48, 80])
def test_paged_block_table_kernel_reads_only_live_keys(cuda, dtype, d):
    """The kernel through a shuffled block table (page_size 16, 128 pages
    a row as in serving) on arenas whose scales are NaN wherever no row
    may read (unowned pages, the trash page, the rows at or past the
    length in each last page): equal to the plain version on the arenas
    with those scales zeroed, bit-equal to the kernel on clean arenas,
    exact zeros at length 0."""
    lengths = [0, 1, 16, 17, 127, 128, 129, 1000, 2048]
    ps, per_row = 16, 128
    gen = torch.Generator(device=cuda).manual_seed(d + 3)
    live = [-(-n // ps) for n in lengths]
    n_pages = sum(live) + 7
    perm = torch.randperm(n_pages, generator=gen, device=cuda)
    bt = torch.full((len(lengths), per_row), n_pages, dtype=torch.int32,
                    device=cuda)
    readable = torch.zeros((n_pages + 1, ps), dtype=torch.bool, device=cuda)
    used = 0
    for i, n in enumerate(lengths):
        pages = perm[used:used + live[i]]
        used += live[i]
        bt[i, :live[i]] = pages.to(torch.int32)
        pos = torch.arange(live[i] * ps, device=cuda)
        readable.view(-1)[pages.repeat_interleave(ps) * ps + pos % ps] = \
            pos < n
    kq, ks, vq, vs = fa.quantize_kv(*(
        torch.randn((n_pages + 1, ps, 2, d), generator=gen, device=cuda)
        for _ in range(2)))
    nan = torch.where(readable[..., None], 0.0, float("nan"))
    poisoned = pa.PagedLayer(kq, vq, ks + nan, vs + nan, quant="int8",
                             read="flash")
    zeroed = pa.PagedLayer(kq, vq, (ks + nan).nan_to_num(0.0),
                           (vs + nan).nan_to_num(0.0), quant="int8",
                           read="flash")
    clean = pa.PagedLayer(kq, vq, ks, vs, quant="int8", read="flash")
    q = torch.randn((len(lengths), 1, 2, d), generator=gen,
                    device=cuda).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kernels.reset_launches()
    out = pa.paged_decode_blocks_cuda(q, poisoned, bt, lens)
    assert torch.equal(out, pa.paged_decode_blocks_cuda(q, clean, bt, lens))
    assert kernels.LAUNCHES["paged_decode"] == 2
    _close(out, pa.paged_decode_blocks_plain(q, zeroed, bt, lens), dtype)
    assert bool((out[0] == 0).all())


def test_wrappers_count_launches_and_refuse_bad_input(cuda):
    x = torch.randn((1, 8, 1, 64), device=cuda)
    kernels.reset_launches()
    fa.flash_attention_fn()(x, x, x)
    assert kernels.LAUNCHES["flash_fwd"] == 1
    # head dim 24 runs on the 32 instance, 264 on the wide path; 0 is past
    # the rule: refused by name, nothing launched
    fa.flash_forward_cuda(*(torch.zeros((1, 8, 1, 24), device=cuda),) * 3)
    assert kernels.LAUNCHES["flash_fwd"] == 2
    fa.flash_forward_cuda(*(torch.zeros((1, 8, 1, 264), device=cuda),) * 3)
    assert kernels.LAUNCHES["flash_fwd"] == 3
    with pytest.raises(ValueError, match="head_dim 0 is refused"):
        fa.flash_forward_cuda(*(torch.zeros((1, 8, 1, 0), device=cuda),) * 3)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.randn((1, 2, 8, 64), device=cuda).transpose(1, 2)
        fa.flash_forward_cuda(y, y, y)
    with pytest.raises(TypeError):
        fa.flash_forward_cuda(*(x.half(),) * 3)
    assert kernels.LAUNCHES["flash_fwd"] == 3


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("case", [
    # (b, lq, lk, h, d, causal, q_offset, kv_offset)
    (2, 100, 100, 2, 64, True, 0, 0),
    (1, 70, 130, 3, 128, False, 0, 0),
    (1, 64, 64, 2, 128, True, 0, 40),     # dead rows and keys: exact zeros
    (2, 40, 96, 1, 64, True, 56, 0),
    (1, 1, 1, 1, 128, True, 0, 0),
    (1, 1000, 1000, 2, 64, True, 0, 0),   # many tiles, ragged last one
    (1, 130, 200, 2, 128, True, 0, 40),   # ragged, dead rows and keys
    # head dims 16, 32, and 48 and 80 at run time
    (1, 130, 200, 2, 16, True, 0, 40),
    (2, 100, 100, 2, 32, True, 0, 0),
    (1, 70, 130, 3, 48, False, 0, 0),
    (1, 130, 130, 2, 80, True, 24, 0),
], ids=str)
def test_flash_backward_kernels_match_plain(cuda, dtype, case):
    b, lq, lk, h, d, causal, qo, ko = case
    gen = torch.Generator(device=cuda).manual_seed(lq * 5 + lk)
    q, k, v, g = (torch.randn((b, n, h, d), generator=gen, device=cuda)
                  .to(dtype) for n in (lq, lk, lk, lq))
    out, lse = fa.flash_forward_cuda(q, k, v, causal, qo, ko)
    got = fa.flash_backward_cuda(q, k, v, out, lse, g, causal, qo, ko)
    ref = fa.flash_backward_plain(q, k, v, out, lse, g, causal, qo, ko)
    for a, r in zip(got, ref):
        _close(a, r, dtype)
    if ko > qo:
        dead = (qo + torch.arange(lq, device=cuda)) < ko
        assert bool((got[0][:, dead] == 0).all())
    if causal:    # keys that no row sees: exact zero dk and dv
        dead = (ko + torch.arange(lk, device=cuda)) > qo + lq - 1
        for grad in got[1:]:
            assert bool((grad[:, dead] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_adamw_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    n = 100_003                                   # not a multiple of a block
    p = torch.randn(n, generator=gen, device=cuda).to(dtype)
    g, m = (torch.randn(n, generator=gen, device=cuda) for _ in range(2))
    v = torch.rand(n, generator=gen, device=cuda)
    row = adamw.scalar_row(1e-3, 0.9, 0.95, 1e-8, 0.1, 2,
                           torch.tensor(0.7, device=cuda))
    ref = [t.clone() for t in (p, m, v)]
    adamw.fused_adamw_cuda(p, g, m, v, row)
    adamw.fused_adamw_plain(ref[0], g, ref[1], ref[2], row)
    assert p.dtype == dtype
    # fp32 math: the kernel's fma contraction leaves a few ulps; a bf16 p
    # can round one ulp apart from that
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    for a, r in zip((p, m, v), ref):
        diff = (a.float() - r.float()).abs()
        assert bool((diff <= tol * (1 + r.float().abs())).all())


def test_adamw_multi_leaf_kernel_matches_plain(cuda):
    """1,100 leaves of two p dtypes in one ``fused_adamw_multi_cuda``: two
    calls (one a dtype), each more rows than one launch's 512, sizes from
    0 to 70,000 and some views at odd element offsets, each leaf held as
    in the one-leaf test."""
    gen = torch.Generator(device=cuda).manual_seed(1101)
    sizes = (0, 1, 3, 5, 64, 4097, 70_000)
    leaves = []
    for i in range(1100):
        n, off = sizes[i % len(sizes)], (1 + i % 3 if i % 7 == 3 else 0)
        dtype = (torch.float32, torch.bfloat16)[i % 2]
        leaves.append((torch.randn(n + off, generator=gen, device=cuda)
                       .to(dtype)[off:],
                       torch.randn(n, generator=gen, device=cuda),
                       torch.randn(n, generator=gen, device=cuda) * 0.1,
                       torch.rand(n, generator=gen, device=cuda) * 0.1))
    ps, gs, ms, vs = (list(t) for t in zip(*leaves))
    row = adamw.scalar_row(1e-3, 0.9, 0.95, 1e-8, 0.1, 2,
                           torch.tensor(0.7, device=cuda))
    ref = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    kernels.reset_launches()
    adamw.fused_adamw_multi_cuda(ps, gs, ms, vs, row)
    assert kernels.LAUNCHES["adamw"] == 2
    for i in range(len(ps)):
        adamw.fused_adamw_plain(ref[0][i], gs[i], ref[1][i], ref[2][i], row)
        tol = 1e-6 if ps[i].dtype == torch.float32 else 2e-2
        for a, r in zip((ps[i], ms[i], vs[i]),
                        (ref[0][i], ref[1][i], ref[2][i])):
            diff = (a.float() - r.float()).abs()
            assert bool((diff <= tol * (1 + r.float().abs())).all()), i


def test_flash_entries_run_misaligned_bf16_views(cuda):
    """A contiguous bf16 view at an odd element offset, and an int8 K at an
    odd byte offset: the forward, the backward and the int8-K/V forward run
    them on the general instance (nothing is refused for alignment), bit-
    equal to an aligned copy on the exact instance."""
    n = 8 * 64
    view = torch.randn(n + 1, device=cuda).to(torch.bfloat16)[1:]
    bad = view.view(1, 8, 1, 64)
    good = bad.clone()
    kernels.reset_launches()
    out, lse = fa.flash_forward_cuda(good, good, good)
    got = fa.flash_forward_cuda(bad, good, good)
    assert torch.equal(got[0], out) and torch.equal(got[1], lse)
    want = fa.flash_backward_cuda(good, good, good, out, lse, good)
    for a, b in zip(fa.flash_backward_cuda(good, good, good, out, lse, bad),
                    want):
        assert torch.equal(a, b)
    kv = fa.quantize_kv(good, good)
    want8 = fa.int8kv_flash_cuda(good, kv)
    assert torch.equal(fa.int8kv_flash_cuda(bad, kv), want8)
    kq = torch.empty(n + 1, dtype=torch.int8, device=cuda)[1:]
    kq.copy_(kv[0].reshape(-1))
    assert torch.equal(
        fa.int8kv_flash_cuda(good, (kq.view(1, 8, 1, 64), *kv[1:])), want8)
    assert kernels.LAUNCHES["flash_fwd"] == 2
    assert kernels.LAUNCHES["flash_bwd_dq"] == 2
    assert kernels.LAUNCHES["flash_fwd_int8kv"] == 3


def test_backward_wrappers_count_launches_and_refuse_bad_input(cuda):
    x = torch.randn((1, 8, 1, 64), device=cuda, requires_grad=True)
    kernels.reset_launches()
    fa.flash_attention_fn()(x, x, x).sum().backward()
    assert kernels.LAUNCHES["flash_fwd"] == 1
    assert kernels.LAUNCHES["flash_bwd_dq"] == 1
    assert kernels.LAUNCHES["flash_bwd_dkv"] == 1
    y = x.detach()
    out, lse = fa.flash_forward_cuda(y, y, y)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_backward_cuda(y, y, y, out, lse[:, :4].contiguous(), out)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_backward_cuda(y, y, y, out, lse, out.double())
    p = torch.zeros(10, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        adamw.fused_adamw_cuda(p, p.half(), p, p, torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        adamw.fused_adamw_cuda(p, p, p.cpu(), p, torch.zeros(8, device=cuda))
    assert kernels.LAUNCHES["flash_bwd_dq"] == 1
    assert kernels.LAUNCHES["adamw"] == 0


def test_training_on_the_card_equals_the_cpu_path(cuda, tmp_path):
    """A tiny fp32 trainer (flash attention, fused AdamW with its clip
    slot): 4 steps on the card (kernels) and on the CPU (plain versions)
    from the same weights. Losses within 1e-4 * (1 + |loss|): cuBLAS and
    the CPU sum matmuls in other orders, and Adam's normalized update
    carries small gradient differences into the params."""
    import json

    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.interop import export_flax_params
    from tpu_dist_torch.models.transformer import tiny_lm

    init = export_flax_params(tiny_lm(vocab_size=64, num_layers=2,
                                      d_model=64, num_heads=1, max_len=80,
                                      device="cpu", seed=2))
    losses = {}
    for dev in ("cpu", cuda):
        path = str(tmp_path / f"{dev}.jsonl")
        cfg = LMConfig(batch_size=4, seq_len=80, d_model=64, num_layers=2,
                       num_heads=1, vocab_size=64, synth_tokens=3000,
                       attn="flash", optimizer="fused_adamw", lr=3e-3,
                       grad_clip=0.5, max_steps=4, print_freq=2,
                       ledger_path=path)
        kernels.reset_launches()
        tr = LMTrainer(cfg, device=dev, init_params=init)
        tr.fit()
        with open(path) as f:
            losses[dev] = [r["loss"] for r in map(json.loads, f)
                           if r["event"] == "step"]
    assert kernels.LAUNCHES["flash_bwd_dq"] == 2 * 4
    assert kernels.LAUNCHES["flash_bwd_dkv"] == 2 * 4
    assert kernels.LAUNCHES["adamw"] == 4        # one call a step
    for a, r in zip(losses[cuda], losses["cpu"]):
        assert abs(a - r) <= 1e-4 * (1 + abs(r))


@pytest.mark.parametrize("dtype,n,offset", [
    (torch.float32, 1, 0), (torch.float32, 4099, 0),
    (torch.float32, 2_359_296, 0),        # ResNet-50's largest leaf
    (torch.float32, 1000, 1),             # unaligned: element by element
    (torch.bfloat16, 777, 0), (torch.bfloat16, 300, 3),
], ids=str)
def test_sgd_kernel_matches_plain(cuda, dtype, n, offset):
    from tpu_dist_torch.ops import pallas_sgd as sgd

    gen = torch.Generator(device=cuda).manual_seed(n + offset)
    p = torch.randn(n + offset, generator=gen, device=cuda).to(dtype)[offset:]
    g = torch.randn(n, generator=gen, device=cuda)
    m = torch.randn(n, generator=gen, device=cuda) * 0.1
    row = sgd.scalar_row(0.1, 0.9, 1e-4, torch.tensor(0.3, device=cuda))
    ref = [p.clone(), m.clone()]
    kernels.reset_launches()
    sgd.fused_sgd_leaf(p, g, m, row)
    sgd.fused_sgd_plain(ref[0], g, ref[1], row)
    assert kernels.LAUNCHES["sgd"] == 1 and p.dtype == dtype
    # fp32 math in the same order: fma contraction leaves a few ulps; a
    # bf16 p can then round one ulp apart
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    for a, r in zip((p, m), ref):
        diff = (a.float() - r.float()).abs()
        assert bool((diff <= tol * (1 + r.float().abs())).all())


def test_sgd_multi_leaf_kernel_matches_plain(cuda):
    """1,100 leaves of two p dtypes in one ``fused_sgd_multi_cuda``: two
    calls (one a dtype), each more rows than one launch's 512, sizes from
    0 to 70,000 and some views at odd element offsets, each leaf held as
    in the one-leaf test."""
    from tpu_dist_torch.ops import pallas_sgd as sgd

    gen = torch.Generator(device=cuda).manual_seed(1100)
    sizes = (0, 1, 3, 5, 64, 4097, 70_000)
    ps, gs, ms = [], [], []
    for i in range(1100):
        n, off = sizes[i % len(sizes)], (1 + i % 3 if i % 7 == 3 else 0)
        dtype = (torch.float32, torch.bfloat16)[i % 2]
        ps.append(torch.randn(n + off, generator=gen, device=cuda)
                  .to(dtype)[off:])
        gs.append(torch.randn(n, generator=gen, device=cuda))
        ms.append(torch.randn(n, generator=gen, device=cuda) * 0.1)
    row = sgd.scalar_row(0.1, 0.9, 1e-4, torch.tensor(0.3, device=cuda))
    ref = [[p.clone() for p in ps], [m.clone() for m in ms]]
    kernels.reset_launches()
    sgd.fused_sgd_multi_cuda(ps, gs, ms, row)
    assert kernels.LAUNCHES["sgd"] == 2
    for i in range(len(ps)):
        sgd.fused_sgd_plain(ref[0][i], gs[i], ref[1][i], row)
        tol = 1e-6 if ps[i].dtype == torch.float32 else 2e-2
        for a, r in ((ps[i], ref[0][i]), (ms[i], ref[1][i])):
            diff = (a.float() - r.float()).abs()
            assert bool((diff <= tol * (1 + r.float().abs())).all()), i


def test_sgd_wrapper_refuses_bad_input(cuda):
    from tpu_dist_torch.ops import pallas_sgd as sgd

    p = torch.zeros(10, device=cuda)
    row = torch.zeros(4, device=cuda)
    kernels.reset_launches()
    with pytest.raises(TypeError, match="float32"):
        sgd.fused_sgd_cuda(p, p.half(), p, row)
    with pytest.raises(TypeError, match="bfloat16"):
        sgd.fused_sgd_cuda(p.double(), p, p, row)
    with pytest.raises(ValueError, match="CUDA"):
        sgd.fused_sgd_cuda(p, p, p.cpu(), row)
    with pytest.raises(ValueError, match="shapes"):
        sgd.fused_sgd_cuda(p, p[:5], p, row)
    with pytest.raises(ValueError, match="4 entries"):
        sgd.fused_sgd_cuda(p, p, p.clone(), torch.zeros(8, device=cuda))
    assert kernels.LAUNCHES["sgd"] == 0


def test_image_training_on_the_card_equals_the_cpu_path(cuda, tmp_path):
    """A tiny fp32 ResNet-18 with ``fused_sgd``: 4 steps on the card (the
    sgd kernel) and on the CPU (its plain version) from the same weights.
    Losses within 1e-4 * (1 + |loss|): cuDNN and the CPU sum convolutions
    in other orders, and BatchNorm's backward carries that over steps."""
    import json

    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine.loop import Trainer
    from tpu_dist_torch.interop import export_flax_image_params
    from tpu_dist_torch.models.resnet import ResNet18

    torch.backends.cudnn.allow_tf32 = False
    init, stats = export_flax_image_params(ResNet18(device="cpu", seed=3))
    losses = {}
    for dev in ("cpu", cuda):
        path = str(tmp_path / f"{dev}.jsonl")
        cfg = TrainConfig(arch="resnet18", batch_size=16, epochs=1,
                          synth_train_size=64, synth_val_size=32,
                          precision="fp32", optimizer="fused_sgd", seed=0,
                          print_freq=1, workers=1, log_csv="",
                          data=str(tmp_path / "no-data"),
                          checkpoint_dir="", ledger_path=path)
        kernels.reset_launches()
        tr = Trainer(cfg, device=dev, init_params=init,
                     init_batch_stats=stats)
        tr.fit()
        with open(path) as f:
            losses[dev] = [r["loss"] for r in map(json.loads, f)
                           if r["event"] == "step"]
    assert kernels.LAUNCHES["sgd"] == 4          # one call a step
    assert len(losses[cuda]) == len(losses["cpu"]) == 4
    for a, r in zip(losses[cuda], losses["cpu"]):
        assert abs(a - r) <= 1e-4 * (1 + abs(r))


# ---- the fused int8 matmul and the int8-K/V flash forward ---------------

def plant_ties(x, w):
    """Row 0 of x and column 0 of w get amax 0.84375 and an element of
    half that: its quotient by the scale is exactly +-63.5 (rint: +-64),
    where the product with the scale's reciprocal is 63.499996 (63)."""
    x[0] = x[0].clamp(-0.8, 0.8)
    x[0, 0], x[0, -1] = 0.84375, -0.421875
    w[:, 0] = w[:, 0].clamp(-0.8, 0.8)
    w[0, 0], w[-1, 0] = -0.84375, 0.421875


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("m,k,n", [(8, 64, 72), (130, 70, 136),
                                   (3, 4096, 40), (1, 1, 1),
                                   (8, 4096, 1000),     # split-K decode
                                   (200, 1000, 300)],   # ragged K, M > 16
                         ids=str)
def test_fused_quant_kernel_matches_plain(cuda, dtype, m, k, n):
    """Bit-equal: int32 sums are exact and the scales, the dequant and
    the one rounding to the output type are the same fp32 operations;
    half-integer quotients that a reciprocal multiply rounds the other way
    are planted in row 0 of x and column 0 of w where K > 1."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = (torch.randn((m, k), generator=gen, device=cuda) * 2).to(dtype)
    w = torch.randn((k, n), generator=gen, device=cuda).to(dtype)
    if k > 1:
        plant_ties(x, w)
    if m > 1:
        x[1] = 0                               # all-zero row: exact zeros
    out = pq.fused_quant_cuda(x, w)
    ref = pq.fused_quant_matmul_plain(x, w)
    assert out.dtype == dtype and torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("m,k,n", [(8, 4096, 1000), (200, 1000, 300)],
                         ids=str)
def test_fused_quant_scaled_pair_matches_plain(cuda, dtype, m, k, n):
    """The scales and product phases apart (gspmd tp's row products):
    the maxima bit-equal to the plain version's; scaled by them, bit-equal
    to the one-call kernel; scaled by a group's larger maxima, bit-equal to
    the plain pair; one count each."""
    gen = torch.Generator(device=cuda).manual_seed(m * k + n)
    x = (torch.randn((m, k), generator=gen, device=cuda) * 2).to(dtype)
    w = torch.randn((k, n), generator=gen, device=cuda).to(dtype)
    plant_ties(x, w)
    kernels.reset_launches()
    xa, wa = pq.fused_quant_amax_cuda(x, w)
    pxa, pwa = pq.fused_quant_amax_plain(x, w)
    assert torch.equal(xa, pxa) and torch.equal(wa, pwa)
    assert torch.equal(pq.fused_quant_scaled_cuda(x, w, xa, wa),
                       pq.fused_quant_cuda(x, w))
    gxa = xa * (1 + torch.rand(m, generator=gen, device=cuda))
    gwa = wa * (1 + torch.rand(n, generator=gen, device=cuda))
    out = pq.fused_quant_scaled_cuda(x, w, gxa, gwa)
    assert out.dtype == dtype and torch.equal(
        out, pq.fused_quant_scaled_plain(x, w, gxa, gwa))
    assert kernels.LAUNCHES["fused_quant_amax"] == 1
    assert kernels.LAUNCHES["fused_quant_scaled"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("case", [
    # (b, lq, lk, h, d, causal, q_offset, kv_offset)
    (2, 100, 100, 2, 64, True, 0, 0),
    (1, 70, 130, 3, 128, False, 0, 0),
    (1, 64, 64, 2, 128, True, 0, 40),     # fully masked rows: exact zeros
    (2, 40, 96, 1, 64, True, 56, 0),
    (2, 130, 200, 2, 64, True, 0, 40),    # several q tiles, dead rows
    (1, 1000, 1000, 2, 128, False, 24, 0),
    # head dims 16, 32, and 48 and 80 at run time
    (2, 130, 200, 2, 16, True, 0, 40),
    (1, 70, 130, 3, 32, False, 0, 0),
    (2, 100, 100, 2, 48, True, 0, 0),
    (1, 130, 130, 2, 80, True, 24, 0),
], ids=str)
def test_int8kv_flash_kernel_matches_plain(cuda, dtype, case):
    b, lq, lk, h, d, causal, qo, ko = case
    gen = torch.Generator(device=cuda).manual_seed(lq * 3 + lk)
    q = torch.randn((b, lq, h, d), generator=gen, device=cuda).to(dtype)
    kv = fa.quantize_kv(*(torch.randn((b, lk, h, d), generator=gen,
                                      device=cuda) for _ in range(2)))
    out = fa.int8kv_flash_cuda(q, kv, causal, qo, ko)
    ref = fa.int8kv_flash_plain(q, kv, causal, qo, ko)
    assert out.dtype == dtype
    _close(out, ref, dtype)
    assert torch.equal((ref == 0).all(-1), (out == 0).all(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_fused_quant_every_ir_tile_is_bit_equal(cuda, dtype):
    """Every compiled GEMM tile, at bk 0 and with K split over blocks
    (bk 128, 256), and IR-legal tiles outside them (the general instance:
    bm 8 and 24 inside an m16 fragment, tiles larger than the shape) give
    the default tile's bits and the plain version's at a ragged shape; a
    tile the plan IR refuses is refused by the IR."""
    from tpu_dist_torch.plan.ir import PlanError

    gen = torch.Generator(device=cuda).manual_seed(17)
    x = (torch.randn((200, 700), generator=gen, device=cuda) * 2).to(dtype)
    w = torch.randn((700, 300), generator=gen, device=cuda).to(dtype)
    ref = pq.fused_quant_matmul_plain(x, w)
    try:
        for bm, bn in pq.INSTANTIATED_TILES:
            for bk in (0, 128, 256):
                pq.set_quant_blocks(bm, bn, bk)
                assert torch.equal(pq.fused_quant_cuda(x, w), ref), \
                    (bm, bn, bk)
        for tile in ((8, 128, 0), (24, 384, 128), (64, 128, 0),
                     (192, 256, 128), (512, 128, 0), (128, 640, 256)):
            pq.set_quant_blocks(*tile)
            assert torch.equal(pq.fused_quant_cuda(x, w), ref), tile
        with pytest.raises(PlanError, match="quant_block bm=12"):
            pq.set_quant_blocks(12, 128, 0)
    finally:
        pq.set_quant_blocks()


def test_optimizer_chunks_follow_block_rows_on_the_card(cuda):
    """sgd.cu and adamw.cu at opt_block_rows 8, 512 and 1024: bit-equal
    across the values over leaves of several chunks and ragged tails."""
    from tpu_dist_torch.ops import pallas_sgd as sgd

    gen = torch.Generator(device=cuda).manual_seed(18)
    sizes = (1, 63, 65, 4097, 9000, 70_000)
    leaves = [[torch.randn(n, generator=gen, device=cuda) for n in sizes]
              for _ in range(3)]
    leaves.append([torch.rand(n, generator=gen, device=cuda) * 0.1
                   for n in sizes])            # v >= 0: no NaN from sqrt
    srow = sgd.scalar_row(0.1, 0.9, 1e-4, torch.tensor(0.3, device=cuda))
    arow = adamw.scalar_row(1e-3, 0.9, 0.95, 1e-8, 0.1, 3,
                            torch.tensor(0.5, device=cuda))
    outs = {}
    try:
        for rows in (512, 8, 1024):
            sgd.set_block_rows(rows)
            p, g, m, v = ([t.clone() for t in ts] for ts in leaves)
            sgd.fused_sgd_multi_cuda(p, g, m, srow)
            ap, am, av = ([t.clone() for t in ts] for ts in
                          (leaves[0], leaves[2], leaves[3]))
            adamw.fused_adamw_multi_cuda(ap, g, am, av, arow)
            outs[rows] = p + m + ap + am + av
    finally:
        sgd.set_block_rows()
    for rows in (8, 1024):
        assert all(torch.equal(a, b) for a, b in zip(outs[rows], outs[512]))


def test_fused_quant_refuses_k_past_the_int32_limit(cuda):
    """K = 133,145 > (2^31 - 1) // 127^2: int32 sums could overflow where
    the plain version (float64) would not, so the wrapper raises before
    any launch."""
    k = pq.MAX_K + 1
    x = torch.ones((1, k), dtype=torch.bfloat16, device=cuda)
    w = torch.ones((k, 1), dtype=torch.bfloat16, device=cuda)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="133144"):
        pq.fused_quant_cuda(x, w)
    assert k == 133_145 and kernels.LAUNCHES["fused_quant"] == 0


def test_quant_wrappers_count_launches_and_refuse_bad_input(cuda):
    kernels.reset_launches()
    x = torch.randn((2, 3, 16), device=cuda, requires_grad=True)
    w = torch.randn((16, 8), device=cuda, requires_grad=True)
    y = pq.fused_quant_matmul(x, w)              # leading dims fold: 1 launch
    assert y.shape == (2, 3, 8) and kernels.LAUNCHES["fused_quant"] == 1
    y.sum().backward()                           # STE: no kernel launch
    torch.testing.assert_close(w.grad, x.detach().reshape(6, 16).t()
                               @ torch.ones(6, 8, device=cuda))
    with pytest.raises(ValueError, match="K"):
        pq.fused_quant_cuda(torch.zeros(2, 8, device=cuda),
                            torch.zeros(4, 8, device=cuda))
    with pytest.raises(TypeError):
        pq.fused_quant_cuda(torch.zeros(2, 8, device=cuda).half(),
                            torch.zeros(8, 4, device=cuda).half())
    q = torch.randn((1, 8, 1, 64), device=cuda)
    kv = fa.quantize_kv(q, q)
    fa.int8kv_flash_attention_fn()(q, kv)
    assert kernels.LAUNCHES["flash_fwd_int8kv"] == 1
    with pytest.raises(TypeError, match="int8"):
        fa.int8kv_flash_cuda(q, (q, kv[1], q, kv[3]))
    assert kernels.LAUNCHES["fused_quant"] == 1
    assert kernels.LAUNCHES["flash_fwd_int8kv"] == 1


@pytest.mark.parametrize("kw", [
    dict(quant="int8"),
    dict(quant="int8", kv_quant="int8", attn_read="flash"),
    dict(spec_k=3, kv_quant="int8", attn_read="flash"),
    dict(spec_k=2, quant="int8", prefix_cache=True),
], ids=str)
def test_int8_and_spec_serving_on_the_card_equal_the_cpu_path(cuda, kw):
    """The same greedy tokens on the card (kernels) and the CPU (plain
    versions), with the fused int8 kernel launched once per dense layer
    per forward: 2 layers x 4 + lm_head = 9, and a speculative tick runs
    k draft forwards and one verify (self-speculation: a prefill runs the
    base and the draft)."""
    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.models.transformer import tiny_lm

    geom = dict(vocab_size=64, num_layers=2, d_model=128, num_heads=2,
                max_len=48, attn_fn=fa.flash_attention_fn())
    cpu_lm = tiny_lm(device="cpu", seed=6, **geom)
    gpu_lm = tiny_lm(device=cuda, seed=None, **geom)
    gpu_lm.load_state_dict(cpu_lm.state_dict())
    cfg = ServeConfig(max_slots=2, page_size=8, num_pages=24, **kw)
    prompts = [np.arange(n, dtype=np.int32) * 5 % 64 for n in (3, 17, 9, 3)]
    reqs = lambda: [DecodeRequest(i, p, 12) for i, p in enumerate(prompts)]
    got = {}
    for dev, lm in (("cpu", cpu_lm), (cuda, gpu_lm)):
        kernels.reset_launches()
        eng = ServeEngine(lm, cfg, device=dev)
        got[dev] = {c.rid: c.tokens for c in eng.run(reqs())}
    k = kw.get("spec_k", 0)
    forwards = (eng.prefills * 2 + eng.ticks * (k + 1) if k
                else eng.prefills + eng.ticks)
    if kw.get("quant") == "int8":
        assert kernels.LAUNCHES["fused_quant"] == 9 * forwards
    if k:
        assert eng.accepted_per_tick > 1.0
        assert kernels.LAUNCHES["paged_decode"] == 0   # verify: Lq = k + 1
    elif kw.get("attn_read") == "flash":
        assert kernels.LAUNCHES["paged_decode"] == 2 * eng.ticks
    for rid, toks in got["cpu"].items():
        np.testing.assert_array_equal(toks, got[cuda][rid])


def test_int8_training_on_the_card_equals_the_cpu_path(cuda, tmp_path):
    """A tiny fp32 LMTrainer(quant="int8") with sgd, 4 steps on the card
    (the fused kernel forward, STE backward) and on the CPU (its plain
    version) from the same weights. The fp32 activations entering each
    quantized layer differ by summation order (cuBLAS and the card's
    attention against the CPU's), and a difference across an int8 rounding
    boundary flips that int8 value by one step, from step 0 on: losses
    are held within 1e-3 * (1 + |loss|)."""
    import json

    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.interop import export_flax_params
    from tpu_dist_torch.models.transformer import tiny_lm

    init = export_flax_params(tiny_lm(vocab_size=64, num_layers=2,
                                      d_model=64, num_heads=1, max_len=80,
                                      device="cpu", seed=2))
    losses, fused = {}, {}
    for dev in ("cpu", cuda):
        path = str(tmp_path / f"{dev}.jsonl")
        cfg = LMConfig(batch_size=4, seq_len=80, d_model=64, num_layers=2,
                       num_heads=1, vocab_size=64, synth_tokens=3000,
                       quant="int8", optimizer="sgd", lr=1e-2, max_steps=4,
                       print_freq=2, ledger_path=path)
        kernels.reset_launches()
        LMTrainer(cfg, device=dev, init_params=init).fit()
        with open(path) as f:
            steps = [r for r in map(json.loads, f) if r["event"] == "step"]
        losses[dev] = [r["loss"] for r in steps]
        fused[dev] = {r["fused"] for r in steps}
    assert fused == {"cpu": {False}, cuda: {True}}
    assert kernels.LAUNCHES["fused_quant"] >= 9 * 4
    for a, r in zip(losses[cuda], losses["cpu"]):
        assert abs(a - r) <= 1e-3 * (1 + abs(r))


# ---- the one-device training knobs ----------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_chunked_xent_on_the_card_equals_the_cpu_path(cuda, dtype):
    """The chunked head and its backward on the card against the same
    function on the CPU. fp32 (TF32 off): summation order, 1e-4 relative.
    bf16 operands: the card's product (``out_dtype`` or the upcast) and the
    CPU's upcast differ by summation order before the backward rounds
    softmax - onehot to bf16, so the gradients agree within 2^-8 of their
    largest entry."""
    from tpu_dist_torch.ops.f32_product import mm_route
    from tpu_dist_torch.ops.fused_xent import chunked_softmax_xent

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 100, 64, generator=gen)
    w = torch.randn(64, 1000, generator=gen) * 0.1
    t = torch.randint(0, 1000, (2, 100), generator=gen)
    m = torch.ones(2, 100)
    m[1, 90:] = 0
    out = {}
    for dev in ("cpu", cuda):
        xs = x.to(dev).requires_grad_(True)
        ws = w.to(dev).requires_grad_(True)
        loss, hits = chunked_softmax_xent(xs, ws, t.to(dev), m.to(dev), 64,
                                          dtype)
        out[str(dev)] = (loss.item(), hits.item(),
                         *(g.cpu() for g in torch.autograd.grad(loss,
                                                                (xs, ws))))
    got, want = out["cuda"], out["cpu"]
    assert got[0] == pytest.approx(want[0], rel=1e-4)
    assert abs(got[1] - want[1]) <= 1          # an argmax near-tie may flip
    for g, r in zip(got[2:], want[2:]):
        tol = 1e-4 * r.abs().max() if dtype == torch.float32 else \
            2 ** -8 * r.abs().max()
        assert (g - r).abs().max() <= tol
    assert mm_route(cuda, dtype) in ("fp32", "out_dtype", "upcast")


def test_blockwise_on_the_card_launches_no_kernel(cuda):
    q, k, v = (torch.randn(1, 96, 2, 64, device=cuda) for _ in range(3))
    kernels.reset_launches()
    out = fa.blockwise_attention_fn(64)(q, k, v, q_offset=8)
    ref = fa.blockwise_attention_fn(64)(q.cpu(), k.cpu(), v.cpu(),
                                        q_offset=8)
    assert sum(kernels.LAUNCHES.values()) == 0
    _close(out.cpu(), ref, torch.float32)


def test_lm_windows_chunk_accum_on_the_card_equal_the_cpu_path(cuda,
                                                               tmp_path):
    """A tiny fp32 LM trainer with 4-step windows over device rows and the
    chunked head, then one with 2-way accumulation: the card (kernels) and
    the CPU (plain versions) from the same weights, losses within 1e-4 *
    (1 + |loss|) (see the test above); one adamw launch per optimizer
    step and one flash backward pair per layer per microbatch."""
    import json

    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.interop import export_flax_params
    from tpu_dist_torch.models.transformer import tiny_lm

    torch.backends.cuda.matmul.allow_tf32 = False
    init = export_flax_params(tiny_lm(vocab_size=64, num_layers=2,
                                      d_model=64, num_heads=1, max_len=80,
                                      device="cpu", seed=2))
    for knobs, micro in ((dict(steps_per_dispatch=4, data_placement="device",
                               loss_chunk=100), 1),
                         (dict(grad_accum_steps=2, loss_chunk=100), 2)):
        losses = {}
        for dev in ("cpu", cuda):
            path = str(tmp_path / f"{dev}.jsonl")
            cfg = LMConfig(batch_size=4, seq_len=80, d_model=64,
                           num_layers=2, num_heads=1, vocab_size=64,
                           synth_tokens=3000, attn="flash",
                           optimizer="fused_adamw", lr=3e-3, grad_clip=0.5,
                           max_steps=4, print_freq=1, ledger_path=path,
                           **knobs)
            kernels.reset_launches()
            LMTrainer(cfg, device=dev, init_params=init).fit()
            with open(path) as f:
                losses[dev] = [r["loss"] for r in map(json.loads, f)
                               if r["event"] == "step"]
        assert kernels.LAUNCHES["adamw"] == 4
        assert kernels.LAUNCHES["flash_bwd_dq"] == 2 * 4 * micro
        assert len(losses[cuda]) == len(losses["cpu"])
        for a, r in zip(losses[cuda], losses["cpu"]):
            assert abs(a - r) <= 1e-4 * (1 + abs(r))


def test_image_accum_and_loss_scale_on_the_card(cuda, tmp_path):
    """ResNet-18 with 2-way accumulation and a 2^15 loss scale: 4 steps on
    the card and the CPU from the same weights (losses within 1e-4 * (1 +
    |loss|), as the plain image test), one sgd launch per step."""
    import json

    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine.loop import Trainer
    from tpu_dist_torch.interop import export_flax_image_params
    from tpu_dist_torch.models.resnet import ResNet18

    torch.backends.cudnn.allow_tf32 = False
    init, stats = export_flax_image_params(ResNet18(device="cpu", seed=3))
    losses = {}
    for dev in ("cpu", cuda):
        path = str(tmp_path / f"{dev}.jsonl")
        cfg = TrainConfig(arch="resnet18", batch_size=16, epochs=1,
                          synth_train_size=64, synth_val_size=32,
                          precision="fp32", optimizer="fused_sgd", seed=0,
                          print_freq=1, workers=1, log_csv="",
                          grad_accum_steps=2, loss_scale=2.0 ** 15,
                          data=str(tmp_path / "no-data"),
                          checkpoint_dir="", ledger_path=path)
        kernels.reset_launches()
        tr = Trainer(cfg, device=dev, init_params=init,
                     init_batch_stats=stats)
        tr.fit()
        with open(path) as f:
            losses[dev] = [r["loss"] for r in map(json.loads, f)
                           if r["event"] == "step"]
    assert kernels.LAUNCHES["sgd"] == 4
    assert int(tr.state.loss_scale.good_steps) == 4
    for a, r in zip(losses[cuda], losses["cpu"]):
        assert abs(a - r) <= 1e-4 * (1 + abs(r))


# ---- multi-process data parallelism on the card ----------------------------

DP_TINY = dict(arch="resnet18", dataset="cifar10", batch_size=16, epochs=1,
               synth_train_size=64, synth_val_size=32, precision="fp32",
               optimizer="fused_sgd", seed=0, print_freq=1, workers=1,
               log_csv="")


def test_nccl_world1_through_launch_initialize(cuda, tmp_path):
    """One rank over nccl: every collective runs on the card (the sums of
    one rank), and a tiny fp32 ``jit`` run through the group equals the
    same run without one (one ``sgd`` launch a step)."""
    from torch_dp_worker import run_group

    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine.loop import Trainer

    jobs = [{"name": "c", "kind": "collectives", "seed": 0,
             "shapes": [[37], [3, 5]], "bucket_mb": 0.0001},
            {"name": "jit", "kind": "image",
             "cfg": dict(DP_TINY, data=str(tmp_path / "no-data"))}]
    (res,) = run_group(1, {"device": "cuda", "backend": "nccl",
                           "jobs": jobs}, str(tmp_path / "nccl"))
    c = res["c"]
    for key in ("reduce_mean", "ring", "psum", "bucketed_rs_ag",
                "adasum_leaf"):
        assert len(c[key]) == 2, key
    assert c["bench"]["us"] > 0
    assert res["jit"]["step"] == 4 and res["jit"]["world"] == 1
    torch.backends.cudnn.allow_tf32 = False
    path = str(tmp_path / "alone.jsonl")
    Trainer(TrainConfig(**DP_TINY, data=str(tmp_path / "no-data"),
                        checkpoint_dir="", ledger_path=path),
            device=cuda).fit()
    import json

    with open(path) as f:
        alone = [r["loss"] for r in map(json.loads, f)
                 if r["event"] == "step"]
    for a, r in zip(res["jit"]["losses"], alone):
        assert abs(a - r) <= 1e-4 * (1 + abs(r))


@pytest.mark.parametrize("variant", ["jit", "shard_map"])
def test_two_gloo_ranks_on_the_card_equal_their_cpu_twin(cuda, tmp_path,
                                                         variant):
    """2 ranks on one card over gloo (CUDA tensors) against 2 gloo ranks on
    the CPU, from the same initial weights: the sgd kernel on each rank's
    synced grads, per-step losses within 1e-4 (1 + |loss|); point-to-point
    collectives refuse CUDA tensors on gloo."""
    from torch_dp_worker import run_group

    from tpu_dist_torch.interop import export_flax_image_params
    from tpu_dist_torch.models.resnet import ResNet18

    init = str(tmp_path / "init.npz")
    params, stats = export_flax_image_params(ResNet18(device="cpu", seed=3))
    np.savez(init, tree=np.array({"params": params, "batch_stats": stats},
                                 dtype=object))
    cfg = dict(DP_TINY, mesh_shape=[2], data=str(tmp_path / "no-data"),
               **({"variant": "shard_map", "gradient_predivide_factor": 2.0}
                  if variant == "shard_map" else {}))
    job = [{"name": "run", "kind": "image", "cfg": cfg, "init": init}]
    card = run_group(2, {"device": "cuda", "backend": "gloo", "jobs": job},
                     str(tmp_path / "card"))
    cpu = run_group(2, {"jobs": job}, str(tmp_path / "cpu"))
    assert card[0]["run"]["step"] == cpu[0]["run"]["step"] == 4
    for a, r in zip(card[0]["run"]["losses"], cpu[0]["run"]["losses"]):
        assert abs(a - r) <= 1e-4 * (1 + abs(r))
    assert card[0]["run"]["best"] == card[1]["run"]["best"]
    assert [r["run"]["launches"]["sgd"] for r in card] == [4, 4]


def test_gloo_refuses_point_to_point_on_cuda_tensors(cuda):
    from unittest import mock

    from tpu_dist_torch.parallel import collectives as C

    with mock.patch.object(C, "backend_of", return_value="gloo"):
        with pytest.raises(NotImplementedError, match="gloo"):
            C.refuse_p2p_on_gloo_cuda("ring_allreduce",
                                      [torch.zeros(2, device=cuda)])


def test_ring_attention_stages_through_the_host_on_the_card(cuda, tmp_path):
    """2 gloo ranks on one card: ring attention's ppermute takes the
    host-staged route (gloo aborts on CUDA point to point) and gives the
    CPU ranks' chunks and gradients within 1e-5 (1 + |x|)."""
    from torch_dp_worker import run_group

    job = [{"name": "ring", "kind": "ring_attention", "seed": 0,
            "shape": [2, 64, 2, 64]}]
    card = run_group(2, {"device": "cuda", "backend": "gloo", "jobs": job},
                     str(tmp_path / "card"))
    cpu = run_group(2, {"jobs": job}, str(tmp_path / "cpu"))
    assert {r["ring"]["route"] for r in card} == {"host-staged"}
    for c, p in zip(card, cpu):
        for causal in ("causal=True", "causal=False"):
            for key, got in c["ring"][causal].items():
                want = np.asarray(p["ring"][causal][key])
                assert np.all(np.abs(np.asarray(got) - want)
                              <= 1e-5 * (1 + np.abs(want))), (causal, key)


def test_model_parallel_modes_on_the_card_equal_their_cpu_twins(cuda,
                                                                tmp_path):
    """fsdp, tp, tp-ring, sp-ring and ep-moe on 2 gloo ranks sharing the
    card against 2 gloo ranks on the CPU, from the same initial weights:
    per-step losses within 1e-4 (1 + |loss|), the reference's mode
    strings, one adamw launch a step on each card rank."""
    from torch_dp_worker import run_group

    from tpu_dist_torch.interop import export_flax_params
    from tpu_dist_torch.models.moe import MoETransformerLM

    base = dict(batch_size=4, seq_len=64, d_model=128, num_layers=2,
                num_heads=2, vocab_size=64, synth_tokens=3000, seed=1,
                attn="flash", optimizer="fused_adamw", lr=3e-3,
                grad_clip=0.5, max_steps=3, print_freq=1)
    # one set of initial weights for the card and the CPU (their
    # generators of one seed give different numbers)
    from tpu_dist_torch.models.transformer import TransformerLM

    inits = {}
    for name, model in (
            ("dense", TransformerLM(vocab_size=64, num_layers=2, d_model=128,
                                    num_heads=2, max_len=64, device="cpu",
                                    seed=1)),
            ("moe", MoETransformerLM(vocab_size=64, num_layers=2,
                                     d_model=128, num_heads=2, num_experts=4,
                                     max_len=64, device="cpu", seed=1))):
        inits[name] = str(tmp_path / f"{name}.npz")
        np.savez(inits[name], tree=np.array(export_flax_params(model),
                                            dtype=object))
    dense = {"fsdp": dict(mesh_shape=[2], mesh_axes=["data"], fsdp=True),
             "tp": dict(mesh_shape=[1, 2], mesh_axes=["data", "model"]),
             "tp-ring": dict(mesh_shape=[1, 2], mesh_axes=["data", "model"],
                             tp_impl="ring"),
             "sp-ring": dict(mesh_shape=[1, 2], mesh_axes=["data", "seq"])}
    jobs = [{"name": m, "kind": "lm", "init": inits["dense"],
             "cfg": dict(base, **kw)} for m, kw in dense.items()]
    jobs.append({"name": "ep-moe", "kind": "lm", "init": inits["moe"],
                 "cfg": dict(base, mesh_shape=[1, 2],
                             mesh_axes=["data", "expert"], num_experts=4,
                             moe_group_size=64)})
    card = run_group(2, {"device": "cuda", "backend": "gloo",
                         "jobs": jobs}, str(tmp_path / "card"))
    cpu = run_group(2, {"jobs": jobs}, str(tmp_path / "cpu"))
    for job in jobs:
        m = job["name"]
        assert {r[m]["mode"] for r in card} == {m}
        assert [r[m]["launches"]["adamw"] for r in card] == [3, 3]
        got, want = card[0][m]["losses"], cpu[0][m]["losses"]
        assert len(got) == len(want) == 3
        for a, r in zip(got, want):
            assert abs(a - r) <= 1e-4 * (1 + abs(r)), (m, got, want)


# ---- restart and faults on the card ---------------------------------------

RESTART_TINY = dict(batch_size=4, seq_len=64, d_model=128, num_layers=2,
                    num_heads=2, vocab_size=64, synth_tokens=3000, seed=1,
                    attn="flash", optimizer="fused_adamw", lr=3e-3,
                    grad_clip=0.5, precision="fp32", print_freq=1)


def test_poison_and_enospc_on_cuda_state(cuda, tmp_path):
    """``nan_batch``'s effect poisons the first fp32 master in place on the
    card, and ``ckpt_enospc`` leaves the previous checkpoint of a CUDA
    state the newest valid one, which reloads onto the card."""
    from tpu_dist_torch.engine import checkpoint as ckpt
    from tpu_dist_torch.engine.state import TrainState
    from tpu_dist_torch.obs import faults
    from tpu_dist_torch.ops.optim import make_optimizer
    from tpu_dist_torch.parallel.supervisor import latest_checkpoint

    model = torch.nn.Linear(8, 4).to(cuda)
    st = TrainState.create(model, make_optimizer(0.1, 0.9, 0.0))
    st.step = 3
    d = str(tmp_path)
    ckpt.save_checkpoint(d, st, 1, 0.0, "lm", False)
    want = [p.detach().clone() for p in st.params]
    faults._reset_for_tests()
    try:
        faults.install("ckpt_enospc@nth=1")
        st.step = 9
        faults.poison_params(st.params)
        assert st.params[0].is_cuda and torch.isnan(st.params[0]).all()
        assert torch.equal(st.params[1], want[1])
        with pytest.raises(OSError, match="injected"):
            ckpt.save_checkpoint(d, st, 2, 0.0, "lm", False)
    finally:
        faults._reset_for_tests()
    ckpt.load_checkpoint(latest_checkpoint(d), st)
    assert st.step == 3
    assert all(torch.equal(p, w) for p, w in zip(st.params, want))


def test_peer_restore_and_preemption_on_two_gloo_ranks(cuda, tmp_path):
    """Two ranks sharing the card over gloo (CUDA tensors): rank 0 resumes
    a step-5 preemption snapshot, rank 1 has none; under
    ``TPU_DIST_PEER_RESUME=1`` rank 1 adopts rank 0's params and step
    (``sum_bytes`` over CUDA bytes), and both take the same losses. A
    ``preempt_deadline`` on rank 1 alone ends both ranks at one step with
    exit 75."""
    from torch_dp_worker import run_group

    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.obs import faults
    from tpu_dist_torch.parallel.supervisor import latest_checkpoint

    ck = str(tmp_path / "ck")
    faults._reset_for_tests()
    try:
        tr = LMTrainer(LMConfig(**RESTART_TINY, max_steps=8,
                                checkpoint_dir=ck,
                                faults="preempt_deadline@step=5"),
                       device="cuda")
        with pytest.raises(SystemExit):
            tr.fit()
    finally:
        faults._reset_for_tests()
    cfg = dict(RESTART_TINY, max_steps=8)
    del cfg["seed"]
    res = run_group(2, {"device": "cuda", "backend": "gloo", "jobs": [
        {"kind": "restart", "name": "peer", "peer": True, "seeds": [1, 1],
         "resume": {"0": latest_checkpoint(ck)}, "cfg": cfg},
        {"kind": "restart", "name": "agree", "seeds": [1, 1],
         "faults": {"1": "preempt_deadline@step=2"},
         "cfg": dict(cfg, print_freq=2, checkpoint_dir="ck-agree")}]},
        str(tmp_path / "card"))
    p0, p1 = res[0]["peer"], res[1]["peer"]
    assert p0["step0"] == p1["step0"] == 5
    assert p0["digest0"] == p1["digest0"]
    assert p0["losses"] == p1["losses"] and len(p0["losses"]) == 3
    a0, a1 = res[0]["agree"], res[1]["agree"]
    assert a0["code"] == a1["code"] == 75
    assert a0["run_end"]["snapshot_step"] == \
        a1["run_end"]["snapshot_step"] == 3


def test_fleet_workers_launch_paged_decode_on_the_card(cuda, tmp_path):
    """A short two-host FleetSim with its workers on the card (int8 pages,
    the flash read): each attempt's ``run_end`` counts ``paged_decode``
    once per layer per decode tick."""
    import json

    from tpu_dist_torch.obs.ledger import read_ledger
    from tpu_dist_torch.sim.runner import FleetSim

    layers = 2
    doc = {"name": "card-fleet", "seed": 3, "hosts": 2, "ticks": 40,
           "tick_s": 0.01,
           "model": {"vocab_size": 64, "num_layers": layers,
                     "d_model": 128, "num_heads": 2, "max_len": 64},
           "serve": {"max_slots": 2, "page_size": 16, "num_pages": 32,
                     "kv_quant": "int8", "attn_read": "flash"},
           "traffic": {"base_rate": 0.3,
                       "tenants": [{"name": "chat", "prompt": [2, 8],
                                    "out": [2, 6]}]}}
    path = tmp_path / "card.json"
    path.write_text(json.dumps(doc))
    report = FleetSim(str(path), str(tmp_path / "fleet"),
                      device="cuda").run()
    assert report["restart_histogram"] == {"clean": 2}
    assert report["serving"]["completed"] > 0
    for h in range(2):
        ends = [r for r in read_ledger(
            str(tmp_path / "fleet" / f"host{h}" / "run.jsonl"))
            if r["event"] == "run_end"]
        assert ends[-1]["ticks"] > 0
        assert ends[-1]["launches"]["paged_decode"] == \
            layers * ends[-1]["ticks"]
