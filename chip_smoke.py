#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (tpu_dist_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU (the
kernels are built for sm_90a with the CUDA toolkit's nvcc). Every phase
raises on failure; the script prints no result and exits non-zero without
CUDA or without the repository beside it. Phases:

1. device: name and power limit (nvidia-smi), TF32 off for matmul/cuDNN;
2. build every CUDA kernel of the port from ``tpu_dist_torch/csrc``, all
   nvcc processes started together;
3. each kernel against its plain PyTorch version on the card, at the
   shapes its main path gives it, with the error, the kernel's time (CUDA
   events, median of 20), the plain version's time, a one-call PyTorch
   yardstick (``scaled_dot_product_attention`` and its backward,
   ``torch._fused_adamw_``; timed here and used nowhere in the port) and
   the least time the card could take;
4. small-input checks: a tiny fp32 model served on the card (kernels) and
   on the CPU (plain versions) gives the same greedy tokens, and a tiny
   fp32 trainer takes 5 steps on both with the same losses;
5. serving main path: ``ServeEngine`` at the full width of the LM the repo
   benches (V=32000, 8 layers, d_model 1024, 8 heads, bf16, random
   weights from a seed), flash prefill and int8 paged decode, serving 16
   requests; the launch counts show both forward kernels ran;
6. training main path: ``LMTrainer`` at the same full width (L=2048, batch
   8, bf16 compute over fp32 masters, flash attention, ``fused_adamw``
   with grad_clip 1.0) for 20 steps: finite, falling losses, and per step
   one ``flash_bwd_dq`` and one ``flash_bwd_dkv`` launch per layer and one
   ``adamw`` launch per parameter leaf.

The line before the last is the card's name and power limit; the one
before it the ``{"kernels": [...]}`` record; the last line is
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 SIMT,
# HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# kernel vs plain version, bf16 outputs: |err| <= BF16_TOL * (1 + |plain|)
# elementwise -- the forward kernels round p and the output to bf16 where
# the plain versions keep fp32: a few bf16 ulps (2^-8 relative each). The
# backward kernels round p and ds at the same points as their plain
# version, so what is left is fp32 summation order before the bf16 outputs
# round: one ulp where a sum sits on a rounding boundary, within the same
# bound
BF16_TOL = 2e-2
# AdamW kernel vs plain, fp32 throughout: the kernel contracts mul+add into
# fma where PyTorch rounds each, a few fp32 ulps (2^-23 relative each)
FP32_TOL = 1e-6
# tiny fp32 trainer, card vs CPU: per-step losses within LOSS_TOL * (1 +
# |loss|) -- matmul summation order differs (cuBLAS vs CPU), and Adam's
# normalized update turns small gradient differences into parameter
# differences over 5 steps
LOSS_TOL = 1e-4
# the training main path (V=32000, 8 layers, d_model 1024, L=2048)
TRAIN_STEPS = 20


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3):
    """Median of ``iters`` CUDA-event timings of ``fn`` (after warmup)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bf16_err(torch, out, ref):
    """(max |out - ref|, every element within BF16_TOL * (1 + |ref|))."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= BF16_TOL * (1 + ref.float().abs())).all())
    return diff.max().item(), ok


def pctl(xs, q):
    xs = sorted(xs)
    return xs[min(int(round(q / 100.0 * (len(xs) - 1))), len(xs) - 1)]


def check_flash(torch, F, L, gen):
    from tpu_dist_torch.ops import flash_attention as fa

    b, h, d = 1, 8, 128
    q, k, v = (torch.randn((b, L, h, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_forward_cuda(q, k, v, causal=True)
    ref, ref_lse = fa.flash_forward_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err, ok = bf16_err(torch, out, ref)
    lse_err = (lse - ref_lse).abs().max().item()
    if not (ok and lse_err <= 1e-3):
        raise AssertionError(f"flash_fwd L={L}: max|out err| {err} "
                             f"(tol {BF16_TOL} (1 + |ref|)), max|lse err| "
                             f"{lse_err} (tol 1e-3)")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = time_ms(torch, lambda: fa.flash_forward_cuda(q, k, v, causal=True))
    plain_ms = time_ms(torch, lambda: fa.flash_forward_plain(q, k, v, True))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    flops = 4.0 * b * h * d * L * (L + 1) / 2          # live causal pairs
    nbytes = 4 * b * L * h * d * 2 + b * h * L * 4      # q, k, v, out + lse
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    return {"shape": f"B{b} L{L} H{h} D{d} bf16 causal",
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "tolerance": f"{BF16_TOL} * (1 + |plain|)", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                         >= nbytes / PEAK_BYTES else "bytes"),
            "library_ms": lib_ms,
            "library": "scaled_dot_product_attention(is_causal=True)"}


def check_paged(torch, F, gen):
    from tpu_dist_torch.ops import flash_attention as fa
    from tpu_dist_torch.ops import paged_attention as pa

    b, lk, h, d = 8, 2048, 8, 128
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((b, lk, h, d), generator=gen, device="cuda")
            for _ in range(2))
    kq, ks, vq, vs = fa.quantize_kv(k, v)
    lengths = torch.randint(1, lk + 1, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
    out = pa.paged_decode_cuda(q, kq, ks, vq, vs, lengths)
    ref = pa.paged_decode_plain(q, kq, ks, vq, vs, lengths)
    torch.cuda.synchronize()
    err, ok = bf16_err(torch, out, ref)
    if not ok:
        raise AssertionError(f"paged_decode: max|err| {err} "
                             f"(tol {BF16_TOL} (1 + |ref|))")
    kd = (kq.float() * ks[..., None]).to(torch.bfloat16).transpose(1, 2)
    vd = (vq.float() * vs[..., None]).to(torch.bfloat16).transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    qh = q.transpose(1, 2).contiguous()
    mask = (torch.arange(lk, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    ms = time_ms(torch, lambda: pa.paged_decode_cuda(q, kq, ks, vq, vs,
                                                     lengths))
    plain_ms = time_ms(torch, lambda: pa.paged_decode_plain(q, kq, ks, vq,
                                                            vs, lengths))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=mask))
    live = int(lengths.sum().item())                   # keys this data needs
    nbytes = live * h * (2 * d + 2 * 4) + 2 * b * h * d * 2 + b * 4
    flops = 4.0 * live * h * d
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    return {"shape": f"B{b} Lk{lk} H{h} D{d} int8 K/V, bf16 q, "
                     f"{live} live keys",
            "max_abs_err": err, "tolerance": f"{BF16_TOL} * (1 + |plain|)",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": ("bytes" if nbytes / PEAK_BYTES
                         >= flops / PEAK_FP32_FLOPS else "operations"),
            "library_ms": lib_ms,
            "library": "scaled_dot_product_attention on dequantized bf16 "
                       "K/V with the length mask"}


def live_causal_pairs(lq, lk):
    """(q, k) pairs a causal mask leaves live, row i seeing keys 0..i."""
    return sum(min(i + 1, lk) for i in range(lq))


def check_flash_bwd(torch, F, gen):
    """dq and dk/dv kernels against flash_backward_plain, B=8 H=8 L=2048
    D=128 bf16 causal: the training main path's shape."""
    from tpu_dist_torch import kernels
    from tpu_dist_torch.ops import flash_attention as fa

    b, L, h, d = 8, 2048, 8, 128
    q, k, v, g = (torch.randn((b, L, h, d), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_forward_cuda(q, k, v, causal=True)
    dq, dk, dv = fa.flash_backward_cuda(q, k, v, out, lse, g, causal=True)
    rq, rk, rv = fa.flash_backward_plain(q, k, v, out, lse, g, True)
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        errs[name], ok = bf16_err(torch, got, ref)
        if not ok:
            raise AssertionError(f"flash backward {name}: max|err| "
                                 f"{errs[name]} (tol {BF16_TOL} (1 + |ref|))")
    del rq, rk, rv
    stream = torch.cuda.current_stream().cuda_stream
    fn_dq = kernels.function("flash_bwd_dq", "tdt_flash_bwd_dq",
                             fa._BWD_DQ_ARGS)
    fn_dkv = kernels.function("flash_bwd_dkv", "tdt_flash_bwd_dkv",
                              fa._BWD_DKV_ARGS)
    delta = fa.bwd_delta(out, g)
    args = (q, k, v, g, lse, delta, True, 0, 0, stream)
    dq_ms = time_ms(torch, lambda: fa._launch_bwd_dq(fn_dq, *args))
    dkv_ms = time_ms(torch, lambda: fa._launch_bwd_dkv(fn_dkv, *args))
    plain_ms = time_ms(torch, lambda: fa.flash_backward_plain(
        q, k, v, out, lse, g, True), iters=5)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    gh = g.transpose(1, 2).contiguous()
    oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        oh, (qh, kh, vh), gh, retain_graph=True))
    live = live_causal_pairs(L, L) * b * h
    elt = b * L * h * d * 2                        # one bf16 (B, L, H, D)
    recs = {}
    for name, ms, products, tensors, errk in (
            ("flash_bwd_dq", dq_ms, 3, 5, ("dq",)),
            ("flash_bwd_dkv", dkv_ms, 4, 6, ("dk", "dv"))):
        flops = 2.0 * d * live * products
        nbytes = tensors * elt + 2 * b * h * L * 4   # + lse, delta
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        recs[name] = {
            "shape": f"B{b} L{L} H{h} D{d} bf16 causal",
            "max_abs_err": max(errs[e] for e in errk),
            "tolerance": f"{BF16_TOL} * (1 + |plain|)", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
            "note": "plain_ms and library_ms cover dq, dk and dv together",
            "library": "scaled_dot_product_attention(is_causal=True) "
                       "backward (autograd.grad)"}
    return recs


def check_adamw(torch, gen):
    """The AdamW kernel against fused_adamw_plain on the lm_head leaf
    (1024 x 32000 fp32), with the clip slot and weight decay live."""
    from tpu_dist_torch.ops import pallas_adamw as pa

    shape = (1024, 32000)
    p, g, m = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    v = torch.rand(shape, generator=gen, device="cuda")
    m, v = m * 1e-3, v * 1e-6
    row = pa.scalar_row(1e-3, 0.9, 0.95, 1e-8, 0.1, 3,
                        torch.tensor(0.5, device="cuda"))
    got = [t.clone() for t in (p, m, v)]
    ref = [t.clone() for t in (p, m, v)]
    pa.fused_adamw_cuda(got[0], g, got[1], got[2], row)
    pa.fused_adamw_plain(ref[0], g, ref[1], ref[2], row)
    torch.cuda.synchronize()
    err = 0.0
    for a, r in zip(got, ref):
        diff = (a - r).abs()
        err = max(err, diff.max().item())
        if not bool((diff <= FP32_TOL * (1 + r.abs())).all()):
            raise AssertionError(f"adamw: max|err| {diff.max().item()} (tol "
                                 f"{FP32_TOL} (1 + |ref|))")
    ms = time_ms(torch, lambda: pa.fused_adamw_cuda(*got[:1], g, *got[1:],
                                                    row))
    plain_ms = time_ms(torch, lambda: pa.fused_adamw_plain(*ref[:1], g,
                                                           *ref[1:], row))
    lib_ms = None
    if hasattr(torch, "_fused_adamw_"):
        lp, lg, lm, lv = (t.clone() for t in (p, g, m, v))
        steps = [torch.tensor(3.0, device="cuda")]
        lib_ms = time_ms(torch, lambda: torch._fused_adamw_(
            [lp], [lg], [lm], [lv], [], steps, lr=1e-3, beta1=0.9,
            beta2=0.95, weight_decay=0.1, eps=1e-8, amsgrad=False,
            maximize=False))
    n = p.numel()
    nbytes = 7 * 4 * n               # read p, g, m, v; write p, m, v
    flops = 16.0 * n
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return {"shape": f"{shape[0]}x{shape[1]} fp32 (lm_head)",
            "max_abs_err": err, "tolerance": f"{FP32_TOL} * (1 + |plain|)",
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "library": "torch._fused_adamw_ (decoupled wd, no clip)"}


def run_trainer(cfg, device, init_params=None):
    """Fit ``cfg`` on ``device``; (trainer, per-step losses from its
    ledger)."""
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.jsonl")
        cfg = dataclasses.replace(cfg, ledger_path=path)
        tr = LMTrainer(cfg, device=device, init_params=init_params)
        tr.fit()
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    return tr, [r["loss"] for r in recs if r["event"] == "step"]


def small_trainer_agreement(torch):
    """Tiny fp32 trainer, flash + fused_adamw with the clip slot: 5 steps
    on the card (kernels) and on the CPU (plain) from the same weights."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.interop import export_flax_params
    from tpu_dist_torch.models.transformer import TransformerLM

    cfg = LMConfig(batch_size=4, seq_len=96, d_model=128, num_layers=2,
                   num_heads=1, vocab_size=64, synth_tokens=4000, seed=SEED,
                   attn="flash", optimizer="fused_adamw", lr=3e-3,
                   grad_clip=0.5, weight_decay=0.1, max_steps=5,
                   print_freq=100)
    # one set of initial weights for both (the CPU and CUDA generators of
    # one seed give different numbers)
    init = export_flax_params(TransformerLM(
        vocab_size=64, num_layers=2, d_model=128, num_heads=1, max_len=96,
        device="cpu", seed=SEED))
    _, cpu_losses = run_trainer(cfg, "cpu", init)
    _, gpu_losses = run_trainer(cfg, "cuda", init)
    if len(gpu_losses) != 5 or len(cpu_losses) != 5:
        raise AssertionError(f"steps: card {len(gpu_losses)}, cpu "
                             f"{len(cpu_losses)}")
    for i, (a, r) in enumerate(zip(gpu_losses, cpu_losses)):
        if abs(a - r) > LOSS_TOL * (1 + abs(r)):
            raise AssertionError(f"step {i}: card loss {a} != plain {r} "
                                 f"(tol {LOSS_TOL} (1 + |loss|))")
    return {"card": gpu_losses, "cpu": cpu_losses,
            "max_abs_diff": max(abs(a - r) for a, r in
                                zip(gpu_losses, cpu_losses))}


def training_path(torch, kernels):
    """The training main path at full width (module docstring, phase 6)."""
    from tpu_dist_torch.configs import LMConfig

    layers = 8
    cfg = LMConfig(vocab_size=32000, num_layers=layers, d_model=1024,
                   num_heads=8, seq_len=2048, batch_size=8,
                   precision="bf16", attn="flash", optimizer="fused_adamw",
                   lr=1e-3, weight_decay=0.1, grad_clip=1.0,
                   synth_tokens=400_000, seed=SEED, max_steps=TRAIN_STEPS,
                   print_freq=5)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    tr, losses = run_trainer(cfg, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    leaves = len(tr.state.params)
    n_eval = len(tr._epoch_indices(tr.val_ds, False, 0)[0])
    if len(losses) != TRAIN_STEPS or tr.state.step != TRAIN_STEPS:
        raise AssertionError(f"trained {tr.state.step} steps, "
                             f"{len(losses)} losses")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    first, last = (statistics.mean(losses[:5]), statistics.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"losses not falling: first 5 mean {first}, "
                             f"last 5 mean {last}: {losses}")
    want = {"flash_bwd_dq": layers * TRAIN_STEPS,
            "flash_bwd_dkv": layers * TRAIN_STEPS,
            "adamw": leaves * TRAIN_STEPS,
            "flash_fwd": layers * (TRAIN_STEPS + n_eval)}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"expected {n}")
    params = sum(p.numel() for p in tr.state.params)
    # the epoch rate leaves out the first step (kernel builds and the
    # allocator's warm-up ride on it)
    tokens = cfg.batch_size * cfg.seq_len
    training = {
        "params": params, "leaves": leaves, "steps": TRAIN_STEPS,
        "losses": losses, "first5_mean": first, "last5_mean": last,
        "tokens_per_s": tr.last_tok_s,
        "step_ms": tokens / tr.last_tok_s * 1e3,
        "wall_s_incl_build_and_eval": wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "launches_per_step": {k: launches[k] / TRAIN_STEPS for k in (
            "flash_bwd_dq", "flash_bwd_dkv", "adamw")},
        "eval_batches": n_eval}
    return training, launches


def small_input_agreement(torch):
    """Tiny fp32 model: kernels on the card == plain versions on the CPU."""
    import numpy as np

    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.models.transformer import tiny_lm
    from tpu_dist_torch.ops.flash_attention import flash_attention_fn

    geom = dict(vocab_size=64, num_layers=2, d_model=256, num_heads=2,
                max_len=96, attn_fn=flash_attention_fn())
    cpu_lm = tiny_lm(device="cpu", seed=SEED, **geom)
    gpu_lm = tiny_lm(device="cuda", seed=None, **geom)
    gpu_lm.load_state_dict(cpu_lm.state_dict())
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32) for n in (5, 33, 64)]
    outs = (20, 12, 30)
    reqs = lambda: [DecodeRequest(i, p, n)
                    for i, (p, n) in enumerate(zip(prompts, outs))]
    cfg = ServeConfig(max_slots=2, page_size=16, num_pages=32,
                      kv_quant="int8", attn_read="flash")
    got = {}
    for dev, lm in (("cpu", cpu_lm), ("cuda", gpu_lm)):
        got[dev] = {c.rid: c.tokens for c in
                    ServeEngine(lm, cfg, device=dev).run(reqs())}
    for rid, toks in got["cpu"].items():
        if not np.array_equal(toks, got["cuda"][rid]):
            raise AssertionError(f"request {rid}: card tokens "
                                 f"{got['cuda'][rid].tolist()} != plain "
                                 f"{toks.tolist()}")
    return len(got["cpu"])


def main_path(torch, kernels):
    import numpy as np

    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.ops.flash_attention import flash_attention_fn

    layers = 8
    model = TransformerLM(vocab_size=32000, num_layers=layers, d_model=1024,
                          num_heads=8, max_len=2048, dtype=torch.bfloat16,
                          attn_fn=flash_attention_fn(), device="cuda",
                          seed=SEED)
    params = sum(p.numel() for p in model.parameters())
    cfg = ServeConfig(max_slots=8, page_size=16, num_pages=1024,
                      kv_quant="int8", attn_read="flash")
    rng = np.random.default_rng(SEED)
    n_req = 16
    prompts = [rng.integers(0, 32000, (int(rng.integers(16, 1025)),))
               .astype(np.int32) for _ in range(n_req)]
    outs = rng.integers(32, 129, n_req)
    reqs = lambda: [DecodeRequest(i, prompts[i], int(outs[i]))
                    for i in range(n_req)]
    # warm-up on a separate engine: cuBLAS handles, allocator, build
    ServeEngine(model, cfg).run(reqs()[:2])
    torch.cuda.synchronize()

    eng = ServeEngine(model, cfg)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    comps = eng.run(reqs())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    if len(comps) != n_req:
        raise AssertionError(f"served {len(comps)}/{n_req}")
    for c in comps:
        if c.n_generated != int(outs[c.rid]) or c.tokens.min() < 0 \
                or c.tokens.max() >= 32000:
            raise AssertionError(f"request {c.rid}: bad completion")
        np.testing.assert_array_equal(c.tokens[:c.prompt_len],
                                      prompts[c.rid])
    if eng.ticks <= 0:
        raise AssertionError("no decode tick ran")
    if launches["flash_fwd"] < eng.prefills * layers:
        raise AssertionError(f"flash_fwd launched {launches['flash_fwd']} "
                             f"times for {eng.prefills} prefills x {layers}")
    if launches["paged_decode"] < layers * eng.ticks:
        raise AssertionError(f"paged_decode launched "
                             f"{launches['paged_decode']} times for "
                             f"{eng.ticks} ticks x {layers}")
    with torch.inference_mode():
        logits = model(torch.as_tensor(prompts[0][None], device="cuda"))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits at full width")
    toks = sum(c.n_generated for c in comps)
    ttft = [c.ttft_s for c in comps]
    tpot = [(c.finish_ts - c.first_token_ts) / (c.n_generated - 1)
            for c in comps if c.n_generated > 1]
    serving = {
        "requests": n_req, "completed": len(comps), "params": params,
        "prompt_tokens": int(sum(p.size for p in prompts)),
        "generated_tokens": toks, "wall_s": wall,
        "tokens_per_s": toks / wall, "prefills": eng.prefills,
        "ticks": eng.ticks, "occupancy": eng.occupancy,
        "ttft_ms": {"p50": pctl(ttft, 50) * 1e3, "p99": pctl(ttft, 99) * 1e3},
        "tpot_ms": {"p50": pctl(tpot, 50) * 1e3, "p99": pctl(tpot, 99) * 1e3},
        "prefill_s": eng.prefill_s, "tick_s": eng.tick_s,
        "ms_per_tick": eng.tick_s / eng.ticks * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}
    return serving, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "tpu_dist_torch")):
        print("chip_smoke: run from the repository (tpu_dist_torch/ "
              "missing beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import torch.nn.functional as F

    from tpu_dist_torch import kernels

    t_start = time.perf_counter()
    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 1 device: {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")

    # 2. build
    t0 = time.perf_counter()
    took = kernels.build()
    took = {k: round(v, 2) for k, v in took.items()}
    log(f"phase 2 build: {json.dumps(took)} in "
        f"{time.perf_counter() - t0:.1f}s wall")
    for k in kernels.SOURCES:
        logp = os.path.join(kernels.build_dir(), f"{k}.log")
        if os.path.isfile(logp):
            with open(logp) as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        log(f"  ptxas {k}: {line.strip()}")

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash = {L: check_flash(torch, F, L, gen) for L in (1024, 2048)}
    paged = check_paged(torch, F, gen)
    bwd = check_flash_bwd(torch, F, gen)
    adamw = check_adamw(torch, gen)
    log(f"phase 3 kernels: flash_fwd {json.dumps(flash)}")
    log(f"phase 3 kernels: paged_decode {json.dumps(paged)}")
    log(f"phase 3 kernels: flash_bwd {json.dumps(bwd)}")
    log(f"phase 3 kernels: adamw {json.dumps(adamw)}")

    # 4. small input: card == CPU reference
    n = small_input_agreement(torch)
    log(f"phase 4 small-input agreement: {n}/{n} requests token-equal "
        "(card kernels vs CPU plain versions, fp32)")
    agree = small_trainer_agreement(torch)
    log(f"phase 4 small-input training: 5 steps, per-step losses agree "
        f"within {LOSS_TOL} (1 + |loss|): {json.dumps(agree)}")

    # 5. the serving main path at full width
    serving, serve_launches = main_path(torch, kernels)
    log(f"phase 5 serving: {json.dumps(serving)} on {card}")

    # 6. the training main path at full width
    training, train_launches = training_path(torch, kernels)
    log(f"phase 6 training: {json.dumps(training)} on {card}")

    entries = []
    for kname, rec, src, replaces, launches in (
            ("flash_fwd", flash[1024], "tpu_dist_torch/csrc/flash_fwd.cu",
             "tpu_dist/ops/flash_attention.py:138", serve_launches),
            ("paged_decode", paged, "tpu_dist_torch/csrc/paged_decode.cu",
             "tpu_dist/ops/paged_attention.py:294", serve_launches),
            ("flash_bwd_dq", bwd["flash_bwd_dq"],
             "tpu_dist_torch/csrc/flash_bwd_dq.cu",
             "tpu_dist/ops/flash_attention.py:201", train_launches),
            ("flash_bwd_dkv", bwd["flash_bwd_dkv"],
             "tpu_dist_torch/csrc/flash_bwd_dkv.cu",
             "tpu_dist/ops/flash_attention.py:246", train_launches),
            ("adamw", adamw, "tpu_dist_torch/csrc/adamw.cu",
             "tpu_dist/ops/pallas_adamw.py:57", train_launches)):
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[kname]}
        entry.update({k: rec[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "tolerance")})
        if kname == "flash_fwd":
            entry["more_shapes"] = [flash[2048]]
            entry["launches_by_path"] = {
                "serving": serve_launches["flash_fwd"],
                "training": train_launches["flash_fwd"]}
        entries.append(entry)
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
