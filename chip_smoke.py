#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (tpu_dist_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU (the
kernels are built for sm_90a with the CUDA toolkit's nvcc). Every phase
raises on failure; the script prints no result and exits non-zero without
CUDA or without the repository beside it. Phases:

1. device: name and power limit (nvidia-smi), TF32 off for matmul/cuDNN;
2. build every CUDA kernel of the serving path from ``tpu_dist_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, with the error, the kernel's time
   (CUDA events, median of 20), the plain version's time, a one-call
   PyTorch yardstick (``scaled_dot_product_attention``, timed here and
   used nowhere in the port) and the least time the card could take;
4. a small-input check: a tiny fp32 model served on the card (kernels)
   and on the CPU (plain versions) gives the same greedy tokens;
5. the main path: ``ServeEngine`` at the full width of the LM the repo
   benches (V=32000, 8 layers, d_model 1024, 8 heads, bf16, random
   weights from a seed), flash prefill and int8 paged decode, serving 16
   requests; the kernel launch counts show both kernels ran.

The line before the last is the card's name and power limit; the one
before it the ``{"kernels": [...]}`` record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 SIMT,
# HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# kernel vs plain version, bf16 outputs: |err| <= BF16_TOL * (1 + |plain|)
# elementwise -- the kernels round p (flash) and the output to bf16 where
# the plain versions keep fp32: a few bf16 ulps (2^-8 relative each)
BF16_TOL = 2e-2


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
    log(f"phase 3 kernels: flash_fwd {json.dumps(flash)}")
    log(f"phase 3 kernels: paged_decode {json.dumps(paged)}")

    # 4. small input: card == CPU reference
    n = small_input_agreement(torch)
    log(f"phase 4 small-input agreement: {n}/{n} requests token-equal "
        "(card kernels vs CPU plain versions, fp32)")

    # 5. the main path at full width
    serving, launches = main_path(torch, kernels)
    log(f"phase 5 serving: {json.dumps(serving)} on {card}")

    entries = []
    for kname, rec, src, replaces in (
            ("flash_fwd", flash[1024], "tpu_dist_torch/csrc/flash_fwd.cu",
             "tpu_dist/ops/flash_attention.py:138"),
            ("paged_decode", paged, "tpu_dist_torch/csrc/paged_decode.cu",
             "tpu_dist/ops/paged_attention.py:294")):
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[kname]}
        entry.update({k: rec[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "tolerance")})
        if kname == "flash_fwd":
            entry["more_shapes"] = [flash[2048]]
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
