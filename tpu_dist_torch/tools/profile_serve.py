"""Where the serving time goes: a ``torch.profiler`` window over the port's
full-width ``ServeEngine`` (the ``chip_smoke.py`` configuration).

Builds the LM the repo benches (V=32000, 8 layers, d_model 1024, 8 heads,
bf16, random weights from ``--seed``) with flash prefill and int8 paged
decode, fills ``--slots`` slots with prompts of ``--prompt-len`` tokens,
then profiles ``--ticks`` decode iterations and, separately, one prefill.
``--quant int8`` runs every dense layer through the fused int8 kernel
(``csrc/fused_quant.cu``); ``--spec-k K`` makes each profiled iteration
one speculative tick (K draft steps of self-speculation and one
(K+1)-wide verify).
Prints one JSON object: for each window the wall time, the device kernel
time (sum of the CUDA kernels' self time; one stream, so no overlap), the
device busy share (kernel time / wall), kernels launched, the device time
and launches of the fused int8 matmul's kernels, and the top kernels by
device time. Needs a CUDA device::

    python -m tpu_dist_torch.tools.profile_serve --ticks 32
    python -m tpu_dist_torch.tools.profile_serve --ticks 32 --quant int8
    python -m tpu_dist_torch.tools.profile_serve --ticks 16 --spec-k 4
"""

from __future__ import annotations

import argparse
import json
import time


# kernel-name fragments of csrc/fused_quant.cu's kernels (its memset shows
# as "Memset (Device)" and is not counted)
FUSED_QUANT = ("fq_", "fused_quant_kernel")


def _window(torch, fn, n_iters, top):
    """Profile ``fn`` run ``n_iters`` times: wall and device breakdown."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels.append((us, evt.count, evt.key))
    kernels.sort(reverse=True)
    dev_s = sum(k[0] for k in kernels) / 1e6
    quant = [k for k in kernels if any(f in k[2] for f in FUSED_QUANT)]
    return {"iters": n_iters, "wall_ms_per_iter": wall / n_iters * 1e3,
            "device_ms_per_iter": dev_s / n_iters * 1e3,
            "fused_quant_ms_per_iter": sum(k[0] for k in quant) / 1e3
            / n_iters,
            "fused_quant_kernels_per_iter": sum(k[1] for k in quant)
            / n_iters,
            "device_busy_share": dev_s / wall if wall else None,
            "kernels_per_iter": sum(k[1] for k in kernels) / n_iters,
            "top": [{"kernel": name[:90], "ms_per_iter": us / 1e3 / n_iters,
                     "launches_per_iter": cnt / n_iters}
                    for us, cnt, name in kernels[:top]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ticks", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--prefill-len", type=int, default=1024)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "int8_wo"],
                    help="dense-layer quant mode (ServeConfig.quant)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens per tick")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tpu_dist_torch.device import resolve_device
    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.ops.flash_attention import flash_attention_fn

    device = resolve_device("cuda")
    model = TransformerLM(vocab_size=32000, num_layers=8, d_model=1024,
                          num_heads=8, max_len=2048, dtype=torch.bfloat16,
                          attn_fn=flash_attention_fn(), device=device,
                          seed=args.seed)
    cfg = ServeConfig(max_slots=args.slots, page_size=16, num_pages=1024,
                      kv_quant="int8", attn_read="flash", quant=args.quant,
                      spec_k=args.spec_k)
    rng = np.random.default_rng(args.seed)
    # nobody finishes inside the window (a spec tick emits up to k tokens)
    big = max(args.spec_k, 1) * (10 * args.ticks + 16)
    if args.prompt_len + big > 2048:
        raise SystemExit(f"--prompt-len {args.prompt_len} + {big} decoded "
                         "tokens exceed the model's 2048 positions: fewer "
                         "--ticks")

    def fill(eng, n, plen):
        for i in range(n):
            eng.submit(DecodeRequest(i, rng.integers(0, 32000, (plen,))
                                     .astype(np.int32), big))
        while eng.queue:
            eng.step()

    warm = ServeEngine(model, cfg)
    fill(warm, args.slots, args.prompt_len)
    for _ in range(4):
        warm.step()
    del warm

    eng = ServeEngine(model, cfg)
    fill(eng, args.slots, args.prompt_len)
    decode = _window(torch, eng.step, args.ticks, args.top)

    pre = ServeEngine(model, ServeConfig(max_slots=1, page_size=16,
                                         num_pages=256, kv_quant="int8",
                                         attn_read="flash", quant=args.quant,
                                         spec_k=args.spec_k))
    prompt = rng.integers(0, 32000, (args.prefill_len,)).astype(np.int32)

    def one_prefill():
        pre.submit(DecodeRequest(0, prompt, 1))
        pre.step()                       # admit + prefill (1 token: done)
        pre.step()                       # evict
    one_prefill()
    prefill = _window(torch, one_prefill, 4, args.top)
    print(json.dumps({
        "device": torch.cuda.get_device_name(device),
        "config": {"slots": args.slots, "prompt_len": args.prompt_len,
                   "prefill_len": args.prefill_len, "layers": 8,
                   "d_model": 1024, "vocab": 32000, "kv_quant": "int8",
                   "attn_read": "flash", "attn": "flash",
                   "quant": args.quant, "spec_k": args.spec_k},
        "decode_tick": decode,
        "accepted_per_tick": eng.accepted_per_tick, "prefill": prefill}))


if __name__ == "__main__":
    main()
