"""Where a training step's device time goes: a ``torch.profiler`` window
over full-width ``LMTrainer`` steps (the port of ``tools/profile_lm.py``).

Builds the trainer at the repo's LM bench geometry (V=32000, 8 layers,
d_model 1024, 8 heads, L=2048, batch 8, bf16 compute over fp32 masters,
flash attention, ``fused_adamw`` with ``grad_clip`` 1.0: the
``chip_smoke.py`` training configuration), runs ``--warmup`` steps, then
profiles ``--steps`` train steps on one fixed batch and prints one JSON
object: wall ms per step, device kernel ms per step (the CUDA kernels' self
time; one stream, so no overlap), the device busy share (kernel time /
wall), kernels launched per step, the split of device time into flash
forward, flash backward, AdamW, cuBLAS products and the rest, and the top
kernels. Needs a CUDA device::

    python -m tpu_dist_torch.tools.profile_lm --steps 4
"""

from __future__ import annotations

import argparse
import json
import time

GEOMETRY = dict(vocab_size=32000, num_layers=8, d_model=1024, num_heads=8,
                seq_len=2048, batch_size=8, precision="bf16", attn="flash",
                optimizer="fused_adamw")

# kernel-name fragments of each bucket, matched in order (the rest is
# elementwise, reductions, copies, embedding and loss kernels)
BUCKETS = (("flash_fwd", ("flash_fwd_kernel",)),
           ("flash_bwd", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
           ("adamw", ("adamw_kernel",)),
           ("cublas_products", ("nvjet", "gemm", "xmma", "cutlass",
                                "sm90_", "cublas")))


def bucket_of(name: str, buckets=BUCKETS) -> str:
    for bucket, keys in buckets:
        if any(k in name for k in keys):
            return bucket
    return "rest"


def profile_steps(torch, step, n_steps: int, top: int,
                  buckets=BUCKETS) -> dict:
    """Profile ``step()`` run ``n_steps`` times: wall and the device split
    by ``buckets`` (``(name, kernel-name fragments)`` pairs, matched in
    order; the rest go to ``rest``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
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
    split = {b: 0.0 for b, _ in buckets}
    split["rest"] = 0.0
    for us, _, name in kernels:
        split[bucket_of(name, buckets)] += us / 1e3 / n_steps
    return {"steps": n_steps, "wall_ms_per_step": wall / n_steps * 1e3,
            "device_ms_per_step": dev_s / n_steps * 1e3,
            "device_busy_share": dev_s / wall if wall else None,
            "kernels_per_step": sum(k[1] for k in kernels) / n_steps,
            "device_ms_by_bucket": split,
            "top": [{"kernel": name[:90], "ms_per_step": us / 1e3 / n_steps,
                     "launches_per_step": cnt / n_steps}
                    for us, cnt, name in kernels[:top]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.engine.lm_steps import lm_train_step

    cfg = LMConfig(**GEOMETRY, lr=1e-3, weight_decay=0.1, grad_clip=1.0,
                   synth_tokens=40 * GEOMETRY["seq_len"], seed=args.seed)
    tr = LMTrainer(cfg, device="cuda")
    idx, _ = tr._epoch_indices(tr.train_ds, True, 0)
    inputs, targets = tr._batch(tr.train_ds, idx[0])
    torch.backends.cuda.matmul.allow_tf32 = False

    def step():
        return lm_train_step(tr.model, tr.tx, tr.state, inputs, targets)

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = profile_steps(torch, step, args.steps, args.top)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "config": GEOMETRY,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "train_step": out}))


if __name__ == "__main__":
    main()
