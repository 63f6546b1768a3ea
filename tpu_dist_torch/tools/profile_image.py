"""Where an image training step's device time goes: a ``torch.profiler``
window over full-width ``Trainer`` steps (the port of
``tools/profile_image.py``).

Builds the trainer at the repo's headline image geometry
(``scripts.image_train.BENCH_GEOMETRY``: ResNet-50 on CIFAR-10, batch 1024,
bf16 convs over fp32 masters, bf16 norm outputs, the s2d stem,
``fused_sgd``, the uint8 set resident on the card: ``chip_smoke.py``'s
image configuration), runs ``--warmup`` windows of K steps, then profiles
``--windows`` more, each step gathering its batch from the resident set as
the windowed loop does. Prints one JSON object: the card and its power
limit, wall and device kernel ms per step, the device busy share (kernel
time / wall; one stream), kernels per step, device ms per step by bucket
(cuDNN/cuBLAS convolutions and the dense head, BatchNorm and other
elementwise and reduction kernels, the ``sgd`` kernel, copies and casts,
the rest) and the top kernels. Needs a CUDA device::

    python -m tpu_dist_torch.tools.profile_image --windows 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

from tpu_dist_torch.tools.profile_lm import profile_steps

# kernel-name fragments of each bucket, matched in order
BUCKETS = (("sgd", ("sgd_kernel",)),
           ("convs_and_dense", ("conv", "cudnn", "xmma", "implicit_gemm",
                                "dgrad", "wgrad", "fprop", "cutlass",
                                "nvjet", "gemm", "sm90_", "sm80_",
                                "cublas")),
           ("copies_and_casts", ("Memcpy", "Memset", "copy_kernel",
                                 "CatArray", "index_select", "indexSelect")),
           ("bn_and_elementwise", ("elementwise", "reduce_kernel",
                                   "vectorized", "unrolled",
                                   "batch_norm")))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    import torch

    from tpu_dist_torch.engine.loop import Trainer
    from tpu_dist_torch.scripts.image_train import BENCH_GEOMETRY, DEFAULTS

    cfg = dataclasses.replace(DEFAULTS, **BENCH_GEOMETRY, checkpoint_dir="",
                              log_csv="")
    tr = Trainer(cfg, device="cuda")
    images_all, labels_all = tr._train_data_dev
    idx, _ = tr._epoch_indices(tr.train_ds, True, 0)
    idx = tr._to_device(idx)
    tr.model.train()
    taken = [0]

    def step():
        b = idx[taken[0] % len(idx)]
        tr._step(images_all.index_select(0, b), labels_all.index_select(0, b),
                 taken[0])
        taken[0] += 1

    for _ in range(args.warmup * tr.k):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = profile_steps(torch, step, args.windows * tr.k, args.top, BUCKETS)
    out["img_per_s_under_profiler"] = (cfg.batch_size * 1e3
                                       / out["wall_ms_per_step"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "card": card,
        "config": BENCH_GEOMETRY, "steps_per_window": tr.k,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "train_step": out}))


if __name__ == "__main__":
    main()
