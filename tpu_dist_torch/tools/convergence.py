"""Steps and seconds to a val top-1 threshold, the image convergence north
star (the port of ``tools/convergence.py``).

Trains the port's ``Trainer`` epoch by epoch on the learnable synthetic
set (fixed seed, deterministic sampler) and reports the first optimizer
step count, and the wall seconds from the first epoch's start, at which
the exact validation reaches ``--threshold``. The first epoch carries the
kernel builds and cuDNN's autotuning; they count in the seconds, as the
reference's first epoch carries its compile. Prints one JSON line with
the reference tool's keys. Runs on CUDA unless ``--device cpu``::

    python -m tpu_dist_torch.tools.convergence --variant jit --precision bf16
    python -m tpu_dist_torch.tools.convergence --device cpu --arch lenet \\
        --dataset synthetic-mnist --batch-size 64 --synth-train-size 2048 \\
        --synth-val-size 512 --precision fp32
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.tools.convergence",
        description="steps/seconds to a val top-1 threshold")
    ap.add_argument("--arch", default="resnet50")
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--variant", default="jit", choices=["jit", "shard_map"])
    ap.add_argument("--precision", default="bf16",
                    choices=["fp32", "bf16", "bf16_params"])
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--synth-train-size", type=int, default=10240)
    ap.add_argument("--synth-val-size", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threshold", type=float, default=0.90)
    ap.add_argument("--max-epochs", type=int, default=20)
    ap.add_argument("--steps-per-dispatch", type=int, default=1)
    ap.add_argument("--norm-dtype", default="",
                    help="'' (fp32 norm outputs) | bf16")
    ap.add_argument("--stem", default="",
                    help="imagenet | cifar | s2d (space-to-depth)")
    ap.add_argument("--optimizer", default="sgd",
                    help="sgd | fused_sgd (the sgd.cu kernel)")
    ap.add_argument("--device", default="cuda")
    return ap


def run(args) -> dict:
    """Train to the threshold; returns the JSON line's object."""
    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine.loop import Trainer

    cfg = TrainConfig(
        arch=args.arch, dataset=args.dataset, variant=args.variant,
        precision=args.precision, batch_size=args.batch_size,
        synth_train_size=args.synth_train_size,
        synth_val_size=args.synth_val_size, lr=args.lr, seed=args.seed,
        epochs=args.max_epochs, print_freq=10 ** 9,
        steps_per_dispatch=args.steps_per_dispatch,
        norm_dtype=args.norm_dtype, stem=args.stem,
        optimizer=args.optimizer, checkpoint_dir="", log_csv="")
    tr = Trainer(cfg, device=args.device)
    t0 = time.time()
    result = None
    for epoch in range(cfg.epochs):
        tr.train_epoch(epoch)
        steps = tr.state.step
        acc = tr.validate(epoch)
        if tr.is_main:
            print(f"epoch {epoch}: step {steps} val_top1 {acc * 100:.2f}%",
                  file=sys.stderr, flush=True)
        if acc >= args.threshold:
            result = {"steps_to_threshold": steps,
                      "seconds_to_threshold": round(time.time() - t0, 2),
                      "epochs": epoch + 1, "val_top1": round(float(acc), 4)}
            break
    return {"metric": f"steps_to_{int(args.threshold * 100)}pct_top1",
            "variant": args.variant, "precision": args.precision,
            "arch": args.arch, "batch_size": args.batch_size,
            "train_size": args.synth_train_size, "seed": args.seed,
            "norm_dtype": args.norm_dtype or "fp32", "stem": args.stem,
            **(result or {"steps_to_threshold": None,
                          "note": f"not reached in {cfg.epochs} epochs"})}


def main(argv: Optional[Sequence[str]] = None) -> int:
    out = run(parser().parse_args(argv))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
