"""Steps and seconds to a val-perplexity threshold, the LM convergence north
star (the port of ``tools/lm_convergence.py``).

Trains the port's ``LMTrainer`` over the synthetic affine corpus (x ->
5x+7 mod V, 5% noise: its entropy floor puts the perplexity near 2 for
V=512 once the rule is learned, so a threshold of 4 proves real learning)
and reports the first optimizer step count, and the wall seconds from the
first epoch's start, at which the held-out perplexity drops to
``--threshold``. Prints one JSON line with the reference tool's keys, from
rank 0. Runs on CUDA unless ``--device cpu``; a ``--mesh`` of N devices
runs as N processes that a launcher starts (``parallel.launch``: the
``TPU_DIST_*`` variables or Slurm's)::

    python -m tpu_dist_torch.tools.lm_convergence
    python -m tpu_dist_torch.tools.lm_convergence --attn flash --precision bf16
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.tools.lm_convergence",
        description="steps/seconds to a val-perplexity threshold")
    ap.add_argument("--mesh", default=None,
                    help="e.g. data=2,seq=4 (script 8's syntax)")
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--attn", default="full",
                    choices=["full", "blockwise", "flash"])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--vocab-size", type=int, default=512)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--num-heads", type=int, default=4)
    ap.add_argument("--synth-tokens", type=int, default=500_000)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"])
    ap.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "cosine", "step"])
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--lr-decay-steps", type=int, default=0)
    ap.add_argument("--lr-min-frac", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threshold", type=float, default=4.0)
    ap.add_argument("--max-epochs", type=int, default=10)
    ap.add_argument("--steps-per-dispatch", type=int, default=8)
    ap.add_argument("--pp-microbatches", type=int, default=4)
    ap.add_argument("--pp-schedule", default="gpipe",
                    choices=["gpipe", "1f1b"])
    ap.add_argument("--device", default="cuda")
    return ap


def run(args) -> dict:
    """Train to the threshold; returns the JSON line's object (every rank
    computes it; :func:`main` prints rank 0's)."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    mesh_shape = mesh_axes = None
    if args.mesh:
        parts = [p.split("=") for p in args.mesh.split(",")]
        mesh_shape = tuple(int(n) for _, n in parts)
        mesh_axes = tuple(name.strip() for name, _ in parts)
    cfg = LMConfig(
        batch_size=args.batch_size, seq_len=args.seq_len,
        vocab_size=args.vocab_size, d_model=args.d_model,
        num_layers=args.num_layers, num_heads=args.num_heads,
        synth_tokens=args.synth_tokens, lr=args.lr, seed=args.seed,
        optimizer=args.optimizer,
        lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        lr_decay_steps=args.lr_decay_steps, lr_min_frac=args.lr_min_frac,
        precision=args.precision, attn=args.attn,
        epochs=args.max_epochs, print_freq=10 ** 9,
        steps_per_dispatch=args.steps_per_dispatch,
        mesh_shape=mesh_shape, mesh_axes=mesh_axes or ("data",),
        pp_microbatches=args.pp_microbatches,
        pp_schedule=args.pp_schedule, checkpoint_dir="")
    tr = LMTrainer(cfg, device=args.device)
    t0 = time.time()
    result = None
    for epoch in range(cfg.epochs):
        tr.train_epoch(epoch)
        steps = tr.state.step
        _, ppl, acc = tr.validate(epoch)
        if tr.is_main:
            print(f"epoch {epoch}: step {steps} val_ppl {ppl:.2f} "
                  f"acc {acc:.3f}", file=sys.stderr, flush=True)
        if ppl <= args.threshold:
            result = {"steps_to_threshold": steps,
                      "seconds_to_threshold": round(time.time() - t0, 2),
                      "epochs": epoch + 1, "val_ppl": round(float(ppl), 3)}
            break
    return {"metric": f"steps_to_ppl_{args.threshold:g}",
            "mode": tr.mode, "attn": args.attn,
            "lr_schedule": args.lr_schedule,
            "warmup_steps": args.warmup_steps,
            "precision": args.precision,
            "batch_size": args.batch_size, "seq_len": args.seq_len,
            "seed": args.seed,
            **(result or {"steps_to_threshold": None,
                          "note": f"not reached in {cfg.epochs} epochs"})}


def main(argv: Optional[Sequence[str]] = None) -> int:
    from tpu_dist_torch.parallel import launch

    args = parser().parse_args(argv)

    info = launch.initialize(device=args.device)
    try:
        out = run(args)
    finally:
        launch.shutdown()
    if info.process_id == 0:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
