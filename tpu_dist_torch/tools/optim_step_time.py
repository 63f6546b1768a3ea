"""Time the optax-protocol optimizer's update step on the card.

One ``engine.steps.apply_update`` of the plain ``Optimizer``
(``ops.optim.make_optimizer``, ``sgd`` or ``adamw``) over the fp32 master
parameters of the LM training geometry (``TransformerLM`` V 32000, 8
layers, d_model 1024: 168,372,224 parameters in 85 leaves), with fixed
random gradients. Prints one JSON line a kind: the CUDA-event median of
``--steps`` timed steps after ``--warmup``, and the step's peak device
memory above what was allocated before it (the transient a step holds on
top of the train state).

It reads only APIs every version of the package has, so it can time
another checkout of the package: put that checkout first on
``PYTHONPATH`` and run this file by its path::

    PYTHONPATH=/path/to/other/checkout python3 \\
        tpu_dist_torch/tools/optim_step_time.py --kinds adamw sgd
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def time_kind(kind: str, model, steps: int, warmup: int, seed: int) -> dict:
    import torch

    from tpu_dist_torch.engine.state import TrainState
    from tpu_dist_torch.engine.steps import apply_update
    from tpu_dist_torch.ops.optim import make_optimizer

    tx = make_optimizer(1e-3, 0.9, 0.1, kind=kind, grad_clip=1.0)
    state = TrainState.create(model, tx)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    grads = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
             for p in state.params]
    for _ in range(warmup):
        apply_update(tx, state, grads, {})
    torch.cuda.synchronize()
    ms, peaks = [], []
    for _ in range(steps):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        apply_update(tx, state, grads, {})
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        peaks.append(torch.cuda.max_memory_allocated() - base)
    n = sum(p.numel() for p in state.params)
    del state, grads
    torch.cuda.empty_cache()
    return {"kind": kind, "params": n, "leaves": len(list(
        model.parameters())), "median_ms": statistics.median(ms),
        "min_ms": min(ms), "max_ms": max(ms),
        "peak_extra_mib": max(peaks) / 2**20}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kinds", nargs="+", default=["adamw", "sgd"],
                    choices=["adamw", "sgd"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="",
                    help="a name for the checkout timed, echoed in the line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("optim_step_time: no CUDA device")
    import tpu_dist_torch
    from tpu_dist_torch.models.transformer import TransformerLM

    model = TransformerLM(vocab_size=32000, num_layers=8, d_model=1024,
                          num_heads=8, max_len=2048, device="cuda",
                          seed=args.seed)
    for kind in args.kinds:
        rec = time_kind(kind, model, args.steps, args.warmup, args.seed)
        rec.update(label=args.label, card=_card(), package=os.path.dirname(
            os.path.abspath(tpu_dist_torch.__file__)))
        print(json.dumps(rec, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
