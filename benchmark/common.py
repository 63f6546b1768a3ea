"""Small pieces the drivers share: device synchronisation, the card's
memory peak, float32 context for the reference, and the gap arithmetic
of the training checks."""

from __future__ import annotations

import gc
import math
import statistics
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warm(device) -> None:
    """One trivial device operation (a profiler's start-up lands on it)."""
    torch.zeros(1, device=device).add_(1)


def memory_peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@contextmanager
def exact_fp32():
    """TF32 off for the reference's products and convolutions."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def worst(values: Iterable[float]) -> float:
    """The largest value; infinity where any is not finite (a NaN never
    hides behind a larger number)."""
    vals = list(values)
    if not vals or not all(math.isfinite(v) for v in vals):
        return math.inf
    return max(vals)


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap between two norms, each against the larger of
    the reference's norm of that leaf and of the median leaf."""
    names = list(want if keep is None else keep)
    med = statistics.median(want[n] for n in want)
    return worst(abs(got[n] - want[n]) / max(want[n], med, 1e-30)
                 for n in names)


def moved_leaves(grad_norms: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's (others move by round-off alone)."""
    med = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= 1e-3 * med]


def train_checks(prog: dict, ref: dict, limits: dict) -> Dict[str, dict]:
    """The training cells' three numbers: each step's loss, the first
    gradient's norm a leaf, and each moving leaf's change after the
    checked steps, each held to its limit."""
    vals = {
        "loss_gap": worst(rel_gap(a, b) for a, b in
                          zip(prog["losses"], ref["losses"])),
        "grad_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"]),
        "update_gap": leaf_gap(prog["change_norms"], ref["change_norms"],
                               moved_leaves(ref["grad_norms"])),
    }
    return {k: {"value": v, "limit": limits[k]} for k, v in vals.items()
            if k in limits}


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    """The three numbers without limits (the control's readings)."""
    return {k: v["value"] for k, v in train_checks(
        prog, ref, {"loss_gap": 0, "grad_gap": 0, "update_gap": 0}).items()}
