"""The output check's control, read on the card at a cell's own size.

    python benchmark/control.py --workload <name> --seeds 1,2,3 \
        --seconds 5

For each seed, one run of the cell as ``run.py`` makes it (a short
window at the cell's own load), after which the plain reference also
runs in the control's place: computed in float8 (``reference/precision``)
and, for a training cell, on half of each checked batch (the fault "half
of the batch left out"). Prints one JSON line a seed: the program's
numbers (the lower readings) and the control's and the fault's (the upper
ones). The benchmark's own runs never run this; the limits in
``limits/<workload>.json`` are set from what it prints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    from benchmark.run import _finite, _fixed_caches

    _fixed_caches()
    import torch

    from benchmark import common, core

    cell = core.find_cell(core.Layout(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        clock0 = time.perf_counter()
        w = cell.driver.run(cell, seed, args.seconds, False, device, clock0,
                            options={"control": True})
        print(json.dumps(_finite({
            "workload": args.workload, "seed": seed,
            "program": {k: v["value"] for k, v in w.checks.items()},
            "control": w.counters.get("control"),
            "correct": w.correct, "metrics": w.metrics,
            "checked_tokens": w.counters.get("checked_tokens")})),
            flush=True)
        del w
        common.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
