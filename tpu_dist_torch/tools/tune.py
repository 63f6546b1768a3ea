#!/usr/bin/env python
"""Tune a step plan per device kind (``tools/tune.py``, ported).

    python -m tpu_dist_torch.tools.tune --device-kind "NVIDIA H100 80GB HBM3" \
        --out plans.json
    python -m tpu_dist_torch.tools.tune --comm-bench comm.json --json
    python -m tpu_dist_torch.tools.tune --ledger-summary report.json
    python -m tpu_dist_torch.tools.tune --workload '{"n_params": 9e8, ...}'

The port's plan tuner (``tpu_dist_torch.plan.tune``): enumerate the
step-plan space (quant x fused kernel x gradient buckets x dispatch window
x the kernels' tiles), prune illegal combinations through the plan IR's
validator, score each candidate with the reference's roofline cost model at
the device kind's peaks (the port's ``device`` tables: the card's name as
``nvidia-smi`` or ``torch.cuda.get_device_name`` gives it), fold in
``tools/comm_bench.py --json`` sweeps for the collective costs, and refine
with measured trials (``tools/ledger_report.py --json`` summaries of short
plan-stamped runs, or a ``trials`` list in the measurement file).

Output: the best-plan-per-device-kind JSON the configs' ``plan`` knob
reads (``--out`` writes it, ``--json`` prints it), interchangeable with the
reference's. The same inputs give byte-identical output. ``--ledger``
appends one ``tune`` event per device kind. Nothing here touches a device.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--comm-bench", action="append", default=[],
                    metavar="JSON",
                    help="tools/comm_bench.py --json sweep file(s); later "
                    "files extend the first's results/trials")
    ap.add_argument("--ledger-summary", action="append", default=[],
                    metavar="JSON",
                    help="tools/ledger_report.py --json summaries of short "
                    "plan-stamped runs (measured refinement)")
    ap.add_argument("--device-kind", action="append", default=[],
                    help="device kind(s) to emit plans for (default: the "
                    "measurement file's device_kind, else 'unknown')")
    ap.add_argument("--workload", default="",
                    help="workload JSON object/string: n_params, "
                    "tokens_per_step, devices, engine (defaults: the "
                    "reference's LM bench geometry)")
    ap.add_argument("--out", default="",
                    help="write the plan JSON here (the config knob's "
                    "input)")
    ap.add_argument("--json", action="store_true",
                    help="print the plan JSON on stdout (the human table "
                    "moves to stderr)")
    ap.add_argument("--top", type=int, default=5,
                    help="how many ranked candidates to show per device "
                    "kind (default 5)")
    ap.add_argument("--ledger", default="",
                    help="append one 'tune' obs.ledger event per device "
                    "kind here")
    args = ap.parse_args(argv)

    from tpu_dist_torch.plan.ir import plan_knob_summary
    from tpu_dist_torch.plan.tune import tune

    workload = json.loads(args.workload) if args.workload else None
    text, results = tune(measurement_files=args.comm_bench,
                         ledger_summary_files=args.ledger_summary,
                         device_kinds=args.device_kind or None,
                         workload=workload)

    say = ((lambda *a, **k: print(*a, file=sys.stderr, **k))
           if args.json else print)
    for kind, res in sorted(results.items()):
        peaks = res["peaks"]
        say(f"{kind}: {res['candidates']} candidate plan(s) at "
            f"{peaks['tflops']:g} TFLOP/s / {peaks['gbps']:g} GB/s"
            + (" (NOMINAL peaks)" if peaks["nominal"] else "")
            + (f"; comm: {res['comm']}" if res["comm"] else
               "; no comm measurements (analytic only)"))
        for i, cand in enumerate(res["ranked"][:max(args.top, 1)]):
            knobs = plan_knob_summary(cand["plan"]) or "(all defaults)"
            say(f"  #{i + 1} {cand['hash']}  {cand['step_s'] * 1e3:9.3f} "
                f"ms/step{' [measured]' if cand['measured'] else ''}  "
                f"{knobs}")
    if args.ledger:
        from tpu_dist_torch.obs.ledger import Ledger

        led = Ledger(args.ledger)
        for kind, res in sorted(results.items()):
            best = res["best"]
            led.emit("tune", device_kind=kind,
                     candidates=res["candidates"],
                     best_hash=best["hash"] if best else None,
                     best_step_s=best["step_s"] if best else None,
                     measured=bool(best and best["measured"]),
                     peaks_nominal=res["peaks"]["nominal"])
        led.close()
        say(f"ledger: {args.ledger}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        say(f"plan file: {args.out}")
    if args.json:
        sys.stdout.write(text)
    if not args.out and not args.json:
        say("(no --out/--json: dry run — the table above is the result)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
