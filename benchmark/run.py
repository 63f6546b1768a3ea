"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the port (``tpu_dist_torch``). The cell's driver loads, warms up,
measures for ``--seconds`` and checks its output against the plain
reference; the last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last: each compared number
beside its limit, printed on standard error too). Exits non-zero,
printing no result, without the cards the cell asks for, without the
port, when a file is missing, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

CLOCK_AT_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the script's own folder would shadow modules of the standard library
# (``trace``): the checkout's root takes its place on the path
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so only a cell's first run in it builds; one host thread for the CPU
    side of the port's operators (idle OpenMP workers spin on the cores
    the host-paced loops need)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    build = os.path.join(ROOT, "build")
    os.environ["TPU_DIST_TORCH_BUILD"] = os.path.join(build, "tpu_dist_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def _finite(x):
    """The line's numbers as JSON numbers: a non-finite one becomes null
    (its check has failed already)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def card(device_index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device_index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()

    from benchmark import core

    clock0 = time.perf_counter() - core.process_start_age()
    layout = core.Layout(ROOT)
    try:
        cell = core.find_cell(layout, args.workload)
    except (core.BenchError, OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2

    if importlib.util.find_spec("tpu_dist_torch") is None:
        print("benchmark: the port (tpu_dist_torch) is not in this checkout",
              file=sys.stderr)
        return 2

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees {cards}", file=sys.stderr)
        return 3

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    window = cell.driver.run(cell, args.seed, args.seconds, bool(args.trace),
                             device, clock0)
    entries = core.metrics_for(layout.spec(), args.workload, bool(args.trace))
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": window.memory_peak_bytes,
           "card": card(0)}
    if args.trace:
        if window.trace is None:
            print("benchmark: a traced run without a trace", file=sys.stderr)
            return 4
        dev["busy_s"] = window.trace.busy_s
        dev["window_s"] = window.trace.window_s
        for span in sorted({e["name"] for e in window.trace.host
                            if e.get("cat") == "user_annotation"
                            and e.get("name", "").startswith("bench.")}):
            ops = window.trace.span_ops(span) or {}
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:6]
            print(f"span {span}: {window.trace.count_ranges(span)} ranges, "
                  f"{sum(ops.values())!r} s on the device: "
                  + "; ".join(f"{n[:60]} {v!r}" for n, v in top),
                  file=sys.stderr)
    run = core.Run(cell, window.counters, window.trace, window.metrics)
    line = core.result_line(window, entries, dev, run, bool(args.trace))
    return _exit_checked(line, window)


def _exit_checked(line: dict, window) -> int:
    """Refuse the result if JAX or the JAX package was loaded; else print
    the compared numbers on standard error and the line last."""
    from benchmark import core

    found = core.forbidden_loaded()
    if found:
        print("benchmark: forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 5
    for text in core.check_lines(window.checks):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
