"""The benchmark's registry and plumbing, shared by every cell.

Everything a cell needs is found by name, never by an edit here:

* ``BENCHMARK.json`` at the checkout's root names the cells, their
  configuration and traffic, and the metrics;
* ``configs/<config>.json`` holds a configuration as it is run; its
  ``reference`` key names the plain module in ``reference/``;
* ``traffic/<mix>.json`` holds a traffic mix; its ``driver`` key names the
  module in ``drivers/`` that runs that kind of work;
* ``metrics/<metric>.py`` is one per-layer metric's reader, ``read(run)``;
* ``limits/<workload>.json`` holds the limits the cell's output check
  holds each compared number to.

A later cell, mix, configuration or metric is new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
# top-level module names a run must never load: the JAX reference package
# and JAX itself (compared whole: the port's name begins with "tpu_dist")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpu_dist")


class BenchError(RuntimeError):
    """A run that cannot produce a result (no card, a missing file)."""


@dataclass
class Layout:
    """Where the benchmark's files live: ``root`` holds ``BENCHMARK.json``,
    ``bench`` the configs, traffic, limits, metrics, drivers and
    references (``benchmark/`` of the checkout, or a test's directory)."""
    root: str
    bench: str = HERE

    def spec(self) -> dict:
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            return json.load(f)

    def _json(self, kind: str, name: str) -> dict:
        path = os.path.join(self.bench, kind, f"{name}.json")
        if not os.path.exists(path):
            raise BenchError(f"no {kind} file {path}")
        with open(path) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def module(self, kind: str, name: str):
        """``<bench>/<kind>/<name>.py`` loaded as a module of its own (a
        name may hold dots, so it is loaded from its path)."""
        path = os.path.join(self.bench, kind, f"{name}.py")
        if not os.path.exists(path):
            raise BenchError(f"no {kind} module {path}")
        key = f"_bench_{kind}_{name}".replace(".", "_").replace("-", "_")
        if key in sys.modules:
            return sys.modules[key]
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
        return mod

    def driver(self, name: str):
        return self.module("drivers", name)

    def reference(self, name: str):
        return self.module("reference", name)

    def metric(self, name: str) -> Callable:
        return self.module("metrics", name).read


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and
    limits loaded."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    layout: Layout

    @property
    def driver(self):
        return self.layout.driver(self.traffic["driver"])

    @property
    def reference(self):
        return self.layout.reference(self.config["reference"])


def find_cell(layout: Layout, workload: str) -> Cell:
    spec = layout.spec()
    entry = next((w for w in spec["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    return Cell(workload, int(entry["chips"]), entry["config"],
                layout.config(entry["config"]),
                layout.traffic(entry["traffic"]), layout.limits(workload),
                layout)


def metrics_for(spec: dict, workload: str, trace: bool) -> List[dict]:
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced. A metric without a
    ``workloads`` key belongs to every cell that reports the metric it
    moves (an end-to-end one: to every cell)."""
    def has(m, w):
        return "workloads" not in m or w in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if has(m, workload)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


# ---- arithmetic shared by the drivers and readers --------------------------

def nearest_rank(values, q: float) -> Optional[float]:
    """The ``q``-th percentile by nearest rank: the ceil(q/100 n)-th
    smallest value (a tail of all the values, never interpolated)."""
    xs = sorted(values)
    if not xs:
        return None
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def process_start_age() -> float:
    """Seconds since this process started (``/proc/self/stat`` start time
    against ``/proc/uptime``), so set-up counts the interpreter's start
    and every import."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])     # field 22 of the whole line
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_loaded(modules=None) -> List[str]:
    """Names in ``sys.modules`` whose top-level name is forbidden, compared
    whole (``tpu_dist_torch`` is not ``tpu_dist``)."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


@dataclass
class Window:
    """What a driver hands back from one run: the window's figures, what
    the output check compared, and, for a traced run, the trace."""
    metrics: Dict[str, float]            # end-to-end figures by name
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]  # name -> {"value", "limit"}
    counters: Dict[str, Any] = field(default_factory=dict)
    trace: Any = None                    # trace.Trace of a traced run
    memory_peak_bytes: int = 0

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks.values())


@dataclass
class Run:
    """What a per-layer metric's reader reads: the cell, the window's
    counters and the trace (None untraced)."""
    cell: Cell
    counters: Dict[str, Any]
    trace: Any
    metrics: Dict[str, float]


def result_line(window: Window, metric_entries: List[dict], device: dict,
                run: Run, trace: bool) -> dict:
    """The run's last line: the keys the contract fixes, the compared
    numbers last."""
    out: Dict[str, Any] = {}
    for m in metric_entries:
        if trace:
            value = run.cell.layout.metric(m["name"])(run)
        else:
            value = window.metrics.get(m["name"])
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": window.correct, "attempted": window.attempted,
            "failed": window.failed, "metrics": out, "device": device}
    if trace and window.trace is not None:
        line["breakdown"] = window.trace.breakdown()
    line["checks"] = window.checks
    return line


def check_lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    """One line a compared number: its name, value and limit."""
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAIL'}"
            for k, v in checks.items()]
