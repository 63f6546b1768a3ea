"""Traced segments and their reduction to device times.

:func:`traced` runs two segments under ``torch.profiler``, each after a
warm-up inside the profiler, and reads each Chrome trace back from the
run's temporary directory (deleting the file). :class:`Trace` reduces
them:

* the device segment (device activity alone, so the host runs at its own
  pace): device operations are its ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events, ``busy_s`` the union of their intervals (streams
  that overlap count once), ``window_s`` the host clock between the
  segment's two synchronisations;
* the ranged segment (host and device activity, inside the benchmark's
  ``bench.window`` range): :meth:`Trace.span_device_s` is the device time
  of every operation launched inside the benchmark's ranges of a name (a
  runtime launch call on the range's thread, inside the range's interval,
  linked to its device operation by the correlation id), so a kernel that
  is renamed, split or fused away still lands in the same range;
* :meth:`Trace.breakdown` gives the device segment's operations that took
  most time, and the ranged segment's longest idle gaps by what the host
  was doing (the innermost host range or operator at the gap's middle;
  the profiler's own host recording stretches these gaps).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


class Range:
    """A named profiler range opened and closed by hand (from hooks whose
    enter and exit are separate calls)."""

    def __init__(self, name: str):
        import torch

        self._rf = torch.autograd.profiler.record_function(name)

    def __enter__(self):
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(None, None, None)
        return False


def _events(prof) -> List[dict]:
    """The profiler's Chrome trace events, through a file that lives in
    the process's temporary directory only while it is read."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)


def traced(device_fn: Callable[[], None], span_fn: Callable[[], None],
           synchronize: Callable[[], None], warm: Callable[[], None]
           ) -> "Trace":
    """Two traced segments. ``device_fn()`` under device activity alone
    (the profiler's host-side recording would slow a host-paced loop and
    inflate its idle share): busy time, the window and the device
    operations. ``span_fn()`` under host and device activity inside the
    ``bench.window`` range: the benchmark's ranges and what the host was
    doing in each idle gap (its own recording stretches those gaps).
    ``warm()`` runs first inside each profiler, so its start-up stays out
    of both windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # (a build without CUDA records no device activity: host activity
    # stands in, and the segment holds no device operation)
    device_only = [ProfilerActivity.CUDA if torch.cuda.is_available()
                   else ProfilerActivity.CPU]
    synchronize()
    with profile(activities=device_only) as prof:
        warm()
        synchronize()
        t0 = time.perf_counter()
        device_fn()
        synchronize()
        window_s = time.perf_counter() - t0
    device = _events(prof)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm()
        synchronize()
        with Range(WINDOW):
            span_fn()
            synchronize()
    return Trace(_events(prof), device, window_s)


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The reduction of the two traced segments (times in seconds):
    ``events`` of the ranged segment, ``device_events`` and ``window_s``
    of the device segment."""

    def __init__(self, events: List[dict], device_events: List[dict],
                 window_s: float):
        dev, host, launch = [], [], []
        win = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                dev.append(e)
            elif cat in LAUNCH_CATS:
                launch.append(e)
            elif cat in HOST_CATS:
                host.append(e)
                if cat == "user_annotation" and e.get("name") == WINDOW:
                    win = e
        if win is None:
            raise ValueError("the trace holds no bench.window range")
        self.t0 = float(win["ts"])
        self.t1 = self.t0 + float(win["dur"])
        self.window_tid = (win.get("pid"), win.get("tid"))
        self.ranged_ops = [e for e in dev
                           if self.t0 <= float(e["ts"]) <= self.t1]
        self.host = host
        self.launch = launch
        self._by_corr = defaultdict(list)
        for e in self.ranged_ops:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                self._by_corr[corr].append(e)
        self.ranged_busy = _merge([
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in self.ranged_ops])
        # the device segment: every device operation it recorded
        self.window_s = window_s
        self.device_ops = [e for e in device_events if e.get("ph") == "X"
                           and e.get("cat", "") in DEVICE_CATS]
        self.busy_s = sum(e - s for s, e in _merge([
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in self.device_ops])) / 1e6

    @property
    def idle_share(self) -> Optional[float]:
        """The window's share with no device operation running, in %."""
        if self.window_s <= 0 or not self.device_ops:
            return None
        return 100.0 * max(0.0, 1.0 - self.busy_s / self.window_s)

    def device_s_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for e in self.device_ops:
            out[e.get("name", "?")] += float(e.get("dur", 0)) / 1e6
        return dict(out)

    def ranges(self, name: str) -> List[dict]:
        """The benchmark's host ranges called ``name``."""
        return [e for e in self.host if e.get("cat") == "user_annotation"
                and e.get("name") == name]

    def span_device_s(self, name: str) -> Optional[float]:
        """Device seconds of every operation launched inside a host range
        called ``name`` (None where there is no such range)."""
        ops = self.span_ops(name)
        return None if ops is None else sum(ops.values())

    def span_ops(self, name: str) -> Optional[Dict[str, float]]:
        """Device seconds by operation name of what was launched inside
        the host ranges called ``name`` (None where there is none)."""
        spans = self.ranges(name)
        if not spans:
            return None
        by_thread = defaultdict(list)
        for s in spans:
            by_thread[(s.get("pid"), s.get("tid"))].append(
                (float(s["ts"]), float(s["ts"]) + float(s["dur"])))
        for k in by_thread:
            by_thread[k] = _merge(by_thread[k])
        starts = {k: [s for s, _ in v] for k, v in by_thread.items()}
        total: Dict[str, float] = defaultdict(float)
        for ln in self.launch:
            key = (ln.get("pid"), ln.get("tid"))
            ivs = by_thread.get(key)
            if not ivs:
                continue
            ts = float(ln["ts"])
            i = bisect.bisect_right(starts[key], ts) - 1
            if i < 0 or ts > ivs[i][1]:
                continue
            corr = ln.get("args", {}).get("correlation")
            for d in self._by_corr.get(corr, ()):
                total[d.get("name", "?")] += float(d.get("dur", 0)) / 1e6
        return dict(total)

    def count_ranges(self, name: str) -> int:
        return len(self.ranges(name))

    def _host_at(self, t: float) -> str:
        """The innermost host range or operator of the window's thread
        running at ``t`` (on one thread ranges nest, so it is the latest
        started that still covers ``t``); "python" where none is."""
        if not hasattr(self, "_host_sorted"):
            evs = sorted((float(e["ts"]), float(e["ts"]) + float(
                e.get("dur", 0)), e.get("name", "?")) for e in self.host
                if (e.get("pid"), e.get("tid")) == self.window_tid
                and e.get("name") != WINDOW)
            self._host_sorted = evs
            self._host_starts = [s for s, _, _ in evs]
        evs = self._host_sorted
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(i - 20000, -1), -1):
            if evs[j][1] >= t:
                return evs[j][2]
        return "python"

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The ranged segment's gaps with no device operation running."""
        gaps, t = [], self.t0
        for s, e in self.ranged_busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_s_by_name().items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])
        by_host: Dict[str, float] = defaultdict(float)
        for s, e in gaps[:500]:            # the longest; the rest are short
            by_host[self._host_at((s + e) / 2)] += (e - s) / 1e6
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:120], v] for n, v in ops[:top]],
                "idle_gaps": [[n[:120], v] for n, v in idle[:top]]}


@contextmanager
def module_ranges(modules, name_of: Callable):
    """While active, each call of each module in ``modules`` runs inside a
    host range named ``name_of(module, args)`` (None: no range)."""
    open_ = {}
    handles = []

    def pre(mod, args):
        name = name_of(mod, args)
        if name is not None:
            open_[id(mod)] = Range(name).__enter__()

    def post(mod, args, out):
        r = open_.pop(id(mod), None)
        if r is not None:
            r.__exit__()

    for m in modules:
        handles.append(m.register_forward_pre_hook(pre))
        handles.append(m.register_forward_hook(post))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def backward_ranges(out, stop, name: str) -> int:
    """Put each autograd node between ``out`` and the tensors ``stop``
    (their own nodes excluded) inside a host range ``name`` while it runs
    in the backward; returns how many nodes it marked. Whatever implements
    the layer (one custom node or many plain ones), its backward's kernels
    land in the range."""
    # the stop nodes' wrappers stay referenced while the walk compares
    # identities (a wrapper made anew for the same node would not match)
    stop_nodes = [t.grad_fn for t in stop
                  if getattr(t, "grad_fn", None) is not None]
    stop_ids = {id(n) for n in stop_nodes}
    root = getattr(out, "grad_fn", None)
    if root is None:
        return 0
    seen, todo, nodes = set(), [root], []
    while todo:
        n = todo.pop()
        if n is None or id(n) in seen or id(n) in stop_ids:
            continue
        seen.add(id(n))
        nodes.append(n)
        todo.extend(nxt for nxt, _ in n.next_functions)
    open_ = {}
    for n in nodes:
        def pre(grad_outputs, key=id(n)):
            open_[key] = Range(name).__enter__()

        def post(grad_inputs, grad_outputs, key=id(n)):
            r = open_.pop(key, None)
            if r is not None:
                r.__exit__()

        n.register_prehook(pre)
        n.register_hook(post)
    return len(nodes)
