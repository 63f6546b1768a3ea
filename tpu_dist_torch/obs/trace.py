"""Step-phase tracer and profiler session for the port
(``tpu_dist/obs/trace.py``), over ``torch.profiler``.

:class:`StepTracer` accumulates named host-side spans
(``with tracer.span("dispatch"): ...``) into the per-step seconds the
ledger's ``step`` records carry; spans nest under joined paths
(``data`` -> ``data/decode``). With ``annotate=True`` (a ``profile_dir``
session is on) each span also enters ``torch.profiler.record_function``
under its path, so the host phases appear as named ranges on the trace,
and :func:`step_annotation` marks each step's number there.

:func:`profile_session` is the trainers' one device-tracing entry point:
the ``torch.profiler`` session (:func:`device_profiler`: the CPU's
operators, and the kernels on a CUDA device) over the whole fit, stopped
on every exit path (a normal end, an exception, a health halt, the
preemption snapshot's ``SystemExit``) and exported as one Chrome trace,
``trace.json`` in ``profile_dir`` (process N: ``trace.pN.json``, by
``ledger.per_process_path``).

Profiler state is process-global: the flight recorder's ``trace/`` window
(``obs.flightrec``) is vetoed while a session runs, and the first step's
cost attribution (``obs.attr``) does not run under one.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from typing import Dict


class StepTracer:
    """Accumulating named spans for one step (or window) of host work.

    A span opened inside another accumulates under the joined path, and
    the parent's total includes the child's time. :meth:`pop` collects
    {phase: seconds} and resets at each step boundary; :meth:`add` folds in
    seconds measured elsewhere."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self._acc: Dict[str, float] = {}
        self._stack = []

    @contextmanager
    def span(self, name: str):
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        ann = None
        if self.annotate:
            import torch

            ann = torch.profiler.record_function(path)
            ann.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if ann is not None:
                ann.__exit__(None, None, None)
            self._stack.pop()
            self._acc[path] = self._acc.get(path, 0.0) + dt

    def add(self, name: str, seconds: float) -> None:
        """Fold externally measured seconds into a phase."""
        self._acc[name] = self._acc.get(name, 0.0) + float(seconds)

    def phases(self) -> Dict[str, float]:
        return dict(self._acc)

    def pop(self) -> Dict[str, float]:
        """Collect the accumulated {phase: seconds} and reset."""
        out, self._acc = self._acc, {}
        return out


@contextmanager
def step_annotation(step_num: int, enabled: bool = True):
    """A ``ProfilerStep#N`` range around one step's dispatch (the name
    ``torch.profiler`` gives its own step markers), so the trace's steps
    carry the ledger's step numbers; a no-op when disabled."""
    if not enabled:
        yield
        return
    import torch

    with torch.profiler.record_function(f"ProfilerStep#{step_num}"):
        yield


def device_profiler(device):
    """A profiler of the CPU's operators and, on a CUDA ``device``, its
    kernels: the kineto profiler ``torch.profiler.profile`` drives
    (``torch.autograd.profiler.profile``), taken directly because
    ``torch.profiler.profile``'s own ``start`` imports ``torch._inductor``
    (7 s on an H100 machine with triton) the first time it runs. Started
    by ``__enter__``, stopped by ``__exit__``, then
    ``export_chrome_trace``."""
    import torch

    cuda = device is not None and torch.device(device).type == "cuda"
    return torch.autograd.profiler.profile(
        use_device="cuda" if cuda else None, use_kineto=True)


@contextmanager
def profile_session(profile_dir: str, enabled: bool = True,
                    process_index: int = 0, device=None):
    """Profile the body into ``profile_dir``'s Chrome trace and stop the
    profiler on every exit path. Yields whether a session runs. A failed
    export warns on stderr and never replaces the body's own exception."""
    if not (profile_dir and enabled):
        yield False
        return
    from tpu_dist_torch.obs.ledger import per_process_path

    os.makedirs(profile_dir, exist_ok=True)
    path = per_process_path(os.path.join(profile_dir, "trace.json"),
                            process_index)
    prof = device_profiler(device)
    prof.__enter__()
    try:
        yield True
    finally:
        prof.__exit__(None, None, None)
        try:
            prof.export_chrome_trace(path)
        except (OSError, RuntimeError) as e:
            print(f"tpu_dist_torch profile_session: trace export to {path} "
                  f"failed ({e!r})", file=sys.stderr)
