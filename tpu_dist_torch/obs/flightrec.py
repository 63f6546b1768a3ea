"""Triggered flight recorder for the port (``tpu_dist/obs/flightrec.py``):
capture a forensic bundle at the bad moment.

The recorder is always on (a bounded in-memory ring of recent ledger
records) and, when triggered, writes one self-contained bundle directory:

* ``manifest.json``    — reason, step, timestamps, file inventory, trace
  status (the machine-readable index; rewritten when the trace lands);
* ``stacks.txt``       — every Python thread's stack at trigger time;
* ``hbm.json``         — the CUDA allocator's counters of the run's device
  (``utils.telemetry``; ``{}`` off CUDA);
* ``memory_snapshot.pickle`` — in place of the reference's
  ``memory.prof``: the CUDA caching allocator's snapshot,
  ``torch.cuda.memory._snapshot(device)``, pickled (its segments and
  blocks, for OOM forensics; load it with ``pickle`` or
  ``torch.cuda.memory``'s viewer), listed in the manifest under its own
  name; absent off CUDA;
* ``events_tail.jsonl``— the ring: the last N ledger records leading up
  to the trigger;
* ``trace/``           — ``trace.json``, a ``torch.profiler`` Chrome trace
  (``obs.trace.device_profiler``) of the next K step records after the
  trigger (armed at trigger time,
  started and stopped on the loop thread from the step-record sink:
  profiler state is global, so a trigger from another thread never
  touches it). It is vetoed while a ``profile_dir`` session owns the
  profiler.

Triggers: watchdog ``stall`` events, health-sentry ``health`` trips, skew
samples whose spread marks a straggler spike, progress-SLO ``slo``
breaches (``obs.goodput``), ``SIGUSR1`` (armed by ``RunObs``), or a
direct :meth:`FlightRecorder.trigger` call. All but the signal arrive
through the run ledger's event stream (the recorder is a ledger sink, as
the metrics registry is). Each bundle emits a ``diagnosis`` ledger event
pointing at its directory; a cooldown and a bundle cap keep a flapping
detector from filling the disk, each with a one-line stderr note.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from tpu_dist_torch.obs.ledger import Ledger

# a skew sample is a straggler SPIKE (not routine jitter) when the
# cross-host spread exceeds both bounds
SKEW_SPREAD_FACTOR = 4.0   # x the sample's own p50 step time
SKEW_SPREAD_MIN_S = 0.5    # and an absolute floor


def _skew_is_spike(rec: dict) -> bool:
    spread = rec.get("spread_s")
    p50 = rec.get("p50_s")
    if spread is None:
        return False
    return (spread >= SKEW_SPREAD_MIN_S
            and spread >= SKEW_SPREAD_FACTOR * (p50 or 0.0))


class FlightRecorder:
    """Always-on ring + triggered bundle capture (see module docstring).

    ``dir=''`` derives the bundle root lazily at first trigger: beside the
    ledger file when it has a path, else a fresh temp directory — a
    triggered capture must never be lost to a missing config knob.
    ``trace_steps=0`` disables the profiler window (the rest of the bundle
    still captures); ``profiler_busy`` lets the owner veto the window when
    a ``profile_dir`` session already drives the (global) profiler.
    """

    def __init__(self, dir: str = "", ledger: Optional[Ledger] = None,
                 ring_size: int = 256, trace_steps: int = 3,
                 profiler_busy: Optional[Callable[[], bool]] = None,
                 cooldown_s: float = 60.0, max_bundles: int = 8,
                 process_index: int = 0, device=None):
        self._dir = dir or ""
        self.ledger = ledger
        self.trace_steps = max(int(trace_steps), 0)
        self._profiler_busy = profiler_busy or (lambda: False)
        self.cooldown_s = cooldown_s
        self.max_bundles = max_bundles
        self.process_index = process_index
        self.device = device   # whose allocator the bundle reads
        self.ring: deque = deque(maxlen=ring_size)
        self.bundles: List[str] = []
        # RLock, not Lock: the SIGUSR1 handler runs ON the main thread and
        # calls trigger() — if the signal lands while that same thread is
        # inside sink()/_advance_trace() holding this lock, a plain Lock
        # would self-deadlock (the same hazard Ledger._lock documents)
        self._lock = threading.RLock()
        self._last_trigger: Optional[float] = None
        self._last_step: Optional[int] = None
        self._drop_noted = False   # one cooldown note per window
        self._cap_noted = False    # one cap note per run
        # pending/active profiler window: {"state", "bundle", "manifest",
        # "remaining"} — mutated only under _lock, profiler calls only on
        # the loop thread (step-event sink)
        self._trace: Optional[dict] = None
        self._seq = 0

    # -- the ledger-sink half (auto-triggers + ring + trace advance) ------
    def sink(self, rec: dict) -> None:
        """Registered on the run ledger: every event feeds the ring; the
        detector events trigger a capture; step records drive the armed
        profiler window (they are emitted on the loop thread at drain
        boundaries — the only safe place to touch global profiler state)."""
        ev = rec.get("event")
        with self._lock:
            self.ring.append(rec)
            if ev == "step" and rec.get("step") is not None:
                self._last_step = rec["step"]
        if ev == "step":
            self._advance_trace()
        elif ev == "stall":
            self.trigger("stall", note=f"idle {rec.get('idle_s')}s "
                                       f"(threshold {rec.get('threshold_s')}s)")
        elif ev == "health":
            self.trigger("health", note=f"{rec.get('kind')} at step "
                                        f"{rec.get('step')} -> "
                                        f"{rec.get('action')}")
        elif ev == "skew" and _skew_is_spike(rec):
            self.trigger("skew", note=f"spread {rec.get('spread_s')}s, "
                                      f"straggler {rec.get('straggler')}")
        elif ev == "slo":
            # progress-SLO breach (obs.goodput): the run is alive but not
            # making floor-rate progress — exactly a flight-record moment
            self.trigger("slo", note=f"{rec.get('kind')} "
                                     f"{rec.get('value')} < floor "
                                     f"{rec.get('floor')} at step "
                                     f"{rec.get('step')}")

    # -- capture ----------------------------------------------------------
    def _base_dir(self) -> str:
        if not self._dir:
            if self.ledger is not None and self.ledger.path:
                self._dir = self.ledger.path + ".flightrec"
            else:
                self._dir = tempfile.mkdtemp(prefix="tpu_dist_torch_flightrec.")
        os.makedirs(self._dir, exist_ok=True)
        return self._dir

    def trigger(self, reason: str, note: Optional[str] = None) -> Optional[str]:
        """Capture a bundle NOW (ring tail, stacks, HBM, allocator snapshot,
        manifest), arm the profiler window for the next ``trace_steps``
        step records, and emit the ``diagnosis`` ledger event. Returns the
        bundle directory, or None when rate-limited (cooldown) or capped.
        Safe to call from any thread — the profiler is never touched here.
        """
        import sys

        now = time.monotonic()
        with self._lock:
            if self._last_trigger is not None \
                    and now - self._last_trigger < self.cooldown_s:
                # dropped-but-observable: an operator's kill -USR1 inside
                # the cooldown must not look like a dead recorder — but a
                # flapping detector triggering every step must not flood
                # stderr either, so note only the FIRST drop per window
                if not self._drop_noted:
                    self._drop_noted = True
                    print(f"tpu_dist_torch flightrec: {reason!r} trigger dropped"
                          f" (cooldown {self.cooldown_s:g}s; further drops"
                          " this window are silent)", file=sys.stderr)
                return None
            if len(self.bundles) >= self.max_bundles:
                if not self._cap_noted:
                    self._cap_noted = True
                    print(f"tpu_dist_torch flightrec: {reason!r} trigger dropped"
                          f" (bundle cap {self.max_bundles} reached; no "
                          "further captures this run)", file=sys.stderr)
                return None
            self._drop_noted = False
            self._last_trigger = now
            self._seq += 1
            seq = self._seq
            tail = list(self.ring)
            step = self._last_step
        bundle = os.path.join(
            self._base_dir(),
            f"{seq:03d}-{reason}-p{self.process_index}")
        os.makedirs(bundle, exist_ok=True)
        files = {}
        files["stacks.txt"] = self._write_stacks(bundle)
        files["hbm.json"] = self._write_hbm(bundle)
        files["memory_snapshot.pickle"] = self._write_memory_snapshot(bundle)
        files["events_tail.jsonl"] = self._write_tail(bundle, tail)
        trace_status = self._arm_trace(bundle)
        manifest = {
            "reason": reason,
            "note": note,
            "step": step,
            "ts": time.time(),
            "process_index": self.process_index,
            "files": {k: v for k, v in files.items() if v},
            "trace": trace_status,
        }
        self._write_manifest(bundle, manifest)
        if trace_status["status"] == "armed":
            with self._lock:
                self._trace = {"state": "armed", "bundle": bundle,
                               "manifest": manifest,
                               "remaining": self.trace_steps}
        with self._lock:
            self.bundles.append(bundle)
        if self.ledger is not None:
            try:
                self.ledger.emit("diagnosis", reason=reason, bundle=bundle,
                                 step=step, note=note,
                                 trace=trace_status["status"])
            except Exception:
                pass  # a capture must never take the run down
        return bundle

    def _write_manifest(self, bundle: str, manifest: dict) -> None:
        try:
            tmp = os.path.join(bundle, "manifest.json.tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, default=str)
            os.replace(tmp, os.path.join(bundle, "manifest.json"))
        except OSError:
            pass

    def _write_stacks(self, bundle: str) -> Optional[str]:
        from tpu_dist_torch.obs.watchdog import thread_stacks

        try:
            with open(os.path.join(bundle, "stacks.txt"), "w") as f:
                f.write(thread_stacks())
            return "stacks.txt"
        except OSError:
            return None

    def _write_hbm(self, bundle: str) -> Optional[str]:
        try:
            from tpu_dist_torch.utils.telemetry import device_memory_stats

            stats = device_memory_stats(self.device)
        except Exception:
            return None
        try:
            with open(os.path.join(bundle, "hbm.json"), "w") as f:
                json.dump(stats, f, indent=1, default=str)
            return "hbm.json"
        except OSError:
            return None

    def _write_memory_snapshot(self, bundle: str) -> Optional[str]:
        """The CUDA caching allocator's snapshot of the run's device,
        pickled; None off CUDA (the reference's ``memory.prof`` likewise
        depends on the backend)."""
        import pickle

        from tpu_dist_torch.utils.telemetry import device_memory_stats

        if not device_memory_stats(self.device):
            return None
        import torch

        try:
            snap = torch.cuda.memory._snapshot(self.device)
            with open(os.path.join(bundle, "memory_snapshot.pickle"),
                      "wb") as f:
                pickle.dump(snap, f)
            return "memory_snapshot.pickle"
        except (OSError, RuntimeError):
            return None

    def _write_tail(self, bundle: str, tail: list) -> Optional[str]:
        try:
            with open(os.path.join(bundle, "events_tail.jsonl"), "w") as f:
                for rec in tail:
                    f.write(json.dumps(rec, default=str) + "\n")
            return "events_tail.jsonl"
        except OSError:
            return None

    # -- the profiler window ---------------------------------------------
    def _arm_trace(self, bundle: str) -> dict:
        if self.trace_steps <= 0:
            return {"status": "disabled", "steps": 0}
        if self._profiler_busy():
            return {"status": "skipped",
                    "why": "a profile_dir session owns the profiler"}
        with self._lock:
            if self._trace is not None:
                return {"status": "skipped",
                        "why": "a prior bundle's window is still open"}
        return {"status": "armed", "steps": self.trace_steps,
                "dir": "trace"}

    def window_open(self) -> bool:
        """Whether a profiler window is armed or running."""
        with self._lock:
            return self._trace is not None

    def _advance_trace(self) -> None:
        """Called on every step record (loop thread): start an armed
        window, count an active one down, stop it when it completes."""
        with self._lock:
            tr = self._trace
            if tr is None:
                return
            state = tr["state"]
        if state == "armed":
            try:
                from tpu_dist_torch.obs.trace import device_profiler

                prof = device_profiler(self.device)
                prof.__enter__()
                with self._lock:
                    tr["prof"] = prof
                    tr["state"] = "active"
            except Exception as e:
                self._finish_trace(tr, "failed", why=repr(e))
            return
        with self._lock:
            tr["remaining"] -= 1
            done = tr["remaining"] <= 0
        if done:
            self._stop_trace(tr, "captured")

    def _stop_trace(self, tr: dict, status: str, why: Optional[str] = None):
        try:
            prof = tr["prof"]
            prof.__exit__(None, None, None)
            out = os.path.join(tr["bundle"], "trace")
            os.makedirs(out, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out, "trace.json"))
        except Exception as e:
            status, why = "failed", repr(e)
        self._finish_trace(tr, status, why=why)

    def _finish_trace(self, tr: dict, status: str,
                      why: Optional[str] = None) -> None:
        manifest = tr["manifest"]
        manifest["trace"] = {"status": status, "dir": "trace",
                             "steps": self.trace_steps}
        if why:
            manifest["trace"]["why"] = why
        self._write_manifest(tr["bundle"], manifest)
        with self._lock:
            if self._trace is tr:
                self._trace = None

    def close(self) -> None:
        """Finalize a window left open at run end (a stall with no
        subsequent steps — the honest manifest says so)."""
        with self._lock:
            tr = self._trace
        if tr is None:
            return
        if tr["state"] == "active":
            self._stop_trace(tr, "captured",
                             why="truncated: run ended inside the window")
        else:
            self._finish_trace(tr, "not-captured",
                               why="no step completed after the trigger")
