"""Hang watchdog for the port (``tpu_dist/obs/watchdog.py``): stack and
device-memory dump when a step stops completing.

The port's own copy of the reference's detector: the same trailing-median
threshold, 5 s floor, one ``stall`` ledger event a stall (``idle_s``,
``threshold_s``, ``stacks``, ``hbm``, ``last_event``), ``pause``/``resume``
around validation and checkpoint writes, and ``beat`` at each drain. The
dump's memory counters are the CUDA allocator's, of the trainer's device,
read through the port's telemetry module (``utils.telemetry``) as the
reference reads its own; none off CUDA.

A hung collective (one host dropped out), a deadlocked loader thread, or a
device queue stuck behind a tunneled controller all present the same way: a
training loop that silently stops printing, forever. The reference cookbook
— and rounds 1-5 of this repo — would sit there until someone killed the
job with zero forensic record.

The watchdog is a daemon thread armed by step completions: the loop calls
:meth:`step_done` after every optimizer-step (or window) dispatch cycle,
which maintains a trailing median of step durations. If no step completes
within ``factor x median`` (floored at ``min_timeout_s`` so fast CPU loops
never false-trigger), it dumps — ONCE per stall — to stderr and the ledger:

* every Python thread's stack (``sys._current_frames``), which catches the
  loader/prefetch/checkpoint threads too;
* live device-memory counters (:func:`device_memory_stats`);
* the last ledger event (what the run was doing when it stopped).

It never kills the run: a stall that resolves (a slow eval, a network blip)
re-arms on the next ``step_done`` and the run continues with the dump as a
breadcrumb. Loops call :meth:`pause` around phases where step completions
legitimately stop (validation, checkpoint gather) and :meth:`resume` when
stepping resumes. Opt out with ``watchdog_factor=0`` in the config.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import deque
from typing import Optional

from tpu_dist_torch.obs.ledger import Ledger
from tpu_dist_torch.utils.telemetry import device_memory_stats


def thread_stacks() -> str:
    """Formatted stacks of every live Python thread (the dump payload)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in sys._current_frames().items():
        parts.append(f"--- thread {names.get(ident, '?')} ({ident}) ---\n"
                     + "".join(traceback.format_stack(frame)))
    return "\n".join(parts)


class Watchdog:
    """Trailing-median hang detector. Thread starts lazily on the first
    :meth:`step_done` (constructing one per Trainer is free until a loop
    actually steps)."""

    def __init__(self, factor: float = 10.0,
                 ledger: Optional[Ledger] = None,
                 min_timeout_s: float = 5.0,
                 poll_s: float = 0.5,
                 stream=None, device=None):
        if factor <= 0:
            raise ValueError("watchdog factor must be > 0 (use no watchdog "
                             "instead of factor<=0)")
        self.factor = factor
        self.ledger = ledger
        self.min_timeout_s = min_timeout_s
        self.poll_s = poll_s
        self._stream = stream  # None -> sys.stderr at dump time (testable)
        self.device = device   # whose allocator counters the dump reads
        self._durations = deque(maxlen=64)
        self._last_done: Optional[float] = None
        self._fired_this_stall = False
        self.stall_count = 0
        self._paused = False
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # -- loop-side API --------------------------------------------------
    def step_done(self, seconds: float) -> None:
        """A step (or dispatch window) completed in ``seconds``."""
        with self._lock:
            self._durations.append(float(seconds))
            self._last_done = time.monotonic()
            self._fired_this_stall = False  # stall over; re-arm
            self._paused = False
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="tpu-dist-watchdog", daemon=True)
            self._thread.start()

    def beat(self) -> None:
        """Progress proven NOW; duration = time since the previous beat.

        The engines beat at drain sync points (the blocking device_get),
        because under async dispatch that is the only moment the host
        KNOWS the devices advanced — off-boundary iterations merely
        enqueue. Beating there with the full inter-drain duration makes
        the trailing median track the print-window cadence, so a
        long-but-healthy boundary block never trips the threshold while a
        genuine hang (> factor x a normal window) still does. The first
        beat after construction/resume only arms (no duration yet)."""
        now = time.monotonic()
        with self._lock:
            # a beat right after pause() (eval/ckpt just ran) only re-arms:
            # its duration would include the paused phase, not a window
            last = None if self._paused else self._last_done
        if last is None:
            with self._lock:
                self._last_done = now
                self._paused = False
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="tpu-dist-watchdog", daemon=True)
                self._thread.start()
            return
        self.step_done(now - last)

    def pause(self) -> None:
        """Suspend stall detection (validation/checkpoint phases where no
        step completes by design)."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            self._last_done = time.monotonic()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s + 1)

    # -- detector -------------------------------------------------------
    def _threshold_s(self) -> Optional[float]:
        if not self._durations:
            return None
        med = sorted(self._durations)[len(self._durations) // 2]
        return max(self.factor * med, self.min_timeout_s)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                if (self._paused or self._fired_this_stall
                        or self._last_done is None):
                    continue
                thr = self._threshold_s()
                idle = time.monotonic() - self._last_done
                if thr is None or idle < thr:
                    continue
                self._fired_this_stall = True  # once per stall
                self.stall_count += 1
            self._dump(idle, thr)

    def _dump(self, idle_s: float, threshold_s: float) -> None:
        stacks = thread_stacks()
        try:
            hbm = device_memory_stats(self.device)
        except Exception:
            hbm = {}
        last = self.ledger.last if self.ledger is not None else None
        stream = self._stream or sys.stderr
        print(f"\n=== tpu_dist_torch watchdog: NO STEP COMPLETED for "
              f"{idle_s:.1f}s (threshold {threshold_s:.1f}s = "
              f"{self.factor:g} x trailing-median step) ===\n"
              f"last ledger event: {last}\n"
              f"hbm: {hbm or 'n/a'}\n{stacks}\n"
              f"=== end watchdog dump (run NOT killed) ===",
              file=stream, flush=True)
        if self.ledger is not None:
            try:
                self.ledger.emit(
                    "stall", idle_s=round(idle_s, 3),
                    threshold_s=round(threshold_s, 3), stacks=stacks,
                    hbm=hbm or None, last_event=last)
            except Exception:
                pass  # the dump must never take the run down
