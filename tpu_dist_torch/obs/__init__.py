"""tpu_dist_torch.obs: the per-run observability handle of the port
(``tpu_dist/obs/__init__.py``, ``RunObs`` ``:79-510``).

:class:`RunObs` is the ported part of the reference's handle, built by
both trainers in place of a bare ``Ledger``:

* run lineage (``:97-120``): one logical job is N restart attempts, each
  writing its own ledger (``run.jsonl``, ``run.a1.jsonl``, ... and
  ``.pN`` for process N, by ``goodput.attempt_path`` and
  ``ledger.per_process_path``); ``attempt=-1`` probes this process's own
  prior files for the next free ordinal; ``job_id`` defaults to the
  ledger's stem. Both ride in ``run_start``;
* the hang watchdog (``obs.watchdog``, ``watchdog_factor``), beaten at
  each drain and paused around validation and checkpoint writes;
* the goodput monitor (``obs.goodput``, ``goodput_every_s``) as a ledger
  sink, with one final ``goodput`` event at ``run_end``;
* fault injection (``obs.faults``): the ``faults`` knob installs its plan,
  ``run_start`` registers the ledger and the attempt (the supervisor's
  ``TPU_DIST_ATTEMPT`` where set) as the fault context, and
  :meth:`RunObs.fire_step_faults` checks the step sites once an iteration;
* the supervisor's heartbeat file (``TPU_DIST_HEARTBEAT_FILE``, touched at
  most once a second at each drain, ``:478-500``);
* coordinated preemption (``:209-233``): a loop that can snapshot enables
  it, and a SIGTERM then only sets a flag (no lock, no I/O, no CUDA call
  in the handler) that the loop acts on at its next step boundary;
* the crash guard (``:345-422``): ``run_end`` at interpreter exit when a
  loop never reached it, the excepthook's traceback in that record, and a
  SIGTERM without a snapshot path ending the run with ``status=crashed``;
* the observers (``:124-175``): the step tracer (``obs.trace``; its spans
  enter ``torch.profiler`` ranges while a ``profile_dir`` session runs,
  which is rank 0's), the cross-rank skew monitor (``obs.skew``,
  ``skew_every``) over the world on the trainer's device, the metrics
  registry as a ledger sink and its Prometheus endpoint at ``metrics_port
  + process_index`` (``obs.metrics``; a ``metrics_snapshot`` event before
  ``run_end``, then the endpoint closes), the always-on flight recorder
  (``obs.flightrec``, ``flightrec_dir``, ``flightrec_trace_steps``) as a
  ledger sink, armed by ``SIGUSR1`` (``:358-363, 385-389``) and closed at
  ``run_end``: the handler writes one byte to a pipe (no lock, no CUDA
  call, beside the SIGTERM handler's one attribute write) and a daemon
  thread reading it captures the bundle, so a hung loop gets one too;
  the goodput monitor's progress-SLO floors (``slo_steps_per_min``,
  ``slo_throughput``); and :meth:`RunObs.observing`, the fit's telemetry
  sampler (``utils.telemetry``, ``telemetry_csv``) and ``profile_dir``
  session;
* the first dispatch of each program (:meth:`RunObs.first_dispatch`,
  :meth:`RunObs.emit_compile`): the ``compile`` event with the
  allocator's peak over that step, and the ``cost_model`` event of
  ``obs.attr`` when the ledger has a path and no profiler runs.
"""

from __future__ import annotations

import atexit
import dataclasses
import os
import signal
import sys
import threading
import time
import traceback
from contextlib import contextmanager, nullcontext
from typing import Optional

from tpu_dist_torch.obs import faults
from tpu_dist_torch.obs.flightrec import FlightRecorder
from tpu_dist_torch.obs.goodput import (GoodputMonitor, attempt_path,
                                        next_attempt_index)
from tpu_dist_torch.obs.ledger import EpochCsvSink, Ledger, per_process_path
from tpu_dist_torch.obs.metrics import (MetricsRegistry, metrics_ledger_sink,
                                        serve_metrics)
from tpu_dist_torch.obs.skew import SkewMonitor
from tpu_dist_torch.obs.trace import (StepTracer, profile_session,
                                      step_annotation)
from tpu_dist_torch.obs.watchdog import Watchdog

__all__ = ["RunObs", "env_int"]


def env_int(name: str, default: int = 0) -> int:
    """An integer environment variable, ``default`` when unset or bad."""
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class RunObs:
    """Per-run observability handle: attempt-aware ledger, health sentry,
    watchdog, goodput sink, the observers, faults, heartbeat, preemption
    and crash guard. ``process_index`` is this process's rank (its ``.pN``
    suffix); ``unit`` names the throughput unit of the run's step records;
    ``device`` is the trainer's device (the allocator the observers read,
    the skew exchange's tensors, over the whole world)."""

    def __init__(self, kind: str, cfg, process_index: int = 0,
                 unit: str = "items/s", device="cpu", plan_info=None):
        from tpu_dist_torch.obs.health import HealthSentry

        self.kind = kind
        self.cfg = cfg
        # the resolved step plan ({'source', 'hash', 'knobs', 'device_kind'}
        # from plan.compile.resolve_config_plan, or None): stamped into
        # run_start and emitted as its own 'plan' event (:94-97, 273-280)
        self.plan_info = plan_info
        self.unit = unit
        self.device = device
        pidx = int(process_index)
        self.process_index = pidx
        self.is_main = pidx == 0
        base_path = getattr(cfg, "ledger_path", "") or ""
        attempt = int(getattr(cfg, "attempt", 0) or 0)
        if attempt < 0:
            # probes THIS process's own prior files, so process 0 creating
            # the bare ledger first never makes a later-starting peer of
            # the same attempt self-assign the next index
            attempt = next_attempt_index(base_path, pidx) if base_path else 0
        self.attempt = attempt
        self.job_id = (getattr(cfg, "job_id", "") or
                       (os.path.splitext(os.path.basename(base_path))[0]
                        if base_path else None))
        self.ledger_path = per_process_path(attempt_path(base_path, attempt),
                                            pidx)
        self.ledger = Ledger(self.ledger_path or None, process_index=pidx)
        if getattr(cfg, "log_csv", "") and self.is_main:
            # the per-epoch CSV is a view of the epoch event
            self.ledger.add_sink(EpochCsvSink(cfg.log_csv))
        self.steps = 0
        self.ledger.add_sink(self._count_steps)
        self.profile_dir = getattr(cfg, "profile_dir", "") or ""
        self.profiling = bool(self.profile_dir) and self.is_main
        self.tracer = StepTracer(annotate=self.profiling)
        skew_every = getattr(cfg, "skew_every", 0) or 0
        self.skew = (SkewMonitor(skew_every, ledger=self.ledger,
                                 device=device) if skew_every > 0 else None)
        wd_factor = getattr(cfg, "watchdog_factor", 0.0) or 0.0
        self.watchdog = (Watchdog(wd_factor, ledger=self.ledger,
                                  device=device) if wd_factor > 0 else None)
        self.health = HealthSentry(getattr(cfg, "health", "record"),
                                   getattr(cfg, "health_spike_z", 8.0) or 0.0,
                                   ledger=self.ledger)
        # every event reaches the scrape through this one sink
        self.metrics = MetricsRegistry()
        self.ledger.add_sink(metrics_ledger_sink(self.metrics))
        self.metrics_server = None
        metrics_port = getattr(cfg, "metrics_port", 0) or 0
        if metrics_port > 0:
            self.metrics_server = serve_metrics(self.metrics,
                                                metrics_port + pidx)
        # the always-on flight recorder: stalls, health trips, skew spikes
        # and slo breaches reach it through the ledger; its profiler window
        # stands down while a profile_dir session owns the profiler
        self.flightrec = FlightRecorder(
            dir=getattr(cfg, "flightrec_dir", "") or "", ledger=self.ledger,
            trace_steps=getattr(cfg, "flightrec_trace_steps", 3),
            profiler_busy=lambda: self.profiling, process_index=pidx,
            device=device)
        self.ledger.add_sink(self.flightrec.sink)
        self.goodput = GoodputMonitor(
            self.ledger, every_s=getattr(cfg, "goodput_every_s", 60.0),
            slo_steps_per_min=getattr(cfg, "slo_steps_per_min", 0.0),
            slo_throughput=getattr(cfg, "slo_throughput", 0.0), unit=unit)
        self.ledger.add_sink(self.goodput.sink)
        # the config knob wins over TPU_DIST_FAULTS
        if getattr(cfg, "faults", ""):
            faults.install(cfg.faults)
        self._hb_path = (os.environ.get("TPU_DIST_HEARTBEAT_FILE", "")
                         if self.is_main else "")
        self._hb_last = 0.0
        self._t0 = time.time()
        self._ended = False
        self._crash_tb: Optional[str] = None
        self._prev_excepthook = None
        self._prev_sigterm = None
        self._prev_sigusr1 = None
        self._usr1_pipe = self._usr1_thread = None
        self._preempt_enabled = False
        # the SIGTERM handler's only write: a plain attribute (no lock)
        self._preempt_source: Optional[str] = None
        self._preempt_deadline: Optional[float] = None

    def _count_steps(self, rec: dict) -> None:
        if rec.get("event") == "step":
            self.steps += int(rec.get("steps_in_dispatch") or 1)

    # -- coordinated preemption ----------------------------------------
    def enable_preempt_snapshot(self) -> None:
        """Loops with a snapshot path call this before :meth:`run_start`:
        SIGTERM becomes a snapshot REQUEST the loop drains at its next
        step boundary rather than an immediate crash-guard shutdown."""
        self._preempt_enabled = True

    def request_preemption(self, deadline_s: Optional[float] = None,
                           source: str = "sigterm") -> None:
        """Arm the snapshot request (idempotent). ``deadline_s`` defaults
        to the supervisor-forwarded ``TPU_DIST_PREEMPT_DEADLINE_S``."""
        if self._preempt_source is not None:
            return
        self._preempt_deadline = deadline_s
        self._preempt_source = source

    def preempt_pending(self) -> bool:
        return self._preempt_source is not None

    @property
    def preempt_source(self) -> Optional[str]:
        return self._preempt_source

    @property
    def preempt_deadline_s(self) -> float:
        if self._preempt_deadline is not None:
            return float(self._preempt_deadline)
        try:
            return float(os.environ.get("TPU_DIST_PREEMPT_DEADLINE_S", "30"))
        except ValueError:
            return 30.0

    # -- lifecycle ------------------------------------------------------
    def run_start(self, **fields) -> None:
        """Emit ``run_start`` (the trainer's fields plus the lineage:
        ``job_id``, ``attempt``, ``resumed_from``, ``degraded`` and
        ``mesh_epoch``, and the step plan's ``plan_hash``, ``plan_source``
        and ``plan_knobs``) and, under a plan, one ``plan`` event right
        after it; set the fault context and arm the crash guard."""
        self._t0 = time.time()
        self._ended = False
        faults.set_ledger(self.ledger)
        # under a supervisor its launch counter is authoritative: the
        # ledger ordinal does not advance across ledgerless deaths
        faults.set_context(attempt=env_int("TPU_DIST_ATTEMPT", self.attempt))
        cfg = self.cfg
        self.ledger.emit(
            "run_start", kind=self.kind,
            config=(dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg)
                    else dict(cfg)),
            job_id=self.job_id, attempt=self.attempt,
            resumed_from=getattr(cfg, "resume", "") or None,
            degraded=os.environ.get("TPU_DIST_DEGRADED") == "1",
            mesh_epoch=env_int("TPU_DIST_MESH_EPOCH"),
            plan_hash=(self.plan_info or {}).get("hash"),
            plan_source=(self.plan_info or {}).get("source"),
            plan_knobs=(self.plan_info or {}).get("knobs"), **fields)
        if self.plan_info:
            self.ledger.emit(
                "plan", source=self.plan_info.get("source"),
                plan_hash=self.plan_info.get("hash"),
                knobs=self.plan_info.get("knobs"),
                device_kind=self.plan_info.get("device_kind"))
        self._arm_crash_guard()

    def run_end(self, status: Optional[str] = None, **extra) -> None:
        """Final goodput and ``run_end``, then close the ledger.
        Idempotent. ``status`` is derived from the active exception when
        not given (``crashed`` with a traceback, ``interrupted`` on
        ``KeyboardInterrupt``, else ``ok``); ``steps`` defaults to the
        step records this attempt emitted."""
        if self._ended:
            return
        self._ended = True
        self._disarm_crash_guard()
        if self.watchdog is not None:
            self.watchdog.stop()
        # a profiler window left open ends before the final events land
        self.flightrec.close()
        if status is None:
            exc = sys.exc_info()[1]
            if exc is None and self._crash_tb is not None:
                status = "crashed"
                extra.setdefault("error", self._crash_tb)
            elif isinstance(exc, KeyboardInterrupt):
                status = "interrupted"
            elif exc is not None:
                status = "crashed"
                extra.setdefault("error", "".join(
                    traceback.format_exception(type(exc), exc,
                                               exc.__traceback__))[-2000:])
            else:
                status = "ok"
        try:
            self.goodput.emit_goodput(final=True)
        except Exception:
            pass
        steps = extra.pop("steps", self.steps)
        # the registry's final values outlive the endpoint in the ledger
        self.ledger.emit("metrics_snapshot", metrics=self.metrics.snapshot())
        self.ledger.emit("run_end", steps=steps,
                         seconds=round(time.time() - self._t0, 6),
                         status=status, health_trips=self.health.trips,
                         **extra)
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None
        self.ledger.close()

    # -- crash-safe shutdown -------------------------------------------
    def _arm_crash_guard(self) -> None:
        atexit.register(self._atexit_end)
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        try:
            if threading.current_thread() is threading.main_thread():
                self._prev_sigterm = signal.signal(signal.SIGTERM,
                                                   self._on_sigterm)
        except (ValueError, OSError):
            self._prev_sigterm = None
        # kill -USR1 <pid>: a flight-recorder bundle, the run goes on
        if threading.current_thread() is threading.main_thread() and \
                hasattr(signal, "SIGUSR1"):
            r, w = os.pipe()
            os.set_blocking(w, False)
            self._usr1_pipe = (r, w)
            self._usr1_thread = threading.Thread(
                target=self._usr1_captures, args=(r,),
                name="tpu-dist-sigusr1", daemon=True)
            self._usr1_thread.start()
            self._prev_sigusr1 = signal.signal(signal.SIGUSR1,
                                               self._on_sigusr1)

    def _disarm_crash_guard(self) -> None:
        try:
            atexit.unregister(self._atexit_end)
        except Exception:
            pass
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass
            self._prev_sigterm = None
        if self._usr1_pipe is not None:
            try:
                signal.signal(signal.SIGUSR1, self._prev_sigusr1)
            except (ValueError, OSError, TypeError):
                pass
            self._prev_sigusr1 = None
            r, w = self._usr1_pipe
            os.close(w)                   # the capture thread sees EOF
            self._usr1_thread.join(timeout=10)
            os.close(r)
            self._usr1_pipe = self._usr1_thread = None

    def _on_sigusr1(self, signum, frame) -> None:
        try:
            os.write(self._usr1_pipe[1], b"u")
        except (OSError, TypeError):      # a full pipe, or disarmed
            pass
        prev = self._prev_sigusr1
        if callable(prev):
            prev(signum, frame)

    def _usr1_captures(self, r: int) -> None:
        """The SIGUSR1 pipe's reader: one bundle a byte, until EOF."""
        while os.read(r, 1):
            self.flightrec.trigger("sigusr1")

    def _excepthook(self, exc_type, exc, tb) -> None:
        self._crash_tb = "".join(
            traceback.format_exception(exc_type, exc, tb))[-2000:]
        prev = self._prev_excepthook or sys.__excepthook__
        prev(exc_type, exc, tb)

    def _atexit_end(self) -> None:
        if not self._ended:
            self.run_end(status="crashed" if self._crash_tb else "ok",
                         **({"error": self._crash_tb}
                            if self._crash_tb else {}))

    def _on_sigterm(self, signum, frame) -> None:
        if self._preempt_enabled and not self._ended:
            # coordinated path: one attribute write; the loop finishes
            # the in-flight step, snapshots, and owns run_end and the exit
            if self._preempt_source is None:
                self._preempt_source = "SIGTERM"
            return
        prev = self._prev_sigterm
        self.run_end(status="crashed", error="SIGTERM")
        if callable(prev):
            prev(signum, frame)
        else:
            raise SystemExit(143)

    # -- the fit's observers --------------------------------------------
    @contextmanager
    def observing(self):
        """Around a fit's training: the telemetry sampler (every rank, its
        CSV ``.pN``-suffixed) and the ``profile_dir`` session (rank 0's),
        both stopped on every exit path."""
        from tpu_dist_torch.utils.telemetry import start_hbm_sampler

        csv_path = getattr(self.cfg, "telemetry_csv", "") or ""
        stop = (start_hbm_sampler(
            per_process_path(csv_path, self.process_index),
            ledger=self.ledger, device=self.device) if csv_path else None)
        try:
            with profile_session(self.profile_dir, self.profiling,
                                 self.process_index, self.device):
                yield
        finally:
            if stop is not None:
                stop()

    def first_dispatch(self):
        """Around a program's first dispatch: the allocator's peak reset,
        and the cost attribution's dispatch mode when the ledger has a
        path and no profiler session or recorder window runs."""
        from tpu_dist_torch.obs.attr import FirstDispatch

        cost = (bool(self.ledger.path) and not self.profiling
                and not self.flightrec.window_open())
        return FirstDispatch(self.device, cost)

    def dispatch(self, gstep: int, fn, first: bool, audit=None):
        """``fn()``, one dispatch of step ``gstep``, under the tracer's
        ``dispatch`` span (a ``ProfilerStep#gstep`` range while profiling)
        and, for a program's ``first`` dispatch, :meth:`first_dispatch`,
        inside which the program audit's recorder ``audit`` runs where
        given (``plan.compile.audit_recorder``). Returns (``fn()``'s
        result, its seconds, the first dispatch's probe or None)."""
        probe = self.first_dispatch() if first else None
        with step_annotation(gstep, self.profiling), \
                self.tracer.span("dispatch"), probe or nullcontext(), \
                audit or nullcontext():
            out = fn()
        return out, self.tracer.pop().get("dispatch", 0.0), probe

    def emit_compile(self, program: str, seconds: float, probe,
                     analytic_flops: float, dtype) -> None:
        """The ``compile`` event of ``program``'s first dispatch (``probe``,
        from :meth:`dispatch`, read after the warm-up sync): its seconds,
        the allocator's peak over it, and its flops (the dispatch mode's
        total where the mode ran, else ``analytic_flops``); then the
        ``cost_model`` event where the mode ran."""
        from tpu_dist_torch.obs.attr import bucket_totals, emit_cost_model
        from tpu_dist_torch.utils.telemetry import peak_hbm_bytes

        buckets = probe.buckets()
        self.ledger.emit(
            "compile", program=program, seconds=seconds or None,
            hbm_bytes=peak_hbm_bytes(self.device),
            flops=(bucket_totals(buckets)["flops"] if buckets
                   else analytic_flops))
        emit_cost_model(self.ledger, program, buckets, self.device, dtype)

    # -- per-step -------------------------------------------------------
    def record_skew(self, step: int, wall_s: float, data_s: float,
                    n_steps: int = 1) -> None:
        """Feed one step record to the skew monitor. A collective: every
        rank calls it for the same records."""
        if self.skew is not None:
            self.skew.record(step, wall_s, data_s, n_steps=n_steps)

    def fire_step_faults(self, step: int, params=()) -> dict:
        """The step-scoped fault sites for this step ordinal, once a loop
        iteration before its dispatch: hard_exit / hang / preempt_sigterm
        act inside fire_step, ``nan_batch`` poisons the first floating
        tensor of ``params`` (the fp32 masters) in place and
        ``preempt_deadline`` requests a snapshot. Returns the fired
        ``{site: Fault}``; near-free without a plan."""
        effects = faults.fire_step(step, ledger=self.ledger)
        if "nan_batch" in effects:
            faults.poison_params(params)
        if "preempt_deadline" in effects:
            self.request_preemption(
                deadline_s=effects["preempt_deadline"].args.get("secs"),
                source="fault")
        return effects

    def preempt_agreed(self, world: int, device, pending=None) -> bool:
        """Whether the loop snapshots at this step boundary. One process
        acts on its own flag at every boundary. Over several, a SIGTERM
        that one rank sees and another does not would split the ranks
        (one in the checkpoint's gather, one in the next step's
        all-reduce): the flag is max-reduced over the world at the
        boundaries right after a drain (``pending`` empty: the same
        iterations on every rank, where the host has just synced), so
        every rank takes the same decision at the same step."""
        if world == 1:
            return self.preempt_pending()
        if pending:
            return False
        import torch

        from tpu_dist_torch.parallel.collectives import pmax

        flag = torch.tensor([float(self.preempt_pending())], device=device)
        return bool(pmax(flag).item())

    def heartbeat(self) -> None:
        """Device progress proven (a drain's fetch returned): beat the
        watchdog and touch the supervisor's heartbeat file (at most once a
        second; a full disk never takes the run down)."""
        if self.watchdog is not None:
            self.watchdog.beat()
        if self._hb_path:
            now = time.time()
            if now - self._hb_last >= 1.0:
                self._hb_last = now
                try:
                    with open(self._hb_path, "w") as f:
                        f.write(f"{now}\n")
                except OSError:
                    pass

    def pause(self) -> None:
        """Entering a phase where step completions legitimately stop
        (validation, checkpoint writes): silence the watchdog."""
        if self.watchdog is not None:
            self.watchdog.pause()

    def resume(self) -> None:
        if self.watchdog is not None:
            self.watchdog.resume()
