"""Run ledger: append-only JSONL of typed run events (the observability spine).

The port's own copy of ``tpu_dist/obs/ledger.py`` (stdlib only): the port
imports nothing of the JAX package, and the copy keeps the same event names
and fields, so ``tools/ledger_report.py`` reads port runs unchanged. Keep
``EVENT_SCHEMA`` in step with the reference when either side adds an event.

The reference cookbook's only record of a run is whatever scrolled past on
stdout plus a per-epoch CSV clone in every script; tpu_dist's round-1-5
engines reproduced those and then grew ad-hoc extras (bench JSON, MFU
prints, HBM probes) with no machine-readable per-step record. The ledger
replaces all of that as the source of truth: every engine/bench/decode run
appends one JSON object per event to ``ledger_path``, and the legacy
artifacts (epoch CSV, progress line) become *sinks* rendered from ledger
records rather than independently computed values.

Schema discipline: ``EVENT_SCHEMA`` below is a PURE LITERAL (dict of
event-name -> tuple of required field names) so ``tools/check_ledger_schema``
can extract it by AST walk — without importing jax — and statically verify
every ``*.emit("<event>", ...)`` call site in the tree names a declared
event and passes its required fields. Values may be ``None`` (e.g. MFU on a
backend with no cost model); *presence* is what the schema pins, so readers
can always key into a record without guards.

Multi-host: each process writes its OWN file — ``per_process_path`` suffixes
non-main paths with the process index (``run.jsonl`` -> ``run.p1.jsonl``) so
N processes never interleave writes into one file. ``emit`` is
thread-safe (the HBM sampler and the hang watchdog feed the ledger from
daemon threads).
"""

from __future__ import annotations

import csv
import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional

# event name -> required fields. PURE LITERAL (tools/check_ledger_schema
# extracts it via ast.literal_eval — no computed values, no imports).
# Required means "key present"; None values are legal where a backend
# cannot supply the number. ``event``/``ts``/``pid`` are stamped by emit().
EVENT_SCHEMA = {
    # run identity: full config + mesh + device kinds, once per run
    "run_start": ("kind", "config", "mesh", "devices", "process_count"),
    # first-dispatch / AOT-probe record (program stats, warm seconds)
    "compile": ("program",),
    # one optimizer step (or one K-step dispatch window: steps_in_dispatch
    # carries the window size) with the full phase breakdown. comm_s is the
    # communication share: unlike the other phases it OVERLAPS device_s
    # (that is the point of parallel.overlap), so it is reported beside the
    # share table, not inside it. None where the engine cannot isolate it
    # (fused GSPMD sync, ring TP interleaving); the explicit bucketed-sync
    # mode stamps a standalone-probe estimate, tools/comm_bench.py measures
    # it exactly (its programs are pure communication). Engines additionally
    # stamp a boolean `fused` extra: whether int8 matmuls rode the fused
    # Pallas kernel (ops.pallas_quant) — ledger_report splits MFU on it.
    "step": ("step", "loss", "throughput", "unit",
             "data_s", "dispatch_s", "device_s", "comm_s", "mfu"),
    # end-of-epoch rollup (the legacy per-epoch CSV row renders from this)
    "epoch": ("epoch", "start_ts", "seconds", "throughput", "unit", "loss"),
    # held-out evaluation
    "eval": ("epoch", "loss"),
    # checkpoint written
    "ckpt": ("epoch", "path", "is_best"),
    # cross-host step-time skew sample (obs.skew every K steps)
    "skew": ("step", "p50_s", "p99_s", "spread_s", "straggler"),
    # hang-watchdog stall dump (obs.watchdog; once per stall)
    "stall": ("idle_s", "threshold_s", "stacks"),
    # periodic HBM sampler row (utils.telemetry feeding the ledger)
    "hbm": ("bytes_in_use",),
    # one generate() call (engine.generate with a ledger passed in)
    "decode": ("tokens", "seconds", "throughput"),
    # serving admission decision (engine.serve): one per submit();
    # accepted=False carries a `reason` extra (queue_full|page_watermark|
    # slo_shedding|too_long|exceeds_pool) — the overload forensics
    "admit": ("rid", "accepted", "queue_depth", "pages_free"),
    # one COMPLETED serving request (engine.serve): the serving-SLO
    # record — timestamps are engine-clock (real seconds by default,
    # virtual units under an injected clock); ttft_s/prompt_len ride as
    # extras
    "request": ("rid", "tokens", "queue_wait_s", "admit_ts",
                "first_token_ts", "finish_ts"),
    # paged KV pool pressure snapshot (engine.serve, periodic + final):
    # shared_pages/cow_copies/prefix_hits track cross-request prefix
    # sharing, spec_emitted/spec_slot_ticks the speculative acceptance
    # trend, sharded_devices the sp-mesh width of the pool (1 when
    # unsharded) and chunks_pending the chunked-prefill backlog (the
    # chunk-queue depth ledger_report trends); high_water_used/slots/
    # tick/chunk_ticks ride as extras
    "kv_cache": ("pages_free", "pages_used", "active_seqs",
                 "shared_pages", "cow_copies", "prefix_hits",
                 "sharded_devices", "chunks_pending"),
    # numerical-health trip (obs.health sentry: non-finite grads/loss or a
    # loss spike); action records what the policy did (record|skip|halt)
    "health": ("step", "kind", "policy", "action", "value"),
    # flight-recorder bundle captured (obs.flightrec): reason names the
    # trigger (stall|health|skew|sigusr1|manual), bundle the directory
    # holding manifest.json + stacks/HBM/ledger-tail/profiler-window
    "diagnosis": ("reason", "bundle", "step"),
    # static cost attribution of one compiled step program (obs.attr):
    # buckets maps category -> {flops, bytes, count}; emitted once at
    # compile time beside the 'compile' event, read back by the
    # ledger_report roofline section
    "cost_model": ("program", "buckets"),
    # final registry dump (obs.metrics) so counter values survive in the
    # flight record after the scrape endpoint is gone
    "metrics_snapshot": ("metrics",),
    # goodput/badput partition snapshot (obs.goodput): categories maps
    # badput category -> seconds (startup/data_wait/dispatch/eval/ckpt/
    # stall/skipped/idle[/restart_gap]); emitted periodically by the
    # GoodputMonitor sink and once at run_end (final=True extra)
    "goodput": ("wall_s", "goodput_s", "ratio", "categories"),
    # progress-SLO breach (obs.goodput): EMA steps/min or items/s fell
    # below the configured floor; auto-triggers the flight recorder
    # through the ledger-sink path like every other detector event
    "slo": ("step", "kind", "value", "floor"),
    # one deterministic fault injection (obs.faults): site names the
    # injection point (nan_batch|hard_exit|hang|preempt_sigterm|
    # ckpt_enospc|rendezvous_fail), spec the matched entry; step/attempt
    # may be None for non-step-scoped sites. Reports use these to keep
    # injected failures distinguishable from organic ones
    "fault": ("site", "step", "spec"),
    # elastic-capacity transition (parallel.supervisor consensus + the
    # engines): action names the transition (shrink|expand|
    # preempt_snapshot|peer_restore|drain), processes the post-transition
    # world size, epoch the consensus/rendezvous epoch (None where no
    # consensus is configured); hosts/step/world_from ride as extras.
    # ledger_report stitches these into the elasticity timeline
    "scale": ("action", "processes", "epoch"),
    # one autoscaling decision (obs.autoscale CapacityMonitor under an
    # AutoscalePolicy): direction (up|down), the capacity transition
    # (hosts_from -> target_hosts), and the FULL attribution — which
    # signal tripped, its value vs threshold, the evaluation window, and
    # the newest flight-recorder bundle reference (None when no diagnosis
    # preceded it) — so "why did we scale" reads from the ledger alone.
    # The fleet tick rides as an extra; the executing scale event stamps
    # the decision id as its own `decision` extra (1:1 pairing)
    "scale_decision": ("decision", "direction", "hosts_from",
                       "target_hosts", "signal", "value", "threshold",
                       "window_ticks", "bundle"),
    # the decision's follow-up (parallel.supervisor after the rescale
    # relaunch): which decision was applied, the executed action
    # (shrink|expand), the post-transition world size and consensus
    # epoch, and the plan_hash of the deterministic plan/tune.py re-run
    # at the new world size (None when no retune is configured), so a
    # retune on rescale is auditable
    "applied": ("decision", "action", "processes", "epoch", "plan_hash"),
    # fleet-simulation identity (tpu_dist.sim.runner): the scenario one
    # fleet run executed — name/seed/hosts/ticks pin the deterministic
    # schedule so a fleet report is self-describing; tick_s/events ride
    # as extras. One per fleet ledger, the fleet analog of run_start
    "scenario": ("name", "seed", "hosts", "ticks"),
    # fleet-plane rollup (tpu_dist.sim.runner, periodic + final=True):
    # hosts_live is the count of virtual hosts with a running child,
    # goodput_ratio the stitched fleet ratio (None on periodic snapshots
    # — the full stitch runs once at the end), slo_breaches the
    # cumulative fleet-wide breach count. Feeds the
    # tpu_dist_fleet_* Prometheus series through the metrics sink
    "fleet": ("hosts_live", "goodput_ratio", "slo_breaches"),
    # one request-lifecycle span (obs.reqtrace): per-request distributed
    # tracing. Ids are DERIVED, not generated — trace_id = H(ns|rid) is
    # host-independent (cross-host traces stitch by equality alone),
    # span_id/parent_id chain H(parent|name|n) under the per-(job_id,
    # attempt) root. start/end are ENGINE-CLOCK seconds (comparable
    # within one process only; emit's wall ``ts`` anchors cross-host
    # placement). name is the lifecycle phase (request|queue|prefill|
    # decode|shed|readmit|prefix_hit|cow_fork); job_id/attempt/host/
    # tenant/reason/bucket/tokens ride as extras
    "span": ("trace_id", "span_id", "parent_id", "name", "rid",
             "start", "end"),
    # resolved step plan (tpu_dist.plan): which tuned/loaded plan drove
    # this run's step compilation — source names the file|'auto', plan_hash
    # the content address (plan.ir.plan_hash), knobs the non-default knob
    # diff; device_kind rides as a field so a report can say which table
    # row the plan was selected for. Emitted once, right after run_start
    "plan": ("source", "plan_hash", "knobs"),
    # one auto-tuner invocation (plan.tune via tools/tune.py --ledger):
    # the search's identity — candidate count and the winning plan hash
    # per device kind; workload/measured extras ride along
    "tune": ("device_kind", "candidates", "best_hash"),
    # one program-audit verdict (tpu_dist.analysis.proglint through
    # plan.compile's audit pass): program names the jitted step/serve
    # program, mode the knob (record|halt), findings the UNWAIVERED
    # finding count (0 = clean); waived and detail (the finding dicts)
    # ride as extras. One event per program at its compile-time pass,
    # plus one latched event per program the recompile sentry catches
    "audit": ("program", "mode", "findings"),
    # run rollup: total steps, wall seconds, best metric in extras;
    # status ("ok"|"crashed"|"interrupted") rides as an extra stamped by
    # RunObs.run_end — the crash-safe shutdown path sets "crashed"
    "run_end": ("steps", "seconds"),
}


def _json_safe(v):
    """Non-finite floats (inf/nan — e.g. best_ppl before any eval) become
    None: json.dumps would otherwise emit the bare tokens Infinity/NaN,
    which are NOT valid JSON and break strict parsers (jq, pandas) on the
    whole line — the machine-readability the ledger exists for."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return v


def per_process_path(path: str, process_index: int) -> str:
    """Suffix non-main output paths with the process index so multi-host
    runs never clobber one file: ``run.jsonl`` -> ``run.p1.jsonl`` for
    process 1; process 0 keeps the bare path (single-host unchanged)."""
    if not path or process_index == 0:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.p{process_index}{ext}"


class Ledger:
    """Append-only JSONL event log with schema validation and sinks.

    ``path=None`` builds a sink-only ledger (no file): the engines always
    carry one so the epoch-CSV sink, watchdog, and skew monitor have a
    single emit() surface whether or not ``ledger_path`` is set.

    Sinks are callables ``sink(record: dict)`` invoked on every emit —
    the legacy renderers (epoch CSV, progress stdout) hang off here, so
    they can never drift from the recorded values.
    """

    def __init__(self, path: Optional[str] = None, process_index: int = 0,
                 sinks: tuple = ()):
        self.path = path or None
        self.process_index = process_index
        self._f = open(path, "a", buffering=1) if path else None
        # RLock, not Lock: the crash guard's SIGTERM handler runs ON the
        # main thread and emits run_end — if the signal lands while that
        # same thread is inside emit(), a plain Lock would self-deadlock
        # on exactly the preemption path the guard exists for. Re-entry
        # writes the inner record as its own complete line (signals fire
        # between bytecodes, never mid-write), so lines stay intact.
        self._lock = threading.RLock()
        self._sinks: List[Callable[[dict], None]] = list(sinks)
        self.last: Optional[dict] = None  # most recent record (watchdog dump)

    def add_sink(self, sink: Callable[[dict], None]) -> None:
        self._sinks.append(sink)

    def emit(self, event: str, **fields) -> dict:
        """Validate + append one typed record; returns the full record."""
        required = EVENT_SCHEMA.get(event)
        if required is None:
            raise ValueError(f"undeclared ledger event {event!r} "
                             f"(EVENT_SCHEMA: {sorted(EVENT_SCHEMA)})")
        missing = [k for k in required if k not in fields]
        if missing:
            raise ValueError(f"ledger event {event!r} missing required "
                             f"fields {missing}")
        rec = _json_safe({"event": event, "ts": time.time(),
                          "pid": self.process_index, **fields})
        with self._lock:
            self.last = rec
            if self._f is not None and not self._f.closed:
                # default=str: config dicts can carry tuples/dtypes — a
                # ledger write must never take the run down
                self._f.write(json.dumps(rec, default=str) + "\n")
            for sink in self._sinks:
                try:
                    sink(rec)
                except Exception:
                    pass  # a renderer must never take the run down
        return rec

    def close(self) -> None:
        with self._lock:
            if self._f is not None and not self._f.closed:
                self._f.flush()
                self._f.close()
            for sink in self._sinks:
                close = getattr(sink, "close", None)
                if close:
                    try:
                        close()
                    except Exception:
                        pass


def read_ledger(path: str, validate: bool = True,
                strict: bool = True) -> List[dict]:
    """Parse a ledger file back into typed records (the round-trip half of
    the schema contract: every line is a declared event carrying its
    required fields).

    ``strict=False`` skips corrupt or truncated lines with a stderr
    warning instead of raising — a process killed mid-``write`` leaves a
    torn trailing line, and crashed runs are exactly the ones operators
    inspect (tools/ledger_report and tools/trace_merge read this way)."""
    import sys

    out = []
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict):
                    raise ValueError("not a JSON object")
                if validate:
                    ev = rec.get("event")
                    required = EVENT_SCHEMA.get(ev)
                    if required is None:
                        raise ValueError(
                            f"{path}:{line_no}: undeclared event {ev!r}")
                    missing = [k for k in required if k not in rec]
                    if missing:
                        raise ValueError(f"{path}:{line_no}: event {ev!r} "
                                         f"missing {missing}")
            except (json.JSONDecodeError, ValueError):
                if strict:
                    raise
                print(f"warning: {path}:{line_no}: skipping corrupt/"
                      f"truncated ledger line ({line[:60]!r}...)",
                      file=sys.stderr)
                continue
            out.append(rec)
    return out


class EpochCsvSink:
    """Render 'epoch' events into the cookbook-parity per-epoch CSV
    (reference 1.dataparallel.py:187-190 format [wall_start, seconds] +
    the tpu_dist rate and peak-HBM columns). The CSV is now a VIEW of the
    ledger's epoch record — same values, one source."""

    def __init__(self, path: str):
        self._path = path
        self._f = None

    def __call__(self, rec: dict) -> None:
        if rec.get("event") != "epoch":
            return
        if self._f is None:
            self._f = open(self._path, "a+", newline="")
        csv.writer(self._f).writerow(
            [rec["start_ts"], rec["seconds"],
             round(rec["throughput"], 1), rec.get("hbm_bytes") or ""])
        self._f.flush()

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()


def _fmt(v, spec: str) -> str:
    """Format a maybe-None numeric ledger field ('?' for None — schema
    requires presence, not non-nullness)."""
    return f"{v:{spec}}" if v is not None else "?"


class ProgressSink:
    """Render step/epoch/stall events as one-line text — the stdout
    renderer flavor of the ledger (tools/ledger_report --tail uses it;
    the in-loop progress line stays MeterBank's cookbook-format string,
    fed from the same MeterBank.snapshot() read as the ledger)."""

    def __init__(self, printer: Callable[[str], None] = print,
                 every: int = 1):
        self._print = printer
        self._every = max(every, 1)

    def __call__(self, rec: dict) -> None:
        # every field is formatted None-tolerantly: the schema only pins
        # PRESENCE, and all-None records are legal (ledger.py header)
        ev = rec.get("event")
        if ev == "step":
            if (rec["step"] or 0) % self._every:
                return
            mfu = rec.get("mfu")
            self._print(
                f"step {rec['step']}: loss " + _fmt(rec["loss"], ".4f")
                + f" {_fmt(rec['throughput'], ',.0f')} {rec['unit']}"
                + (f" MFU {mfu * 100:.1f}%" if mfu else "")
                + f" [data {_fmt(rec['data_s'], '.3f')}s dispatch "
                  f"{_fmt(rec['dispatch_s'], '.3f')}s device "
                  f"{_fmt(rec['device_s'], '.3f')}s]")
        elif ev == "epoch":
            self._print(f"epoch {rec['epoch']}: "
                        f"loss {_fmt(rec['loss'], '.4f')} "
                        f"{_fmt(rec['throughput'], ',.0f')} {rec['unit']} "
                        f"({_fmt(rec['seconds'], '.1f')}s)")
        elif ev == "stall":
            self._print(f"STALL: no step for {_fmt(rec['idle_s'], '.1f')}s "
                        f"(threshold {_fmt(rec['threshold_s'], '.1f')}s)")


def phase_totals(records) -> Dict[str, float]:
    """Sum the per-step phase seconds across a record list — the per-phase
    time-share rollup ledger_report and bench publish. ``comm_s`` rides
    along but OVERLAPS device_s (schema note), so share denominators must
    exclude it."""
    tot = {"data_s": 0.0, "dispatch_s": 0.0, "device_s": 0.0, "comm_s": 0.0}
    for rec in records:
        if rec.get("event") != "step":
            continue
        for k in tot:
            tot[k] += rec.get(k) or 0.0
    return tot
