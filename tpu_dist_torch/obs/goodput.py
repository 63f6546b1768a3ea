"""Goodput accounting and restart-aware run lineage for the port
(``tpu_dist/obs/goodput.py``).

The port's own copy of the reference module (stdlib only): the same
categories, the same per-attempt ledger naming (``run.jsonl``,
``run.a1.jsonl``, ... beside ``.pN`` for process N) and the same
supervisor sibling (``run.sup.jsonl``), so ``tools/ledger_report.py``
stitches the port's attempts as it stitches the reference's. The
:class:`GoodputMonitor` is a ledger sink here too, with the trainers'
progress-SLO floors (``slo_steps_per_min``, ``slo_throughput``), and
:func:`attempt_ordinal` labels each attempt ledger for the trace merge
(``tools/trace_merge.py``).

The reference cookbook meters per-step throughput inside one healthy
process; nothing upstream answers the allocation owner's question — "how
much of my wall-clock actually trained the model?" — once compiles, data
stalls, evals, checkpoints, crashes and restarts enter the picture. This
module is the *accounting* half of the obs subsystem (detection lives in
watchdog/health/skew, diagnosis in flightrec/attr, export in metrics):

* :class:`GoodputAccumulator` — time-weighted partition of one attempt's
  wall-clock into **goodput** (productive device step seconds) and the
  badput categories (:data:`CATEGORIES`): startup/compile, data wait,
  dispatch, eval, checkpoint, watchdog stalls, health-skipped steps, and
  drain/idle residue. Pure stdlib, fed one ledger record at a time — the
  same object powers the offline report (replay a file) and the live
  monitor (registered as a ledger sink).
* **Run lineage** — :func:`attempt_path` / :func:`next_attempt_index` /
  :func:`discover_attempt_paths` name and find the per-attempt ledgers of
  one logical job (``run.jsonl``, ``run.a1.jsonl``, ... — the restart
  analog of the multi-process ``.pN`` story), and
  :func:`split_attempts` / :func:`job_accounting` stitch them into one
  timeline with crash→restart gaps charged as ``restart_gap`` badput.
  ``RunObs`` stamps ``job_id``/``attempt`` into ``run_start`` and applies
  the attempt suffix to the ledger path (``attempt=-1`` auto-picks the
  next free index). :func:`load_job_records` reads a job back (attempts
  in order, the supervisor sibling appended) and :func:`fleet_accounting`
  sums per-host job partitions into the fleet's.
* :class:`GoodputMonitor` — host-side ledger sink that (a) emits periodic
  and final ``goodput`` events (feeding the ``tpu_dist_goodput_ratio`` /
  ``tpu_dist_badput_seconds`` gauges through the metrics sink), and (b)
  watches progress SLOs: EMA optimizer steps/min and items/s against
  configured floors, emitting an ``slo`` event at each breach episode —
  which auto-triggers the flight recorder through the ledger-sink path,
  the same zero-new-plumbing wiring every other detector uses.

Accounting conventions (the fixture tests in tests/test_goodput.py pin
these exactly):

* everything between ``run_start`` and the ``compile`` event is
  ``startup`` (init, first data fetch, the compile, the warm execute —
  the engines emit ``compile`` right after the warm dispatch's blocking
  device_get, so the whole warm batch lies inside that gap). The warm
  step record itself is emitted later, at the drain; its span is already
  covered by the gap, so it only charges ``startup`` on streams with NO
  ``compile`` event (hand-built ledgers);
* ``eval``/``ckpt`` events use their ``seconds`` field when the engines
  stamp it (exact), else the gap since the previous loop-ordered event;
* a watchdog ``stall``'s idle seconds are badput, and are deducted from
  the next step record's device/data/dispatch contribution — the stalled
  wait surfaces inside that record's phases, so without the deduction it
  would double-count;
* a ``health`` skip moves the skipped step's device share from goodput to
  ``skipped`` (the device ran, the update was discarded);
* whatever the records cannot explain is ``idle`` (drain residue, python
  overhead); categories + goodput always sum to wall-clock, with any
  over-attribution surfaced as ``overrun_s`` instead of hidden.
"""

from __future__ import annotations

import glob
import os
import re
import threading
import time
from typing import Dict, List, Optional

# badput categories, in report order. "goodput" rides beside them (it is
# the complement, not a badput); "restart_gap" only appears at job level.
CATEGORIES = ("startup", "data_wait", "dispatch", "eval", "ckpt", "stall",
              "skipped", "idle", "restart_gap")

# events whose emission order follows the loop thread: they anchor the
# gap cursor. Daemon-thread events (hbm sampler, watchdog stall, flightrec
# diagnosis) land at arbitrary points and must not shrink an eval/ckpt gap.
_ANCHORS = frozenset({
    "run_start", "compile", "step", "eval", "ckpt", "epoch", "decode",
    "health", "skew", "goodput", "slo", "metrics_snapshot", "run_end"})


# -- run lineage: per-attempt ledger naming --------------------------------

def attempt_path(path: str, attempt: int) -> str:
    """Suffix a ledger path with the attempt ordinal: ``run.jsonl`` ->
    ``run.a2.jsonl`` for attempt 2; attempt 0 keeps the bare path (the
    restart analog of :func:`~tpu_dist_torch.obs.ledger.per_process_path`)."""
    if not path or attempt <= 0:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.a{attempt}{ext}"


def next_attempt_index(path: str, process_index: int = 0) -> int:
    """The next free attempt ordinal for ``path``: 0 when this process's
    bare-attempt file does not exist yet, else 1 + the highest ``.aN`` on
    disk — the ``attempt=-1`` auto mode, so a restarted job never
    clobbers or appends to a previous attempt's ledger.

    Detection probes THIS process's own files (``run.p1.jsonl`` /
    ``run.aN.p1.jsonl`` for process 1), never the shared bare path:
    process 0 creating ``run.jsonl`` first must not make a
    later-starting process 1 of the SAME attempt self-assign attempt 1.
    On multi-host runs without a shared ledger directory, still pass the
    attempt explicitly (the scheduler's restart counter) so all
    processes agree."""
    from tpu_dist_torch.obs.ledger import per_process_path

    if not path:
        return 0
    mine = lambda n: per_process_path(attempt_path(path, n), process_index)
    if not os.path.exists(mine(0)):
        return 0
    root, ext = os.path.splitext(path)
    psuf = f".p{process_index}" if process_index else ""
    highest = 0
    for p in glob.glob(f"{glob.escape(root)}.a*{psuf}{ext}"):
        m = re.fullmatch(re.escape(root) + r"\.a(\d+)"
                         + re.escape(psuf + ext), p)
        if m:
            highest = max(highest, int(m.group(1)))
    return highest + 1


def attempt_ordinal(path: str) -> int:
    """The attempt number a ledger path encodes (``run.a2.jsonl`` -> 2;
    bare -> 0) — label lanes/reports by THIS, not by list position, so a
    lost intermediate attempt ledger never renumbers the rest."""
    root, _ = os.path.splitext(path)
    m = re.search(r"\.a(\d+)$", root)
    return int(m.group(1)) if m else 0


def discover_attempt_paths(path: str) -> List[str]:
    """``run.jsonl`` -> [run.jsonl, run.a1.jsonl, ...] (attempt order).
    Works from any attempt's path — the bare stem is derived first."""
    root, ext = os.path.splitext(path)
    m = re.fullmatch(r"(.*)\.a(\d+)", root)
    if m:
        root = m.group(1)
        path = root + ext
    found = {}
    for p in glob.glob(f"{glob.escape(root)}.a*{ext}"):
        mm = re.fullmatch(re.escape(root) + r"\.a(\d+)" + re.escape(ext), p)
        if mm:
            found[int(mm.group(1))] = p
    out = [path] if os.path.exists(path) or not found else []
    return out + [found[i] for i in sorted(found)]


def sup_sibling_path(path: str) -> str:
    """The supervisor's own scale-event ledger for a job: any attempt
    path -> ``<stem>.sup<ext>`` (``run.a2.jsonl`` -> ``run.sup.jsonl``).
    THE naming rule — the supervisor writes it, and the reference's
    report and trace tools discover it, through this one function."""
    root, ext = os.path.splitext(path)
    root = re.sub(r"\.a\d+$", "", root)  # any attempt path -> the stem
    return f"{root}.sup{ext}"


def load_job_records(path: str, discover: bool = True,
                     warn=None) -> List[dict]:
    """Read one logical JOB back from disk: the attempt family of ``path``
    (``run.jsonl``, ``run.a1.jsonl``, ... in attempt order) with the
    supervisor's ``<stem>.sup.jsonl`` scale-event sibling APPENDED — never
    ts-interleaved, because a between-attempt ``scale`` record sorted into
    the middle would split a pseudo-attempt into the run_start-boundary
    goodput/restart math (the consumers order scale events by ts
    themselves). ``discover=False`` reads only the given file.

    The one job-loading rule: :class:`tpu_dist_torch.sim.fleet.FleetLedger`
    calls it once per host, so cross-host discovery is per-host job
    discovery plus a directory walk. Lenient by design (``strict=False``
    reads, unreadable files skipped through ``warn``): crashed hosts are
    exactly the ones a fleet report inspects."""
    import sys

    from tpu_dist_torch.obs.ledger import read_ledger

    warn = warn or (lambda msg: print(msg, file=sys.stderr))
    paths = (discover_attempt_paths(path) or [path]) if discover else [path]
    records: List[dict] = []
    for p in paths:
        try:
            records.extend(read_ledger(p, strict=False))
        except OSError as e:
            warn(f"warning: skipping {p}: {e}")
    if discover:
        sup = sup_sibling_path(paths[0])
        if os.path.exists(sup):
            try:
                records.extend(read_ledger(sup, strict=False))
            except OSError as e:
                warn(f"warning: skipping {sup}: {e}")
    return records


def fleet_accounting(host_jobs: Dict) -> Optional[dict]:
    """Aggregate per-host job partitions (each a :func:`job_accounting`
    dict, keyed by host id) into ONE fleet partition.

    The fleet invariant is inherited, not re-proven: each host's
    categories + goodput sum to its own stitched wall (restart gaps
    included, over-attribution surfaced as overrun), so the fleet sums
    preserve it — ``goodput_s + sum(categories) == aggregate_wall_s`` to
    rounding, with ``sum_check`` carrying the measured ratio so a report
    can assert ~100% instead of trusting this comment. ``aggregate wall``
    is the sum of host walls (N hosts x T seconds = NT host-seconds of
    capacity — the denominator a capacity owner pays for), NOT the max
    span."""
    jobs = {h: j for h, j in host_jobs.items() if j}
    if not jobs:
        return None
    cats = {c: 0.0 for c in CATEGORIES}
    wall = goodput = overrun = 0.0
    opt_steps = 0
    per_host = {}
    for h in sorted(jobs):
        j = jobs[h]
        wall += j["wall_s"]
        goodput += j["goodput_s"]
        overrun += j.get("overrun_s") or 0.0
        opt_steps += j.get("opt_steps") or 0
        for k, v in (j.get("categories") or {}).items():
            cats[k] = cats.get(k, 0.0) + v
        per_host[h] = {"wall_s": j["wall_s"], "goodput_s": j["goodput_s"],
                       "ratio": j.get("ratio"),
                       "attempts": len(j.get("attempts") or ()) or 1}
    explained = goodput + sum(cats.values())
    return {"hosts": len(jobs),
            "aggregate_wall_s": round(wall, 6),
            "goodput_s": round(goodput, 6),
            "goodput_ratio": round(goodput / wall, 6) if wall else None,
            "categories": {k: round(v, 6) for k, v in cats.items()},
            "overrun_s": round(overrun, 6) if overrun > 1e-9 else 0.0,
            "opt_steps": opt_steps,
            "sum_check": round(explained / wall, 6) if wall else None,
            "per_host": per_host}


def split_attempts(records: List[dict]) -> List[List[dict]]:
    """Split one record stream at ``run_start`` boundaries — the shape of
    a stitched multi-attempt read (files concatenated in attempt order)
    AND of a single file a restarted job appended to."""
    out: List[List[dict]] = []
    for rec in records:
        if rec.get("event") == "run_start" or not out:
            out.append([])
        out[-1].append(rec)
    return out


# -- the accumulator -------------------------------------------------------

class GoodputAccumulator:
    """Feed ledger records in order; :meth:`finalize` yields the partition.

    Also usable directly as a ledger sink (``ledger.add_sink(acc.add)``) —
    bench.py does exactly that to put a ``goodput`` block in its headline
    JSON. All fields tolerate schema-legal ``None`` values.
    """

    def __init__(self):
        self.t0: Optional[float] = None
        self.t_end: Optional[float] = None
        self._t_last: Optional[float] = None
        self._prev: Optional[float] = None
        self.cat: Dict[str, float] = {c: 0.0 for c in CATEGORIES
                                      if c != "restart_gap"}
        self.goodput = 0.0
        self.n_opt = 0
        self.status: Optional[str] = None
        self._pending_stall = 0.0
        self._last_dev_per_opt = 0.0
        self._saw_compile = False

    def add(self, rec: dict) -> None:
        ev = rec.get("event")
        ts = rec.get("ts")
        if ts is None:
            return
        if self.t0 is None:
            self.t0 = ts
            if ev == "run_start":
                self._prev = ts
                self._t_last = ts
                return
        gap = max(0.0, ts - self._prev) if self._prev is not None else 0.0
        if ev == "compile":
            self.cat["startup"] += gap
            self._saw_compile = True
        elif ev == "step":
            d = rec.get("data_s") or 0.0
            p = rec.get("dispatch_s") or 0.0
            v = rec.get("device_s") or 0.0
            if rec.get("warm"):
                # with a compile event, the warm span already lies inside
                # the run_start->compile gap charged above (the record is
                # merely EMITTED later, at the drain) — charging it again
                # would double-count the whole compile
                if not self._saw_compile:
                    self.cat["startup"] += d + p + v
            else:
                k = max(int(rec.get("steps_in_dispatch") or 1), 1)
                self._last_dev_per_opt = v / k
                self.n_opt += k
                # a stall's wait resurfaces inside this record's phases —
                # deduct it so stall badput is not double-counted
                for val, key in ((v, None), (d, "data_wait"),
                                 (p, "dispatch")):
                    take = min(self._pending_stall, val)
                    self._pending_stall -= take
                    if key is None:
                        self.goodput += val - take
                    else:
                        self.cat[key] += val - take
        elif ev == "eval":
            secs = rec.get("seconds")
            self.cat["eval"] += secs if secs is not None else gap
        elif ev == "ckpt":
            secs = rec.get("seconds")
            self.cat["ckpt"] += secs if secs is not None else gap
        elif ev == "decode":
            # a generate() call is productive device work
            self.goodput += rec.get("seconds") or 0.0
        elif ev == "stall":
            idle = rec.get("idle_s") or 0.0
            self.cat["stall"] += idle
            self._pending_stall += idle
        elif ev == "health":
            if rec.get("action") == "skip":
                # the device ran the step; the update was discarded
                shift = min(self.goodput, self._last_dev_per_opt)
                self.goodput -= shift
                self.cat["skipped"] += shift
        elif ev == "run_end":
            self.t_end = ts
            self.status = rec.get("status")
        if ev in _ANCHORS:
            self._prev = ts
        self._t_last = (ts if self._t_last is None
                        else max(self._t_last, ts))

    def end_ts(self) -> Optional[float]:
        return self.t_end if self.t_end is not None else self._t_last

    def finalize(self, end_ts: Optional[float] = None) -> Optional[dict]:
        """The partition as a JSON-safe dict (non-destructive — the live
        monitor snapshots mid-run). None until a first record arrived."""
        if self.t0 is None:
            return None
        end = end_ts if end_ts is not None else self.end_ts()
        wall = max((end or self.t0) - self.t0, 0.0)
        known = self.goodput + sum(v for k, v in self.cat.items()
                                   if k != "idle")
        idle = wall - known
        overrun = max(-idle, 0.0)
        cats = {k: round(v, 6) for k, v in self.cat.items() if k != "idle"}
        cats["idle"] = round(max(idle, 0.0), 6)
        return {"wall_s": round(wall, 6),
                "goodput_s": round(self.goodput, 6),
                "ratio": round(self.goodput / wall, 6) if wall else None,
                "categories": cats,
                "overrun_s": round(overrun, 6) if overrun > 1e-9 else 0.0,
                "opt_steps": self.n_opt,
                "status": self.status}


def accounting(records: List[dict],
               end_ts: Optional[float] = None) -> Optional[dict]:
    """One attempt's records -> its goodput partition (pure replay)."""
    acc = GoodputAccumulator()
    for rec in records:
        acc.add(rec)
    return acc.finalize(end_ts=end_ts)


def job_accounting(attempts: List[List[dict]]) -> Optional[dict]:
    """Stitch per-attempt record lists (attempt order) into one job-level
    partition: categories summed across attempts, plus the between-attempt
    ``restart_gap`` badput (attempt k+1's run_start minus attempt k's last
    event — the crash, scheduler requeue and re-init the per-attempt
    ledgers cannot see). Categories + goodput sum to the stitched wall."""
    accs = []
    for recs in attempts:
        acc = GoodputAccumulator()
        for rec in recs:
            acc.add(rec)
        if acc.t0 is not None:
            # label by the STAMPED ordinal, not the list position — a
            # lost intermediate attempt ledger must not renumber the rest
            starts = [r for r in recs if r.get("event") == "run_start"]
            acc.attempt_no = (starts[0].get("attempt")
                              if starts and starts[0].get("attempt")
                              is not None else len(accs))
            accs.append(acc)
    if not accs:
        return None
    cats = {c: 0.0 for c in CATEGORIES}
    goodput = 0.0
    overrun = 0.0
    opt_steps = 0
    per_attempt = []
    prev_end: Optional[float] = None
    for acc in accs:
        part = acc.finalize()
        for k, v in part["categories"].items():
            cats[k] += v
        goodput += part["goodput_s"]
        overrun += part["overrun_s"]
        opt_steps += part["opt_steps"]
        gap = (max(0.0, acc.t0 - prev_end)
               if prev_end is not None else 0.0)
        cats["restart_gap"] += gap
        per_attempt.append({"attempt": acc.attempt_no,
                            "status": part["status"],
                            "wall_s": part["wall_s"],
                            "goodput_s": part["goodput_s"],
                            "opt_steps": part["opt_steps"],
                            "restart_gap_s": round(gap, 6) or 0.0})
        prev_end = acc.end_ts()
    wall = max((accs[-1].end_ts() or accs[0].t0) - accs[0].t0, 0.0)
    return {"wall_s": round(wall, 6),
            "goodput_s": round(goodput, 6),
            "ratio": round(goodput / wall, 6) if wall else None,
            "categories": {k: round(v, 6) for k, v in cats.items()},
            "overrun_s": round(overrun, 6) if overrun > 1e-9 else 0.0,
            "opt_steps": opt_steps,
            "attempts": per_attempt}


# -- the live monitor ------------------------------------------------------

class GoodputMonitor:
    """Ledger sink: live goodput accounting + progress-SLO watch.

    Registered by ``RunObs`` on every run (a few float adds per event).
    Emits ``goodput`` events every ``every_s`` seconds of run time (0 =
    only the final one ``RunObs.run_end`` asks for) and one ``slo`` event
    per breach *episode* (hysteresis: re-arms when the EMA recovers above
    the floor) — both reach the metrics registry and the flight recorder
    through the normal sink fan-out. EMAs ignore warm records and need
    ``min_records`` samples before judging, so a compile can never breach.
    """

    def __init__(self, ledger, every_s: float = 60.0,
                 slo_steps_per_min: float = 0.0,
                 slo_throughput: float = 0.0, unit: str = "items/s",
                 alpha: float = 0.5, min_records: int = 2):
        self._ledger = ledger
        self.acc = GoodputAccumulator()
        self.every_s = max(float(every_s or 0.0), 0.0)
        self.floors = {"steps_per_min": float(slo_steps_per_min or 0.0),
                       "throughput": float(slo_throughput or 0.0)}
        self.unit = unit
        self.alpha = alpha
        self.min_records = min_records
        self.breaches = 0
        self._in_breach = {k: False for k in self.floors}
        self._ema = {k: None for k in self.floors}
        self._samples = 0
        self._last_step_ts: Optional[float] = None
        self._last_emit_ts: Optional[float] = None
        # RLock, not Lock: run_end's SIGTERM path calls emit_goodput() on
        # the main thread — if the signal lands while that same thread is
        # inside sink() holding this lock, a plain Lock would self-deadlock
        # (the exact hazard Ledger._lock documents; distlint DL101)
        self._lock = threading.RLock()

    def sink(self, rec: dict) -> None:
        ev = rec.get("event")
        if ev in ("goodput", "slo"):
            return  # our own (nested) emits
        with self._lock:
            self.acc.add(rec)
            if ev == "run_start":
                self._last_emit_ts = rec.get("ts")
                return
            if ev in ("eval", "ckpt", "epoch"):
                # steps legitimately stop completing across eval/ckpt
                # boundaries — the next step's dt must not read as a
                # steps/min collapse (spurious breach every epoch)
                self._last_step_ts = None
                return
            if ev != "step":
                return
            ts = rec.get("ts") or time.time()
            step = rec.get("step")
            breached = self._observe(rec, ts) if not rec.get("warm") else []
            periodic = (self.every_s > 0
                        and self._last_emit_ts is not None
                        and ts - self._last_emit_ts >= self.every_s)
            if periodic:
                self._last_emit_ts = ts
        # emit OUTSIDE the monitor lock (the nested Ledger.emit re-enters
        # this sink via the fan-out; Ledger's own RLock handles its side)
        for kind, value, floor in breached:
            self._ledger.emit("slo", step=step, kind=kind,
                              value=round(value, 6), floor=floor,
                              unit=self.unit)
        if periodic:
            self.emit_goodput(final=False)

    def _observe(self, rec: dict, ts: float):
        """Update the EMAs from one hot step record; return the breaches
        that just started (kind, ema, floor). Caller holds the lock."""
        out = []
        samples = {}
        if self._last_step_ts is not None and ts > self._last_step_ts:
            k = max(int(rec.get("steps_in_dispatch") or 1), 1)
            samples["steps_per_min"] = k / (ts - self._last_step_ts) * 60.0
        self._last_step_ts = ts
        if rec.get("throughput") is not None:
            samples["throughput"] = float(rec["throughput"])
        if not samples:
            return out
        self._samples += 1
        for kind, v in samples.items():
            prev = self._ema[kind]
            self._ema[kind] = (v if prev is None
                               else self.alpha * v
                               + (1 - self.alpha) * prev)
        if self._samples < self.min_records:
            return out
        for kind, floor in self.floors.items():
            ema = self._ema[kind]
            if floor <= 0 or ema is None:
                continue
            if ema < floor and not self._in_breach[kind]:
                self._in_breach[kind] = True
                self.breaches += 1
                out.append((kind, ema, floor))
            elif ema >= floor and self._in_breach[kind]:
                self._in_breach[kind] = False  # re-arm
        return out

    def emit_goodput(self, final: bool = True) -> Optional[dict]:
        """Emit one ``goodput`` event from the current partition (the
        final one is ``RunObs.run_end``'s, stamped ``final=True``)."""
        with self._lock:
            part = self.acc.finalize(
                end_ts=time.time() if final else None)
            breaches = self.breaches
        if part is None:
            return None
        return self._ledger.emit(
            "goodput", wall_s=part["wall_s"], goodput_s=part["goodput_s"],
            ratio=part["ratio"], categories=part["categories"],
            overrun_s=part["overrun_s"], opt_steps=part["opt_steps"],
            slo_breaches=breaches, final=final)
