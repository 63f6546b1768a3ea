#!/usr/bin/env python
"""Merge a run's per-process ledgers into one Chrome/Perfetto trace: the
port's copy of ``tools/trace_merge.py``, reading port ledgers through the
port's own ``obs.ledger.read_ledger`` and ``obs.goodput`` lineage.

    python -m tpu_dist_torch.tools.trace_merge run.jsonl   # + run.p*.jsonl
    python -m tpu_dist_torch.tools.trace_merge run.jsonl -o trace.json
    python -m tpu_dist_torch.tools.trace_merge a.jsonl b.p1.jsonl --no-discover

For the same ledgers it writes the same trace as the reference tool (its
``otherData.tool`` names this module):

* one **process lane per ledger** (pid = the ledger's process index),
  with named thread rows: ``steps`` (the data/dispatch/device slices of
  every step record, laid back-to-back ending at the record's emit time,
  plus decode calls), ``comm`` (the overlapped comm_s share beside its
  device slice), ``phases`` (epoch spans, eval/ckpt/compile markers) and
  ``alerts`` (watchdog stalls, health trips), plus one row per traced
  request;
* **counter tracks** for skew spread and HBM-in-use;
* clocks normalized per process to its own ``run_start``;
* **restart attempts** (``run.a1.jsonl``, ...) auto-discovered like the
  ``.pN`` siblings, each attempt its own lane group offset by its real
  distance from attempt 0's ``run_start``, with a ``restart gap`` slice;
* the **supervisor sibling** (``<stem>.sup.jsonl``) as a ``supervisor``
  marker lane of its ``scale`` records.

Corrupt or truncated trailing lines are skipped with a warning
(``read_ledger(strict=False)``). Stdlib and the port's ledger only.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from tpu_dist_torch.obs.goodput import (attempt_ordinal,
                                        discover_attempt_paths,
                                        sup_sibling_path)
from tpu_dist_torch.obs.ledger import read_ledger

TOOL = "tpu_dist_torch/tools/trace_merge.py"

# thread-row ids within each process lane (Chrome wants ints; names are
# attached via thread_name metadata events)
TID_STEPS, TID_COMM, TID_PHASES, TID_ALERTS = 0, 1, 2, 3
_TID_NAMES = {TID_STEPS: "steps", TID_COMM: "comm (overlaps device)",
              TID_PHASES: "phases", TID_ALERTS: "alerts"}
# per-request lanes (obs.reqtrace span events): each traced rid gets its
# own thread row from this base, so waterfalls render NEXT TO the step/
# phase lanes of the process that served them
TID_REQ_BASE = 16


def discover_ledgers(path: str) -> list:
    """``run.jsonl`` -> [run.jsonl, run.p1.jsonl, run.p2.jsonl, ...]."""
    root, ext = os.path.splitext(path)
    sibs = sorted(glob.glob(f"{glob.escape(root)}.p*{ext}"),
                  key=lambda p: _pidx_from_name(p, root, ext))
    return [path] + sibs


def _pidx_from_name(path: str, root: str, ext: str) -> int:
    tag = path[len(root) + 2: len(path) - len(ext)]
    return int(tag) if tag.isdigit() else 0


def _args(rec: dict, keys) -> dict:
    return {k: rec[k] for k in keys if rec.get(k) is not None}


def _process_events(records: list, pid: int) -> list:
    """One ledger's records -> Chrome trace events (ts/dur in µs, offset
    to the process's own run_start)."""
    starts = [r["ts"] for r in records if r.get("event") == "run_start"]
    t0 = starts[0] if starts else (records[0]["ts"] if records else 0.0)
    us = lambda ts: max((ts - t0) * 1e6, 0.0)
    ev: list = []
    name = None
    for r in records:
        if r.get("event") == "run_start":
            name = f"process {pid}" + (
                f" ({'/'.join(r['devices'])})" if r.get("devices") else "")
    ev.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": name or f"process {pid}"}})
    for tid, tname in _TID_NAMES.items():
        ev.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": tname}})
    # request lane assignment: one thread row per traced rid, in order of
    # first appearance (deterministic — the ledger's emit order is)
    req_tids: dict = {}

    def _req_tid(rid) -> int:
        tid = req_tids.get(rid)
        if tid is None:
            tid = TID_REQ_BASE + len(req_tids)
            req_tids[rid] = tid
            ev.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": f"request r{rid}"}})
        return tid

    for r in records:
        kind, ts = r.get("event"), r.get("ts", t0)
        if kind == "step":
            phases = [(p, r.get(f"{p}_s") or 0.0)
                      for p in ("data", "dispatch", "device")]
            end = us(ts)
            start = end - sum(d for _, d in phases) * 1e6
            meta = _args(r, ("step", "loss", "mfu", "throughput", "unit",
                             "steps_in_dispatch", "grad_norm",
                             "nonfinite_count", "warm"))
            cursor = start
            for pname, dur in phases:
                if dur <= 0:
                    continue
                ev.append({"ph": "X", "name": pname, "pid": pid,
                           "tid": TID_STEPS, "ts": cursor, "dur": dur * 1e6,
                           "args": meta})
                if pname == "device" and r.get("comm_s"):
                    # comm OVERLAPS the device block (obs.ledger schema
                    # note) — its own row, aligned under the device slice
                    ev.append({"ph": "X", "name": "comm", "pid": pid,
                               "tid": TID_COMM, "ts": cursor,
                               "dur": min(r["comm_s"], dur) * 1e6,
                               "args": {"comm_s": r["comm_s"]}})
                cursor += dur * 1e6
        elif kind == "epoch":
            start = r.get("start_ts")
            dur = r.get("seconds")
            if start is not None and dur:
                ev.append({"ph": "X", "name": f"epoch {r.get('epoch')}",
                           "pid": pid, "tid": TID_PHASES, "ts": us(start),
                           "dur": dur * 1e6,
                           "args": _args(r, ("loss", "throughput", "unit"))})
        elif kind == "decode":
            dur = r.get("seconds") or 0.0
            ev.append({"ph": "X", "name": "decode", "pid": pid,
                       "tid": TID_STEPS, "ts": us(ts) - dur * 1e6,
                       "dur": dur * 1e6,
                       "args": _args(r, ("tokens", "throughput", "cached"))})
        elif kind == "span":
            # span start/end are engine-clock; the wall emit ts anchors
            # the slice's END (spans close at emit — same convention as
            # the 'decode' slices above), so the lane lines up with the
            # step rows without cross-clock arithmetic
            dur = (r.get("end") or 0.0) - (r.get("start") or 0.0)
            ev.append({"ph": "X", "name": r.get("name") or "span",
                       "pid": pid, "tid": _req_tid(r.get("rid")),
                       "ts": us(ts) - dur * 1e6, "dur": dur * 1e6,
                       "args": _args(r, ("trace_id", "rid", "bucket",
                                         "tokens", "ticks", "reason",
                                         "pages_shared", "spec_drafted",
                                         "ttft_s", "tenant"))})
        elif kind in ("eval", "ckpt", "compile", "run_start", "run_end"):
            ev.append({"ph": "i", "name": kind, "pid": pid,
                       "tid": TID_PHASES, "ts": us(ts), "s": "t",
                       "args": _args(r, ("epoch", "loss", "ppl", "acc1",
                                         "path", "program", "status",
                                         "steps"))})
        elif kind == "stall":
            ev.append({"ph": "i", "name": "STALL", "pid": pid,
                       "tid": TID_ALERTS, "ts": us(ts), "s": "g",
                       "args": _args(r, ("idle_s", "threshold_s"))})
        elif kind == "health":
            ev.append({"ph": "i", "name": f"health:{r.get('kind')}",
                       "pid": pid, "tid": TID_ALERTS, "ts": us(ts),
                       "s": "g",
                       "args": _args(r, ("step", "policy", "action",
                                         "value", "loss"))})
        elif kind == "skew":
            ev.append({"ph": "C", "name": "skew spread (ms)", "pid": pid,
                       "ts": us(ts),
                       "args": {"spread": (r.get("spread_s") or 0) * 1e3}})
        elif kind == "hbm":
            ev.append({"ph": "C", "name": "hbm bytes", "pid": pid,
                       "ts": us(ts),
                       "args": {"in_use": r.get("bytes_in_use") or 0}})
    return ev


def merge_ledgers(paths: list) -> dict:
    """Paths -> the Chrome trace object ({"traceEvents": [...], ...})."""
    return merge_job([(0, paths)])


def _run_start_ts(records: list):
    for r in records:
        if r.get("event") == "run_start":
            return r["ts"]
    return records[0]["ts"] if records else None


def merge_job(groups: list, sup_records: list = ()) -> dict:
    """[(attempt_index, [lane paths]), ...] -> one Chrome trace. A single
    group is the classic multi-process merge; multiple groups (restart
    attempts, obs.goodput lineage) offset each attempt's lanes by its real
    wall distance from attempt 0's run_start and draw the restart gap.
    ``sup_records`` (the supervisor's ``<stem>.sup.jsonl`` sibling —
    elasticity decisions) render as their own marker lane: one instant
    event per ``scale`` record, on the job clock, so shrink/re-expansion
    and preemption-drain transitions sit visibly above the attempt lanes
    instead of silently missing from the merged trace."""
    events: list = []
    lanes = 0
    multi = len(groups) > 1
    job_t0 = None
    prev_end = None
    # read everything first: the per-attempt pid offset must clear the
    # HIGHEST process index seen anywhere (a 128-process job's attempt 0
    # must not share lane pids with attempt 1's low processes)
    loaded = []
    max_pid = 0
    for att, paths in groups:
        lane_records = []
        for i, p in enumerate(paths):
            try:
                records = read_ledger(p, strict=False)
            except OSError as e:
                print(f"warning: skipping {p}: {e}", file=sys.stderr)
                continue
            if not records:
                print(f"warning: {p}: no readable records", file=sys.stderr)
                continue
            pid = records[0].get("pid", i)
            max_pid = max(max_pid, pid)
            lane_records.append((pid, records))
        loaded.append((att, lane_records))
    pid_stride = max(100, max_pid + 1)
    for att, lane_records in loaded:
        pid_off = att * pid_stride if multi else 0
        att_events: list = []
        att_t0 = None
        att_end = None
        for pid, records in lane_records:
            att_events.extend(_process_events(records, pid))
            lanes += 1
            ts0 = _run_start_ts(records)
            if att_t0 is None:  # the group's first (p0) file anchors it
                att_t0 = ts0
            last = max(r.get("ts", 0.0) for r in records)
            att_end = last if att_end is None else max(att_end, last)
        if att_t0 is None:
            continue
        if job_t0 is None:
            job_t0 = att_t0
        offset_us = max((att_t0 - job_t0) * 1e6, 0.0)
        for e in att_events:
            e["pid"] += pid_off
            if "ts" in e:
                e["ts"] += offset_us
            if e.get("ph") == "M" and e.get("name") == "process_name" \
                    and multi:
                e["args"]["name"] = (f"attempt {att} · "
                                     f"{e['args'].get('name', '')}")
        events.extend(att_events)
        if multi and prev_end is not None and att_t0 > prev_end:
            gap = att_t0 - prev_end
            events.append({"ph": "X", "name": "restart gap",
                           "pid": pid_off, "tid": TID_PHASES,
                           "ts": offset_us - gap * 1e6, "dur": gap * 1e6,
                           "args": {"gap_s": round(gap, 3),
                                    "attempt": att}})
        prev_end = att_end
    scales = [r for r in (sup_records or ())
              if r.get("event") == "scale" and r.get("ts") is not None]
    # autoscaling markers (the reference's obs.autoscale): the capacity
    # monitor's scale_decision events and the supervisor's applied
    # follow-ups render as instants on the SAME supervisor lane, beside
    # the scale events they attribute — decision -> rescale -> new plan
    # hash reads left to right on one timeline
    decisions = [r for r in (sup_records or ())
                 if r.get("event") in ("scale_decision", "applied")
                 and r.get("ts") is not None]
    if (scales or decisions) and job_t0 is not None:
        # the supervisor lane: one stride past the HIGHEST attempt
        # ordinal (lane offsets key on the filename-stamped ordinal, not
        # list position — a lost intermediate attempt must not make this
        # lane collide with the last attempt's)
        sup_pid = pid_stride * (max((att for att, _ in groups),
                                    default=0) + 1)
        events.append({"ph": "M", "name": "process_name", "pid": sup_pid,
                       "tid": 0, "args": {"name": "supervisor"}})
        events.append({"ph": "M", "name": "thread_name", "pid": sup_pid,
                       "tid": 0, "args": {"name": "scale events"}})
        for r in scales:
            events.append({
                "ph": "i", "name": f"scale:{r.get('action')}",
                "pid": sup_pid, "tid": 0,
                "ts": max((r["ts"] - job_t0) * 1e6, 0.0), "s": "g",
                "args": _args(r, ("action", "processes", "epoch", "hosts",
                                  "step", "world_from", "shed",
                                  "decision"))})
        for r in decisions:
            name = (f"decision:{r.get('direction')}"
                    if r["event"] == "scale_decision"
                    else f"applied:{r.get('action')}")
            events.append({
                "ph": "i", "name": name, "pid": sup_pid, "tid": 0,
                "ts": max((r["ts"] - job_t0) * 1e6, 0.0), "s": "g",
                "args": _args(r, ("decision", "direction", "hosts_from",
                                  "target_hosts", "signal", "value",
                                  "threshold", "window_ticks", "bundle",
                                  "action", "processes", "epoch",
                                  "plan_hash"))})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"tool": TOOL,
                          "processes": lanes,
                          "attempts": len(groups),
                          "scale_events": len(scales),
                          "autoscale_events": len(decisions),
                          "clock": ("per-process, zeroed at attempt 0's "
                                    "run_start" if multi else
                                    "per-process, zeroed at run_start")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+",
                    help="ledger JSONL path(s); the first path's .pN "
                         "siblings are auto-discovered")
    ap.add_argument("-o", "--out", default="",
                    help="output path (default: <first ledger>.trace.json)")
    ap.add_argument("--no-discover", action="store_true",
                    help="merge only the paths given (no .pN process or "
                    ".aN attempt glob)")
    args = ap.parse_args(argv)
    paths = list(args.paths)
    if args.no_discover:
        trace = merge_ledgers(paths)
    else:
        # restart lineage first (run.jsonl, run.a1.jsonl, ... — obs.
        # goodput), then each attempt's .pN process siblings
        attempt_paths = discover_attempt_paths(paths[0]) or [paths[0]]
        groups = []
        for j, base in enumerate(attempt_paths):
            lane_paths = discover_ledgers(base)
            if j == 0:
                for extra in paths[1:]:
                    if extra not in lane_paths:
                        lane_paths.append(extra)
            # label by the filename's stamped ordinal, not list position:
            # a lost intermediate attempt must not renumber the rest
            groups.append((attempt_ordinal(base), lane_paths))
        # the supervisor's own scale-event sibling (parallel.supervisor
        # elasticity decisions) renders as a marker lane — without it a
        # merged trace of an elastic run silently omits every rescale
        sup_path = sup_sibling_path(attempt_paths[0])
        sup_records = []
        if os.path.exists(sup_path):
            try:
                sup_records = read_ledger(sup_path, strict=False)
            except OSError as e:
                print(f"warning: skipping {sup_path}: {e}", file=sys.stderr)
        trace = merge_job(groups, sup_records=sup_records)
    if not trace["traceEvents"]:
        print("no records in any input ledger", file=sys.stderr)
        return 1
    out = args.out or (os.path.splitext(paths[0])[0] + ".trace.json")
    with open(out, "w") as f:
        json.dump(trace, f)
    n_att = trace["otherData"].get("attempts", 1)
    n_scale = trace["otherData"].get("scale_events", 0)
    print(f"{out}: {trace['otherData']['processes']} process lane(s)"
          + (f" across {n_att} attempts" if n_att > 1 else "")
          + (f", {n_scale} supervisor scale event(s)" if n_scale else "")
          + f", {len(trace['traceEvents'])} events — load in "
          "chrome://tracing or ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
