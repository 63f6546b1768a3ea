"""Per-request tail attribution and waterfalls for the port.

The port's own copy of what the decode bench reads from
``tools/request_report.py`` (stdlib only), over the span records of the
port's ``obs/reqtrace.py``: the same functions, names and output dicts,
so a port ledger and a reference ledger report alike.

* :func:`requests_summary`: the machine-readable summary of a span
  stream, with the ``tail_attribution`` block: each completed request's
  admit->finish latency split into queue / prefill / decode with a
  per-request sum-check (attributed seconds + residue == latency), and
  the TTFT/TPOT percentiles decomposed by their nearest-rank request;
* :func:`slowest_traces` and :func:`waterfall_lines`: the slowest request
  trees rendered as per-phase bars (the decode bench's ``--waterfalls``).

SLO-breach exemplars ride the summary as in the reference. The CLI reads
a ledger (its attempt family and supervisor sibling) or a fleet directory
(``tpu_dist_torch.sim.runner``'s layout)::

    python -m tpu_dist_torch.tools.request_report /tmp/fleet --json
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from tpu_dist_torch.obs import reqtrace

# per-request sum-check tolerance: span endpoints are rounded to 1e-6
# before emit, so a request's tiling can drift by ~n_spans * 0.5e-6
SUM_TOL = 1e-4
# exemplar window around a breach's wall timestamp
EXEMPLAR_WINDOW_S = 30.0
EXEMPLARS_PER_BREACH = 3
_BAR_W = 32

LABELS = {
    "queue": "admission backlog (queue span: submit -> prefill start)",
    "prefill": "prompt processing (bucket pad, page writes, first token)",
    "decode": "token generation (windowed decode ticks, spec rounds)",
    "residue": "unattributed (lost spans / torn ledger)",
}


def _pctl(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of a sorted list (the repo convention)."""
    if not xs:
        return None
    return xs[min(int(round(q / 100.0 * (len(xs) - 1))), len(xs) - 1)]


def _dur(span: dict) -> float:
    return float(span.get("end") or 0.0) - float(span.get("start") or 0.0)


# -- attribution ------------------------------------------------------------

def attribute_root(root: dict, trace: dict) -> dict:
    """One completed host-attempt view of a request, decomposed: category
    seconds summed from the root's child spans, residue = measured
    latency minus attributed (about 0 when no span was lost)."""
    kids = [s for s in trace["spans"]
            if s.get("parent_id") == root["span_id"]]
    cats = {c: 0.0 for c in reqtrace.CATEGORIES}
    for s in kids:
        if s.get("name") in cats:
            cats[s["name"]] += _dur(s)
    latency = _dur(root)
    attributed = sum(cats.values())
    residue = latency - attributed
    tokens = root.get("tokens")
    decode_s = cats["decode"]
    return {
        "trace_id": trace["trace_id"], "rid": root.get("rid"),
        "job_id": root.get("job_id"), "attempt": root.get("attempt"),
        "host": root.get("host"),
        "latency_s": round(latency, 6),
        "queue_s": round(cats["queue"], 6),
        "prefill_s": round(cats["prefill"], 6),
        "decode_s": round(decode_s, 6),
        "residue_s": round(residue, 6),
        "ttft_s": root.get("ttft_s"),
        "tokens": tokens,
        "tpot_s": (round(decode_s / tokens, 6) if tokens else None),
        "spans": len(kids),
        "sum_check_ok": abs(residue) <= SUM_TOL,
        "ts": root.get("ts"),
    }


def request_rows(traces: Dict[str, dict]) -> List[dict]:
    """Every completed (root-emitting) host-attempt of every trace, by
    rid, then job identity."""
    rows = []
    for tid in sorted(traces):
        tr = traces[tid]
        for root in tr["roots"]:
            rows.append(attribute_root(root, tr))
    rows.sort(key=lambda r: (r["rid"] if r["rid"] is not None else -1,
                             str(r["job_id"]), r["attempt"] or 0))
    return rows


def _tail_point(rows: List[dict], metric: str, parts) -> Dict[str, dict]:
    """p50/p90/p99 of ``metric`` with the nearest-rank request's named
    decomposition attached."""
    pool = sorted((r for r in rows if r.get(metric) is not None),
                  key=lambda r: (r[metric], str(r["trace_id"])))
    out = {}
    for q in (50, 90, 99):
        r = _pctl(pool, q)
        if r is None:
            out[f"p{q}"] = None
            continue
        out[f"p{q}"] = {metric: r[metric], "rid": r["rid"],
                        "trace_id": r["trace_id"],
                        **{p: r[p] for p in parts}}
    return out


def tail_attribution(rows: List[dict]) -> dict:
    """The headline block: TTFT decomposes into queue + prefill, TPOT into
    decode per token; ``shares`` are the category fractions of total
    latency, ``coverage`` the attributed share."""
    total = sum(r["latency_s"] for r in rows)
    shares = {}
    for cat in (*reqtrace.CATEGORIES, "residue"):
        secs = sum(r[f"{cat}_s"] for r in rows)
        shares[cat] = {"seconds": round(secs, 6),
                       "share": round(secs / total, 6) if total else None,
                       "label": LABELS[cat]}
    attributed = sum(shares[c]["seconds"] for c in reqtrace.CATEGORIES)
    return {
        "requests": len(rows),
        "ttft": _tail_point(rows, "ttft_s", ("queue_s", "prefill_s")),
        "tpot": _tail_point(rows, "tpot_s", ("decode_s", "tokens")),
        "shares": shares,
        "coverage": round(attributed / total, 6) if total else None,
        "sum_check": {
            "ok": all(r["sum_check_ok"] for r in rows),
            "requests": len(rows),
            "failed": [r["trace_id"] for r in rows
                       if not r["sum_check_ok"]],
            "max_residue_s": (round(max(abs(r["residue_s"]) for r in rows),
                                    6) if rows else 0.0),
            "tolerance_s": SUM_TOL,
        },
    }


# -- SLO-breach exemplars ---------------------------------------------------

def _candidates(records, traces: Dict[str, dict]) -> List[dict]:
    """Everything a breach can point at: completed request roots and shed
    spans, on the wall ``ts`` (emit time) clock."""
    out = []
    for tid in sorted(traces):
        tr = traces[tid]
        for root in tr["roots"]:
            row = attribute_root(root, tr)
            if row["ts"] is not None:
                out.append({"kind": "request", **row})
        for s in tr["spans"]:
            if s.get("name") == "shed" and s.get("ts") is not None:
                out.append({"kind": "shed", "trace_id": tid,
                            "rid": s.get("rid"), "host": s.get("host"),
                            "job_id": s.get("job_id"),
                            "queue_s": round(_dur(s), 6),
                            "latency_s": round(_dur(s), 6),
                            "reason": s.get("reason"), "ts": s["ts"]})
    return out


def slo_exemplars(records, traces: Dict[str, dict]) -> List[dict]:
    """Bind every ``slo`` breach event to its worst-offender traces inside
    the wall-clock breach window (same host first), falling back to the
    nearest candidate in time."""
    cands = _candidates(records, traces)
    out = []
    for rec in records:
        if rec.get("event") != "slo" or rec.get("ts") is None:
            continue
        kind = rec.get("kind")
        score_key = "queue_s" if kind == "queue_wait" else "latency_s"
        host = rec.get("host")
        same_host = [c for c in cands
                     if host is None or c.get("host") == host]
        pool = same_host or cands
        windowed = [c for c in pool
                    if abs(c["ts"] - rec["ts"]) <= EXEMPLAR_WINDOW_S]
        chosen = sorted(
            windowed,
            key=lambda c: (-(c.get(score_key) or 0.0),
                           str(c["trace_id"])))[:EXEMPLARS_PER_BREACH]
        if not chosen and pool:
            chosen = sorted(
                pool, key=lambda c: (abs(c["ts"] - rec["ts"]),
                                     str(c["trace_id"])))[:1]
        out.append({
            "kind": kind, "host": host, "value": rec.get("value"),
            "floor": rec.get("floor"), "step": rec.get("step"),
            "exemplars": [
                {"trace_id": c["trace_id"], "rid": c["rid"],
                 "kind": c["kind"], "job_id": c.get("job_id"),
                 "score_s": round(c.get(score_key) or 0.0, 6),
                 "dt_s": round(c["ts"] - rec["ts"], 3)}
                for c in chosen],
        })
    return out


# -- waterfalls -------------------------------------------------------------

def waterfall_lines(trace: dict) -> List[str]:
    """One trace as indented bars, each host-attempt against its own
    engine clock."""
    rows = [attribute_root(root, trace) for root in trace["roots"]]
    latency = max((r["latency_s"] for r in rows), default=0.0)
    hosts = ",".join(str(h) for h in trace["hosts"]) or "-"
    lines = [f"trace {trace['trace_id']}  rid={trace['rid']}  "
             f"hosts=[{hosts}]  attempts={len(trace['roots'])}  "
             f"latency={latency:.6g}s"]
    by_parent = reqtrace.children_of(trace)
    orphans = [s for s in trace["spans"]
               if s.get("parent_id") is not None
               and s["parent_id"] not in {r["span_id"]
                                          for r in trace["roots"]}]
    for root in trace["roots"]:
        t0, t1 = float(root["start"]), float(root["end"])
        width = max(t1 - t0, 1e-9)
        lines.append(f"  [{root.get('job_id')} a{root.get('attempt')}] "
                     f"request {t0:.6g} -> {t1:.6g}  ({t1 - t0:.6g}s)")
        for s in by_parent.get(root["span_id"], ()):
            off = int(_BAR_W * (float(s["start"]) - t0) / width)
            n = max(int(_BAR_W * _dur(s) / width), 1)
            off = min(off, _BAR_W - 1)
            n = min(n, _BAR_W - off)
            bar = "." * off + "#" * n + "." * (_BAR_W - off - n)
            extra = ""
            if s.get("name") == "prefill":
                extra = (f"  bucket={s.get('bucket')} "
                         f"shared={s.get('pages_shared')}")
            elif s.get("name") == "decode":
                extra = (f"  ticks={s.get('ticks')} "
                         f"tokens={s.get('tokens')}")
            elif s.get("name") in ("shed", "readmit"):
                extra = f"  reason={s.get('reason')}"
            lines.append(f"    {s.get('name'):<10} |{bar}| "
                         f"{_dur(s):.6g}s{extra}")
    for s in orphans:
        lines.append(f"  [{s.get('job_id')} a{s.get('attempt')}] "
                     f"{s.get('name'):<10} (no root: attempt never "
                     f"completed it)  {_dur(s):.6g}s  "
                     f"reason={s.get('reason')}")
    return lines


def slowest_traces(traces: Dict[str, dict], n: int) -> List[dict]:
    """The n slowest traces by their worst completed attempt, slowest
    first (trace_id breaks ties)."""
    scored = []
    for tid in sorted(traces):
        tr = traces[tid]
        if not tr["roots"]:
            continue
        worst = max(_dur(r) for r in tr["roots"])
        scored.append((worst, tid, tr))
    scored.sort(key=lambda x: (-x[0], x[1]))
    return [tr for _w, _tid, tr in scored[:n]]


# -- the summary ------------------------------------------------------------

def requests_summary(records) -> dict:
    """The one machine-readable dict of a span stream."""
    traces = reqtrace.traces(records)
    rows = request_rows(traces)
    sheds = sum(1 for t in traces.values()
                for s in t["spans"] if s.get("name") == "shed")
    readmits = sum(1 for t in traces.values()
                   for s in t["spans"] if s.get("name") == "readmit")
    return {
        "traces": len(traces),
        "completed_requests": len(rows),
        "cross_host_traces": sum(1 for t in traces.values()
                                 if len(t["hosts"]) > 1),
        "sheds": sheds,
        "readmits": readmits,
        "per_request": rows,
        "tail_attribution": tail_attribution(rows) if rows else None,
        "slo_exemplars": slo_exemplars(records, traces),
        "slowest": [t["trace_id"] for t in slowest_traces(traces, 5)],
    }


def render(summary: dict, records, out=print, waterfalls: int = 3) -> None:
    out("== requests (per-request traces: obs.reqtrace) ==")
    out(f"  traces {summary['traces']}  completed "
        f"{summary['completed_requests']}  cross-host "
        f"{summary['cross_host_traces']}  sheds {summary['sheds']}  "
        f"readmits {summary['readmits']}")
    ta = summary.get("tail_attribution")
    if ta:
        sc = ta["sum_check"]
        out(f"  sum-check: {'OK' if sc['ok'] else 'FAILED'} over "
            f"{sc['requests']} requests (max residue "
            f"{sc['max_residue_s']:.6g}s, tol {sc['tolerance_s']:g})")
        out(f"  coverage: {ta['coverage']} of latency attributed")
        out("  where the seconds went:")
        for cat, row in ta["shares"].items():
            share = "-" if row["share"] is None else f"{row['share']:.1%}"
            out(f"    {cat:<8} {row['seconds']:>10.6g}s  {share:>7}  "
                f"{row['label']}")
        for metric, parts in (("ttft", ("queue_s", "prefill_s")),
                              ("tpot", ("decode_s", "tokens"))):
            out(f"  {metric} percentiles (nearest-rank exemplar request):")
            for q in ("p50", "p90", "p99"):
                p = ta[metric][q]
                if p is None:
                    out(f"    {q}: no data")
                    continue
                split = "  ".join(f"{k}={p[k]}" for k in parts)
                out(f"    {q}: {p[metric + '_s']:.6g}s  rid={p['rid']}  "
                    f"{split}")
    if summary["slo_exemplars"]:
        out("  slo breaches -> exemplar traces:")
        for b in summary["slo_exemplars"]:
            host = "-" if b["host"] is None else b["host"]
            ex = ", ".join(
                f"rid={e['rid']} {e['kind']} {e['score_s']:.6g}s "
                f"({e['trace_id'][:8]})" for e in b["exemplars"]) or "NONE"
            out(f"    [{b['kind']} host={host} value={b['value']}] {ex}")
    if waterfalls > 0:
        slow = slowest_traces(reqtrace.traces(records), waterfalls)
        if slow:
            out(f"  {len(slow)} slowest request waterfalls:")
            for tr in slow:
                for line in waterfall_lines(tr):
                    out("    " + line)


def load_records(path: str, discover: bool = True) -> List[dict]:
    """A ledger file loads as one job (attempt family + sup sibling); a
    directory loads as a fleet (host*/ subtrees, host stamped on every
    record — the cross-host exemplar index needs it)."""
    if os.path.isdir(path):
        from tpu_dist_torch.sim.fleet import FleetLedger

        return FleetLedger.discover(path).merged()
    from tpu_dist_torch.obs.goodput import load_job_records

    return load_job_records(path, discover=discover)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-request waterfalls, tail-latency attribution "
                    "and SLO-breach exemplars from span ledger events")
    ap.add_argument("path", help="serving ledger (.jsonl) or fleet dir")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the machine-readable summary")
    ap.add_argument("--waterfalls", type=int, default=3,
                    help="N slowest request waterfalls in human output")
    ap.add_argument("--no-discover", action="store_true",
                    help="read exactly this file, no attempt-family glob")
    args = ap.parse_args(argv)
    records = load_records(args.path, discover=not args.no_discover)
    summary = requests_summary(records)
    if args.as_json:
        print(json.dumps(summary, default=str))
    else:
        render(summary, records, out=print, waterfalls=args.waterfalls)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
