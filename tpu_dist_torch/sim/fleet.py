"""FleetLedger: stitch per-host run ledgers into one fleet plane (the
port's copy of ``tpu_dist/sim/fleet.py``).

``tools/ledger_report`` answers "what happened to this job" for ONE
host's attempt family; a fleet run (tpu_dist_torch.sim.runner, or any N
supervised hosts writing into one shared directory tree) needs the same
answer across hosts: cross-host discovery, clocks normalized to one
fleet epoch, and the rollups that make "handles heavy traffic" a number
— fleet goodput that provably sums to aggregate wall, the restart-class
histogram, the fleet-wide SLO-breach count, the elasticity timeline, and
per-tenant request percentiles.

Layout contract (what :meth:`FleetLedger.discover` walks)::

    <root>/fleet.jsonl          # the runner's own ledger (scenario/fleet)
    <root>/host0/run.jsonl      # host 0's attempt family + .sup sibling
    <root>/host1/run.jsonl
    ...

Each host is loaded through :func:`tpu_dist_torch.obs.goodput.load_job_records`
— the SAME one job-loading rule ``ledger_report`` uses (attempt family in
order, supervisor sibling appended) — so the fleet plane is the per-host
plane N times plus aggregation, never a second parser. Torn trailing
lines and unreadable files are tolerated per host: one crashed host must
not take down the fleet report that exists to explain it.

Stdlib-only apart from the package import (the supervisor/classify
imports touch no device), with the reference's report dict key for key,
so ``tools/fleet_report.py --json`` and
``python -m tpu_dist_torch.tools.fleet_report --json`` print the same
document for the same tree.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional

from tpu_dist_torch.obs.goodput import (fleet_accounting, job_accounting,
                                        load_job_records, split_attempts)


def _pctl(xs: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of a sorted list — the repo convention
    (``tools/ledger_report._pctl``, the reference fleet's ``_pctl``)."""
    if not xs:
        return None
    return xs[min(int(round(q / 100.0 * (len(xs) - 1))), len(xs) - 1)]


class FleetLedger:
    """The stitched fleet: ``{host_id: [records...]}`` plus the runner's
    own fleet ledger, with the rollup methods a report needs."""

    def __init__(self, hosts: Dict[int, List[dict]],
                 fleet_records: Optional[List[dict]] = None):
        self.hosts = dict(hosts)
        self.fleet_records = list(fleet_records or ())

    # -- discovery --------------------------------------------------------
    @classmethod
    def discover(cls, root: str, ledger_name: str = "run.jsonl",
                 warn=None) -> "FleetLedger":
        """Walk ``<root>/host<N>/<ledger_name>`` (plus the runner's
        ``<root>/fleet.jsonl``) and load every host's job. A host dir with
        no readable records still earns an (empty) entry — a host that
        died before its first ledger line is a finding, not a KeyError."""
        hosts: Dict[int, List[dict]] = {}
        for d in sorted(glob.glob(os.path.join(glob.escape(root), "host*"))):
            m = re.fullmatch(r"host(\d+)", os.path.basename(d))
            if not m or not os.path.isdir(d):
                continue
            h = int(m.group(1))
            base = os.path.join(d, ledger_name)
            hosts[h] = (load_job_records(base, warn=warn)
                        if os.path.exists(base) else [])
        fleet_path = os.path.join(root, "fleet.jsonl")
        fleet = (load_job_records(fleet_path, discover=False, warn=warn)
                 if os.path.exists(fleet_path) else [])
        return cls(hosts, fleet)

    # -- clock normalization ---------------------------------------------
    def t0(self) -> Optional[float]:
        """The fleet epoch: the earliest timestamp anywhere (run_start
        preferred — a sup sibling's scale event can predate the first
        child's run_start only by supervisor startup noise)."""
        starts = [r["ts"] for recs in self.hosts.values() for r in recs
                  if r.get("event") == "run_start"
                  and r.get("ts") is not None]
        if starts:
            return min(starts)
        everything = [r.get("ts") for recs in self.hosts.values()
                      for r in recs if r.get("ts") is not None]
        everything += [r.get("ts") for r in self.fleet_records
                       if r.get("ts") is not None]
        return min(everything) if everything else None

    def merged(self) -> List[dict]:
        """One clock-normalized fleet stream: every record copied with
        ``host`` stamped and ``t_rel`` (seconds since the fleet epoch)
        attached, host streams appended in host order — NOT
        ts-interleaved, for the same reason the sup sibling is appended
        (run_start boundaries are load-bearing for the per-attempt math);
        time-ordered consumers sort on ``t_rel`` themselves."""
        t0 = self.t0() or 0.0
        out = []
        for h in sorted(self.hosts):
            for r in self.hosts[h]:
                rec = dict(r)
                rec["host"] = h
                if rec.get("ts") is not None:
                    rec["t_rel"] = round(rec["ts"] - t0, 6)
                out.append(rec)
        return out

    # -- rollups ----------------------------------------------------------
    def scenario(self) -> Optional[dict]:
        for r in self.fleet_records:
            if r.get("event") == "scenario":
                return r
        return None

    def accounting(self) -> Optional[dict]:
        """Per-host :func:`job_accounting` aggregated by
        :func:`fleet_accounting`: the goodput half of the fleet report."""
        jobs = {h: job_accounting(split_attempts(recs))
                for h, recs in self.hosts.items() if recs}
        return fleet_accounting(jobs)

    def restart_classes(self) -> Dict[int, List[str]]:
        """Per-host attempt classification, from records alone (the
        report-side mode of ``classify_attempt``) — compared EXACTLY
        against the scenario's own prediction by the acceptance tests."""
        from tpu_dist_torch.parallel.supervisor import classify_attempt

        out: Dict[int, List[str]] = {}
        for h, recs in self.hosts.items():
            # the sup sibling's scale events ride appended after the last
            # attempt; they are not an attempt and must not classify as one
            own = [r for r in recs if r.get("event") != "scale"]
            out[h] = [classify_attempt(att) for att in split_attempts(own)
                      if att]
        return out

    def restart_histogram(self) -> Dict[str, int]:
        hist: Dict[str, int] = {}
        for classes in self.restart_classes().values():
            for cls in classes:
                hist[cls] = hist.get(cls, 0) + 1
        return hist

    def slo_breaches(self) -> int:
        return sum(1 for recs in self.hosts.values() for r in recs
                   if r.get("event") == "slo")

    def elasticity(self) -> List[dict]:
        """Fleet-wide ``scale`` timeline: every host's scale events (sup
        siblings included — load_job_records appended them) in fleet-clock
        order, each stamped with its host."""
        t0 = self.t0() or 0.0
        rows = []
        for h, recs in self.hosts.items():
            for r in recs:
                if r.get("event") != "scale":
                    continue
                rows.append({"host": h,
                             "t_rel": round((r.get("ts") or t0) - t0, 6),
                             **{k: r.get(k) for k in
                                ("action", "processes", "epoch", "hosts",
                                 "step", "world_from", "shed",
                                 "decision")}})
        rows.sort(key=lambda r: (r["t_rel"], r["host"]))
        return rows

    def autoscale(self) -> Optional[dict]:
        """The decision audit: every ``scale_decision`` the capacity
        monitor emitted (runner fleet ledger), each joined with the scale
        event(s) the supervisor attributed to it (``decision`` stamp) and
        the ``applied`` follow-up carrying the retuned plan hash. The
        acceptance invariant is the pairing: ``unattributed_scales == 0``
        and every decision's ``scale_events == 1`` means capacity never
        moved except under an auditable decision. ``None`` when the run
        had no autoscaling (fixed-capacity fleets stay unchanged)."""
        decisions = [r for r in self.fleet_records
                     if r.get("event") == "scale_decision"]
        if not decisions:
            return None
        t0 = self.t0() or 0.0
        scales = self.elasticity()
        applied = []
        for h, recs in self.hosts.items():
            for r in recs:
                if r.get("event") != "applied":
                    continue
                applied.append({"host": h,
                                "t_rel": round((r.get("ts") or t0) - t0, 6),
                                **{k: r.get(k) for k in
                                   ("decision", "action", "processes",
                                    "epoch", "plan_hash")}})
        rows = []
        for d in decisions:
            did = d.get("decision")
            match = [s for s in scales if s.get("decision") == did]
            app = [a for a in applied if a.get("decision") == did]
            t_rel = round((d.get("ts") or t0) - t0, 6)
            rows.append({
                "decision": did, "t_rel": t_rel, "tick": d.get("tick"),
                **{k: d.get(k) for k in
                   ("direction", "hosts_from", "target_hosts", "signal",
                    "value", "threshold", "window_ticks", "bundle")},
                "scale_events": len(match),
                "lag_s": (round(match[0]["t_rel"] - t_rel, 6)
                          if match else None),
                "applied": app[0] if app else None})
        rows.sort(key=lambda r: (r["t_rel"], r["decision"] or ""))
        traces = self.traces()
        return {
            "decisions": rows,
            "paired": sum(1 for r in rows if r["scale_events"] == 1),
            # only MEMBERSHIP actions need attribution: drains/snapshots
            # are per-host mechanics, not capacity changes
            "unattributed_scales": sum(
                1 for s in scales
                if s.get("action") in ("shrink", "expand")
                and s.get("decision") is None),
            "applied_with_plan_hash": sum(
                1 for r in rows
                if (r["applied"] or {}).get("plan_hash") is not None),
            "shed_lost": sum(1 for tr in traces.values()
                             if tr["sheds"] and not tr["completed"]),
        }

    def per_tenant(self) -> Dict[str, dict]:
        """Per-tenant serving percentiles over the fleet's ``request``
        events (the worker stamps ``tenant`` on each): queue wait and
        TTFT p50/p99, completed counts and generated tokens — the
        many-workloads-one-fleet accounting ROADMAP item 4 asks for."""
        by_tenant: Dict[str, List[dict]] = {}
        for recs in self.hosts.values():
            for r in recs:
                if r.get("event") != "request":
                    continue
                by_tenant.setdefault(str(r.get("tenant") or "?"),
                                     []).append(r)
        out = {}
        for tenant, rs in sorted(by_tenant.items()):
            waits = sorted(r["queue_wait_s"] for r in rs
                           if r.get("queue_wait_s") is not None)
            ttfts = sorted(r["ttft_s"] for r in rs
                           if r.get("ttft_s") is not None)
            out[tenant] = {
                "requests": len(rs),
                "tokens": sum(r.get("tokens") or 0 for r in rs),
                "queue_wait_s": {"p50": _pctl(waits, 50),
                                 "p99": _pctl(waits, 99)},
                "ttft_s": {"p50": _pctl(ttfts, 50), "p99": _pctl(ttfts, 99)}}
        return out

    def traces(self) -> Dict[str, dict]:
        """Cross-host request traces, stitched by trace_id equality alone
        (obs.reqtrace derives host-independent ids, so hosts that never
        exchanged a byte mint the same id for the same rid) — the request
        analog of the goodput stitch. Returns trace_id -> a summary row:
        which hosts touched the request, span/shed/readmit counts, and
        whether ANY host completed it (a root ``request`` span exists).
        The heavy per-trace machinery (waterfalls, attribution, exemplars)
        lives in ``tpu_dist_torch.tools.request_report`` over :meth:`merged`."""
        from tpu_dist_torch.obs import reqtrace

        out = {}
        for tid, tr in sorted(reqtrace.traces(self.merged()).items()):
            names = [s.get("name") for s in tr["spans"]]
            out[tid] = {
                "rid": tr["rid"],
                "hosts": tr["hosts"],
                "spans": len(tr["spans"]),
                "sheds": sum(1 for n in names if n == "shed"),
                "readmits": sum(1 for n in names if n == "readmit"),
                "completed": bool(tr["roots"]),
            }
        return out

    def serving_totals(self) -> dict:
        completed = rejected = 0
        for recs in self.hosts.values():
            for r in recs:
                if r.get("event") == "request":
                    completed += 1
                elif r.get("event") == "admit" and not r.get("accepted"):
                    rejected += 1
        return {"completed": completed, "rejected": rejected}

    def hosts_live_timeline(self) -> List[dict]:
        """The runner's periodic ``fleet`` snapshots (hosts_live over
        fleet time) — the scrape-series view, read back from the ledger."""
        t0 = self.t0() or 0.0
        return [{"t_rel": round((r.get("ts") or t0) - t0, 6),
                 "hosts_live": r.get("hosts_live"),
                 "slo_breaches": r.get("slo_breaches"),
                 "tick": r.get("tick")}
                for r in self.fleet_records if r.get("event") == "fleet"]

    def report(self) -> dict:
        """The one machine-readable fleet dict (tools/fleet_report --json
        prints it verbatim; the acceptance tests assert into it)."""
        acct = self.accounting()
        scenario = self.scenario()
        return {
            "hosts": sorted(self.hosts),
            "scenario": ({k: scenario.get(k) for k in
                          ("name", "seed", "hosts", "ticks", "tick_s")}
                         if scenario else None),
            "fleet": acct,
            "restart_classes": {str(h): cls for h, cls in
                                sorted(self.restart_classes().items())},
            "restart_histogram": self.restart_histogram(),
            "slo_breaches": self.slo_breaches(),
            "elasticity": self.elasticity(),
            "per_tenant": self.per_tenant(),
            "serving": self.serving_totals(),
            "traces": self.traces(),
            "hosts_live": self.hosts_live_timeline(),
            "autoscale": self.autoscale(),
        }
