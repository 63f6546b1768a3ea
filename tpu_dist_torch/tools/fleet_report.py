"""Render a stitched fleet (tpu_dist_torch.sim.fleet.FleetLedger) from
the CLI (the port's ``tools/fleet_report.py``).

    python -m tpu_dist_torch.tools.fleet_report /tmp/fleet          # summary
    python -m tpu_dist_torch.tools.fleet_report /tmp/fleet --json   # report

``PATH`` is a fleet directory (the ``tpu_dist_torch.sim.runner`` layout:
``host<N>/run.jsonl`` families + the runner's ``fleet.jsonl``); any tree
of per-host supervised runs with that shape works. Renders: the scenario
identity, the fleet goodput partition (per-host goodput/badput aggregated
over every attempt and restart gap, with the sum-check that proves
categories + goodput account for ~100% of the aggregate wall), the
restart-class histogram and per-host class lists (`classify_attempt` in
report mode), the fleet-wide SLO-breach count, the cross-host elasticity
timeline (every ``scale`` event on the fleet clock), per-tenant request
percentiles, the hosts-live timeline from the runner's periodic ``fleet``
events, and — when the run autoscaled — the decision audit (every
``scale_decision`` with its attribution, the paired scale event's lag,
and the retuned plan hash from the ``applied`` follow-up).

``--json`` prints :meth:`FleetLedger.report` verbatim: the same document
the reference's tool prints for the same tree.
"""

import argparse
import json
import os
import sys

from tpu_dist_torch.sim.fleet import FleetLedger

GOODPUT_LABELS = {"startup": "startup/compile", "data_wait": "data wait",
                  "dispatch": "dispatch", "eval": "eval",
                  "ckpt": "checkpoint", "stall": "watchdog stall",
                  "skipped": "health-skipped", "idle": "idle/drain",
                  "restart_gap": "restart gap"}


def render(report: dict, out=print) -> None:
    sc = report.get("scenario")
    if sc:
        out(f"scenario: {sc.get('name')!r} seed={sc.get('seed')} "
            f"hosts={sc.get('hosts')} ticks={sc.get('ticks')} "
            f"tick_s={sc.get('tick_s')}")
    hosts = report.get("hosts") or []
    out(f"fleet: {len(hosts)} host dir(s) discovered")
    acct = report.get("fleet")
    if acct and not acct["aggregate_wall_s"]:
        # every host died at (or before) its first timestamp — the wall
        # is zero and there are no shares to print; this report exists
        # for exactly such fleets, so say it instead of dividing by it
        out(f"\nfleet goodput: {acct['hosts']} host(s) but ZERO aggregate "
            "wall (no host survived past its first record)")
    elif acct:
        wall = acct["aggregate_wall_s"]
        out(f"\nfleet goodput ({acct['hosts']} host(s), aggregate wall "
            f"{wall:.1f} host-seconds):")
        rows = [("goodput", acct["goodput_s"])] + [
            (c, acct["categories"].get(c, 0.0)) for c in GOODPUT_LABELS]
        for cat, secs in rows:
            if cat != "goodput" and not secs:
                continue
            out(f"  {GOODPUT_LABELS.get(cat, cat):<16} {secs:9.3f}s  "
                f"{secs / wall * 100:5.1f}%")
        out(f"  fleet goodput ratio {acct['goodput_ratio']:.3f} over "
            f"{acct['opt_steps']} tick(s); categories + goodput account "
            f"for {acct['sum_check'] * 100:.1f}% of aggregate wall"
            + (f"; OVERRUN {acct['overrun_s']:.3f}s"
               if acct.get("overrun_s") else ""))
        for h, hj in sorted(acct.get("per_host", {}).items()):
            out(f"  host {h}: {hj['wall_s']:.1f}s wall, "
                f"{hj['goodput_s']:.1f}s goodput "
                f"(ratio {hj['ratio']}), {hj['attempts']} attempt(s)")
    hist = report.get("restart_histogram") or {}
    classes = report.get("restart_classes") or {}
    if hist:
        out(f"\nrestarts: histogram {hist}")
        for h, cls in sorted(classes.items(), key=lambda kv: int(kv[0])):
            out(f"  host {h}: {' -> '.join(cls) if cls else '(no attempts)'}")
    out(f"\nSLO breaches (fleet-wide): {report.get('slo_breaches')}")
    tenants = report.get("per_tenant") or {}
    if tenants:
        out("\nper-tenant serving:")
        for name, t in tenants.items():
            qw, tt = t["queue_wait_s"], t["ttft_s"]
            out(f"  {name:<12} {t['requests']:4d} request(s), "
                f"{t['tokens']} tok"
                + (f"; queue wait p50 {qw['p50'] * 1e3:.1f}ms / "
                   f"p99 {qw['p99'] * 1e3:.1f}ms"
                   if qw["p50"] is not None else "")
                + (f"; TTFT p50 {tt['p50'] * 1e3:.1f}ms / "
                   f"p99 {tt['p99'] * 1e3:.1f}ms"
                   if tt["p50"] is not None else ""))
    srv = report.get("serving") or {}
    if srv:
        out(f"serving totals: {srv.get('completed')} completed, "
            f"{srv.get('rejected')} rejected")
    traces = report.get("traces") or {}
    if traces:
        cross = [t for t in traces.values() if len(t.get("hosts") or []) > 1]
        out(f"request traces: {len(traces)} stitched, {len(cross)} "
            f"cross-host, "
            f"{sum(t.get('sheds') or 0 for t in traces.values())} shed "
            f"span(s), "
            f"{sum(t.get('readmits') or 0 for t in traces.values())} "
            "readmit(s)")
        for t in cross[:5]:
            out(f"  rid {t['rid']}: hosts {t['hosts']}, {t['spans']} "
                f"span(s), completed={t['completed']} — one trace_id, "
                "N hosts (waterfalls: tpu_dist_torch.tools.request_report)")
    elas = report.get("elasticity") or []
    if elas:
        out(f"\nelasticity ({len(elas)} scale event(s), fleet clock):")
        for r in elas:
            out(f"  +{r['t_rel']:8.1f}s  host {r['host']}: "
                f"{r.get('action')}"
                + (f" -> {r['processes']} process(es)"
                   if r.get("processes") is not None else "")
                + (f" epoch {r['epoch']}" if r.get("epoch") is not None
                   else ""))
    live = report.get("hosts_live") or []
    if live:
        peak = max((r.get("hosts_live") or 0) for r in live)
        out(f"\nhosts-live timeline: {len(live)} snapshot(s), peak {peak}")
    auto = report.get("autoscale")
    if auto:
        rows = auto.get("decisions") or []
        out(f"\nautoscale: {len(rows)} decision(s), {auto.get('paired')} "
            f"paired 1:1 with a scale event, "
            f"{auto.get('unattributed_scales')} unattributed scale "
            f"event(s), {auto.get('applied_with_plan_hash')} applied with "
            f"a retuned plan hash, {auto.get('shed_lost')} shed request(s) "
            "lost")
        for r in rows:
            out(f"  +{r['t_rel']:8.1f}s  {r['decision']}: "
                f"{r.get('direction')} {r.get('hosts_from')}"
                f"->{r.get('target_hosts')} host(s) @tick {r.get('tick')} "
                f"— {r.get('signal')}={r.get('value')} vs "
                f"{r.get('threshold')} over {r.get('window_ticks')} "
                "tick(s)"
                + (f"; scaled after {r['lag_s']:.1f}s"
                   if r.get("lag_s") is not None else "; UNPAIRED")
                + (f"; plan {r['applied']['plan_hash']} @epoch "
                   f"{r['applied']['epoch']}"
                   if (r.get("applied") or {}).get("plan_hash") else "")
                + (f"; bundle {r['bundle']}" if r.get("bundle") else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="fleet directory (host<N>/run.jsonl "
                    "families + fleet.jsonl)")
    ap.add_argument("--ledger-name", default="run.jsonl",
                    help="per-host base ledger filename (default "
                    "run.jsonl)")
    ap.add_argument("--json", action="store_true",
                    help="print the FleetLedger report as one JSON object")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.path):
        print(f"{args.path}: not a fleet directory", file=sys.stderr)
        return 1
    fleet = FleetLedger.discover(args.path, ledger_name=args.ledger_name)
    if not fleet.hosts:
        print(f"{args.path}: no host*/ dirs found", file=sys.stderr)
        return 1
    report = fleet.report()
    if args.json:
        print(json.dumps(report, default=str))
    else:
        render(report)
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        raise SystemExit(0)
