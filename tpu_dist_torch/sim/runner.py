"""FleetSim: drive one scenario across N supervised virtual hosts (the
port's ``tpu_dist/sim/runner.py``).

The runner opens no device, as the supervisor it composes (only the
worker children do): per host it runs one
:class:`~tpu_dist_torch.parallel.supervisor.Supervisor` (in a thread)
around ``python -m tpu_dist_torch.sim.worker --device D``, exports that
host's compiled fault spec as ``TPU_DIST_FAULTS``, and gives the
scenario's ``consensus_host`` a real
:class:`~tpu_dist_torch.parallel.consensus.ConsensusDir` — so a
preemption wave's ``leave`` and the later ``register`` (the host return)
drive the consensus membership path for real: epoch bump, mid-attempt
SIGTERM, rescale relaunch, ``shrink``/``expand`` scale events in the
``.sup.jsonl`` sibling.

Scheduling is on the **fleet clock**: consensus actions fire when every
live (not scheduled-down, not finished) host's published tick
(``<ledger>.tick`` sidecar) has reached the action's tick — tick gating
both orders the actions deterministically w.r.t. the traffic and proves
the gated hosts are actually serving (a host mid-restart holds the clock
until it resumes). A wall deadline backstops a wedged fleet.

Outputs under ``out_dir``::

    scenario.json   # the normalized schedule (self-contained artifact)
    fleet.jsonl     # the runner's own ledger: scenario + fleet events
    host<N>/        # each host's attempt ledgers + .sup sibling + sidecars
    report.json     # the stitched FleetLedger report
    headline.json   # bench_track-shaped point carrying fleet.goodput_ratio

``python -m tpu_dist_torch.sim.runner --scenario scripts/fleet_ci.json
--out /tmp/fleet [--device cpu]`` is the CLI;
``python -m tpu_dist_torch.tools.fleet_report`` renders the result.

With an autoscale policy the consensus host's supervisor re-tunes the
step plan at every new world size for ``device_kind``: the card's name
(``torch.cuda.get_device_name()``) when the workers run on CUDA, else
the caller's ``device_kind`` (required then).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from tpu_dist_torch.obs.autoscale import (AutoscalePolicy, CapacityMonitor,
                                          LedgerTailer, emit_decision)
from tpu_dist_torch.obs.ledger import Ledger
from tpu_dist_torch.obs.metrics import MetricsRegistry, metrics_ledger_sink
from tpu_dist_torch.parallel.consensus import ConsensusDir
from tpu_dist_torch.parallel.supervisor import RestartPolicy, Supervisor
from tpu_dist_torch.sim.scenario import (Scenario, compile_host_plans,
                                         load_scenario)


_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


# kept through the scrub: where the kernels' libraries are built, not a
# run knob (a worker that lost it would rebuild them elsewhere)
_KEEP_ENV = ("TPU_DIST_TORCH_BUILD",)


def _scrubbed_env(extra: Dict[str, str]) -> Dict[str, str]:
    """A child env with no inherited TPU_DIST/XLA state (the test
    harness's own knobs must not leak into the simulated hosts).
    ``python -m tpu_dist_torch.sim.worker`` must resolve from any cwd, so
    the package root rides PYTHONPATH."""
    env = {k: v for k, v in os.environ.items()
           if k in _KEEP_ENV or not (k.startswith("TPU_DIST")
                                     or k == "XLA_FLAGS")}
    env["PYTHONPATH"] = _REPO_ROOT + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update(extra)
    return env


class FleetSim:
    """One scenario run (see module docstring). ``scenario`` may be a
    path or a parsed :class:`~tpu_dist_torch.sim.scenario.Scenario`.
    ``device`` is the workers' torch device (every host's); ``device_kind``
    names the retune's device (module docstring)."""

    def __init__(self, scenario, out_dir: str, *,
                 python: str = sys.executable,
                 stall_timeout_s: float = 300.0,
                 max_restarts: int = 6, device: str = "cuda",
                 device_kind: Optional[str] = None):
        self.sc: Scenario = (scenario if isinstance(scenario, Scenario)
                             else load_scenario(scenario))
        self.out = out_dir
        self.python = python
        self.stall_timeout_s = stall_timeout_s
        self.max_restarts = max_restarts
        self.device = str(device)
        self.plans, self.actions = compile_host_plans(self.sc)
        self.results: Dict[int, object] = {}
        self._sups: Dict[int, Supervisor] = {}
        self._breaches = 0
        # autoscaling (obs.autoscale): standby hosts start
        # parked; the CapacityMonitor, fed by tailing every host ledger,
        # decides when they join (and when elastic hosts leave again)
        auto = self.sc.autoscale or {}
        pol = auto.get("policy")
        if isinstance(pol, str) and not os.path.exists(pol):
            # checked-in scenarios name their policy repo-relative
            # (scripts/autoscale_policy.json) — resolve it from anywhere
            pol = os.path.join(_REPO_ROOT, pol)
        self.policy: Optional[AutoscalePolicy] = (
            None if pol is None else
            AutoscalePolicy.from_doc(pol) if isinstance(pol, dict)
            else AutoscalePolicy.load(pol))
        self.standby = set(self.sc.standby_hosts())
        self.decisions: List[dict] = []
        self.device_kind = device_kind
        if self.policy is not None and not device_kind:
            if not self.device.startswith("cuda"):
                raise ValueError(
                    "FleetSim: an autoscale scenario on a non-CUDA device "
                    "needs device_kind (the retune's device name)")
            import torch

            self.device_kind = torch.cuda.get_device_name()

    # -- wiring -----------------------------------------------------------
    def _host_dir(self, h: int) -> str:
        return os.path.join(self.out, f"host{h}")

    def _ledger_path(self, h: int) -> str:
        return os.path.join(self._host_dir(h), "run.jsonl")

    def _build_supervisor(self, h: int, cdir: str,
                          scenario_path: str) -> Supervisor:
        plan = self.plans[h]
        sc = self.sc
        env = _scrubbed_env({
            "TPU_DIST_NUM_PROCESSES": str(sc.hosts),
            "TPU_DIST_PROCESS_ID": str(h),
            **({"TPU_DIST_FAULTS": plan.faults} if plan.faults else {}),
        })
        # a preempted-with-return host must stay genuinely absent until
        # its return tick: the first restart's backoff covers the gap
        holdoff = plan.restart_holdoff_ticks * sc.tick_s * plan.skew
        policy = RestartPolicy(
            max_restarts=self.max_restarts,
            backoff_base_s=max(holdoff, 0.2),
            backoff_max_s=max(holdoff * 2, 30.0),
            stall_timeout_s=self.stall_timeout_s,
            # the sim's SIGTERM faults are the schedule, not host loss
            shrink_on_host_loss=False)
        consensus = (ConsensusDir(cdir, h, planned=self._planned(),
                                  lease_s=3600.0)
                     if h == sc.consensus_host else None)
        # with a policy configured, the consensus host re-tunes the plan
        # deterministically at every new world size and stamps its hash
        # into the decision's `applied` follow-up event
        retune = None
        if consensus is not None and self.policy is not None:
            retune = {"device_kind": self.device_kind,
                      "devices_per_host": max(sc.worker_devices, 1),
                      "plan_dir": os.path.join(self.out, "plans")}
        return Supervisor(
            [self.python, "-m", "tpu_dist_torch.sim.worker",
             "--scenario", scenario_path, "--host", str(h),
             "--device", self.device],
            ledger=self._ledger_path(h), policy=policy, env=env,
            poll_s=0.1, consensus=consensus, consensus_poll_s=0.25,
            retune=retune)

    def _planned(self) -> int:
        """The baseline (planned) world size: standby hosts are extra
        elastic capacity ABOVE plan, so the consensus host's first
        resolve at the parked-standby world must not read as a shrink."""
        return self.sc.hosts - (len(self.standby) if self.policy else 0)

    def _read_tick(self, h: int) -> int:
        try:
            with open(self._ledger_path(h) + ".tick") as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    # -- the autoscaling loop (obs.autoscale) -----------------------------
    def _autoscale_step(self, monitor: CapacityMonitor,
                        tailer: LedgerTailer, clock: int, live: list,
                        peers: Dict[int, ConsensusDir], parked: set,
                        elastic: set, gone: set, down: set,
                        fleet_ledger: Ledger, start_host) -> None:
        """Feed the monitor from every host's growing ledgers, evaluate
        the policy at the fleet clock, and EXECUTE any decision through
        the machinery that already owns capacity: consensus membership
        (register a parked standby / leave an elastic host) whose epoch
        bump the consensus-host supervisor turns into the shrink/expand
        rescale — stamped with the decision id for the 1:1 pairing."""
        sc = self.sc
        paths = sorted(glob.glob(os.path.join(
            glob.escape(self.out), "host*", "run*.jsonl")))
        for rec in tailer.poll(paths):
            monitor.observe(rec)
        # capacity is what decisions CONTROL (parked standby out, removed
        # hosts out) — not thread liveness: a host finishing its trace is
        # not a scale-down, and must not re-open headroom under the max
        capacity = sc.hosts - len(parked) - len(gone)
        dec = monitor.evaluate(tick=clock, hosts_live=capacity)
        if dec is None:
            return
        emit_decision(fleet_ledger, dec)
        self.decisions.append(dec)
        n = dec["target_hosts"] - dec["hosts_from"]
        csup = self._sups.get(sc.consensus_host)
        if dec["direction"] == "up":
            for h in sorted(parked)[:max(n, 0)]:
                # seed a FRESH cursor at the fleet clock: the new host
                # serves from now on (pre-start arrivals were never
                # admitted anywhere) and publishes its tick immediately
                # so the fleet clock never snaps back to zero
                base = self._ledger_path(h)
                with open(base + ".cursor.json", "w") as f:
                    json.dump({"tick": clock, "done": [], "fresh": True}, f)
                with open(base + ".tick", "w") as f:
                    f.write(f"{clock}\n")
                if csup is not None:
                    csup.autoscale_decision = dec["decision"]
                peers[h].register()
                parked.discard(h)
                elastic.add(h)
                start_host(h)
        else:
            cands = sorted((h for h in elastic
                            if h in live and h != sc.consensus_host),
                           reverse=True)
            for h in cands[:max(-n, 0)]:
                if csup is not None:
                    csup.autoscale_decision = dec["decision"]
                peers[h].leave()
                down.add(h)      # the clock must not wait on it
                gone.add(h)      # permanently out: sheds hand off
                elastic.discard(h)
                sup = self._sups.get(h)
                if sup is not None:
                    sup.request_stop()

    def _handoff_step(self, gone: set, handoff_done: set,
                      live: list) -> None:
        """Once a permanently-removed host's drain cursor lands (it
        carries the `shed` descriptors), append them to the lowest
        surviving host's handoff sidecar — the worker re-admits each at
        its scheduled tick under a `readmit` span, so no shed request is
        lost and the request stays one trace across hosts."""
        for h in sorted(gone - handoff_done):
            cursor = self._ledger_path(h) + ".cursor.json"
            try:
                with open(cursor) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            if "shed" not in doc:
                continue        # not drained yet — retry next poll
            handoff_done.add(h)
            shed = [e for e in (doc.get("shed") or ())
                    if isinstance(e, dict) and e.get("rid") is not None]
            survivors = [s for s in live if s != h]
            if not shed or not survivors:
                continue
            dst = self._ledger_path(min(survivors)) + ".handoff.jsonl"
            try:
                with open(dst, "a") as f:
                    for e in shed:
                        f.write(json.dumps({**e, "from_host": h}) + "\n")
            except OSError:
                pass    # the report will show the loss — never crash

    # -- the run ----------------------------------------------------------
    def run(self, timeout_s: Optional[float] = None) -> dict:
        sc = self.sc
        os.makedirs(self.out, exist_ok=True)
        for h in range(sc.hosts):
            os.makedirs(self._host_dir(h), exist_ok=True)
        scenario_path = os.path.join(self.out, "scenario.json")
        with open(scenario_path, "w") as f:
            json.dump(sc.to_doc(), f, indent=1)
        if timeout_s is None:
            # paced trace + a compile/restart allowance per expected launch
            launches = sc.hosts + sum(
                len(p.expected_classes) - 1 for p in self.plans.values())
            timeout_s = sc.wall_estimate_s() * 4 + 90.0 * launches + 120.0

        fleet_ledger = Ledger(os.path.join(self.out, "fleet.jsonl"))
        registry = MetricsRegistry()
        fleet_ledger.add_sink(metrics_ledger_sink(registry))
        fleet_ledger.emit("scenario", name=sc.name, seed=sc.seed,
                          hosts=sc.hosts, ticks=sc.ticks,
                          tick_s=sc.tick_s, consensus_host=sc.consensus_host,
                          events=[dict(ev) for ev in sc.events])

        cdir = os.path.join(self.out, "consensus")
        peers = {h: ConsensusDir(cdir, h, planned=self._planned(),
                                 lease_s=3600.0)
                 for h in range(sc.hosts)}
        parked: set = set(self.standby) if self.policy is not None else set()
        for h, c in peers.items():
            if h not in parked:
                c.register()

        threads: Dict[int, threading.Thread] = {}

        def _start_host(h: int) -> None:
            sup = self._build_supervisor(h, cdir, scenario_path)
            self._sups[h] = sup

            def _run(h=h, sup=sup):
                self.results[h] = sup.run()

            t = threading.Thread(target=_run, name=f"fleet-sup-{h}",
                                 daemon=True)
            threads[h] = t
            t.start()

        for h in range(sc.hosts):
            if h not in parked:
                _start_host(h)

        monitor = (CapacityMonitor(self.policy,
                                   hosts_live=sc.hosts - len(parked))
                   if self.policy is not None else None)
        tailer = LedgerTailer()
        elastic: set = set()        # hosts an up-decision admitted
        gone: set = set()           # hosts a down-decision removed for good
        handoff_done: set = set()
        pending = list(self.actions)
        down: set = set()
        t_start = time.monotonic()
        force_after = t_start + timeout_s * 0.75
        last_fleet_emit = 0.0
        while any(t.is_alive() for t in threads.values()):
            now = time.monotonic()
            if now - t_start > timeout_s:
                for sup in self._sups.values():
                    sup.request_stop()
                break
            # fleet clock: every live gated host must have reached the tick
            live = [h for h, t in threads.items()
                    if t.is_alive() and h not in down]
            clock = min((self._read_tick(h) for h in live), default=None)
            while pending and ((clock is not None
                                and clock >= pending[0].tick)
                               or now > force_after or not live):
                act = pending.pop(0)
                if act.action == "leave":
                    peers[act.host].leave()
                    down.add(act.host)
                elif act.action == "register":
                    peers[act.host].register()
                    down.discard(act.host)
            if monitor is not None and clock is not None:
                self._autoscale_step(monitor, tailer, clock, live, peers,
                                     parked, elastic, gone, down,
                                     fleet_ledger, _start_host)
                self._handoff_step(gone, handoff_done, live)
            if now - last_fleet_emit >= 1.0:
                last_fleet_emit = now
                fleet_ledger.emit("fleet", hosts_live=len(live),
                                  goodput_ratio=None, slo_breaches=None,
                                  final=False, tick=clock)
            time.sleep(0.1)
        for t in threads.values():
            t.join(timeout=max(timeout_s * 0.25, 30.0))

        from tpu_dist_torch.sim.fleet import FleetLedger

        stitched = FleetLedger.discover(self.out)
        report = stitched.report()
        report["supervisors"] = {
            str(h): {"status": getattr(r, "status", "unjoined"),
                     "attempts": [a.failure_class
                                  for a in getattr(r, "attempts", ())]}
            for h, r in sorted(self.results.items())}
        acct = report.get("fleet") or {}
        fleet_ledger.emit("fleet", hosts_live=0,
                          goodput_ratio=acct.get("goodput_ratio"),
                          slo_breaches=report.get("slo_breaches"),
                          final=True)
        fleet_ledger.close()
        with open(os.path.join(self.out, "report.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        # the bench_track-shaped point: fleet.goodput_ratio is the gated
        # number (tools/bench_track.py abstains on pre-fleet history);
        # autoscale_lag_ticks — burst onset to the first up decision —
        # rides along as the lower-is-better reaction-time gate
        burst0 = min((int(ev["tick"]) for ev in sc.events
                      if ev["type"] == "burst"), default=None)
        up0 = next((d["tick"] for d in self.decisions
                    if d["direction"] == "up"), None)
        lag = (up0 - burst0 if burst0 is not None and up0 is not None
               else None)
        with open(os.path.join(self.out, "headline.json"), "w") as f:
            json.dump({"metric": "fleet_sim_goodput",
                       "value": acct.get("goodput_ratio"),
                       "unit": "ratio",
                       "fleet": {"goodput_ratio": acct.get("goodput_ratio"),
                                 "slo_breaches": report.get("slo_breaches"),
                                 "hosts": sc.hosts,
                                 **({"autoscale_lag_ticks": lag,
                                     "autoscale_decisions":
                                         len(self.decisions)}
                                    if self.policy is not None else {})}},
                      f, indent=1)
        return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", required=True,
                    help="scenario JSON/YAML (tpu_dist_torch.sim.scenario)")
    ap.add_argument("--out", required=True, help="fleet output directory")
    ap.add_argument("--timeout-s", type=float, default=0.0,
                    help="wall bound for the whole fleet (0 = derived "
                    "from the schedule)")
    ap.add_argument("--json", action="store_true",
                    help="print the fleet report JSON on stdout")
    ap.add_argument("--device", default="cuda",
                    help="the workers' torch device (default cuda)")
    ap.add_argument("--device-kind", default="",
                    help="the retune's device name (default: the card's "
                    "name on cuda; required elsewhere with autoscaling)")
    args = ap.parse_args(argv)
    sim = FleetSim(args.scenario, args.out, device=args.device,
                   device_kind=args.device_kind or None)
    report = sim.run(timeout_s=args.timeout_s or None)
    if args.json:
        print(json.dumps(report, default=str))
    else:
        acct = report.get("fleet") or {}
        print(f"fleet '{(report.get('scenario') or {}).get('name')}': "
              f"{len(report['hosts'])} host(s), goodput ratio "
              f"{acct.get('goodput_ratio')}, "
              f"{report.get('slo_breaches')} SLO breach(es), "
              f"restart histogram {report.get('restart_histogram')} — "
              f"full report: {os.path.join(args.out, 'report.json')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
