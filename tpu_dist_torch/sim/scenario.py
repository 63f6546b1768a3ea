"""Declarative fleet-scenario schedules + their deterministic compiler
(the port's copy of ``tpu_dist/sim/scenario.py``).

A scenario is one JSON (or YAML, when pyyaml is importable) document that
names everything a fleet run does: how many virtual hosts, how long (in
**ticks** — the scheduler-iteration unit the serve engine and the trace
replay already use, so schedules are machine-speed-independent), what the
traffic looks like (diurnal Poisson arrivals over weighted tenants with
mixed prompt/output lengths), and which operational events hit which host
at which tick (preemption waves, crashes, hangs, slow-host skew, traffic
bursts, host returns).

:func:`compile_host_plans` turns the document into per-host work: the
admitted-request arrival schedule, the ``TPU_DIST_FAULTS`` spec string
(:mod:`tpu_dist_torch.obs.faults` grammar — the injection machinery is
reused, not reinvented), the pacing skew factor, and the fleet-level
consensus actions (``leave``/``register`` — the consensus membership
path). The compile is a pure function of (schedule, seed): same inputs
-> byte-identical arrivals and fault sequences, which is what lets the
tests assert exact event counts and lets a report reader re-derive what a
run *should* have seen.

Stdlib-only by construction (``random.Random`` is a cross-platform-stable
Mersenne twister; no numpy, no torch), with the reference's draw order
kept: the same document and seed compile to the same arrivals, fault
strings, skews, hold-offs, actions and expected restart classes in both
packages.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# operational event types a schedule may carry
EVENT_TYPES = ("preempt", "crash", "hang", "slow_host", "burst")

# rid namespace stride: request ids are unique fleet-wide by construction
# (host h's rids live in [h * stride, (h+1) * stride))
RID_STRIDE = 1_000_000


@dataclass(frozen=True)
class Tenant:
    """One traffic class: relative weight + prompt/output length ranges."""

    name: str
    weight: float = 1.0
    prompt: Tuple[int, int] = (4, 8)     # inclusive token-length range
    out: Tuple[int, int] = (2, 6)


@dataclass(frozen=True)
class Arrival:
    """One admitted request of the compiled schedule."""

    tick: int
    rid: int
    tenant: str
    prompt_len: int
    out_len: int


@dataclass(frozen=True)
class FleetAction:
    """One consensus-membership action the runner executes when the fleet
    clock (min live-host tick) reaches ``tick``."""

    tick: int
    action: str        # "leave" | "register"
    host: int


@dataclass
class HostPlan:
    """Everything one virtual host needs: its arrivals, its fault spec,
    its pacing skew, and (for preempted-with-return hosts) the restart
    hold-off that keeps it genuinely absent until its return tick."""

    host: int
    arrivals: List[Arrival] = field(default_factory=list)
    faults: str = ""
    skew: float = 1.0
    restart_holdoff_ticks: int = 0
    expected_classes: List[str] = field(default_factory=list)


@dataclass
class Scenario:
    """The parsed schedule (see module docstring for the grammar tour)."""

    name: str
    seed: int
    hosts: int
    ticks: int
    tick_s: float = 0.02
    consensus_host: int = 0
    model: Dict = field(default_factory=dict)
    serve: Dict = field(default_factory=dict)
    worker_devices: int = 1
    # traffic
    base_rate: float = 0.1       # mean arrivals/tick/host at the diurnal mean
    amplitude: float = 0.0       # diurnal swing as a fraction of base_rate
    period: int = 0              # diurnal period in ticks (0 = flat)
    phase: float = 0.0           # fraction of a period
    tenants: List[Tenant] = field(default_factory=list)
    events: List[Dict] = field(default_factory=list)
    # autoscaling (round 20, obs.autoscale): {"policy": <path or inline
    # policy doc>, "standby_hosts": [host, ...]} — standby hosts start
    # PARKED (no worker, not registered) and join only when a scale-up
    # decision admits them; None = fixed capacity (every host live)
    autoscale: Optional[Dict] = None

    def standby_hosts(self) -> List[int]:
        return sorted(int(h) for h in
                      ((self.autoscale or {}).get("standby_hosts") or ()))

    def rate(self, tick: int, host: int) -> float:
        """Mean arrivals for (tick, host): the diurnal curve plus any
        burst events covering this tick. Clamped at zero (a deep diurnal
        trough is an idle fleet, not a negative one)."""
        r = self.base_rate
        if self.period > 0 and self.amplitude:
            r *= 1.0 + self.amplitude * math.sin(
                2.0 * math.pi * (tick / self.period + self.phase))
        for ev in self.events:
            if ev["type"] != "burst":
                continue
            if ev.get("hosts") is not None and host not in ev["hosts"]:
                continue
            if ev["tick"] <= tick < ev["tick"] + ev.get("ticks", 1):
                r += ev.get("rate", 0.0)
        return max(r, 0.0)

    def to_doc(self) -> Dict:
        """The JSON-able document form (round-trips through
        :func:`parse_scenario`): the runner re-writes the scenario beside
        its outputs so a fleet directory is self-contained."""
        return {
            "name": self.name, "seed": self.seed, "hosts": self.hosts,
            "ticks": self.ticks, "tick_s": self.tick_s,
            "consensus_host": self.consensus_host,
            "worker_devices": self.worker_devices,
            "model": dict(self.model), "serve": dict(self.serve),
            "traffic": {
                "base_rate": self.base_rate, "amplitude": self.amplitude,
                "period": self.period, "phase": self.phase,
                "tenants": [{"name": t.name, "weight": t.weight,
                             "prompt": list(t.prompt), "out": list(t.out)}
                            for t in self.tenants]},
            "events": [dict(ev) for ev in self.events],
            **({"autoscale": dict(self.autoscale)}
               if self.autoscale is not None else {})}

    def wall_estimate_s(self) -> float:
        """Lower-bound wall estimate of one host's paced trace (runner
        timeouts scale this up; compiles and restarts come on top)."""
        max_skew = max([1.0] + [ev.get("factor", 1.0) for ev in self.events
                                if ev["type"] == "slow_host"])
        return self.ticks * self.tick_s * max_skew


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"scenario: {msg}")


def parse_scenario(doc: Dict) -> Scenario:
    """Validate + build a :class:`Scenario` from a parsed document."""
    _require(isinstance(doc, dict), "document must be a JSON/YAML mapping")
    for key in ("name", "seed", "hosts", "ticks"):
        _require(key in doc, f"missing required key {key!r}")
    traffic = doc.get("traffic") or {}
    tenants = []
    for t in traffic.get("tenants", [{"name": "default"}]):
        _require(isinstance(t, dict) and t.get("name"),
                 f"tenant entries need a name ({t!r})")
        prompt = tuple(t.get("prompt", (4, 8)))
        out = tuple(t.get("out", (2, 6)))
        _require(len(prompt) == 2 and 1 <= prompt[0] <= prompt[1],
                 f"tenant {t['name']!r}: prompt range must be [lo, hi], "
                 f"lo >= 1 (got {prompt})")
        _require(len(out) == 2 and 1 <= out[0] <= out[1],
                 f"tenant {t['name']!r}: out range must be [lo, hi], "
                 f"lo >= 1 (got {out})")
        _require(float(t.get("weight", 1.0)) > 0,
                 f"tenant {t['name']!r}: weight must be > 0")
        tenants.append(Tenant(name=str(t["name"]),
                              weight=float(t.get("weight", 1.0)),
                              prompt=(int(prompt[0]), int(prompt[1])),
                              out=(int(out[0]), int(out[1]))))
    sc = Scenario(
        name=str(doc["name"]), seed=int(doc["seed"]),
        hosts=int(doc["hosts"]), ticks=int(doc["ticks"]),
        tick_s=float(doc.get("tick_s", 0.02)),
        consensus_host=int(doc.get("consensus_host", 0)),
        model=dict(doc.get("model") or {}),
        serve=dict(doc.get("serve") or {}),
        worker_devices=int(doc.get("worker_devices", 1)),
        base_rate=float(traffic.get("base_rate", 0.1)),
        amplitude=float(traffic.get("amplitude", 0.0)),
        period=int(traffic.get("period", 0)),
        phase=float(traffic.get("phase", 0.0)),
        tenants=tenants,
        events=[dict(ev) for ev in doc.get("events", [])],
        autoscale=(dict(doc["autoscale"])
                   if doc.get("autoscale") is not None else None))
    _require(sc.hosts >= 1, "hosts must be >= 1")
    _require(sc.ticks >= 1, "ticks must be >= 1")
    _require(sc.tick_s > 0, "tick_s must be > 0")
    _require(0 <= sc.consensus_host < sc.hosts,
             f"consensus_host {sc.consensus_host} out of range")
    max_total = (max(t.prompt[1] + t.out[1] for t in sc.tenants)
                 if sc.tenants else 0)
    model_max = int(sc.model.get("max_len", 64))
    _require(max_total <= model_max,
             f"longest tenant request ({max_total} tokens) exceeds "
             f"model max_len ({model_max})")
    for ev in sc.events:
        _require(isinstance(ev, dict) and ev.get("type") in EVENT_TYPES,
                 f"unknown event type in {ev!r} (types: {EVENT_TYPES})")
        kind = ev["type"]
        if kind in ("preempt", "crash", "hang", "burst"):
            _require(0 <= int(ev.get("tick", -1)) < sc.ticks,
                     f"{kind} event needs a tick inside [0, {sc.ticks})")
        if kind in ("preempt", "crash", "hang"):
            hosts = ev.get("hosts")
            _require(isinstance(hosts, list) and hosts
                     and all(0 <= int(h) < sc.hosts for h in hosts),
                     f"{kind} event needs a non-empty in-range hosts list")
            _require(sc.consensus_host not in hosts,
                     f"{kind} event may not target the consensus host "
                     f"{sc.consensus_host} (it anchors membership)")
        if kind == "preempt" and ev.get("return_tick") is not None:
            _require(int(ev["tick"]) < int(ev["return_tick"]) <= sc.ticks,
                     "preempt return_tick must lie in (tick, ticks]")
        if kind == "slow_host":
            _require(0 <= int(ev.get("host", -1)) < sc.hosts,
                     "slow_host event needs an in-range host")
            _require(float(ev.get("factor", 0)) >= 1.0,
                     "slow_host factor must be >= 1.0")
    if sc.autoscale is not None:
        _require(isinstance(sc.autoscale, dict),
                 "autoscale must be a mapping")
        pol = sc.autoscale.get("policy")
        _require(isinstance(pol, (str, dict)) and pol,
                 "autoscale needs a 'policy' (path or inline document)")
        standby = sc.standby_hosts()
        _require(all(0 <= h < sc.hosts for h in standby),
                 f"autoscale standby_hosts out of range {standby}")
        _require(sc.consensus_host not in standby,
                 f"consensus host {sc.consensus_host} cannot be standby "
                 "(it anchors membership)")
        _require(len(set(standby)) == len(standby),
                 f"duplicate autoscale standby_hosts {standby}")
    return sc


def load_scenario(path: str) -> Scenario:
    """Parse a scenario file: JSON always; ``.yaml``/``.yml`` when pyyaml
    is importable (it is an optional nicety, never a dependency)."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError as e:
            raise ValueError(
                f"{path}: YAML scenario but pyyaml is not installed — "
                "use the JSON form") from e
        doc = yaml.safe_load(text)
    else:
        doc = json.loads(text)
    return parse_scenario(doc)


def _host_rng(seed: int, host: int) -> random.Random:
    """Per-host substream: decorrelated across hosts, reproducible across
    runs/platforms (``random.Random`` core draws are version-stable)."""
    return random.Random(seed * 1_000_003 + host)


def _poisson(rng: random.Random, lam: float) -> int:
    """Knuth's Poisson sampler — exact for the small per-tick rates a
    scenario uses, stdlib-only."""
    if lam <= 0:
        return 0
    limit = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1


def _pick_tenant(rng: random.Random, tenants: List[Tenant]) -> Tenant:
    total = sum(t.weight for t in tenants)
    x = rng.random() * total
    for t in tenants:
        x -= t.weight
        if x <= 0:
            return t
    return tenants[-1]


def compile_host_plans(sc: Scenario) -> Tuple[Dict[int, HostPlan],
                                              List[FleetAction]]:
    """The deterministic compile: ``(schedule, seed) -> ({host: HostPlan},
    fleet consensus actions)``.

    Arrivals: one per-host Poisson stream over :meth:`Scenario.rate`, each
    arrival assigned a weighted tenant and per-request prompt/output
    lengths from the same substream. Faults: scenario events become
    :mod:`tpu_dist_torch.obs.faults` spec entries (``preempt`` ->
    ``preempt_sigterm@step=T``, ``crash`` -> ``hard_exit@step=T``,
    ``hang`` -> ``hang@step=T,secs=S``), each gated on the attempt the
    restart chain puts it at: a host's k-th disruption can only fire on
    attempt k (every earlier disruption consumed one restart), so a
    restarted worker neither re-fires an old wave nor starves a later
    one behind an ``attempt=0`` gate it can no longer satisfy. Fleet
    actions: a ``preempt`` with a ``return_tick`` emits the consensus
    ``leave`` / ``register`` pair the runner drives through the consensus
    membership path.

    ``expected_classes`` per host is the schedule's own prediction of
    the FLEET REPORT's restart classification (record-mode
    ``classify_attempt`` — tests assert the report matches it EXACTLY):
    every event on a host contributes its class in tick order, the
    consensus host contributes one ``preemption_snapshotted`` per
    membership change (the mid-attempt rescale relaunch), and every host
    ends ``clean``. A ``hang`` predicts ``crash``, not ``stall``: the
    serve worker runs no watchdog (its ledger tail is the liveness
    signal), so the SIGKILLed attempt leaves neither a ``run_end`` nor a
    ``stall`` event and record-mode classification reads ``crash`` — the
    supervisor's own live-side result (which saw the kill) still says
    ``stall``.
    """
    tenants = sc.tenants or [Tenant(name="default")]
    plans = {h: HostPlan(host=h) for h in range(sc.hosts)}
    for h in range(sc.hosts):
        rng = _host_rng(sc.seed, h)
        seq = 0
        for tick in range(sc.ticks):
            for _ in range(_poisson(rng, sc.rate(tick, h))):
                t = _pick_tenant(rng, tenants)
                plans[h].arrivals.append(Arrival(
                    tick=tick, rid=h * RID_STRIDE + seq, tenant=t.name,
                    prompt_len=rng.randint(*t.prompt),
                    out_len=rng.randint(*t.out)))
                seq += 1

    actions: List[FleetAction] = []
    fault_entries: Dict[int, List[str]] = {h: [] for h in range(sc.hosts)}
    disruptions: Dict[int, List[Tuple[int, str]]] = \
        {h: [] for h in range(sc.hosts)}   # (tick, class) per host
    membership_ticks: List[int] = []
    for ev in sorted(sc.events, key=lambda e: int(e.get("tick", 0))):
        kind = ev["type"]
        if kind == "slow_host":
            plans[int(ev["host"])].skew = float(ev.get("factor", 1.0))
            continue
        if kind == "burst":
            continue  # folded into rate()
        tick = int(ev["tick"])
        for h in (int(x) for x in ev["hosts"]):
            # this host's k-th disruption lands on attempt k (each prior
            # disruption ended one attempt and started the next)
            att = len(disruptions[h])
            if kind == "preempt":
                fault_entries[h].append(
                    f"preempt_sigterm@step={tick},attempt={att}")
                disruptions[h].append((tick, "preemption_snapshotted"))
                if ev.get("return_tick") is not None:
                    ret = int(ev["return_tick"])
                    actions.append(FleetAction(tick, "leave", h))
                    actions.append(FleetAction(ret, "register", h))
                    membership_ticks += [tick, ret]
                    plans[h].restart_holdoff_ticks = max(
                        plans[h].restart_holdoff_ticks, ret - tick)
            elif kind == "crash":
                fault_entries[h].append(
                    f"hard_exit@step={tick},attempt={att}")
                disruptions[h].append((tick, "crash"))
            elif kind == "hang":
                secs = float(ev.get("secs", 3600.0))
                fault_entries[h].append(
                    f"hang@step={tick},attempt={att},secs={secs:g}")
                # record-mode class (see docstring): SIGKILL leaves no
                # run_end and no stall event -> the report reads "crash"
                disruptions[h].append((tick, "crash"))
    for tick in sorted(membership_ticks):
        disruptions[sc.consensus_host].append(
            (tick, "preemption_snapshotted"))
    for h, plan in plans.items():
        plan.faults = ";".join(fault_entries[h])
        plan.expected_classes = [cls for _, cls in
                                 sorted(disruptions[h],
                                        key=lambda tc: tc[0])] + ["clean"]
    actions.sort(key=lambda a: (a.tick, a.host))
    return plans, actions


def expected_restart_classes(sc: Scenario) -> Dict[int, List[str]]:
    """Schedule -> the exact per-host attempt classification the fleet
    report must show (the acceptance contract)."""
    plans, _ = compile_host_plans(sc)
    return {h: plan.expected_classes for h, plan in plans.items()}
