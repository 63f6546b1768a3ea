"""Autoscaler for the port (``tpu_dist/obs/autoscale.py``): the
observability plane drives capacity, auditable.

The port's own copy of the reference module (stdlib only, the same
signals, validation messages, decision dicts and replay), so the same
ledger records under the same policy give byte-identical decisions in
both packages:

* :class:`AutoscalePolicy` — a declarative JSON policy (min/max hosts,
  per-direction step size + cooldown, up-trip thresholds, down-side
  hysteresis). ``scripts/autoscale_policy.json`` is the checked-in
  exemplar.
* :class:`CapacityMonitor` — a ledger sink/tail-follower maintaining the
  rolling capacity signals (SLO-breach window, queue-wait and queue-depth
  EMAs, free-page watermark, fleet goodput ratio, step-time changepoint)
  and, under the policy, producing ``scale_decision`` records with FULL
  attribution: which signal tripped, its value vs threshold, the window,
  and the newest flight-recorder bundle reference — "why did we scale"
  is answerable from the ledger alone.
* :func:`replay_decisions` — the pure replay: ``(records, policy) ->
  decisions``, byte-deterministic (no wall clock, no randomness; the
  replay clock is the ``tick`` extra on ``fleet`` heartbeats).
* :class:`LedgerTailer` — the incremental multi-file reader the fleet
  runner uses to feed live host ledgers into the monitor (complete lines
  only; torn trailing lines are held back, the `_LedgerTail` contract).

The CONSUMPTION side lives where capacity already lives: the fleet
runner (:mod:`tpu_dist_torch.sim.runner`) executes decisions as consensus
``register``/``leave`` membership changes, the supervisor
(:mod:`tpu_dist_torch.parallel.supervisor`) turns the epoch bump into the
shrink/expand rescale it already owns — stamping the pending decision id
onto its ``scale`` event — and re-runs
:func:`tpu_dist_torch.plan.tune.tune` at the new world size, recording
the fresh ``plan_hash`` in the decision's ``applied`` follow-up event.
Every scale ACTION therefore pairs 1:1 with a decision that explains it.
"""

from __future__ import annotations

import json
import os
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# Canonical signal evaluation order: attribution must be deterministic,
# so the FIRST tripped signal in this order names the decision. Each
# entry is (name, trip-sense): "high" trips at value >= threshold
# (pressure signals), "low" at value <= threshold (depletion signals).
SIGNALS = (
    ("slo_breaches_window", "high"),   # slo events within window_ticks
    ("queue_wait_ema_s", "high"),      # EMA of request.queue_wait_s
    ("queue_depth_ema", "high"),       # EMA of admit.queue_depth
    ("free_page_frac", "low"),         # kv_cache free/(free+used) watermark
    ("goodput_ratio", "low"),          # last goodput/fleet ratio
    ("step_time_ratio", "high"),       # short-EMA/long-EMA step-wall change
)
SIGNAL_SENSE = dict(SIGNALS)
SIGNAL_NAMES = tuple(name for name, _ in SIGNALS)

# the attribution name of a hysteresis-triggered scale-down: the "signal"
# is sustained calm itself (value = calm ticks, threshold = stable_ticks)
CALM_SIGNAL = "calm_ticks"


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"autoscale policy: {msg}")


@dataclass(frozen=True)
class DirectionPolicy:
    """One direction's knobs: how far to step, how long to hold off
    after ANY decision (cooldown), and — scale-down only — how long
    every down signal must stay calm first (hysteresis)."""

    step: int = 1
    cooldown_ticks: int = 0
    stable_ticks: int = 0                      # down-side hysteresis
    signals: Dict[str, float] = field(default_factory=dict)


@dataclass(frozen=True)
class AutoscalePolicy:
    """The declarative policy (pure data). ``up.signals`` are TRIP
    thresholds (any one trips a scale-up); ``down.signals`` are CALM
    thresholds (all must hold
    strictly inside their calm side for ``down.stable_ticks`` straight
    evaluations, with zero SLO breaches in the window, before a
    scale-down fires)."""

    min_hosts: int
    max_hosts: int
    up: DirectionPolicy
    down: DirectionPolicy
    window_ticks: int = 16        # the slo-breach counting window
    ema_alpha: float = 0.25       # queue wait/depth EMA smoothing

    @classmethod
    def from_doc(cls, doc: Dict) -> "AutoscalePolicy":
        _require(isinstance(doc, dict), "document must be a JSON mapping")
        for key in ("min_hosts", "max_hosts", "up"):
            _require(key in doc, f"missing required key {key!r}")
        dirs = {}
        for direction in ("up", "down"):
            d = doc.get(direction) or {}
            _require(isinstance(d, dict),
                     f"{direction!r} must be a mapping")
            sigs = d.get("signals") or {}
            for name, thr in sigs.items():
                _require(name in SIGNAL_NAMES,
                         f"unknown signal {name!r} (signals: "
                         f"{list(SIGNAL_NAMES)})")
                _require(isinstance(thr, (int, float)),
                         f"signal {name!r}: threshold must be a number")
            dirs[direction] = DirectionPolicy(
                step=int(d.get("step", 1)),
                cooldown_ticks=int(d.get("cooldown_ticks", 0)),
                stable_ticks=int(d.get("stable_ticks", 0)),
                signals={str(k): float(v) for k, v in sigs.items()})
            _require(dirs[direction].step >= 1,
                     f"{direction}.step must be >= 1")
            _require(dirs[direction].cooldown_ticks >= 0,
                     f"{direction}.cooldown_ticks must be >= 0")
        pol = cls(min_hosts=int(doc["min_hosts"]),
                  max_hosts=int(doc["max_hosts"]),
                  up=dirs["up"], down=dirs["down"],
                  window_ticks=int(doc.get("window_ticks", 16)),
                  ema_alpha=float(doc.get("ema_alpha", 0.25)))
        _require(pol.min_hosts >= 1, "min_hosts must be >= 1")
        _require(pol.max_hosts >= pol.min_hosts,
                 "max_hosts must be >= min_hosts")
        _require(pol.window_ticks >= 1, "window_ticks must be >= 1")
        _require(0.0 < pol.ema_alpha <= 1.0,
                 "ema_alpha must be in (0, 1]")
        _require(bool(pol.up.signals),
                 "up.signals must name at least one trip threshold")
        _require(not pol.down.signals or pol.down.stable_ticks >= 1,
                 "down.signals without down.stable_ticks >= 1 would "
                 "flap — hysteresis is required for scale-down")
        return pol

    @classmethod
    def load(cls, path: str) -> "AutoscalePolicy":
        with open(path) as f:
            return cls.from_doc(json.load(f))

    def to_doc(self) -> Dict:
        return {
            "min_hosts": self.min_hosts, "max_hosts": self.max_hosts,
            "window_ticks": self.window_ticks, "ema_alpha": self.ema_alpha,
            "up": {"step": self.up.step,
                   "cooldown_ticks": self.up.cooldown_ticks,
                   "signals": dict(self.up.signals)},
            "down": {"step": self.down.step,
                     "cooldown_ticks": self.down.cooldown_ticks,
                     "stable_ticks": self.down.stable_ticks,
                     "signals": dict(self.down.signals)}}


class CapacityMonitor:
    """Fold ledger records into rolling capacity signals; evaluate the
    policy into ``scale_decision`` dicts.

    Deterministic BY CONSTRUCTION: no wall clock, no randomness — time is
    the tick the caller passes to :meth:`evaluate` (the fleet runner's
    fleet clock) or, in replay, the ``tick`` extra on ``fleet`` heartbeat
    records. Decision ids are a plain sequence (``d0``, ``d1``, ...), so
    the same records under the same policy always produce byte-identical
    decisions — the property the replay tests pin.
    """

    def __init__(self, policy: AutoscalePolicy, hosts_live: int):
        self.policy = policy
        self.hosts = int(hosts_live)    # current target capacity
        self.tick = 0
        self.decisions: List[dict] = []
        self._seq = 0
        self._queue_wait_ema: Optional[float] = None
        self._queue_depth_ema: Optional[float] = None
        self._free_frac: Optional[float] = None
        self._goodput_ratio: Optional[float] = None
        self._step_short: Optional[float] = None
        self._step_long: Optional[float] = None
        self._slo_ticks: deque = deque()
        self._last_bundle: Optional[str] = None
        self._last_decision_tick: Optional[int] = None
        self._calm_since: Optional[int] = None

    # -- signal folding ---------------------------------------------------
    def _ema(self, prev: Optional[float], x: float) -> float:
        a = self.policy.ema_alpha
        return x if prev is None else prev + a * (x - prev)

    def observe(self, rec: dict) -> None:
        """Fold one ledger record (any host's stream; order within a tick
        is immaterial — signals are EMAs/windows, not sequences)."""
        ev = rec.get("event")
        if ev == "fleet":
            t = rec.get("tick")
            if t is not None:
                self.tick = max(self.tick, int(t))
            if rec.get("goodput_ratio") is not None:
                self._goodput_ratio = float(rec["goodput_ratio"])
        elif ev == "request":
            if rec.get("queue_wait_s") is not None:
                self._queue_wait_ema = self._ema(
                    self._queue_wait_ema, float(rec["queue_wait_s"]))
        elif ev == "admit":
            if rec.get("queue_depth") is not None:
                self._queue_depth_ema = self._ema(
                    self._queue_depth_ema, float(rec["queue_depth"]))
        elif ev == "kv_cache":
            free = rec.get("pages_free")
            used = rec.get("pages_used")
            if free is not None and used is not None and free + used > 0:
                self._free_frac = free / float(free + used)
        elif ev == "slo":
            self._slo_ticks.append(self.tick)
        elif ev == "goodput":
            if rec.get("ratio") is not None:
                self._goodput_ratio = float(rec["ratio"])
        elif ev == "step":
            wall = sum(rec.get(k) or 0.0
                       for k in ("data_s", "dispatch_s", "device_s"))
            n = rec.get("steps_in_dispatch") or 1
            if wall > 0 and n:
                per = wall / n
                # changepoint pair: a fast EMA over a slow one — a
                # sustained step-time regression pushes the ratio > 1
                self._step_short = (per if self._step_short is None else
                                    self._step_short + 0.5 *
                                    (per - self._step_short))
                self._step_long = (per if self._step_long is None else
                                   self._step_long + 0.05 *
                                   (per - self._step_long))
        elif ev == "diagnosis":
            if rec.get("bundle"):
                self._last_bundle = str(rec["bundle"])

    def signal_value(self, name: str) -> Optional[float]:
        """The current value of one named signal (None until its feeding
        events have been observed — an unobserved signal never trips)."""
        if name == "queue_wait_ema_s":
            return self._queue_wait_ema
        if name == "queue_depth_ema":
            return self._queue_depth_ema
        if name == "free_page_frac":
            return self._free_frac
        if name == "goodput_ratio":
            return self._goodput_ratio
        if name == "slo_breaches_window":
            lo = self.tick - self.policy.window_ticks
            while self._slo_ticks and self._slo_ticks[0] < lo:
                self._slo_ticks.popleft()
            return float(len(self._slo_ticks))
        if name == "step_time_ratio":
            if self._step_short is None or not self._step_long:
                return None
            return self._step_short / self._step_long
        raise ValueError(f"unknown autoscale signal {name!r}")

    # -- policy evaluation ------------------------------------------------
    def _cooldown_ok(self, direction: DirectionPolicy) -> bool:
        return (self._last_decision_tick is None
                or self.tick - self._last_decision_tick
                >= direction.cooldown_ticks)

    def _decide(self, direction: str, target: int, signal: str,
                value: float, threshold: float) -> dict:
        dec = {"decision": f"d{self._seq}", "direction": direction,
               "hosts_from": self.hosts, "target_hosts": target,
               "signal": signal, "value": round(float(value), 6),
               "threshold": threshold,
               "window_ticks": self.policy.window_ticks,
               "tick": self.tick, "bundle": self._last_bundle}
        self._seq += 1
        self.hosts = target
        self._last_decision_tick = self.tick
        self._calm_since = None
        self.decisions.append(dec)
        return dec

    def evaluate(self, tick: Optional[int] = None,
                 hosts_live: Optional[int] = None) -> Optional[dict]:
        """One policy evaluation at ``tick`` (defaults to the replay
        clock) against ``hosts_live`` (defaults to the monitor's own
        simulated capacity). Returns the decision dict, or None."""
        pol = self.policy
        if tick is not None:
            self.tick = max(self.tick, int(tick))
        if hosts_live is not None:
            self.hosts = int(hosts_live)
        # scale-UP: first configured tripped signal in canonical order
        for name in SIGNAL_NAMES:
            thr = pol.up.signals.get(name)
            if thr is None:
                continue
            v = self.signal_value(name)
            if v is None:
                continue
            tripped = (v >= thr if SIGNAL_SENSE[name] == "high"
                       else v <= thr)
            if tripped:
                if self.hosts < pol.max_hosts and self._cooldown_ok(pol.up):
                    target = min(self.hosts + pol.up.step, pol.max_hosts)
                    return self._decide("up", target, name, v, thr)
                # pressure exists: a calm streak must not accrue under it
                self._calm_since = None
                return None
        # scale-DOWN: every calm threshold held + zero breaches in window,
        # sustained for stable_ticks straight evaluations (hysteresis)
        if not pol.down.signals:
            return None
        calm = self.signal_value("slo_breaches_window") == 0.0
        for name, thr in pol.down.signals.items():
            v = self.signal_value(name)
            if v is None or not (v < thr if SIGNAL_SENSE[name] == "high"
                                 else v > thr):
                calm = False
                break
        if not calm:
            self._calm_since = None
            return None
        if self._calm_since is None:
            self._calm_since = self.tick
        held = self.tick - self._calm_since
        if (held >= pol.down.stable_ticks and self.hosts > pol.min_hosts
                and self._cooldown_ok(pol.down)):
            target = max(self.hosts - pol.down.step, pol.min_hosts)
            return self._decide("down", target, CALM_SIGNAL,
                                float(held), float(pol.down.stable_ticks))
        return None


def emit_decision(ledger, dec: dict) -> dict:
    """Write one decision as its ``scale_decision`` ledger event (the
    explicit-keyword emit site DL006 verifies against the schema)."""
    return ledger.emit(
        "scale_decision", decision=dec["decision"],
        direction=dec["direction"], hosts_from=dec["hosts_from"],
        target_hosts=dec["target_hosts"], signal=dec["signal"],
        value=dec["value"], threshold=dec["threshold"],
        window_ticks=dec["window_ticks"], bundle=dec["bundle"],
        tick=dec.get("tick"))


def replay_decisions(records: List[dict], policy: AutoscalePolicy,
                     hosts0: int) -> List[dict]:
    """The pure replay: fold ``records`` in order, evaluating the policy
    at every ``fleet`` heartbeat that carries a ``tick`` extra (the
    canned-fixture clock). Capacity evolves from ``hosts0`` by the
    decisions themselves — same records + same policy -> byte-identical
    decision list, which is what makes the CI gate meaningful."""
    mon = CapacityMonitor(policy, hosts_live=hosts0)
    for rec in records:
        mon.observe(rec)
        if rec.get("event") == "fleet" and rec.get("tick") is not None:
            mon.evaluate()
    return list(mon.decisions)


class LedgerTailer:
    """Incremental reader over a GROWING set of JSONL ledger files: each
    :meth:`poll` returns the new complete records across every path, in
    path order (live feeding is not byte-ordered across hosts and does
    not need to be — the monitor's signals are EMAs and windows). Torn
    trailing lines are held back until their newline lands, the
    ``supervisor._LedgerTail`` contract; corrupt lines are skipped."""

    def __init__(self) -> None:
        self._offsets: Dict[str, int] = {}
        self._partials: Dict[str, bytes] = {}

    def poll(self, paths: List[str]) -> List[dict]:
        out: List[dict] = []
        for path in paths:
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            offset = self._offsets.get(path, 0)
            if size <= offset:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read(size - offset)
            except OSError:
                continue
            self._offsets[path] = size
            data = self._partials.get(path, b"") + chunk
            lines = data.split(b"\n")
            self._partials[path] = lines.pop()
            for line in lines:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue    # torn mid-crash line: skip, not truth
                if isinstance(rec, dict):
                    out.append(rec)
        return out
