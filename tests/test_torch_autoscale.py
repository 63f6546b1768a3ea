"""The port's autoscaler (``tpu_dist_torch/obs/autoscale.py``) against the
JAX package's (``tpu_dist/obs/autoscale.py``):

* the policy grammar refuses the same documents with the same messages,
  and the checked-in ``scripts/autoscale_policy.json`` loads to the same
  ``to_doc``;
* ``replay_decisions`` over the reference's canned fixture
  (``tests/fixtures/autoscale/ledger.jsonl``) is byte-equal to the
  reference's, with the reference's pins, and so is a live
  ``CapacityMonitor`` fed the same record sequences;
* ``LedgerTailer`` holds torn lines back and skips corrupt ones;
* the ``tpu_dist_autoscale_*`` Prometheus series appear and move, the
  ``scale_decision``/``applied`` events round-trip the port's ledger
  schema, and the fleet stitcher's decision join matches the
  reference's."""

import json
import os

import pytest
import torch

torch.set_num_threads(1)
pytest.importorskip("jax")

from tpu_dist.obs import autoscale as ref_auto  # noqa: E402
from tpu_dist.sim import fleet as ref_fleet  # noqa: E402

from tpu_dist_torch.obs import autoscale as auto  # noqa: E402
from tpu_dist_torch.obs.ledger import Ledger, read_ledger  # noqa: E402
from tpu_dist_torch.obs.metrics import (MetricsRegistry,  # noqa: E402
                                        metrics_ledger_sink)
from tpu_dist_torch.sim import fleet  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = os.path.join(ROOT, "scripts", "autoscale_policy.json")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "autoscale",
                       "ledger.jsonl")


def _policy_doc(**over):
    doc = {"min_hosts": 1, "max_hosts": 3,
           "up": {"step": 1, "cooldown_ticks": 4,
                  "signals": {"queue_wait_ema_s": 0.1}},
           "down": {"step": 1, "cooldown_ticks": 4, "stable_ticks": 2,
                    "signals": {"queue_wait_ema_s": 0.05}}}
    doc.update(over)
    return doc


BAD = {
    "missing_key": {"max_hosts": 2},
    "not_mapping": [1],
    "unknown_signal": _policy_doc(up={"signals": {"vibes": 1.0}}),
    "threshold_type": _policy_doc(up={"signals": {"queue_wait_ema_s": "x"}}),
    "direction_type": _policy_doc(down=[1]),
    "step": _policy_doc(up={"step": 0,
                            "signals": {"queue_wait_ema_s": 0.1}}),
    "cooldown": _policy_doc(up={"cooldown_ticks": -1,
                                "signals": {"queue_wait_ema_s": 0.1}}),
    "min_hosts": _policy_doc(min_hosts=0),
    "max_hosts": _policy_doc(min_hosts=5),
    "window": _policy_doc(window_ticks=0),
    "ema_alpha": _policy_doc(ema_alpha=0.0),
    "no_trip": _policy_doc(up={"signals": {}}),
    "hysteresis": _policy_doc(down={"signals": {"queue_wait_ema_s": 0.05}}),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_policy_refusals_match_the_reference(name):
    with pytest.raises(ValueError) as want:
        ref_auto.AutoscalePolicy.from_doc(BAD[name])
    with pytest.raises(ValueError) as got:
        auto.AutoscalePolicy.from_doc(BAD[name])
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("autoscale policy: ")


def test_policy_and_constants_match_the_reference():
    pol = auto.AutoscalePolicy.load(POLICY)
    assert pol.to_doc() == ref_auto.AutoscalePolicy.load(POLICY).to_doc()
    assert auto.AutoscalePolicy.from_doc(pol.to_doc()).to_doc() == \
        pol.to_doc()
    assert pol.min_hosts == 2 and pol.max_hosts == 3
    for name, calm in pol.down.signals.items():
        trip = pol.up.signals.get(name)
        if trip is not None:
            assert trip > calm, (name, trip, calm)
    assert (auto.SIGNALS, auto.CALM_SIGNAL) == \
        (ref_auto.SIGNALS, ref_auto.CALM_SIGNAL)


def _fixture_records():
    with open(FIXTURE) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("hosts0", [1, 2, 3])
def test_replay_fixture_is_byte_equal_to_the_reference(hosts0):
    records = _fixture_records()
    got = auto.replay_decisions(records, auto.AutoscalePolicy.load(POLICY),
                                hosts0=hosts0)
    want = ref_auto.replay_decisions(
        records, ref_auto.AutoscalePolicy.load(POLICY), hosts0=hosts0)
    assert json.dumps(got) == json.dumps(want)
    again = auto.replay_decisions(records,
                                  auto.AutoscalePolicy.load(POLICY),
                                  hosts0=hosts0)
    assert json.dumps(got) == json.dumps(again)
    if hosts0 == 2:    # the reference's pins
        assert [(d["decision"], d["direction"], d["signal"])
                for d in got] == [("d0", "up", "slo_breaches_window"),
                                  ("d1", "down", auto.CALM_SIGNAL)]
        assert got[0]["tick"] == 14 and got[1]["tick"] == 64


def _sequence(kind):
    """Hand-made record streams with a replay clock on every fleet line."""
    recs = []
    for t in range(120):
        recs.append({"event": "fleet", "tick": t, "goodput_ratio": None})
        if kind == "queue" and 20 <= t < 40:
            recs.append({"event": "admit", "queue_depth": 9 + t % 3})
            recs.append({"event": "request", "queue_wait_s": 0.2})
        elif kind == "pages" and t % 5 == 0:
            recs.append({"event": "kv_cache", "pages_free": max(40 - t, 1),
                         "pages_used": min(8 + t, 47)})
        elif kind == "steps":
            recs.append({"event": "step", "data_s": 0.0, "dispatch_s": 0.01,
                         "device_s": 0.1 if t < 60 else 0.4,
                         "steps_in_dispatch": 1})
        elif kind == "slo" and t in (10, 11, 12, 70):
            recs.append({"event": "slo", "kind": "queue_wait"})
            recs.append({"event": "diagnosis", "bundle": f"b{t}"})
        if t % 7 == 0:
            recs.append({"event": "request", "queue_wait_s": 0.0})
            recs.append({"event": "admit", "queue_depth": 0})
        if t % 30 == 0:
            recs.append({"event": "goodput", "ratio": 0.2 + t / 300})
    return recs


SEQ_POLICY = {
    "min_hosts": 1, "max_hosts": 4, "window_ticks": 8, "ema_alpha": 0.5,
    "up": {"step": 1, "cooldown_ticks": 5,
           "signals": {"slo_breaches_window": 2, "queue_wait_ema_s": 0.12,
                       "queue_depth_ema": 6.0, "free_page_frac": 0.1,
                       "goodput_ratio": 0.05, "step_time_ratio": 1.5}},
    "down": {"step": 1, "cooldown_ticks": 10, "stable_ticks": 6,
             "signals": {"queue_wait_ema_s": 0.06, "queue_depth_ema": 2.0}},
}


@pytest.mark.parametrize("kind", ["queue", "pages", "steps", "slo"])
def test_live_monitor_matches_the_reference(kind):
    recs = _sequence(kind)
    mons = [m.CapacityMonitor(m.AutoscalePolicy.from_doc(SEQ_POLICY),
                              hosts_live=2) for m in (auto, ref_auto)]
    trail = [[], []]
    for rec in recs:
        for mon, out in zip(mons, trail):
            mon.observe(rec)
            if rec["event"] == "fleet":
                out.append([mon.signal_value(n) for n in auto.SIGNAL_NAMES])
                out.append(mon.evaluate(tick=rec["tick"]))
    assert json.dumps(trail[0]) == json.dumps(trail[1])
    assert mons[0].decisions and \
        json.dumps(mons[0].decisions) == json.dumps(mons[1].decisions)


def test_ledger_tailer_holds_back_torn_lines(tmp_path):
    path = str(tmp_path / "run.jsonl")
    tail = auto.LedgerTailer()
    assert tail.poll([path]) == []
    with open(path, "w") as f:
        f.write(json.dumps({"event": "step", "step": 0}) + "\n")
        f.write("not json at all\n")
        f.write('{"event": "step", "st')
    assert [r.get("step") for r in tail.poll([path])] == [0]
    with open(path, "a") as f:
        f.write('ep": 1}\n')
    assert [r.get("step") for r in tail.poll([path])] == [1]
    assert tail.poll([path]) == []
    other = str(tmp_path / "run.a1.jsonl")
    with open(other, "w") as f:
        f.write(json.dumps({"event": "step", "step": 5}) + "\n[1, 2]\n")
    with open(path, "a") as f:
        f.write(json.dumps({"event": "step", "step": 2}) + "\n")
    assert [r.get("step") for r in tail.poll([path, other])] == [2, 5]


def test_autoscale_metrics_series():
    reg = MetricsRegistry()
    sink = metrics_ledger_sink(reg)
    text = reg.render()
    assert 'tpu_dist_autoscale_decisions_total{direction="up"} 0' in text
    assert 'tpu_dist_autoscale_decisions_total{direction="down"} 0' in text
    assert "tpu_dist_autoscale_target_hosts 0" in text
    pol = auto.AutoscalePolicy.from_doc(_policy_doc())
    mon = auto.CapacityMonitor(pol, hosts_live=2)
    mon.observe({"event": "request", "queue_wait_s": 0.5})
    up = mon.evaluate(tick=3)
    sink({"event": "scale_decision", **up})
    sink({"event": "scale_decision", "decision": "d1", "direction": "down",
          "hosts_from": 3, "target_hosts": 2, "signal": auto.CALM_SIGNAL,
          "value": 24.0, "threshold": 24.0, "window_ticks": 16,
          "bundle": None})
    text = reg.render()
    assert 'tpu_dist_autoscale_decisions_total{direction="up"} 1' in text
    assert 'tpu_dist_autoscale_decisions_total{direction="down"} 1' in text
    assert "tpu_dist_autoscale_target_hosts 2" in text


def test_emit_decision_roundtrips_the_ledger_schema(tmp_path):
    led = Ledger(str(tmp_path / "fleet.jsonl"))
    mon = auto.CapacityMonitor(auto.AutoscalePolicy.from_doc(_policy_doc()),
                               hosts_live=1)
    mon.observe({"event": "request", "queue_wait_s": 0.5})
    dec = mon.evaluate(tick=7)
    auto.emit_decision(led, dec)
    led.emit("applied", decision=dec["decision"], action="expand",
             processes=2, epoch=1, plan_hash="abc123def456", devices=4)
    led.close()
    recs = read_ledger(str(tmp_path / "fleet.jsonl"))
    assert [r["event"] for r in recs] == ["scale_decision", "applied"]
    for k in ("decision", "direction", "hosts_from", "target_hosts",
              "signal", "value", "threshold", "window_ticks", "bundle",
              "tick"):
        assert recs[0][k] == dec[k], k
    with pytest.raises(ValueError, match="missing required"):
        Ledger(str(tmp_path / "bad.jsonl")).emit("scale_decision",
                                                 direction="up")


def _emit_line(f, **rec):
    f.write(json.dumps(rec) + "\n")


def test_fleet_autoscale_join_matches_the_reference(tmp_path):
    t0 = 1000.0
    h0 = os.path.join(str(tmp_path), "host0")
    os.makedirs(h0)
    with open(os.path.join(h0, "run.jsonl"), "w") as f:
        _emit_line(f, event="run_start", ts=t0, pid=0, kind="fleet_sim",
                   config={}, mesh=None, devices=["cpu"], process_count=1,
                   attempt=0)
        _emit_line(f, event="run_end", ts=t0 + 2.0, pid=0, steps=1,
                   seconds=2.0, status="ok")
    with open(os.path.join(h0, "run.sup.jsonl"), "w") as f:
        _emit_line(f, event="scale", ts=t0 + 6.0, pid=0, action="expand",
                   processes=3, epoch=1, world_from=2, decision="d0")
        _emit_line(f, event="applied", ts=t0 + 6.5, pid=0, decision="d0",
                   action="expand", processes=3, epoch=1,
                   plan_hash="abc123def456")
        _emit_line(f, event="scale", ts=t0 + 11.0, pid=0, action="drain",
                   processes=1, epoch=2)
        _emit_line(f, event="scale", ts=t0 + 15.0, pid=0, action="expand",
                   processes=3, epoch=3, world_from=2)
    with open(os.path.join(str(tmp_path), "fleet.jsonl"), "w") as f:
        _emit_line(f, event="scale_decision", ts=t0 + 5.0, pid=0,
                   decision="d0", direction="up", hosts_from=2,
                   target_hosts=3, signal="queue_depth_ema", value=7.0,
                   threshold=6.0, window_ticks=16, bundle=None, tick=40)
        _emit_line(f, event="scale_decision", ts=t0 + 11.5, pid=0,
                   decision="d1", direction="down", hosts_from=3,
                   target_hosts=2, signal=auto.CALM_SIGNAL, value=24.0,
                   threshold=24.0, window_ticks=16, bundle=None, tick=170)
    got = fleet.FleetLedger.discover(str(tmp_path)).autoscale()
    want = ref_fleet.FleetLedger.discover(str(tmp_path)).autoscale()
    assert got == want
    assert (got["paired"], got["unattributed_scales"],
            got["applied_with_plan_hash"]) == (1, 1, 1)
    assert fleet.FleetLedger({0: []}, []).autoscale() is None
