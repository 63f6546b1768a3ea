"""The port's scenario compiler (``tpu_dist_torch/sim/scenario.py``)
against the JAX package's (``tpu_dist/sim/scenario.py``).

* every document below — the checked-in ``scripts/fleet_ci.json`` and
  ``scripts/fleet_autoscale.json``, hand-made ones with ``crash``,
  ``hang`` and a ``burst`` on listed hosts, and each at seeds 0-4 —
  compiles to identical arrivals, fault spec strings, skews, restart
  hold-offs, fleet actions, expected restart classes, ``to_doc``, rates,
  wall estimates and standby hosts in both packages;
* the same malformed documents are refused with the same messages;
* the exact CI counts the reference pins (``tests/test_fleet.py``) hold
  for the port's compile of ``scripts/fleet_ci.json``."""

import dataclasses
import json
import os

import pytest
import torch

torch.set_num_threads(1)
pytest.importorskip("jax")

from tpu_dist.sim import scenario as ref_sc  # noqa: E402

from tpu_dist_torch.obs import faults  # noqa: E402
from tpu_dist_torch.sim import scenario as sc_mod  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CI = os.path.join(ROOT, "scripts", "fleet_ci.json")
AUTO = os.path.join(ROOT, "scripts", "fleet_autoscale.json")


def _load(path):
    with open(path) as f:
        return json.load(f)


def _doc(**over):
    doc = {"name": "t", "seed": 3, "hosts": 2, "ticks": 40,
           "traffic": {"base_rate": 0.2}}
    doc.update(over)
    return doc


HAND = {
    "crash_hang": _doc(hosts=3, ticks=60, events=[
        {"type": "crash", "tick": 7, "hosts": [1]},
        {"type": "hang", "tick": 9, "hosts": [1], "secs": 5},
        {"type": "hang", "tick": 30, "hosts": [2]},
        {"type": "crash", "tick": 44, "hosts": [1, 2]}]),
    "burst_on_hosts": _doc(hosts=4, ticks=80, traffic={
        "base_rate": 0.15, "amplitude": 0.7, "period": 50, "phase": 0.25,
        "tenants": [{"name": "a", "weight": 3, "prompt": [1, 4],
                     "out": [1, 3]},
                    {"name": "b", "weight": 0.5, "prompt": [5, 9],
                     "out": [2, 8]}]},
        events=[{"type": "burst", "tick": 10, "ticks": 12, "rate": 2.5,
                 "hosts": [1, 3]},
                {"type": "burst", "tick": 50, "rate": 4.0},
                {"type": "slow_host", "host": 3, "factor": 2.25}]),
    "waves_and_returns": _doc(hosts=4, ticks=90, consensus_host=1, events=[
        {"type": "preempt", "tick": 20, "hosts": [2, 3], "return_tick": 50},
        {"type": "preempt", "tick": 60, "hosts": [0]},
        {"type": "crash", "tick": 70, "hosts": [2]}]),
}
DOCS = {"fleet_ci": _load(CI), "fleet_autoscale": _load(AUTO), **HAND}
CASES = [(name, seed) for name in DOCS for seed in (None, 0, 1, 2, 3, 4)]


def _with_seed(doc, seed):
    return doc if seed is None else {**doc, "seed": seed}


def _compiled(mod, doc):
    sc = mod.parse_scenario(json.loads(json.dumps(doc)))
    plans, actions = mod.compile_host_plans(sc)
    return {
        "plans": {h: {"arrivals": [dataclasses.astuple(a)
                                   for a in p.arrivals],
                      "faults": p.faults, "skew": p.skew,
                      "holdoff": p.restart_holdoff_ticks,
                      "classes": p.expected_classes}
                  for h, p in plans.items()},
        "actions": [dataclasses.astuple(a) for a in actions],
        "expected": mod.expected_restart_classes(sc),
        "to_doc": sc.to_doc(),
        "rates": [[sc.rate(t, h) for h in range(sc.hosts)]
                  for t in range(sc.ticks)],
        "wall": sc.wall_estimate_s(),
        "standby": sc.standby_hosts(),
    }


@pytest.mark.parametrize("name,seed", CASES,
                         ids=[f"{n}-seed{s}" for n, s in CASES])
def test_compile_matches_the_reference(name, seed):
    doc = _with_seed(DOCS[name], seed)
    got, want = _compiled(sc_mod, doc), _compiled(ref_sc, doc)
    assert got == want
    assert any(p["arrivals"] for p in got["plans"].values())


@pytest.mark.parametrize("name", sorted(DOCS))
def test_doc_roundtrip_and_load_match(name, tmp_path):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(DOCS[name]))
    sc = sc_mod.load_scenario(str(path))
    assert sc_mod.parse_scenario(sc.to_doc()) == sc
    assert sc.to_doc() == ref_sc.load_scenario(str(path)).to_doc()
    assert (sc_mod.EVENT_TYPES, sc_mod.RID_STRIDE) == \
        (ref_sc.EVENT_TYPES, ref_sc.RID_STRIDE)


BAD = {
    "missing_key": {"name": "x"},
    "not_mapping": ["a"],
    "unknown_event": _doc(events=[{"type": "meteor", "tick": 1}]),
    "hosts_list": _doc(events=[{"type": "crash", "tick": 1, "hosts": [9]}]),
    "consensus_target": _doc(events=[{"type": "preempt", "tick": 1,
                                      "hosts": [0]}]),
    "return_tick": _doc(events=[{"type": "preempt", "tick": 30,
                                 "hosts": [1], "return_tick": 10}]),
    "tick_outside": _doc(events=[{"type": "burst", "tick": 40}]),
    "prompt_range": _doc(traffic={"tenants": [{"name": "bad",
                                               "prompt": [9, 2]}]}),
    "out_range": _doc(traffic={"tenants": [{"name": "bad", "out": [0, 2]}]}),
    "weight": _doc(traffic={"tenants": [{"name": "w", "weight": 0}]}),
    "tenant_name": _doc(traffic={"tenants": [{"weight": 1}]}),
    "exceeds_max_len": _doc(model={"max_len": 8}, traffic={"tenants": [
        {"name": "big", "prompt": [6, 8], "out": [4, 6]}]}),
    "slow_host_range": _doc(events=[{"type": "slow_host", "host": 5,
                                     "factor": 2}]),
    "slow_host_factor": _doc(events=[{"type": "slow_host", "host": 1,
                                      "factor": 0.5}]),
    "hosts_zero": _doc(hosts=0),
    "ticks_zero": _doc(ticks=0),
    "tick_s": _doc(tick_s=0),
    "consensus_range": _doc(consensus_host=4),
    "autoscale_policy": _doc(hosts=3, autoscale={"policy": ""}),
    "standby_range": _doc(hosts=3, autoscale={"policy": "p.json",
                                              "standby_hosts": [7]}),
    "standby_consensus": _doc(hosts=3, autoscale={"policy": "p.json",
                                                  "standby_hosts": [0]}),
    "standby_duplicate": _doc(hosts=3, autoscale={"policy": "p.json",
                                                  "standby_hosts": [2, 2]}),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_refusals_match_the_reference(name):
    with pytest.raises(ValueError) as want:
        ref_sc.parse_scenario(BAD[name])
    with pytest.raises(ValueError) as got:
        sc_mod.parse_scenario(BAD[name])
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("scenario: ")


def test_exact_ci_counts():
    """The reference's determinism pin (``tests/test_fleet.py``), on the
    port's compile."""
    sc = sc_mod.load_scenario(CI)
    p1, a1 = sc_mod.compile_host_plans(sc)
    p2, a2 = sc_mod.compile_host_plans(sc)
    key = lambda plans: [dataclasses.astuple(x)
                         for h in sorted(plans) for x in plans[h].arrivals]
    assert key(p1) == key(p2) and a1 == a2
    assert [len(p1[h].arrivals) for h in range(3)] == [65, 56, 49]
    assert p1[1].faults == "preempt_sigterm@step=56,attempt=0"
    assert p1[0].faults == "" and p1[2].faults == ""
    assert p1[2].skew == 1.5
    assert p1[1].restart_holdoff_ticks == 64
    assert [(a.tick, a.action, a.host) for a in a1] == \
        [(56, "leave", 1), (120, "register", 1)]
    rids = [x.rid for h in p1 for x in p1[h].arrivals]
    assert len(set(rids)) == len(rids)
    assert all(x.rid // sc_mod.RID_STRIDE == h for h in p1
               for x in p1[h].arrivals)
    assert sc_mod.expected_restart_classes(sc) == {
        0: ["preemption_snapshotted", "preemption_snapshotted", "clean"],
        1: ["preemption_snapshotted", "clean"],
        2: ["clean"]}
    other = sc_mod.parse_scenario({**sc.to_doc(), "seed": sc.seed + 1})
    assert [(x.tick, x.prompt_len) for x in p1[0].arrivals] != \
        [(x.tick, x.prompt_len) for x in
         sc_mod.compile_host_plans(other)[0][0].arrivals]


def test_fault_specs_parse_with_the_port_grammar():
    sc = sc_mod.parse_scenario(_doc(events=[
        {"type": "crash", "tick": 7, "hosts": [1]},
        {"type": "hang", "tick": 9, "hosts": [1], "secs": 5}]))
    plans, _ = sc_mod.compile_host_plans(sc)
    assert faults.FaultPlan.parse(plans[1].faults).sites() == \
        {"hard_exit", "hang"}
    assert plans[1].faults == \
        "hard_exit@step=7,attempt=0;hang@step=9,attempt=1,secs=5"
    assert sc_mod.expected_restart_classes(sc)[1] == \
        ["crash", "crash", "clean"]


def test_diurnal_rate_peaks_bursts_and_clamps():
    sc = sc_mod.parse_scenario(_doc(
        traffic={"base_rate": 0.2, "amplitude": 1.5, "period": 40},
        events=[{"type": "burst", "tick": 5, "ticks": 3, "rate": 2.0}]))
    assert sc.rate(10, 0) > 0.2
    assert sc.rate(30, 0) == 0.0
    assert sc.rate(5, 0) == pytest.approx(sc.rate(4, 0) + 2.0, abs=0.2)
    assert sc.rate(8, 0) < 2.0
