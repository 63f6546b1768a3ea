"""The port's autoscaling fleet end to end on the CPU: ``FleetSim`` over
the checked-in ``scripts/fleet_autoscale.json`` (3 hosts, host 2 parked
standby, a diurnal curve with a burst at tick 40) with every worker on
``device="cpu"`` and the retune planned for the reference's
``"TPU v5 lite"``.

Held exactly: the first decision is ``up`` (2 -> 3 hosts), a ``down``
(3 -> 2, by the calm signal) follows it, every decision pairs 1:1 with
one ``scale`` event stamped with its id (``expand`` to 3 processes, then
``shrink`` to 2) and no capacity change goes unattributed; each
``applied`` follow-up carries the plan hash that the JAX package's own
tuner (``tpu_dist.plan.tune.tune``) gives at ``processes x
worker_devices`` devices, and its ``plans/plan_epoch<N>.json`` exists;
hosts-live starts at 2 and peaks at 3; no shed request is lost, and the
requests planned for the removed standby after its drain complete on a
survivor under the same trace.

Wall-dependent, so held to bounds only: the up decision's tick (within
64 ticks after the burst's start, the reference's window; not from
below, since ``queue_wait_ema_s`` is in seconds and a loaded host's late
ticks can trip it before the burst) and the goodput ratio (in (0, 1]:
it is the engines' busy share of a paced trace, so a faster box idles
more and a CPU run can land below the reference's 0.05 floor)."""

import json
import os

import pytest
import torch

torch.set_num_threads(1)
pytest.importorskip("jax")

from tpu_dist.plan.tune import tune as ref_tune  # noqa: E402
from tpu_dist.sim import scenario as ref_sc  # noqa: E402

from tpu_dist_torch.obs.autoscale import CALM_SIGNAL  # noqa: E402
from tpu_dist_torch.sim.fleet import FleetLedger  # noqa: E402
from tpu_dist_torch.sim.runner import FleetSim  # noqa: E402
from tpu_dist_torch.tools import fleet_report  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIO = os.path.join(ROOT, "scripts", "fleet_autoscale.json")
KIND = "TPU v5 lite"


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("fleet") / "auto")
    inline = FleetSim(SCENARIO, out_dir, device="cpu",
                      device_kind=KIND).run()
    report = json.loads(json.dumps(FleetLedger.discover(out_dir).report(),
                                   default=str))
    return {"dir": out_dir, "inline": inline, "report": report,
            "sc": ref_sc.load_scenario(SCENARIO)}


def test_decisions_follow_the_burst(fleet_run):
    rows = fleet_run["report"]["autoscale"]["decisions"]
    burst0 = min(ev["tick"] for ev in fleet_run["sc"].events
                 if ev["type"] == "burst")
    ups = [r for r in rows if r["direction"] == "up"]
    downs = [r for r in rows if r["direction"] == "down"]
    assert rows[0]["direction"] == "up" and downs, rows
    assert (ups[0]["hosts_from"], ups[0]["target_hosts"]) == (2, 3)
    assert ups[0]["tick"] <= burst0 + 64, ups[0]
    assert (downs[0]["hosts_from"], downs[0]["target_hosts"]) == (3, 2)
    assert downs[0]["signal"] == CALM_SIGNAL
    assert downs[0]["tick"] > ups[0]["tick"]


def test_every_decision_pairs_with_one_scale_event(fleet_run):
    report = fleet_run["report"]
    auto = report["autoscale"]
    rows = auto["decisions"]
    assert auto["paired"] == len(rows)
    assert auto["unattributed_scales"] == 0
    assert auto["applied_with_plan_hash"] == len(rows)
    for r in rows:
        assert r["scale_events"] == 1, r
        assert r["lag_s"] is not None and r["lag_s"] >= 0
        assert r["applied"]["decision"] == r["decision"]
    membership = [e for e in report["elasticity"]
                  if e["action"] in ("shrink", "expand")]
    assert [(e["action"], e["processes"], e["decision"])
            for e in membership] == [
        ("expand", 3, rows[0]["decision"]),
        ("shrink", 2, [r for r in rows
                       if r["direction"] == "down"][0]["decision"])]
    live = [s["hosts_live"] for s in report["hosts_live"]
            if s["hosts_live"] is not None]
    assert live[0] == 2 and max(live) == 3


def test_applied_plan_hash_equals_the_reference_tuner(fleet_run):
    wd = fleet_run["sc"].worker_devices
    for r in fleet_run["report"]["autoscale"]["decisions"]:
        app = r["applied"]
        _, results = ref_tune(device_kinds=[KIND],
                              workload={"devices": app["processes"] * wd})
        assert results[KIND]["best"]["hash"] == app["plan_hash"], r
        path = os.path.join(fleet_run["dir"], "plans",
                            f"plan_epoch{app['epoch']}.json")
        with open(path) as f:
            assert app["plan_hash"] in f.read()


def test_no_shed_request_is_lost(fleet_run):
    auto = fleet_run["report"]["autoscale"]
    traces = fleet_run["report"]["traces"]
    assert auto["shed_lost"] == 0
    readmitted = [t for t in traces.values() if t["readmits"]]
    assert readmitted and all(t["completed"] for t in readmitted)
    for t in traces.values():
        if t["sheds"]:
            assert t["readmits"] > 0 and t["completed"], t
    drained = fleet_run["sc"].standby_hosts()[0]
    crossed = [t for t in readmitted
               if t["rid"] // ref_sc.RID_STRIDE == drained
               and drained not in t["hosts"]]
    assert crossed, readmitted


def test_goodput_headline_and_report_tool(fleet_run, capsys):
    report = fleet_run["report"]
    assert 0 < report["fleet"]["goodput_ratio"] <= 1
    assert report["fleet"]["sum_check"] == pytest.approx(1.0, abs=0.02)
    with open(os.path.join(fleet_run["dir"], "headline.json")) as f:
        headline = json.load(f)
    rows = report["autoscale"]["decisions"]
    assert headline["fleet"]["autoscale_decisions"] == len(rows)
    assert headline["fleet"]["autoscale_lag_ticks"] <= 64
    assert fleet_run["inline"]["autoscale"]["paired"] == len(rows)
    assert fleet_report.main([fleet_run["dir"]]) == 0
    text = capsys.readouterr().out
    assert f"autoscale: {len(rows)} decision(s), {len(rows)} paired" in text


def test_a_cpu_autoscale_run_needs_a_device_kind(tmp_path):
    with pytest.raises(ValueError, match="needs device_kind"):
        FleetSim(SCENARIO, str(tmp_path), device="cpu")
