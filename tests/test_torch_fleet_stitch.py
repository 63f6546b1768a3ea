"""The port's fleet stitcher (``tpu_dist_torch/sim/fleet.py``), its goodput
loaders and its report tools against the JAX package's, on one hand-made
fleet tree (the reference test's ``_build_fleet_dir``: a preempted
attempt and a clean one with a supervisor sibling on host 0, a torn
trailing line on host 1, two tenants, SLO breaches, scale events):

* ``FleetLedger.discover(...).report()`` and every rollup compare equal;
* ``load_job_records`` and ``fleet_accounting`` give equal outputs;
* ``python -m tpu_dist_torch.tools.fleet_report`` prints the same
  ``--json`` document and the same text as ``tools/fleet_report.py``,
  and ``python -m tpu_dist_torch.tools.request_report --json`` the same
  summary as ``tools/request_report.py``."""

import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)
pytest.importorskip("jax")

from tpu_dist.obs import goodput as ref_goodput  # noqa: E402
from tpu_dist.sim import fleet as ref_fleet  # noqa: E402

from tpu_dist_torch.obs import goodput  # noqa: E402
from tpu_dist_torch.sim import fleet  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _emit_line(f, **rec):
    f.write(json.dumps(rec) + "\n")


def _host_ledger(path, t0, *, attempt=0, steps=2, status="ok",
                 tenant="chat", slo=0, scale=None, torn=False, rid=1):
    """One attempt ledger: run_start -> compile -> step(s) -> serving
    events (a request and its root span) -> run_end, with optional
    slo/scale events and a torn tail (the reference test's helper, plus
    one span so the request tools have a trace to read)."""
    with open(path, "w") as f:
        _emit_line(f, event="run_start", ts=t0, pid=0, kind="fleet_sim",
                   config={}, mesh=None, devices=["cpu"], process_count=1,
                   attempt=attempt)
        _emit_line(f, event="compile", ts=t0 + 1.0, pid=0, program="serve")
        for i in range(steps):
            _emit_line(f, event="step", ts=t0 + 1.5 + i, pid=0, step=i,
                       loss=None, throughput=10.0, unit="tok/s",
                       data_s=0.0, dispatch_s=0.1, device_s=0.4,
                       comm_s=None, mfu=None)
        _emit_line(f, event="request", ts=t0 + 1.6, pid=0, rid=rid,
                   tokens=4, queue_wait_s=0.05 * (rid % 3 + 1),
                   admit_ts=0.0, first_token_ts=0.1, finish_ts=0.4,
                   tenant=tenant, ttft_s=0.1 * rid)
        _emit_line(f, event="span", ts=t0 + 1.6, pid=0, trace_id=f"t{rid}",
                   span_id=f"s{rid}", parent_id=None, name="request",
                   rid=rid, start=t0 + 1.2, end=t0 + 1.6, job_id="j",
                   attempt=attempt, tenant=tenant)
        for i in range(slo):
            _emit_line(f, event="slo", ts=t0 + 2.0 + i, pid=0, step=i,
                       kind="queue_wait", value=0.9, floor=0.5)
        if scale:
            _emit_line(f, event="scale", ts=t0 + 2.5, pid=0, **scale)
        if torn:
            f.write('{"event": "step", "ts": ')   # the killed writer
        else:
            _emit_line(f, event="run_end", ts=t0 + 1.5 + steps, pid=0,
                       steps=steps, seconds=1.5 + steps, status=status)


def _build_fleet_dir(root):
    t0 = 1000.0
    h0 = os.path.join(root, "host0")
    h1 = os.path.join(root, "host1")
    os.makedirs(h0)
    os.makedirs(h1)
    _host_ledger(os.path.join(h0, "run.jsonl"), t0, status="preempted",
                 tenant="chat", slo=1, rid=1)
    _host_ledger(os.path.join(h0, "run.a1.jsonl"), t0 + 10.0, attempt=1,
                 tenant="chat", rid=2)
    with open(os.path.join(h0, "run.sup.jsonl"), "w") as f:
        _emit_line(f, event="scale", ts=t0 + 6.0, pid=0, action="shrink",
                   processes=1, epoch=1, world_from=2)
        _emit_line(f, event="scale", ts=t0 + 9.0, pid=0, action="expand",
                   processes=2, epoch=2, world_from=1)
    _host_ledger(os.path.join(h1, "run.jsonl"), t0 + 0.5, tenant="batch",
                 torn=True, rid=1_000_001)
    with open(os.path.join(root, "fleet.jsonl"), "w") as f:
        _emit_line(f, event="scenario", ts=t0, pid=0, name="hand", seed=1,
                   hosts=2, ticks=10, tick_s=0.02)
        _emit_line(f, event="fleet", ts=t0 + 1.0, pid=0, hosts_live=2,
                   goodput_ratio=None, slo_breaches=None)
        _emit_line(f, event="fleet", ts=t0 + 20.0, pid=0, hosts_live=0,
                   goodput_ratio=0.4, slo_breaches=1, final=True)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _build_fleet_dir(str(tmp_path_factory.mktemp("fleet")))


def _quiet(msg):
    pass


ROLLUPS = ("t0", "merged", "scenario", "accounting", "restart_classes",
           "restart_histogram", "slo_breaches", "elasticity", "autoscale",
           "per_tenant", "traces", "serving_totals", "hosts_live_timeline",
           "report")


@pytest.mark.parametrize("method", ROLLUPS)
def test_rollups_match_the_reference(tree, method):
    got = getattr(fleet.FleetLedger.discover(tree, warn=_quiet), method)()
    want = getattr(ref_fleet.FleetLedger.discover(tree, warn=_quiet),
                   method)()
    assert got == want


def test_report_holds_the_reference_pins(tree):
    report = fleet.FleetLedger.discover(tree, warn=_quiet).report()
    acct = report["fleet"]
    explained = acct["goodput_s"] + sum(acct["categories"].values())
    assert explained == pytest.approx(acct["aggregate_wall_s"], rel=1e-6)
    assert acct["sum_check"] == pytest.approx(1.0, abs=1e-6)
    assert acct["per_host"][0]["attempts"] == 2
    assert acct["categories"]["restart_gap"] > 0
    assert report["restart_classes"] == {
        "0": ["preemption_snapshotted", "clean"], "1": ["crash"]}
    assert report["slo_breaches"] == 1
    assert [(e["host"], e["action"]) for e in report["elasticity"]] == \
        [(0, "shrink"), (0, "expand")]
    assert set(report["per_tenant"]) == {"chat", "batch"}
    assert [s["hosts_live"] for s in report["hosts_live"]] == [2, 0]
    json.dumps(report)


@pytest.mark.parametrize("xs", [[], [0.5], [0.1, 0.2, 0.3],
                                [float(i) for i in range(101)],
                                [0.01 * i * i for i in range(37)]])
@pytest.mark.parametrize("q", [0, 50, 90, 99, 100])
def test_nearest_rank_percentile_matches(xs, q):
    assert fleet._pctl(sorted(xs), q) == ref_fleet._pctl(sorted(xs), q)


@pytest.mark.parametrize("discover", [True, False])
def test_load_job_records_matches(tree, discover):
    base = os.path.join(tree, "host0", "run.jsonl")
    got = goodput.load_job_records(base, discover=discover, warn=_quiet)
    want = ref_goodput.load_job_records(base, discover=discover,
                                        warn=_quiet)
    assert got == want
    if discover:   # the sup sibling rides after every attempt
        assert [r["event"] for r in got[-2:]] == ["scale", "scale"]
    else:
        assert got[-1]["event"] == "run_end"


def test_fleet_accounting_matches(tree):
    assert goodput.fleet_accounting({}) is None
    j = {"wall_s": 10.0, "goodput_s": 4.0, "ratio": 0.4,
         "categories": {"startup": 2.0, "idle": 4.0}, "overrun_s": 0.0,
         "opt_steps": 7, "attempts": [{}]}
    cases = [{0: j, 1: j}, {0: j, 3: None},
             {0: dict(j, overrun_s=0.5, wall_s=0.0)}]
    stitched = fleet.FleetLedger.discover(tree, warn=_quiet)
    cases.append({h: goodput.job_accounting(goodput.split_attempts(recs))
                  for h, recs in stitched.hosts.items()})
    for host_jobs in cases:
        assert goodput.fleet_accounting(host_jobs) == \
            ref_goodput.fleet_accounting(host_jobs)
    agg = goodput.fleet_accounting({0: j, 1: j})
    assert agg["aggregate_wall_s"] == 20.0 and agg["opt_steps"] == 14
    assert agg["sum_check"] == pytest.approx(1.0)


def _run(args):
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("as_json", [True, False], ids=["json", "text"])
def test_fleet_report_cli_matches_the_reference(tree, as_json):
    flag = ["--json"] if as_json else []
    got = _run(["-m", "tpu_dist_torch.tools.fleet_report", tree, *flag])
    want = _run([os.path.join(ROOT, "tools", "fleet_report.py"), tree,
                 *flag])
    if as_json:
        assert json.loads(got) == json.loads(want)
        assert json.loads(got)["restart_histogram"]["crash"] == 1
    else:
        assert got == want
        assert "fleet goodput ratio" in got
        assert "per-tenant serving" in got


@pytest.mark.parametrize("as_json", [True, False], ids=["json", "text"])
def test_request_report_cli_matches_the_reference(tree, as_json):
    flag = ["--json"] if as_json else []
    got = _run(["-m", "tpu_dist_torch.tools.request_report", tree, *flag])
    want = _run([os.path.join(ROOT, "tools", "request_report.py"), tree,
                 *flag])
    if as_json:
        assert json.loads(got) == json.loads(want)
        assert json.loads(got)["completed_requests"] == 3
    else:
        assert got == want
        assert "traces 3  completed 3" in got


def test_fleet_report_refuses_a_non_fleet_path(tmp_path, capsys):
    from tpu_dist_torch.tools import fleet_report

    assert fleet_report.main([str(tmp_path / "nope")]) == 1
    assert "not a fleet directory" in capsys.readouterr().err
    assert fleet_report.main([str(tmp_path)]) == 1
    assert "no host*/ dirs found" in capsys.readouterr().err
