"""The port's fleet end to end on the CPU: ``FleetSim`` over the checked-in
``scripts/fleet_ci.json`` (3 hosts, host 1 preempted at tick 56 and
returning at 120 through the consensus path, a 1.5x slow host 2, a burst
at tick 80, two tenants) with every worker on ``device="cpu"``.

What the schedule fixes is held exactly, against the JAX package's
compiler (``tpu_dist.sim.scenario``): the per-host restart classes and
their histogram, the consensus host's ``shrink`` then ``expand`` (to 2
then 3 processes), host 1's drain, and every completed request's tenant,
prompt length and generated tokens (the arrival the schedule gave its
rid).

What the wall clock moves is held only to bounds a host under ``-n 6``
load cannot break. The queue-wait EMA that decides SLO breaches is in
seconds, so a loaded host breaches more often (late ticks lengthen every
wait) and never less than once: the burst queues more requests than two
slots can serve in the 7.5 ticks the 0.15 s floor allows. A breach
episode needs a fresh wait sample to open, so the count is bounded by the
admission records. The goodput sum-check is an identity up to rounding.

The file also runs host 0 of a no-event scenario through each package's
worker (``slo_queue_wait_s = 0`` and a deep queue, so nothing is refused):
their ``request`` records agree in rid, tenant, prompt length and tokens
generated."""

import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)
pytest.importorskip("jax")

from tpu_dist.sim import scenario as ref_sc  # noqa: E402

from tpu_dist_torch.obs.ledger import read_ledger  # noqa: E402
from tpu_dist_torch.sim.runner import FleetSim  # noqa: E402
from tpu_dist_torch.tools import request_report  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CI = os.path.join(ROOT, "scripts", "fleet_ci.json")


def _tool(args):
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("fleet") / "ci")
    inline = FleetSim(CI, out_dir, device="cpu").run()
    report = _tool(["-m", "tpu_dist_torch.tools.fleet_report", out_dir,
                    "--json"])
    req = request_report.requests_summary(
        request_report.load_records(out_dir))
    return {"dir": out_dir, "inline": inline, "report": report, "req": req}


def test_restart_classes_equal_the_reference_schedule(fleet_run):
    want = ref_sc.expected_restart_classes(ref_sc.load_scenario(CI))
    report = fleet_run["report"]
    assert report["restart_classes"] == \
        {str(h): cls for h, cls in want.items()}
    assert report["restart_histogram"] == {
        "preemption_snapshotted": 3, "clean": 3}
    sups = fleet_run["inline"]["supervisors"]
    assert {h: s["status"] for h, s in sups.items()} == \
        {"0": "clean", "1": "clean", "2": "clean"}


def test_consensus_shrink_expand_and_the_wave_drain(fleet_run):
    elas = fleet_run["report"]["elasticity"]
    scales = [e for e in elas if e["host"] == 0
              and e["action"] in ("shrink", "expand")]
    assert [(e["action"], e["processes"]) for e in scales] == \
        [("shrink", 2), ("expand", 3)]
    assert any(e["action"] == "drain" and e["host"] == 1 for e in elas)


def test_goodput_partition_sums_to_the_aggregate_wall(fleet_run):
    acct = fleet_run["report"]["fleet"]
    assert acct["hosts"] == 3
    assert acct["sum_check"] == pytest.approx(1.0, abs=0.02)
    explained = acct["goodput_s"] + sum(acct["categories"].values())
    assert explained == pytest.approx(acct["aggregate_wall_s"], rel=0.02)
    assert acct["goodput_s"] > 0 and acct["goodput_ratio"] > 0
    assert acct["categories"]["restart_gap"] > 0
    assert [acct["per_host"][h]["attempts"] for h in "012"] == [3, 2, 1]


def test_served_requests_are_the_scheduled_ones(fleet_run):
    plans, _ = ref_sc.compile_host_plans(ref_sc.load_scenario(CI))
    sched = {a.rid: a for p in plans.values() for a in p.arrivals}
    recs = [r for path in _ledgers(fleet_run["dir"])
            for r in read_ledger(path, strict=False)
            if r["event"] == "request"]
    rids = [r["rid"] for r in recs]
    assert recs and len(rids) == len(set(rids))
    for r in recs:
        a = sched[r["rid"]]
        assert (r["tenant"], r["prompt_len"], r["tokens"]) == \
            (a.tenant, a.prompt_len, a.out_len), r
    report = fleet_run["report"]
    assert set(report["per_tenant"]) == {"chat", "batch"}
    for t in report["per_tenant"].values():
        assert t["requests"] > 0 and t["queue_wait_s"]["p50"] is not None
    assert report["serving"]["completed"] == len(recs)


def _ledgers(out_dir):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(out_dir)
                  for f in fs if f.startswith("run") and
                  f.endswith(".jsonl") and ".sup." not in f)


def test_slo_breaches_are_bounded_and_have_exemplars(fleet_run):
    report, req = fleet_run["report"], fleet_run["req"]
    admits = sum(1 for path in _ledgers(fleet_run["dir"])
                 for r in read_ledger(path, strict=False)
                 if r["event"] == "admit")
    assert 1 <= report["slo_breaches"] <= admits
    assert len(req["slo_exemplars"]) == report["slo_breaches"]
    for breach in req["slo_exemplars"]:
        assert len(breach["exemplars"]) >= 1, breach
    assert len(report["traces"]) == req["traces"] > 0


def test_request_attribution_sums(fleet_run):
    req = fleet_run["req"]
    assert req["completed_requests"] == \
        fleet_run["report"]["serving"]["completed"]
    assert req["tail_attribution"]["sum_check"]["ok"]
    for row in req["per_request"]:
        assert row["latency_s"] == pytest.approx(
            row["queue_s"] + row["prefill_s"] + row["decode_s"]
            + row["residue_s"], abs=1e-6)


def test_runner_artifacts(fleet_run):
    out_dir, report = fleet_run["dir"], fleet_run["report"]
    inline = dict(fleet_run["inline"])
    inline.pop("supervisors")
    # the runner stitched before it wrote its own final fleet event
    assert json.loads(json.dumps(inline, default=str)) == \
        {**report, "hosts_live": report["hosts_live"][:-1]}
    with open(os.path.join(out_dir, "headline.json")) as f:
        headline = json.load(f)
    assert headline["fleet"]["goodput_ratio"] == \
        report["fleet"]["goodput_ratio"]
    final = [r for r in read_ledger(os.path.join(out_dir, "fleet.jsonl"))
             if r["event"] == "fleet" and r.get("final")]
    assert final[-1]["slo_breaches"] == report["slo_breaches"]
    with open(os.path.join(out_dir, "scenario.json")) as f:
        assert json.load(f) == ref_sc.load_scenario(CI).to_doc()
    for path in _ledgers(out_dir):     # the run_end extras
        ends = [r for r in read_ledger(path, strict=False)
                if r["event"] == "run_end"]
        assert ends and ends[-1]["ticks"] > 0
        assert ends[-1]["launches"]["paged_decode"] == 0   # plain on CPU


def test_reference_tools_read_the_port_fleet(fleet_run):
    out_dir = fleet_run["dir"]
    assert _tool([os.path.join(ROOT, "tools", "fleet_report.py"), out_dir,
                  "--json"]) == fleet_run["report"]
    assert _tool([os.path.join(ROOT, "tools", "request_report.py"),
                  out_dir, "--json"]) == \
        json.loads(json.dumps(fleet_run["req"], default=str))


PAIR = {
    "name": "pair", "seed": 5, "hosts": 1, "ticks": 48, "tick_s": 0.005,
    "worker_devices": 1,
    "model": {"vocab_size": 64, "num_layers": 1, "d_model": 32,
              "num_heads": 2, "max_len": 32},
    "serve": {"max_slots": 2, "page_size": 8, "num_pages": 64,
              "queue_depth_max": 1000, "slo_queue_wait_s": 0.0},
    "traffic": {"base_rate": 0.35, "amplitude": 0.5, "period": 24,
                "tenants": [{"name": "chat", "weight": 2, "prompt": [2, 6],
                             "out": [2, 5]},
                            {"name": "batch", "weight": 1,
                             "prompt": [4, 10], "out": [3, 6]}]},
}


def test_workers_of_both_packages_serve_the_same_requests(tmp_path):
    scen = tmp_path / "pair.json"
    scen.write_text(json.dumps(PAIR))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_DIST")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    procs = {}
    for pkg, extra in (("tpu_dist", []),
                       ("tpu_dist_torch", ["--device", "cpu"])):
        ledger = str(tmp_path / pkg / "run.jsonl")
        os.makedirs(os.path.dirname(ledger))
        procs[pkg] = (ledger, subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.sim.worker", "--scenario",
             str(scen), "--host", "0", "--ledger-path", ledger, *extra],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    got = {}
    for pkg, (ledger, proc) in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        got[pkg] = sorted(
            (r["rid"], r["tenant"], r["prompt_len"], r["tokens"])
            for r in read_ledger(ledger, strict=False)
            if r["event"] == "request")
    plans, _ = ref_sc.compile_host_plans(ref_sc.parse_scenario(PAIR))
    want = sorted((a.rid, a.tenant, a.prompt_len, a.out_len)
                  for a in plans[0].arrivals)
    assert len(want) >= 10
    assert got["tpu_dist_torch"] == got["tpu_dist"] == want


def test_worker_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from tpu_dist_torch.sim import worker

    scen = tmp_path / "pair.json"
    scen.write_text(json.dumps(PAIR))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker.main(["--scenario", str(scen), "--host", "0"])
