"""A SIGTERM that reaches the port's fleet worker before its first tick is
a drain request, as one after its first tick is (``tpu_dist_torch/sim/
worker.py``): the attempt ends ``preemption_snapshotted`` and the next
attempt serves the rest of the host's plan.

The worker runs under the port's ``Supervisor`` on the CPU, started as
``python -c HOOK`` with the worker's arguments. On attempt 0 the hook
sends the worker its own SIGTERM from inside one point of its start, so
the signal lands there every time, with no timing:

* ``before_torch``: inside the scenario compile, before ``import torch``
  (the hook asserts torch is not imported yet: the package's import pulls
  in none);
* ``before_runobs``: as ``RunObs`` is built, after torch and before
  ``RunObs`` takes SIGTERM over;
* ``before_first_tick``: as the engine is built, with ``RunObs`` up.
"""

import json
import os
import sys

import pytest

from tpu_dist_torch.obs.ledger import read_ledger
from tpu_dist_torch.parallel.supervisor import (PREEMPT_SNAPSHOT_RC,
                                                RestartPolicy, Supervisor)
from tpu_dist_torch.sim.scenario import compile_host_plans, parse_scenario

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENARIO = {
    "name": "drain", "seed": 5, "hosts": 1, "ticks": 48, "tick_s": 0.005,
    "worker_devices": 1,
    "model": {"vocab_size": 64, "num_layers": 1, "d_model": 32,
              "num_heads": 2, "max_len": 32},
    "serve": {"max_slots": 2, "page_size": 8, "num_pages": 64,
              "queue_depth_max": 1000, "slo_queue_wait_s": 0.0},
    "traffic": {"base_rate": 0.35, "amplitude": 0.5, "period": 24,
                "tenants": [{"name": "chat", "weight": 1, "prompt": [2, 6],
                             "out": [2, 5]}]},
}

HOOK = """
import os, signal, sys

def term_inside(module, name, check=None):
    real = getattr(module, name)

    def held(*a, **kw):
        if check is not None:
            check()
        os.kill(os.getpid(), signal.SIGTERM)
        return real(*a, **kw)
    setattr(module, name, held)

site = os.environ["DRAIN_TEST_SITE"]
if os.environ.get("TPU_DIST_ATTEMPT") == "0":
    if site == "before_torch":
        from tpu_dist_torch.sim import scenario

        def no_torch():
            assert "torch" not in sys.modules, "torch imported too early"
        term_inside(scenario, "compile_host_plans", no_torch)
    elif site == "before_runobs":
        import tpu_dist_torch.obs as obs
        term_inside(obs, "RunObs")
    else:
        from tpu_dist_torch.engine import serve
        term_inside(serve, "ServeEngine")
from tpu_dist_torch.sim import worker
sys.exit(worker.main(sys.argv[1:]))
"""


@pytest.mark.parametrize("site", ["before_torch", "before_runobs",
                                  "before_first_tick"])
def test_sigterm_before_the_first_tick_drains_and_the_restart_serves_all(
        tmp_path, site):
    scen = tmp_path / "drain.json"
    scen.write_text(json.dumps(SCENARIO))
    ledger = str(tmp_path / "h0" / "run.jsonl")
    os.makedirs(os.path.dirname(ledger))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_DIST")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", DRAIN_TEST_SITE=site)
    sup = Supervisor(
        [sys.executable, "-c", HOOK, "--scenario", str(scen), "--host", "0",
         "--device", "cpu"], ledger,
        policy=RestartPolicy(max_restarts=2, backoff_base_s=0.0,
                             backoff_jitter=0.0), env=env)
    result = sup.run()
    classes = [a.failure_class for a in result.attempts]
    assert classes == ["preemption_snapshotted", "clean"], classes
    assert result.status == "clean"
    first, second = result.attempts
    assert first.returncode == PREEMPT_SNAPSHOT_RC and first.steps == 0

    recs0 = read_ledger(first.ledger, strict=False)
    end0 = [r for r in recs0 if r["event"] == "run_end"]
    assert len(end0) == 1 and end0[0]["status"] == "preempted"
    assert end0[0]["snapshot_tick"] == 0 and end0[0]["ticks"] == 0
    assert not [r for r in recs0 if r["event"] == "request"]

    plan = compile_host_plans(parse_scenario(SCENARIO))[0][0]
    want = sorted((a.rid, a.prompt_len, a.out_len) for a in plan.arrivals)
    assert len(want) >= 10
    recs1 = read_ledger(second.ledger, strict=False)
    got = sorted((r["rid"], r["prompt_len"], r["tokens"])
                 for r in recs1 if r["event"] == "request")
    assert got == want
    end1 = [r for r in recs1 if r["event"] == "run_end"]
    assert end1[-1]["status"] in (None, "ok")
    assert end1[-1]["completed"] == len(want)
