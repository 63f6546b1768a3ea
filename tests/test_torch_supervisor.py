"""The port's supervisor (``tpu_dist_torch/parallel/supervisor.py`` and
``python -m tpu_dist_torch.supervise``) against the JAX package's.

* the policy math: ``classify_attempt`` over the reference test's table,
  ``compute_backoff`` over a grid with and without a host id, and
  ``degraded_env``, equal in both packages;
* ``latest_checkpoint`` over the port's ``.pt`` containers: the pointer,
  then the newest file;
* the reference test's stdlib fake child (``tests/test_supervisor.py``,
  copied here) driven by both packages' ``Supervisor`` for each behaviour
  sequence: equal ``SupervisorResult``s;
* ``run_supervised`` on the port's tiny LM under ``health="halt"`` with a
  ``nan_batch``: the restart resumes the newest checkpoint and the run's
  losses are bit-equal to an uninterrupted one's;
* the CLI end to end over the port's script 8 with ``hard_exit`` then
  ``preempt_deadline``: classes crash, preemption_snapshotted, clean, the
  stitched losses bit-equal to an uninterrupted script run, and the
  reference's ``tools/ledger_report.py`` reading the port's attempt
  ledgers and ``.sup.jsonl`` to the same classes and ``job_accounting``
  as the port's own functions."""

import dataclasses
import json
import os
import signal
import subprocess
import sys

import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist.obs import faults as ref_faults  # noqa: E402
from tpu_dist.obs import goodput as ref_goodput  # noqa: E402
from tpu_dist.parallel import supervisor as ref_sup  # noqa: E402

from tpu_dist_torch.configs import LMConfig  # noqa: E402
from tpu_dist_torch.engine import checkpoint as ckpt  # noqa: E402
from tpu_dist_torch.engine.lm_loop import LMTrainer  # noqa: E402
from tpu_dist_torch.obs import faults, goodput  # noqa: E402
from tpu_dist_torch.obs.health import HealthError  # noqa: E402
from tpu_dist_torch.obs.ledger import read_ledger  # noqa: E402
from tpu_dist_torch.parallel import supervisor as sup  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2,
            seq_len=32, batch_size=4, synth_tokens=660, val_frac=0.2,
            precision="fp32", optimizer="adamw", lr=3e-3, print_freq=1,
            seed=0)


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    for k in ("TPU_DIST_FAULTS", "TPU_DIST_ATTEMPT",
              "TPU_DIST_HEARTBEAT_FILE", "TPU_DIST_PEER_RESUME"):
        monkeypatch.delenv(k, raising=False)
    faults._reset_for_tests()
    ref_faults._reset_for_tests()
    yield
    faults._reset_for_tests()
    ref_faults._reset_for_tests()


# ---------------------------------------------------------------------------
# the policy math, equal in both packages

def _end(status=None, error=None):
    return {"event": "run_end", "steps": 3, "seconds": 1.0,
            "status": status, "error": error}


CLASSIFY = [
    ([_end("ok")], 0, False, ""),
    ([_end("ok")], None, False, ""),
    ([_end("crashed", "HealthError: val_loss spike z=9.1")], 1, False, ""),
    ([_end("crashed", "SIGTERM")], 143, False, ""),
    ([], -signal.SIGTERM, False, ""),
    ([], 1, False, "rendezvous failed: could not reach coordinator"),
    ([], 1, False, "grpc DEADLINE_EXCEEDED"),
    ([{"event": "stall", "idle_s": 9.0}], -9, True, ""),
    ([{"event": "stall", "idle_s": 9.0}], -9, False, ""),
    ([], 13, False, ""),
    ([_end("ok")], -9, True, ""),
    ([_end("preempted")], 75, False, ""),
    ([_end("preempted")], None, False, ""),
    ([], 75, False, ""),
    ([_end("interrupted")], 1, False, ""),
    ([_end("crashed", "health=halt: nonfinite at step 6")], 1, False, ""),
    ([_end("crashed", "boom")], 1, False,
     "rendezvous failed: could not reach coordinator"),
]


@pytest.mark.parametrize("case", range(len(CLASSIFY)))
def test_classify_attempt_equals_the_reference(case):
    records, rc, killed, stderr = CLASSIFY[case]
    got = sup.classify_attempt(records, rc, killed, stderr)
    assert got == ref_sup.classify_attempt(records, rc, killed, stderr)
    assert got in sup.FAILURE_CLASSES
    assert sup.FAILURE_CLASSES == ref_sup.FAILURE_CLASSES
    assert sup.PREEMPT_SNAPSHOT_RC == ref_sup.PREEMPT_SNAPSHOT_RC == 75


@pytest.mark.parametrize("base,cap,jitter", [
    (1.0, 60.0, 0.5), (0.5, 8.0, 0.0), (2.0, 30.0, 1.0), (0.01, 0.02, 0.25)])
def test_compute_backoff_grid_equals_the_reference(base, cap, jitter):
    pol = sup.RestartPolicy(backoff_base_s=base, backoff_max_s=cap,
                            backoff_jitter=jitter)
    ref = ref_sup.RestartPolicy(backoff_base_s=base, backoff_max_s=cap,
                                backoff_jitter=jitter)
    for n in range(0, 12):
        for host in (None, 0, 1, 2, 7, 63):
            assert sup.compute_backoff(n, pol, host_id=host) == \
                ref_sup.compute_backoff(n, ref, host_id=host)
    assert dataclasses.asdict(sup.RestartPolicy()) == \
        dataclasses.asdict(ref_sup.RestartPolicy())


@pytest.mark.parametrize("env,lost", [
    ({"TPU_DIST_NUM_PROCESSES": "4"}, 1), ({"TPU_DIST_NUM_PROCESSES": "1"}, 1),
    ({}, 1), ({"TPU_DIST_NUM_PROCESSES": "8", "X": "y"}, 3),
    ({"TPU_DIST_NUM_PROCESSES": "2"}, 5), ({"TPU_DIST_NUM_PROCESSES": "3"},
                                           0)])
def test_degraded_env_equals_the_reference(env, lost):
    assert sup.degraded_env(env, lost) == ref_sup.degraded_env(env, lost)
    assert sup.DEGRADED_FLAGS == ref_sup.DEGRADED_FLAGS


def _tiny_state(seed, step):
    from tpu_dist_torch.engine.state import TrainState
    from tpu_dist_torch.ops.optim import make_optimizer

    torch.manual_seed(seed)
    st = TrainState.create(torch.nn.Linear(3, 2),
                           make_optimizer(0.1, 0.9, 0.0))
    st.step = step
    return st


def test_latest_checkpoint_pointer_then_mtime_over_pt(tmp_path):
    d = str(tmp_path)
    assert sup.latest_checkpoint(d) is None
    assert sup.latest_checkpoint(str(tmp_path / "missing")) is None
    ckpt.save_checkpoint(d, _tiny_state(0, 4), 1, 0.0, "lm", False, keep=3)
    ckpt.save_checkpoint(d, _tiny_state(0, 8), 2, 0.0, "lm", False, keep=3)
    newest = os.path.join(d, "lm-checkpoint.pt")
    assert sup.latest_checkpoint(d) == newest
    with open(os.path.join(d, "lm-checkpoint.index.json")) as f:
        assert json.load(f)["newest"] == "lm-checkpoint.pt"
    # the pointer wins over mtime: point it at the retained step-4 file
    with open(os.path.join(d, "lm-checkpoint.index.json"), "w") as f:
        json.dump({"newest": "lm-checkpoint.r4.pt"}, f)
    assert sup.latest_checkpoint(d) == os.path.join(d, "lm-checkpoint.r4.pt")
    # a pointer naming a missing file is not trusted: newest .pt by mtime
    with open(os.path.join(d, "lm-checkpoint.index.json"), "w") as f:
        json.dump({"newest": "gone.pt"}, f)
    os.utime(os.path.join(d, "lm-checkpoint.r8.pt"), (1, 1))
    os.utime(os.path.join(d, "lm-checkpoint.r4.pt"), (1, 1))
    assert sup.latest_checkpoint(d) == newest
    os.remove(os.path.join(d, "lm-checkpoint.index.json"))
    assert sup.latest_checkpoint(d) == newest
    # the reference's containers are warm-start donors, not resume sources
    os.remove(newest)
    os.utime(os.path.join(d, "lm-checkpoint.r8.pt"), (5, 5))
    with open(os.path.join(d, "lm-checkpoint.msgpack"), "wb") as f:
        f.write(b"x")
    assert sup.latest_checkpoint(d) is None
    assert ref_sup.latest_checkpoint(d).endswith("lm-checkpoint.msgpack")


def test_latest_checkpoint_newest_pointer_of_two_archs(tmp_path):
    d = str(tmp_path)
    for arch, step, age in (("lenet", 3, 1), ("lm", 5, 2)):
        ckpt.save_checkpoint(d, _tiny_state(0, step), 1, 0.0, arch, False)
        idx = os.path.join(d, f"{arch}-checkpoint.index.json")
        os.utime(idx, (age, age))
    assert sup.latest_checkpoint(d).endswith("lm-checkpoint.pt")


def test_supervisor_refuses_retune_by_name(tmp_path):
    """A retune config without its device kind is refused by name: the
    supervisor plans for the children's card without opening it."""
    with pytest.raises(ValueError, match="device_kind"):
        sup.Supervisor(["true"], ledger=str(tmp_path / "run.jsonl"),
                       retune={"plan_dir": str(tmp_path / "plans")})
    sup.Supervisor(["true"], ledger=str(tmp_path / "run.jsonl"),
                   retune={"device_kind": "NVIDIA H100 80GB HBM3"})


# ---------------------------------------------------------------------------
# the reference test's fake child (tests/test_supervisor.py), copied; its
# faultloop loads the fault module of the package under test by file path

_CHILD = r"""
import importlib.util, json, os, signal, sys, time

def emit(f, event, **kw):
    f.write(json.dumps({"event": event, "ts": time.time(), **kw}) + "\n")
    f.flush()

argv = sys.argv[1:]
base = argv[argv.index("--ledger-base") + 1]
behaviors = json.loads(argv[argv.index("--behaviors") + 1])
faults_file = argv[argv.index("--faults-file") + 1]
attempt = int(os.environ.get("TPU_DIST_ATTEMPT", "0"))
b = behaviors[min(attempt, len(behaviors) - 1)]
root, ext = os.path.splitext(base)
path = base if attempt == 0 else f"{root}.a{attempt}{ext}"
with open(path, "a") as f:
    emit(f, "run_start", attempt=attempt)
    if b == "dead":
        sys.exit(3)  # dies before its first step (crash-loop fodder)
    if b == "rdzv":
        print("rendezvous failed: could not reach coordinator",
              file=sys.stderr, flush=True)
        sys.exit(1)
    if b == "shrunk_clean":
        ok = (os.environ.get("TPU_DIST_NUM_PROCESSES") == "1"
              and os.environ.get("TPU_DIST_DEGRADED") == "1"
              and "--mesh-shape" in argv)
        if not ok:
            sys.exit(9)
    emit(f, "step", step=0)
    if b == "faultloop":
        spec = importlib.util.spec_from_file_location("faults", faults_file)
        faults = importlib.util.module_from_spec(spec)
        sys.modules["faults"] = faults
        spec.loader.exec_module(faults)
        for step in range(1, 6):
            faults.fire_step(step)
            emit(f, "step", step=step)
    if b == "halt":
        emit(f, "run_end", steps=1, seconds=0.1, status="crashed",
             error="HealthError: val_loss spike z=9.1")
        sys.exit(2)
    if b == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(30)
    if b == "hang":
        emit(f, "stall", idle_s=9.0, threshold_s=1.0, stacks="")
        time.sleep(60)
    emit(f, "run_end", steps=1, seconds=0.1, status="ok")
"""

FAKE = {
    "clean": (["clean"], {}, {}),
    "hard_exit": (["faultloop", "faultloop"],
                  {"TPU_DIST_FAULTS": "hard_exit@step=3,attempt=0,code=13"},
                  {}),
    "halt": (["halt", "clean"], {}, {}),
    "sigterm": (["sigterm", "clean"], {}, {}),
    "stall": (["hang", "clean"], {}, {}),
    "crash_loop": (["dead"], {}, {"max_restarts": 10, "crash_loop_k": 3}),
    "exhausted": (["dead", "halt"], {}, {"max_restarts": 1}),
    "rdzv_shrink": (["rdzv", "rdzv", "shrunk_clean"],
                    {"TPU_DIST_NUM_PROCESSES": "2"}, {}),
}


def _fake_run(mod, tmp, name):
    behaviors, env, pol_kw = FAKE[name]
    script = os.path.join(tmp, "child.py")
    with open(script, "w") as f:
        f.write(_CHILD)
    ledger = os.path.join(tmp, "run.jsonl")
    fault_file = os.path.join(
        ROOT, "tpu_dist_torch" if mod is sup else "tpu_dist", "obs",
        "faults.py")
    kw = dict(max_restarts=3, backoff_base_s=0.01, backoff_max_s=0.02,
              stall_timeout_s=10.0, stall_grace_s=0.3, crash_loop_k=3)
    kw.update(pol_kw)
    child_env = {k: v for k, v in os.environ.items()
                 if not k.startswith("TPU_DIST_")}
    child_env.update(env)
    s = mod.Supervisor(
        [sys.executable, script, "--ledger-base", ledger, "--behaviors",
         json.dumps(behaviors), "--faults-file", fault_file],
        ledger=ledger, policy=mod.RestartPolicy(**kw), env=child_env,
        forward_flags=name == "rdzv_shrink", poll_s=0.05)
    res = s.run()
    return (res.status, res.ok, s.degraded,
            s.env.get("TPU_DIST_NUM_PROCESSES"),
            [(a.attempt, a.returncode, a.failure_class, a.steps,
              os.path.basename(a.ledger)) for a in res.attempts])


@pytest.mark.parametrize("name", sorted(FAKE))
def test_fake_child_results_equal_the_reference(tmp_path, name):
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "ref")
    got = _fake_run(sup, str(tmp_path / "port"), name)
    want = _fake_run(ref_sup, str(tmp_path / "ref"), name)
    assert got == want
    sibling = goodput.sup_sibling_path(str(tmp_path / "port" / "run.a2.jsonl"))
    assert sibling == str(tmp_path / "port" / "run.sup.jsonl")
    assert os.path.basename(sibling) == os.path.basename(
        ref_goodput.sup_sibling_path("run.a2.jsonl"))


# ---------------------------------------------------------------------------
# in process: run_supervised over the tiny LM

def _losses(path):
    return {r["step"]: r["loss"] for r in read_ledger(path, validate=False)
            if r["event"] == "step"}


def test_run_supervised_restarts_a_health_halt_from_the_newest_checkpoint(
        tmp_path):
    """``nan_batch`` at step 6 of attempt 0 under ``health="halt"``: the
    halt rebuilds the trainer from the step-4 epoch checkpoint with the
    next attempt's ledger (``run.a1.jsonl``), and the run's losses (attempt
    0's steps 0-5, attempt 1's 4-11) equal an uninterrupted run's bit for
    bit."""
    base = LMConfig(**TINY, epochs=3, health="halt")
    want = LMTrainer(dataclasses.replace(
        base, ledger_path=str(tmp_path / "a.jsonl")), device="cpu")
    want.fit()
    want = _losses(str(tmp_path / "a.jsonl"))
    cfg = dataclasses.replace(
        base, ledger_path=str(tmp_path / "run.jsonl"),
        checkpoint_dir=str(tmp_path / "ck"), max_restarts=2,
        restart_backoff_s=0.0, faults="nan_batch@step=6,attempt=0")
    built = []

    def make(run_cfg):
        built.append(run_cfg)
        return LMTrainer(run_cfg, device="cpu")

    sup.run_supervised(make, cfg, sleep=lambda s: None)
    assert len(built) == 2
    assert built[1].resume == os.path.join(str(tmp_path / "ck"),
                                           "lm-checkpoint.pt")
    assert built[1].attempt == -1
    att0 = read_ledger(str(tmp_path / "run.jsonl"), validate=False)
    att1 = read_ledger(str(tmp_path / "run.a1.jsonl"), validate=False)
    assert att0[-1]["status"] == "crashed" and "HealthError" in \
        att0[-1]["error"]
    assert sup.classify_attempt(att0) == "health_halt"
    assert sup.classify_attempt(att1) == "clean"
    assert [r["attempt"] for r in (att0[0], att1[0])] == [0, 1]
    assert att1[0]["resumed_from"].endswith("lm-checkpoint.pt")
    first = _losses(str(tmp_path / "run.jsonl"))
    assert sorted(first) == list(range(7))      # step 6 is the NaN one
    stitched = {k: v for k, v in first.items() if k < 4}
    stitched.update(_losses(str(tmp_path / "run.a1.jsonl")))
    assert stitched == want


def test_run_supervised_exhaustion_reraises_and_crash_loop_stops():
    calls = []

    def halting(cfg):
        calls.append(cfg)

        class T:
            obs = type("O", (), {"steps": 3})()

            def fit(self):
                raise HealthError("health=halt: nonfinite")
        return T()

    cfg = LMConfig(**TINY, max_restarts=2)
    with pytest.raises(HealthError):
        sup.run_supervised(halting, cfg, sleep=lambda s: None)
    assert len(calls) == 3

    def dead(cfg):
        raise RuntimeError("dies building")

    with pytest.raises(sup.CrashLoopError):
        sup.run_supervised(dead, dataclasses.replace(cfg, max_restarts=9),
                           sleep=lambda s: None)


# ---------------------------------------------------------------------------
# the CLI end to end over the port's script 8

_SCRIPT = ["-m", "tpu_dist_torch.scripts.lm_longcontext", "--device", "cpu",
           "--epochs", "3", "--batch-size", "4", "--seq-len", "32",
           "--d-model", "32", "--num-layers", "1", "--num-heads", "2",
           "--vocab-size", "64", "--synth-tokens", "660", "--val-frac",
           "0.2", "--precision", "fp32", "--optimizer", "adamw", "--lr",
           "3e-3", "--print-freq", "1"]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_DIST", "SLURM_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **extra)
    return env


def test_supervise_cli_stitches_a_bit_equal_run(tmp_path):
    """``python -m tpu_dist_torch.supervise`` over script 8: ``hard_exit``
    at step 9 of attempt 0 (after the step-8 epoch checkpoint), then
    ``preempt_deadline`` at step 10 of attempt 1 (the snapshot): classes
    crash, preemption_snapshotted, clean, resumed at steps 8 and 10, exit
    0, and the stitched losses equal an uninterrupted script run's bit for
    bit."""
    one = str(tmp_path / "one.jsonl")
    subprocess.run([sys.executable, *_SCRIPT, "--ledger-path", one],
                   env=_env(), cwd=ROOT, check=True, capture_output=True,
                   timeout=300)
    want = _losses(one)
    ledger = str(tmp_path / "run.jsonl")
    res = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.supervise", "--ledger",
         ledger, "--ckpt-dir", str(tmp_path / "ck"), "--max-restarts", "3",
         "--backoff-s", "0.05", "--", sys.executable, *_SCRIPT],
        env=_env(TPU_DIST_FAULTS="hard_exit@step=9,attempt=0;"
                 "preempt_deadline@step=10,attempt=1"),
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "a0=crash, a1=preemption_snapshotted, a2=clean" in res.stderr
    paths = goodput.discover_attempt_paths(ledger)
    assert [os.path.basename(p) for p in paths] == \
        ["run.jsonl", "run.a1.jsonl", "run.a2.jsonl"]
    per = [_losses(p) for p in paths]
    assert [min(p) for p in per] == [0, 8, 10]
    stitched = {}
    for p in per:
        stitched.update(p)
    assert stitched == want                     # every step, bit-equal

    # the reference's report reads the port's job as it reads its own
    sys.path.insert(0, ROOT)
    from tools import ledger_report

    # the job as the report loads it: the attempt family in order, the
    # supervisor's sibling appended
    ref_records = ref_goodput.load_job_records(ledger, warn=lambda m: None)
    records = [r for p in paths for r in read_ledger(p, validate=False)]
    sibling = goodput.sup_sibling_path(ledger)
    if os.path.exists(sibling):
        records += read_ledger(sibling, validate=False)
    assert records == ref_records
    rows = ledger_report.restarts_section(ref_records, out=lambda s: None)
    classes = [r["class"] for r in rows["attempts"]]
    assert classes == ["crash", "preemption_snapshotted", "clean"]
    assert classes == [sup.classify_attempt(a)
                       for a in goodput.split_attempts(records)]
    assert [r["attempt"] for r in rows["attempts"]] == [0, 1, 2]
    gp = ledger_report.goodput_section(ref_records, out=lambda s: None)
    mine = goodput.job_accounting(goodput.split_attempts(records))
    assert {k: v for k, v in gp.items() if k != "slo_breaches"} == mine
    assert mine["categories"]["restart_gap"] > 0
    scale = ledger_report.elasticity_section(ref_records, out=lambda s: None)
    assert [r["action"] for r in scale] == ["preempt_snapshot"]
    assert scale[0]["step"] == 10
