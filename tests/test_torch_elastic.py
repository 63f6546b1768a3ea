"""The port's elastic layer against the JAX package: consensus membership
(``parallel/consensus.py``), the launch overrides, peer restore over a
gloo group, the coordinated preemption snapshot (SIGTERM and
``preempt_deadline``, one rank and two), and the ``ckpt_enospc`` and
``rendezvous_fail`` fault sites.

The consensus views, ``epoch_coordinator``/``detect_launch`` and the
rendezvous retry counts are held equal to the reference's on the same
scripted inputs; the snapshot and peer-restore runs are the port's tiny
fp32 LM on the CPU, held bit-equal to an uninterrupted run (one rank) or
within 1e-5 of a one-rank run (two ranks)."""

import dataclasses
import json
import os
import signal
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist.obs import faults as ref_faults  # noqa: E402
from tpu_dist.parallel import consensus as ref_consensus  # noqa: E402
from tpu_dist.parallel import launch as ref_launch  # noqa: E402

from tpu_dist_torch.configs import LMConfig  # noqa: E402
from tpu_dist_torch.engine import checkpoint as ckpt  # noqa: E402
from tpu_dist_torch.engine.lm_loop import LMTrainer  # noqa: E402
from tpu_dist_torch.obs import faults  # noqa: E402
from tpu_dist_torch.obs.ledger import read_ledger  # noqa: E402
from tpu_dist_torch.parallel import consensus, launch  # noqa: E402
from tpu_dist_torch.parallel.supervisor import (  # noqa: E402
    PREEMPT_SNAPSHOT_RC, latest_checkpoint)

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# 16 train rows of L+1 = 33 tokens: 4 steps an epoch at batch 4
TINY = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2,
            seq_len=32, batch_size=4, synth_tokens=660, val_frac=0.2,
            precision="fp32", optimizer="adamw", lr=3e-3, print_freq=1,
            seed=0)


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    """Both packages' fault plans are process-global."""
    for k in ("TPU_DIST_FAULTS", "TPU_DIST_ATTEMPT", "TPU_DIST_PEER_RESUME",
              "TPU_DIST_HEARTBEAT_FILE", "TPU_DIST_MESH_EPOCH"):
        monkeypatch.delenv(k, raising=False)
    faults._reset_for_tests()
    ref_faults._reset_for_tests()
    yield
    faults._reset_for_tests()
    ref_faults._reset_for_tests()


def _losses(path):
    return {r["step"]: r["loss"] for r in read_ledger(path, validate=False)
            if r["event"] == "step"}


# ---------------------------------------------------------------------------
# consensus: the same scripted membership through both packages

def _script(mod, tmp, planned, lease_s, ops):
    """Run ``ops`` (a list of (op, host[, dt])) against ``mod``'s
    ConsensusDir under a virtual clock; returns the views resolved."""
    now = [1000.0]
    hosts = {h: mod.ConsensusDir(tmp, h, planned=planned, lease_s=lease_s,
                                 now=lambda: now[0])
             for h in range(planned)}
    views = []
    for op in ops:
        kind, h = op[0], op[1]
        if kind == "register":
            hosts[h].register()
        elif kind == "leave":
            hosts[h].leave()
        elif kind == "tick":
            now[0] += h
        elif kind == "install":
            (faults if mod is consensus else ref_faults).install(h)
        else:
            v = hosts[h].resolve(heartbeat=(kind == "resolve"))
            views.append((v.epoch, v.hosts, v.planned, v.degraded,
                          [v.process_id(x) for x in v.hosts]))
    return views


SEQUENCES = {
    "initial": (3, [("register", 0), ("register", 1), ("register", 2),
                    ("resolve", 0), ("resolve", 1), ("resolve", 2)]),
    "mid_loss": (3, [("register", 0), ("register", 1), ("register", 2),
                     ("resolve", 0), ("leave", 1), ("resolve", 0),
                     ("resolve", 2)]),
    "return": (3, [("register", 0), ("register", 1), ("register", 2),
                   ("resolve", 0), ("leave", 1), ("resolve", 2),
                   ("register", 1), ("resolve", 0), ("resolve", 1)]),
    "lease": (4, [("register", 0), ("register", 1), ("register", 2),
                  ("register", 3), ("resolve", 0), ("tick", 10.0),
                  ("register", 0), ("register", 3), ("resolve", 0),
                  ("tick", 2.0), ("register", 2), ("resolve", 3)]),
    "host_return": (3, [("register", 0), ("register", 1), ("register", 2),
                        ("resolve", 0), ("leave", 1), ("leave", 2),
                        ("resolve", 0), ("install", "host_return@nth=1"),
                        ("resolve", 0)]),
    "host_return_one": (3, [("register", 0), ("register", 1),
                            ("register", 2), ("resolve", 0), ("leave", 1),
                            ("leave", 2), ("resolve", 0),
                            ("install", "host_return@host=2"),
                            ("resolve", 0), ("peek", 0)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_consensus_views_equal_the_reference(tmp_path, name):
    planned, ops = SEQUENCES[name]
    got = _script(consensus, str(tmp_path / "port"), planned, 5.0, ops)
    want = _script(ref_consensus, str(tmp_path / "ref"), planned, 5.0, ops)
    assert got == want
    assert len(got) >= 2
    env = {"TPU_DIST_NUM_PROCESSES": str(planned),
           "TPU_DIST_PROCESS_ID": "2", "TPU_DIST_DEGRADED": "1"}
    last = got[-1]
    for h in last[1]:
        view = consensus.MeshView(last[0], tuple(last[1]), planned)
        rview = ref_consensus.MeshView(last[0], tuple(last[1]), planned)
        assert consensus.consensus_env(env, view, h) == \
            ref_consensus.consensus_env(env, rview, h)
    assert consensus.successor_hosts([3, 1], [1, 3, 0]) == \
        ref_consensus.successor_hosts([3, 1], [1, 3, 0]) == [3, 1, 0]


@pytest.mark.parametrize("coord,epoch", [
    ("10.0.0.1:8476", 0), ("10.0.0.1:8476", 3), ("[::1]:8476", 2),
    ("not-a-port", 2), ("", 2)])
def test_epoch_coordinator_equals_the_reference(coord, epoch):
    assert launch.epoch_coordinator(coord, epoch) == \
        ref_launch.epoch_coordinator(coord, epoch)


@pytest.mark.parametrize("env", [
    {"TPU_DIST_COORDINATOR": "127.0.0.1:9000", "TPU_DIST_NUM_PROCESSES": "2",
     "TPU_DIST_PROCESS_ID": "1", "TPU_DIST_MESH_EPOCH": "2"},
    {"SLURM_PROCID": "3", "SLURM_NPROCS": "4",
     "SLURM_JOB_NODELIST": "node[1-4]"},
    {"SLURM_PROCID": "3", "SLURM_NPROCS": "4",
     "SLURM_JOB_NODELIST": "node[1-4]", "TPU_DIST_NUM_PROCESSES": "3",
     "TPU_DIST_PROCESS_ID": "2", "TPU_DIST_MESH_EPOCH": "1"}],
    ids=["env_epoch", "slurm", "slurm_consensus_override"])
def test_detect_launch_honours_the_overrides(monkeypatch, env):
    for k in list(os.environ):
        if k.startswith(("TPU_DIST_", "SLURM_")):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = launch.detect_launch(), ref_launch.detect_launch()
    assert (got.coordinator, got.num_processes, got.process_id,
            got.method) == (want.coordinator, want.num_processes,
                            want.process_id, want.method)


# ---------------------------------------------------------------------------
# fault sites: rendezvous_fail and ckpt_enospc

@pytest.mark.parametrize("spec,retries", [
    ("rendezvous_fail@times=2", 5), ("rendezvous_fail@times=5", 3),
    ("rendezvous_fail@nth=2", 4), ("", 2)])
def test_rendezvous_fail_site_fails_the_first_tries(spec, retries):
    """The first ``times=K`` tries raise ``ConnectionError`` before the
    join; the attempt counts (and the exhaustion) equal the reference's."""
    def run(mod, fmod):
        fmod.install(spec)
        calls = []
        info = mod.LaunchInfo("127.0.0.1:1", 2, 0, "env")
        try:
            used = mod.rendezvous_with_retry(
                lambda: calls.append(1), info, retries=retries,
                timeout_s=60.0, backoff_s=0.0, sleep=lambda s: None)
        except RuntimeError as e:
            assert "rendezvous failed" in str(e)
            used = "exhausted"
        fmod._reset_for_tests()
        return used, len(calls)

    assert run(launch, faults) == run(ref_launch, ref_faults)


def _tiny_state(seed):
    from tpu_dist_torch.engine.state import TrainState
    from tpu_dist_torch.ops.optim import make_optimizer

    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Linear(4, 3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return TrainState.create(model, make_optimizer(0.1, 0.9, 0.0))


@pytest.mark.parametrize("async_write", [False, True])
def test_ckpt_enospc_leaves_the_previous_checkpoint_valid(tmp_path,
                                                          async_write):
    d = str(tmp_path)
    st = _tiny_state(0)
    st.step = 3
    ckpt.save_checkpoint(d, st, 1, 0.0, "lm", False, keep=2)
    with open(os.path.join(d, "lm-checkpoint.index.json")) as f:
        index = json.load(f)
    faults.install("ckpt_enospc@nth=1")
    st.step = 7
    with torch.no_grad():
        st.params[0].add_(1.0)
    if async_write:
        ckpt.save_checkpoint(d, st, 2, 0.0, "lm", False, keep=2,
                             async_write=True)
        with pytest.raises(RuntimeError, match="async checkpoint") as e:
            ckpt.wait_for_async_save(d)
        err = e.value.__cause__
    else:
        with pytest.raises(OSError) as e:
            ckpt.save_checkpoint(d, st, 2, 0.0, "lm", False, keep=2)
        err = e.value
    assert isinstance(err, OSError) and "injected" in str(err)
    with open(os.path.join(d, "lm-checkpoint.index.json")) as f:
        assert json.load(f) == index          # the pointer did not move
    newest = latest_checkpoint(d)
    assert newest == os.path.join(d, "lm-checkpoint.pt")
    fresh = _tiny_state(1)
    ckpt.load_checkpoint(newest, fresh)
    assert fresh.step == 3
    assert torch.equal(fresh.params[0], _tiny_state(0).params[0])
    # the site fired once: the next write lands
    ckpt.save_checkpoint(d, st, 2, 0.0, "lm", False, keep=2)
    assert ckpt.read_checkpoint_meta(newest)["step"] == 7


# ---------------------------------------------------------------------------
# the coordinated preemption snapshot, one process

def _fit_losses(cfg):
    tr = LMTrainer(cfg, device="cpu")
    tr.fit()
    return tr, _losses(cfg.ledger_path)


@pytest.mark.parametrize("site", ["preempt_sigterm", "preempt_deadline"])
def test_preemption_snapshot_resumes_the_exact_step(tmp_path, site):
    """A SIGTERM (the real signal, sent by the fault site to this process:
    the handler only sets a flag) or the advance notice at step 6 makes
    the loop snapshot at that step boundary and exit 75; the resumed run
    starts at step 6 and its losses are bit-equal to an uninterrupted
    run's."""
    base = LMConfig(**TINY, epochs=3)
    _, want = _fit_losses(dataclasses.replace(
        base, ledger_path=str(tmp_path / "a.jsonl")))
    ck = str(tmp_path / "ck")
    cfg = dataclasses.replace(base, ledger_path=str(tmp_path / "b.jsonl"),
                              checkpoint_dir=ck, faults=f"{site}@step=6")
    prev = signal.getsignal(signal.SIGTERM)
    tr = LMTrainer(cfg, device="cpu")
    with pytest.raises(SystemExit) as e:
        tr.fit()
    assert e.value.code == PREEMPT_SNAPSHOT_RC
    assert signal.getsignal(signal.SIGTERM) is prev   # the guard disarmed
    recs = read_ledger(cfg.ledger_path, validate=False)
    end = recs[-1]
    assert end["event"] == "run_end" and end["status"] == "preempted"
    assert end["snapshot_step"] == 6
    assert [r["action"] for r in recs if r["event"] == "scale"] == \
        ["preempt_snapshot"]
    assert any(r["event"] == "ckpt" and r.get("preempt") for r in recs)
    assert [r["site"] for r in recs if r["event"] == "fault"] == [site]
    meta = ckpt.read_checkpoint_meta(latest_checkpoint(ck))
    assert meta["step"] == 6 and meta["preempt"] and meta["mid_epoch"]
    faults._reset_for_tests()
    resumed = dataclasses.replace(
        base, ledger_path=str(tmp_path / "b.jsonl"), attempt=-1,
        checkpoint_dir=ck, resume=latest_checkpoint(ck))
    tr2, _ = _fit_losses(resumed)
    got = _losses(cfg.ledger_path)
    after = _losses(str(tmp_path / "b.a1.jsonl"))
    assert min(after) == 6
    got.update(after)
    assert got == want                         # bit-equal, every step


# ---------------------------------------------------------------------------
# two ranks: peer restore and one decision for every rank

def _group(tmp_path, jobs, world=2):
    from torch_dp_worker import run_group

    return run_group(world, {"jobs": jobs}, str(tmp_path / "group"),
                     timeout=240)


def test_two_ranks_peer_restore_and_agreed_preemption(tmp_path):
    """One gloo group of two ranks, spawned once:
    (a) rank 0 resumes a step-5 checkpoint, rank 1 has none (a fresh
        init at step 0, as a returning host has; the seed also picks the
        synthetic corpus and the sampler's order, so the ranks keep one
        seed); under ``TPU_DIST_PEER_RESUME=1`` rank 1 adopts rank 0's
        state exactly (params and step), both emit ``scale
        action=peer_restore``, and the run's losses equal a one-rank run
        resumed from the same checkpoint within 1e-5;
    (b) ``preempt_deadline`` on rank 1 alone at step 6 (print_freq 2, so
        not a drain boundary): both ranks snapshot at step 7, the first
        boundary after it, and exit 75."""
    ck = str(tmp_path / "ck")
    one = LMConfig(**TINY, epochs=2, checkpoint_dir=ck,
                   ledger_path=str(tmp_path / "one.jsonl"),
                   faults="preempt_deadline@step=5")
    with pytest.raises(SystemExit):
        LMTrainer(one, device="cpu").fit()
    src = latest_checkpoint(ck)
    assert ckpt.read_checkpoint_meta(src)["step"] == 5
    faults._reset_for_tests()
    tail = dataclasses.replace(one, faults="", checkpoint_dir="",
                               resume=src,
                               ledger_path=str(tmp_path / "tail.jsonl"))
    _, want = _fit_losses(tail)
    cfg = {k: v for k, v in TINY.items() if k != "seed"}
    res = _group(tmp_path, [
        {"kind": "restart", "name": "peer", "peer": True, "seeds": [0, 0],
         "resume": {"0": src}, "cfg": dict(cfg, epochs=2)},
        {"kind": "restart", "name": "agree", "seeds": [0, 0],
         "faults": {"1": "preempt_deadline@step=6"},
         "cfg": dict(cfg, epochs=2, print_freq=2,
                     checkpoint_dir="ck-agree")}])
    p0, p1 = res[0]["peer"], res[1]["peer"]
    assert p0["step0"] == p1["step0"] == 5
    assert p0["digest0"] == p1["digest0"]
    assert p0["code"] == p1["code"] == 0
    for r in (p0, p1):
        assert [s["action"] for s in r["scale"]] == ["peer_restore"]
    assert p0["losses"] == p1["losses"]       # the group's summed losses
    got = {int(k): v for k, v in p0["losses"].items()}
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [want[k] for k in sorted(want)],
                               rtol=1e-5, atol=1e-5)
    a0, a1 = res[0]["agree"], res[1]["agree"]
    assert a0["code"] == a1["code"] == PREEMPT_SNAPSHOT_RC
    assert a0["run_end"]["snapshot_step"] == \
        a1["run_end"]["snapshot_step"] == 7
    assert a0["step"] == a1["step"] == 7
    assert a0["digest"] == a1["digest"]
    meta = ckpt.read_checkpoint_meta(
        latest_checkpoint(str(tmp_path / "group" / "ck-agree")))
    assert meta["step"] == 7 and meta["preempt"]


def test_peer_restore_is_a_no_op_on_one_process():
    st = _tiny_state(0)
    before = [p.clone() for p in st.params]
    out, did = ckpt.peer_restore_state(st)
    assert out is st and not did
    assert all(torch.equal(a, b) for a, b in zip(before, st.params))
    # the injected exchange's seam: every tensor and the step go through
    calls = []

    def fake(tensors):
        calls.append(len(tensors))
        return [torch.full_like(t, 42) for t in tensors]

    out, did = ckpt.peer_restore_state(st, broadcast=fake)
    assert did and out.step == 42
    assert calls == [1 + len(st.params) + len(st.opt_tensors())]
    assert all(bool((p == 42).all()) for p in st.params)
