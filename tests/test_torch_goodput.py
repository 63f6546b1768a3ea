"""The port's run lineage and observers against the JAX package's:
``obs/goodput.py`` (attempt naming, ``GoodputAccumulator``,
``job_accounting`` with its ``restart_gap``, the ``GoodputMonitor``
sink), ``obs/watchdog.py`` (one ``stall`` event a stall, the reference's
fields) and ``RunObs`` as both trainers build it (``attempt``, ``job_id``,
the heartbeat file, the refusals that name ROADMAP item 6)."""

import io
import json
import os
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist.obs import goodput as ref_goodput  # noqa: E402
from tpu_dist.obs import watchdog as ref_watchdog  # noqa: E402
from tpu_dist.obs.ledger import Ledger as RefLedger  # noqa: E402

from tpu_dist_torch.configs import LMConfig, TrainConfig  # noqa: E402
from tpu_dist_torch.engine.lm_loop import LMTrainer  # noqa: E402
from tpu_dist_torch.engine.loop import Trainer  # noqa: E402
from tpu_dist_torch.obs import faults, goodput, watchdog  # noqa: E402
from tpu_dist_torch.obs.ledger import Ledger, read_ledger  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2,
            seq_len=32, batch_size=4, synth_tokens=660, val_frac=0.2,
            precision="fp32", optimizer="adamw", lr=3e-3, print_freq=1,
            seed=0)
TINY_IMAGE = dict(arch="lenet", dataset="mnist", batch_size=16,
                  synth_train_size=32, synth_val_size=16, epochs=1,
                  precision="fp32", print_freq=1, seed=0, workers=0)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("TPU_DIST_FAULTS", "TPU_DIST_ATTEMPT",
              "TPU_DIST_HEARTBEAT_FILE", "TPU_DIST_PEER_RESUME"):
        monkeypatch.delenv(k, raising=False)
    faults._reset_for_tests()
    yield
    faults._reset_for_tests()


# ---------------------------------------------------------------------------
# attempt naming

@pytest.mark.parametrize("path,attempt", [
    ("run.jsonl", 0), ("run.jsonl", 2), ("/x/y/run.jsonl", 11),
    ("run", 3), ("", 4), ("a.b.jsonl", 1)])
def test_attempt_path_and_sibling_equal_the_reference(path, attempt):
    got = goodput.attempt_path(path, attempt)
    assert got == ref_goodput.attempt_path(path, attempt)
    if path:
        assert goodput.sup_sibling_path(got) == \
            ref_goodput.sup_sibling_path(got)


def test_next_attempt_index_and_discovery_equal_the_reference(tmp_path):
    base = str(tmp_path / "run.jsonl")

    def both(pidx=0):
        got = goodput.next_attempt_index(base, pidx)
        assert got == ref_goodput.next_attempt_index(base, pidx)
        assert goodput.discover_attempt_paths(base) == \
            ref_goodput.discover_attempt_paths(base)
        return got

    assert both() == 0 and both(1) == 0
    for name, want0, want1 in (("run.jsonl", 1, 0), ("run.p1.jsonl", 1, 1),
                               ("run.a1.jsonl", 2, 1),
                               ("run.a3.jsonl", 4, 1),
                               ("run.a1.p1.jsonl", 4, 2),
                               ("run.a2x.jsonl", 4, 2)):
        open(str(tmp_path / name), "w").close()
        assert (both(0), both(1)) == (want0, want1)
    assert goodput.discover_attempt_paths(str(tmp_path / "run.a3.jsonl")) \
        == [base, str(tmp_path / "run.a1.jsonl"),
            str(tmp_path / "run.a3.jsonl")]


# ---------------------------------------------------------------------------
# the accounting, on records drawn from a numpy seed

def _attempt(rng, t0, attempt, end=True):
    recs = [{"event": "run_start", "ts": t0, "pid": 0, "kind": "lm",
             "config": {}, "mesh": None, "devices": ["cpu"],
             "process_count": 1, "job_id": "run", "attempt": attempt}]
    t = t0 + float(rng.uniform(0.5, 3.0))
    if rng.random() < 0.7:
        recs.append({"event": "compile", "ts": t, "pid": 0,
                     "program": "train_step"})
    step = 0
    for i in range(int(rng.integers(3, 9))):
        k = int(rng.integers(1, 5))
        d, p, v = (float(x) for x in rng.uniform(0.0, 0.6, 3))
        t += d + p + v + float(rng.uniform(0.0, 0.2))
        recs.append({"event": "step", "ts": t, "pid": 0, "step": step,
                     "loss": 2.0 / (1 + i), "throughput": 1000.0,
                     "unit": "tok/s", "data_s": d, "dispatch_s": p,
                     "device_s": v, "comm_s": None, "mfu": None,
                     "steps_in_dispatch": k, "warm": i == 0})
        step += k
        u = rng.random()
        if u < 0.15:
            t += 0.01
            recs.append({"event": "health", "ts": t, "pid": 0, "step": step,
                         "kind": "nonfinite", "policy": "skip",
                         "action": "skip", "value": 1.0})
        elif u < 0.3:
            t += float(rng.uniform(0.1, 1.0))
            recs.append({"event": "stall", "ts": t, "pid": 0,
                         "idle_s": float(rng.uniform(0.1, 1.5)),
                         "threshold_s": 1.0, "stacks": ""})
        elif u < 0.45:
            t += 0.5
            recs.append({"event": "eval", "ts": t, "pid": 0, "epoch": i,
                         "loss": 1.0, **({"seconds": 0.3}
                                         if rng.random() < 0.5 else {})})
            t += 0.2
            recs.append({"event": "ckpt", "ts": t, "pid": 0, "epoch": i,
                         "path": "ck", "is_best": False,
                         **({"seconds": 0.1} if rng.random() < 0.5
                            else {})})
    if end:
        t += 0.1
        recs.append({"event": "run_end", "ts": t, "pid": 0, "steps": step,
                     "seconds": t - t0,
                     "status": "ok" if rng.random() < 0.5 else "crashed"})
    return recs, t


@pytest.mark.parametrize("seed", range(6))
def test_accounting_and_job_accounting_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    attempts, t = [], 100.0
    for a in range(int(rng.integers(1, 4))):
        recs, t = _attempt(rng, t + float(rng.uniform(0.0, 5.0)), a,
                           end=rng.random() < 0.7)
        attempts.append(recs)
    for recs in attempts:
        assert goodput.accounting(recs) == ref_goodput.accounting(recs)
    flat = [r for recs in attempts for r in recs]
    split = goodput.split_attempts(flat)
    assert split == ref_goodput.split_attempts(flat)
    got = goodput.job_accounting(split)
    assert got == ref_goodput.job_accounting(split)
    assert set(got["categories"]) == set(goodput.CATEGORIES)
    if len(attempts) > 1:
        assert got["categories"]["restart_gap"] > 0
    explained = got["goodput_s"] + sum(got["categories"].values())
    assert explained == pytest.approx(got["wall_s"] + got["overrun_s"],
                                      abs=1e-4)


def test_goodput_monitor_events_equal_the_reference(monkeypatch):
    """The monitor as a ledger sink: the same periodic and final
    ``goodput`` events from the same stream (the final one at a pinned
    clock)."""
    rng = np.random.default_rng(7)
    recs, _ = _attempt(rng, 1000.0, 0, end=False)
    out = {}
    for name, L, G in (("port", Ledger, goodput), ("ref", RefLedger,
                                                   ref_goodput)):
        got = []
        led = L(None, sinks=(got.append,))
        mon = G.GoodputMonitor(led, every_s=1.0, unit="tok/s")
        for r in recs:
            mon.sink(r)
        with monkeypatch.context() as m:
            m.setattr(time, "time", lambda: recs[-1]["ts"] + 1.0)
            mon.emit_goodput(final=True)
        out[name] = [{k: v for k, v in e.items() if k not in ("ts", "pid")}
                     for e in got]
    assert out["port"] == out["ref"]
    assert out["port"][-1]["final"] is True
    assert sum(not e["final"] for e in out["port"]) >= 1


# ---------------------------------------------------------------------------
# the watchdog

def test_watchdog_one_stall_event_a_stall_with_the_reference_fields():
    """A scripted hang (no step completes) under a small floor: each
    package's watchdog dumps once a stall, and again after a re-arm, with
    the same ``stall`` event keys; a paused one stays silent."""
    keys = {}
    for name, L, W in (("port", Ledger, watchdog), ("ref", RefLedger,
                                                    ref_watchdog)):
        got = []
        led = L(None, sinks=(got.append,))
        wd = W.Watchdog(factor=2.0, ledger=led, min_timeout_s=0.05,
                        poll_s=0.02, stream=io.StringIO())
        for _ in range(5):
            wd.step_done(0.02)
        time.sleep(0.4)
        assert wd.stall_count == 1, name
        wd.step_done(0.02)
        time.sleep(0.2)
        assert wd.stall_count == 2, name
        wd.pause()
        time.sleep(0.2)
        assert wd.stall_count == 2, name
        wd.stop()
        stalls = [e for e in got if e["event"] == "stall"]
        assert len(stalls) == 2
        assert stalls[0]["idle_s"] >= 0.05
        assert stalls[0]["threshold_s"] == pytest.approx(0.05)
        assert "--- thread" in stalls[0]["stacks"]
        keys[name] = set(stalls[0])
    assert keys["port"] == keys["ref"]
    with pytest.raises(ValueError):
        watchdog.Watchdog(factor=0)


def test_watchdog_beat_arms_then_derives_durations():
    wd = watchdog.Watchdog(factor=10.0, poll_s=10.0)
    wd.beat()                      # arms only
    assert list(wd._durations) == []
    time.sleep(0.02)
    wd.beat()
    assert len(wd._durations) == 1 and wd._durations[0] >= 0.02
    wd.pause()
    wd.beat()                      # right after a pause: re-arms only
    assert len(wd._durations) == 1
    wd.stop()
    assert watchdog.device_memory_stats() == {} or \
        torch.cuda.is_available()


# ---------------------------------------------------------------------------
# RunObs as the trainers build it

def test_lm_trainer_attempt_and_job_id_name_the_ledger(tmp_path):
    """``attempt=2`` writes ``run.a2.jsonl`` (the reference's naming), its
    ``run_start`` carries ``job_id``/``attempt``, the run ends with a final
    ``goodput`` event, the watchdog is on by default, and the heartbeat
    file is touched at the drains."""
    base = str(tmp_path / "run.jsonl")
    hb = str(tmp_path / "hb")
    os.environ["TPU_DIST_HEARTBEAT_FILE"] = hb
    try:
        tr = LMTrainer(LMConfig(**TINY, max_steps=3, attempt=2,
                                job_id="job7", ledger_path=base),
                       device="cpu")
    finally:
        del os.environ["TPU_DIST_HEARTBEAT_FILE"]
    assert tr.obs.watchdog is not None and tr.obs.attempt == 2
    tr.fit()
    assert not os.path.exists(base)
    recs = read_ledger(str(tmp_path / "run.a2.jsonl"))
    start = recs[0]
    assert start["event"] == "run_start"
    assert (start["job_id"], start["attempt"], start["mode"]) == \
        ("job7", 2, "dp")
    # the final goodput, then the metrics registry's snapshot (the
    # reference's order, tpu_dist/obs/__init__.py:322-332)
    assert [r["event"] for r in recs[-3:]] == ["goodput", "metrics_snapshot",
                                               "run_end"]
    assert recs[-3]["final"] is True and recs[-1]["status"] == "ok"
    assert recs[-1]["steps"] == 3
    with open(hb) as f:
        assert float(f.read()) > 0
    # attempt=-1 probes this process's files: after a bare attempt 0 and
    # attempt 2 the next free ordinal is 3
    open(base, "w").close()
    assert ref_goodput.next_attempt_index(base, 0) == 3
    tr = LMTrainer(LMConfig(**TINY, max_steps=1, attempt=-1,
                            ledger_path=base, watchdog_factor=0.0),
                   device="cpu")
    assert tr.obs.attempt == 3 and tr.obs.watchdog is None
    assert tr.obs.job_id == "run"
    assert tr.obs.ledger_path == str(tmp_path / "run.a3.jsonl")


@pytest.mark.parametrize("mode", ["record", "x"])
def test_image_trainer_audit_knob_takes_effect(tmp_path, mode):
    """The image ``Trainer``'s ``audit`` knob: ``record`` emits one clean
    ``audit`` event for ``train_step`` into the attempt's ledger; an
    unknown mode raises ValueError naming the modes."""
    base = str(tmp_path / "run.jsonl")
    cfg = TrainConfig(**TINY_IMAGE, attempt=1, audit=mode, ledger_path=base,
                      checkpoint_dir="")
    if mode == "x":
        with pytest.raises(ValueError, match="'none', 'record', 'halt'"):
            Trainer(cfg, device="cpu")
        return
    Trainer(cfg, device="cpu").fit()
    recs = read_ledger(str(tmp_path / "run.a1.jsonl"))
    audits = [r for r in recs if r["event"] == "audit"]
    assert [(a["program"], a["mode"], a["findings"]) for a in audits] == \
        [("train_step", "record", 0)]


def test_image_trainer_attempt_job_id_and_faults_take_effect(tmp_path):
    """The image ``Trainer``'s ``attempt``/``job_id``/``faults`` knobs:
    ``run.a1.jsonl``, the lineage in ``run_start``, and a ``nan_batch``
    that the ``halt`` policy turns into a ``HealthError`` with the
    ``fault`` and ``health`` events on the record."""
    from tpu_dist_torch.obs.health import HealthError

    base = str(tmp_path / "run.jsonl")
    tr = Trainer(TrainConfig(**TINY_IMAGE, attempt=1, job_id="img",
                             ledger_path=base, health="halt",
                             faults="nan_batch@step=1"), device="cpu")
    with pytest.raises(HealthError):
        tr.fit()
    recs = read_ledger(str(tmp_path / "run.a1.jsonl"))
    assert (recs[0]["job_id"], recs[0]["attempt"]) == ("img", 1)
    events = [r["event"] for r in recs]
    assert "fault" in events and "health" in events
    end = recs[-1]
    assert end["status"] == "crashed" and "HealthError" in end["error"]
    fault = recs[events.index("fault")]
    assert (fault["site"], fault["step"], fault["attempt"]) == \
        ("nan_batch", 1, 1)
    assert json.dumps(end)
