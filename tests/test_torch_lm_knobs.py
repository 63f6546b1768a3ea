"""The LM trainer's one-device knobs in the port, on CPU: windowed dispatch
over device-resident rows, gradient accumulation, checkpoints with
step-exact mid-epoch resume, the geometry checks, and the warm start.

* the windowed path (K steps per window, rows gathered and shifted on the
  device) equals the per-batch host path: fp32 params within 1e-5
  relative (in practice bit-equal: the same operations in the same order),
  and follows the JAX trainer's windowed path from the same initial params
  (window losses within 1e-5 relative, the fp32 summation order of two
  libraries);
* accumulation over K equal microbatches equals one step over the full
  batch (fp32, 1e-5 relative: the mean of per-microbatch means is the
  full-batch mean up to summation order) and follows the JAX trainer's
  accumulation step;
* an interrupted run resumed from its mid-epoch checkpoint equals an
  uninterrupted one exactly (the reference's
  ``tests/test_lm_loop.py:130-159``), AdamW moments and the warmup+cosine
  schedule's position included;
* a hard geometry mismatch fails before any state loads; the soft keys
  bind only a mid-epoch checkpoint;
* the warm start grafts every leaf whose name and shape match, exactly,
  over a fresh optimizer at step 0."""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist.configs import LMConfig as JaxLMConfig  # noqa: E402
from tpu_dist.engine.lm_loop import LMTrainer as JaxLMTrainer  # noqa: E402
from tpu_dist_torch.configs import LMConfig  # noqa: E402
from tpu_dist_torch.engine import lm_loop  # noqa: E402
from tpu_dist_torch.engine.lm_loop import LMTrainer  # noqa: E402

torch.set_num_threads(1)

TINY = dict(batch_size=8, seq_len=32, d_model=32, num_layers=2, num_heads=2,
            vocab_size=64, synth_tokens=3000, seed=3, print_freq=100,
            epochs=1, lr=1e-2)
WIN = dict(steps_per_dispatch=4, data_placement="device")


def _vec(tr):
    return torch.cat([p.detach().flatten() for p in tr.state.params]).numpy()


def _steps(path):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["event"] == "step"]


def _ref(cfg):
    """The JAX trainer on one device (the port's geometry)."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    return JaxLMTrainer(cfg, mesh=mesh)


def _fit(cfg, **kw):
    tr = LMTrainer(cfg, device="cpu", **kw)
    tr.fit()
    return tr


# ---- windows -------------------------------------------------------------

def test_windowed_equals_per_batch_across_epochs(tmp_path):
    kw = dict(TINY, epochs=2)
    host = _fit(LMConfig(**kw))
    win = _fit(LMConfig(ledger_path=str(tmp_path / "w.jsonl"), **WIN, **kw))
    assert win.device_data and win._train_rows_dev.device.type == "cpu"
    assert host.state.step == win.state.step == 2 * win.steps_per_epoch
    np.testing.assert_allclose(_vec(win), _vec(host), rtol=1e-5, atol=0)
    assert win.best_ppl == pytest.approx(host.best_ppl, rel=1e-5)
    nb = win.steps_per_epoch
    recs = _steps(tmp_path / "w.jsonl")
    assert [r["steps_in_dispatch"] for r in recs] == (
        [4] * (nb // 4) + ([nb % 4] if nb % 4 else [])) * 2


def test_windowed_matches_reference_trainer(tmp_path):
    kw = dict(TINY, max_steps=6, print_freq=1, **WIN)
    ref = _ref(JaxLMConfig(ledger_path=str(tmp_path / "j.jsonl"), **kw))
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(ref.state.params))
    ref.fit()
    port = _fit(LMConfig(ledger_path=str(tmp_path / "t.jsonl"), **kw),
                init_params=init)
    got, want = _steps(tmp_path / "t.jsonl"), _steps(tmp_path / "j.jsonl")
    # max_steps lands mid-window: the second window is clipped to 2 steps
    assert [r["steps_in_dispatch"] for r in got] == [4, 2]
    assert port.state.step == int(jax.device_get(ref.state.step)) == 6
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], rtol=1e-5)
    assert port.best_ppl == pytest.approx(ref.best_ppl, rel=1e-5)


def test_auto_placement_follows_the_size_rule(monkeypatch):
    assert LMTrainer(LMConfig(**TINY, steps_per_dispatch=2),
                     device="cpu").device_data
    assert not LMTrainer(LMConfig(**TINY), device="cpu").device_data
    monkeypatch.setenv("TPU_DIST_DEVICE_DATA_MAX", "1")
    with pytest.raises(ValueError, match="device-resident row path"):
        LMTrainer(LMConfig(**TINY, steps_per_dispatch=2), device="cpu")


# ---- gradient accumulation ----------------------------------------------

def test_accum_equals_full_batch():
    kw = dict(TINY, max_steps=3, optimizer="sgd")
    full = _fit(LMConfig(**kw))
    acc = _fit(LMConfig(grad_accum_steps=4, **kw))
    assert acc.state.step == 3
    np.testing.assert_allclose(_vec(acc), _vec(full), rtol=1e-5, atol=1e-6)


def test_accum_matches_reference_trainer(tmp_path):
    kw = dict(TINY, max_steps=3, print_freq=1, grad_accum_steps=2,
              loss_chunk=100)
    ref = _ref(JaxLMConfig(ledger_path=str(tmp_path / "j.jsonl"), **kw))
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(ref.state.params))
    ref.fit()
    _fit(LMConfig(ledger_path=str(tmp_path / "t.jsonl"), **kw),
         init_params=init)
    got, want = _steps(tmp_path / "t.jsonl"), _steps(tmp_path / "j.jsonl")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], rtol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(grad_accum_steps=2, steps_per_dispatch=2), "mutually exclusive"),
    (dict(grad_accum_steps=2, data_placement="device"), "data_placement"),
    (dict(grad_accum_steps=3), "not divisible"),
    (dict(grad_accum_steps=0), "grad_accum_steps must be"),
    (dict(steps_per_dispatch=2, data_placement="host"), "device-resident"),
    (dict(data_placement="hbm"), "unknown data_placement"),
    (dict(attn="ring"), "unknown attn"),
])
def test_knob_exclusions_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        LMTrainer(LMConfig(**{**TINY, **kw}), device="cpu")


# ---- checkpoints and resume ----------------------------------------------

SCHED = dict(optimizer="fused_adamw", lr=3e-3, lr_schedule="cosine",
             warmup_steps=3, grad_clip=0.5)


def _interrupted(cfg, windows: int):
    """Fit ``cfg`` with the window step raising KeyboardInterrupt on its
    ``windows + 1``-th call (the reference test's cut)."""
    tr = LMTrainer(cfg, device="cpu")
    real, calls = tr.window_step, {"n": 0}

    def limited(*a, **k):
        if calls["n"] == windows:
            raise KeyboardInterrupt
        calls["n"] += 1
        return real(*a, **k)

    tr.window_step = limited
    with pytest.raises(KeyboardInterrupt):
        tr.fit()
    return tr


def test_mid_epoch_resume_is_step_exact(tmp_path):
    kw = dict(TINY, epochs=2, steps_per_dispatch=2, **SCHED)
    full = _fit(LMConfig(checkpoint_dir=str(tmp_path / "full"), **kw))
    cut = _interrupted(LMConfig(checkpoint_dir=str(tmp_path / "int"), **kw),
                       windows=2)
    assert cut.state.step == 4
    ck = str(tmp_path / "int" / "lm-checkpoint.pt")
    res = LMTrainer(LMConfig(checkpoint_dir=str(tmp_path / "res"),
                             resume=ck, **kw), device="cpu")
    assert (res.start_epoch, res._skip_batches, res.state.step) == (0, 4, 4)
    res.fit()
    assert res.state.step == full.state.step == 2 * full.steps_per_epoch
    np.testing.assert_array_equal(_vec(res), _vec(full))
    for a, b in zip(res.state.opt_tensors(), full.state.opt_tensors()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_epoch_checkpoint_meta_and_resume(tmp_path):
    d = str(tmp_path / "ck")
    tr = _fit(LMConfig(checkpoint_dir=d, keep_checkpoints=1,
                       **{**TINY, "epochs": 2}))
    from tpu_dist_torch.engine import checkpoint as ckpt

    meta = ckpt.read_checkpoint_meta(os.path.join(d, "lm-checkpoint.pt"))
    assert (meta["arch"], meta["epoch"], meta["step"]) == (
        "lm", 2, tr.state.step)
    assert meta["best_ppl"] == pytest.approx(tr.best_ppl)
    assert {k: meta[k] for k in lm_loop.HARD_GEOMETRY} == {
        k: tr._run_meta[k] for k in lm_loop.HARD_GEOMETRY}
    assert "mid_epoch" not in meta
    assert os.path.isfile(os.path.join(d, "lm-model_best.pt"))
    assert len(ckpt.retained_checkpoints(
        os.path.join(d, "lm-checkpoint.pt"))) == 1
    # an end-of-epoch checkpoint resumes at the next epoch, skipping nothing
    res = LMTrainer(LMConfig(resume=os.path.join(d, "lm-checkpoint.pt"),
                             **{**TINY, "epochs": 3}), device="cpu")
    assert (res.start_epoch, res._skip_batches) == (2, 0)
    assert res.best_ppl == pytest.approx(tr.best_ppl)


@pytest.mark.parametrize("field,value", [("d_model", 48), ("num_layers", 1),
                                         ("vocab_size", 80), ("seq_len", 24)])
def test_hard_geometry_mismatch_fails_before_the_load(tmp_path, monkeypatch,
                                                      field, value):
    d = str(tmp_path / "ck")
    _fit(LMConfig(checkpoint_dir=d, max_steps=1, **TINY))

    def no_load(*a, **k):
        raise AssertionError("state loaded before the geometry check")

    monkeypatch.setattr(lm_loop.ckpt, "load_checkpoint", no_load)
    with pytest.raises(ValueError, match=f"different model geometry.*{field}"):
        LMTrainer(LMConfig(**{**TINY, field: value,
                              "resume": os.path.join(d, "lm-checkpoint.pt")}),
                  device="cpu")


def test_soft_geometry_binds_only_a_mid_epoch_checkpoint(tmp_path):
    kw = dict(TINY, **WIN)
    _interrupted(LMConfig(checkpoint_dir=str(tmp_path / "int"), **kw), 1)
    ck = str(tmp_path / "int" / "lm-checkpoint.pt")
    with pytest.raises(ValueError, match="mid-epoch resume requires.*batch"):
        LMTrainer(LMConfig(**{**kw, "batch_size": 4, "resume": ck}),
                  device="cpu")
    end = str(tmp_path / "end")
    _fit(LMConfig(checkpoint_dir=end, **TINY))
    tr = LMTrainer(LMConfig(**{**TINY, "batch_size": 4, "epochs": 2,
                               "resume": os.path.join(end,
                                                      "lm-checkpoint.pt")}),
                   device="cpu")
    assert tr.start_epoch == 1


def test_interrupt_without_checkpoint_dir_saves_nothing(tmp_path, capsys):
    _interrupted(LMConfig(**TINY, **WIN), 1)
    assert "nothing saved" in capsys.readouterr().out


# ---- warm start ----------------------------------------------------------

def test_warm_start_grafts_matching_leaves(tmp_path):
    d = str(tmp_path / "ck")
    donor = _fit(LMConfig(checkpoint_dir=d, max_steps=4, **SCHED,
                          **{k: v for k, v in TINY.items() if k != "lr"}))
    best = os.path.join(d, "lm-model_best.pt")
    tr = LMTrainer(LMConfig(pretrained=best, **TINY), device="cpu")
    assert tr.state.step == 0
    np.testing.assert_array_equal(_vec(tr), _vec(donor))
    assert all(float(t.abs().sum()) == 0 for t in tr.state.opt_tensors())
    tr.fit()                                   # and it trains from there
    # another vocabulary: the embedding and the head keep their fresh init
    other = LMTrainer(LMConfig(pretrained=best, **{**TINY,
                                                   "vocab_size": 80}),
                      device="cpu")
    fresh = LMTrainer(LMConfig(**{**TINY, "vocab_size": 80}), device="cpu")
    donor_p = dict(zip(donor.state.param_names, donor.state.params))
    fresh_p = dict(zip(fresh.state.param_names, fresh.state.params))
    for name, p in zip(other.state.param_names, other.state.params):
        want = fresh_p[name] if name in ("tok_emb.weight",
                                         "lm_head.kernel") else donor_p[name]
        assert torch.equal(p, want), name


def test_warm_start_refusals(tmp_path):
    with pytest.raises(FileNotFoundError, match="--pretrained"):
        LMTrainer(LMConfig(pretrained=str(tmp_path / "nope.pt"), **TINY),
                  device="cpu")
    with pytest.raises(FileNotFoundError, match="--resume"):
        LMTrainer(LMConfig(resume=str(tmp_path / "nope.pt"), **TINY),
                  device="cpu")
    d = str(tmp_path / "ck")
    _fit(LMConfig(checkpoint_dir=d, max_steps=1, **{**TINY, "d_model": 48}))
    with pytest.raises(ValueError, match="shares no tensors"):
        LMTrainer(LMConfig(pretrained=os.path.join(d, "lm-checkpoint.pt"),
                           **{**TINY, "vocab_size": 80}), device="cpu")


def test_entry_script_runs_the_new_flags(tmp_path, capsys):
    from tpu_dist_torch.scripts import lm_longcontext

    args = ["--device", "cpu", "--batch-size", "8", "--seq-len", "32",
            "--d-model", "32", "--num-layers", "1", "--num-heads", "2",
            "--vocab-size", "64", "--synth-tokens", "3000",
            "--attn", "blockwise", "--attn-block", "16", "--loss-chunk",
            "100", "--steps-per-dispatch", "4", "--print-freq", "100"]
    d = str(tmp_path / "ck")
    lm_longcontext.main(args + ["--epochs", "1", "--checkpoint-dir", d])
    lm_longcontext.main(args + ["--epochs", "2", "--resume",
                                os.path.join(d, "lm-checkpoint.pt")])
    out = capsys.readouterr().out
    assert "resumed from" in out and "Epoch 1 [dp]" in out
