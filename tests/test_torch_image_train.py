"""Image training in the port against the reference, on CPU:

* the port's ``Trainer`` and the JAX ``Trainer`` from the same initial
  params: ResNet-18, synthetic CIFAR-10 (64 train / 32 val), batch 16,
  fp32, one epoch, for ``optimizer`` sgd and fused_sgd (the reference's
  Pallas kernel in interpret mode, the port's plain version): per-step
  losses within 1e-4 * (1 + |loss|) (fp32 conv and reduction summation
  order, carried through BatchNorm's backward over four steps), and the
  same validation acc@1;
* on the port, the windowed device-data path (K=4) equals the per-batch
  host path; an interrupted run resumed from its mid-epoch checkpoint
  equals an uninterrupted one step for step; a corrupt newest checkpoint
  falls back to the retained one;
* every knob not ported yet raises ``NotImplementedError`` naming itself,
  a data axis wider than the process count raises ``ValueError``, the
  default device is CUDA, an unported arch and ``quant`` on a conv arch
  refuse, and the entry script runs on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from tpu_dist.engine.loop import Trainer as JaxTrainer  # noqa: E402
from tpu_dist_torch.configs import TrainConfig  # noqa: E402
from tpu_dist_torch.engine import checkpoint as ckpt  # noqa: E402
from tpu_dist_torch.engine.loop import Trainer  # noqa: E402
from tpu_dist_torch.plan.compile import audit_mode  # noqa: E402

torch.set_num_threads(1)

TINY = dict(arch="resnet18", dataset="cifar10", batch_size=16, epochs=1,
            synth_train_size=64, synth_val_size=32, precision="fp32",
            seed=0, print_freq=1, workers=1, log_csv="")


def _losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f)
                if r["event"] == "step"]


def _params(tr):
    return [p.detach().float().numpy().copy() for p in tr.state.params]


@pytest.mark.parametrize("optimizer", ["sgd", "fused_sgd"])
def test_trainer_matches_reference_trainer(tmp_path, optimizer):
    kw = dict(TINY, optimizer=optimizer, data=str(tmp_path / "no-data"))
    one_device = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    ref = JaxTrainer(JaxTrainConfig(
        checkpoint_dir=str(tmp_path / "jck"),
        ledger_path=str(tmp_path / "j.jsonl"), **kw), mesh=one_device)
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(ref.state.params))
    stats = jax.tree_util.tree_map(np.asarray,
                                   jax.device_get(ref.state.batch_stats))
    ref_acc = ref.fit()
    port = Trainer(TrainConfig(checkpoint_dir=str(tmp_path / "tck"),
                               ledger_path=str(tmp_path / "t.jsonl"), **kw),
                   device="cpu", init_params=init, init_batch_stats=stats)
    port_acc = port.fit()
    want = _losses(tmp_path / "j.jsonl")
    got = _losses(tmp_path / "t.jsonl")
    assert len(got) == len(want) == 4 and port.state.step == 4
    for a, r in zip(got, want):
        assert abs(a - r) <= 1e-4 * (1 + abs(r)), (got, want)
    assert port_acc == pytest.approx(ref_acc, abs=1e-6)


def _run(tmp_path, name, **kw):
    cfg = TrainConfig(**{**TINY, "epochs": 2, "optimizer": "sgd",
                         "checkpoint_dir": str(tmp_path / f"{name}-ck"),
                         "ledger_path": str(tmp_path / f"{name}.jsonl"),
                         **kw})
    tr = Trainer(cfg, device="cpu")
    tr.fit()
    return tr


def test_windowed_device_path_equals_per_batch_host_path(tmp_path):
    host = _run(tmp_path, "host", data_placement="host")
    win = _run(tmp_path, "win", steps_per_dispatch=4,
               data_placement="device")
    assert not host.device_data and win.device_data
    assert host.state.step == win.state.step == 8
    per_step = _losses(tmp_path / "host.jsonl")
    windows = _losses(tmp_path / "win.jsonl")     # one record per window
    assert len(per_step) == 8 and len(windows) == 2
    np.testing.assert_allclose(windows, [np.mean(per_step[:4]),
                                         np.mean(per_step[4:])], rtol=1e-6)
    for a, b in zip(_params(host), _params(win)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert host.best_acc1 == win.best_acc1


def test_interrupted_run_resumes_step_exact(tmp_path, monkeypatch):
    full = _run(tmp_path, "full")
    step = Trainer._step

    def interrupt_at_5(self, images, labels, gstep):
        if gstep == 5:
            raise KeyboardInterrupt
        return step(self, images, labels, gstep)

    monkeypatch.setattr(Trainer, "_step", interrupt_at_5)
    with pytest.raises(KeyboardInterrupt):
        _run(tmp_path, "cut")
    monkeypatch.setattr(Trainer, "_step", step)
    path = str(tmp_path / "cut-ck" / "resnet18-checkpoint.pt")
    meta = ckpt.read_checkpoint_meta(path)
    assert meta["mid_epoch"] and meta["step"] == 5 and meta["epoch"] == 1
    resumed = _run(tmp_path, "resumed", resume=path)
    assert resumed.state.step == 8
    # the resumed run's steps 5-7 are the uninterrupted run's
    np.testing.assert_allclose(_losses(tmp_path / "resumed.jsonl"),
                               _losses(tmp_path / "full.jsonl")[5:],
                               rtol=1e-6)
    for a, b in zip(_params(full), _params(resumed)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    for a, b in zip(full.state.opt_tensors(), resumed.state.opt_tensors()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    tr = _run(tmp_path, "ck", keep_checkpoints=2)
    path = str(tmp_path / "ck-ck" / "resnet18-checkpoint.pt")
    assert [os.path.basename(p) for p in ckpt.retained_checkpoints(path)] \
        == ["resnet18-checkpoint.r8.pt", "resnet18-checkpoint.r4.pt"]
    os.remove(path.replace(".pt", ".r8.pt"))
    with open(path, "r+b") as f:          # tear the newest
        f.truncate(os.path.getsize(path) - 10)
    fresh = Trainer(tr.cfg, device="cpu")
    _, meta = ckpt.load_checkpoint(path, fresh.state)
    assert meta["step"] == 4 and fresh.state.step == 4
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_checkpoint(path, fresh.state, fallback=False)


@pytest.mark.parametrize("mode", ["record", "x"])
def test_audit_knob_records_one_event_or_names_the_modes(tmp_path, mode):
    """The ``audit`` knob: ``record`` emits one ``audit`` event for the
    run's one program (``train_step``, clean) and ``fit`` disarms it; an
    unknown mode raises ValueError naming the modes."""
    path = str(tmp_path / "run.jsonl")
    cfg = TrainConfig(**TINY, audit=mode, ledger_path=path,
                      checkpoint_dir=str(tmp_path))
    if mode == "x":
        with pytest.raises(ValueError,
                           match=r"audit='x'.*'none', 'record', 'halt'"):
            Trainer(cfg, device="cpu")
        return
    Trainer(cfg, device="cpu").fit()
    with open(path) as f:
        audits = [r for r in map(json.loads, f) if r["event"] == "audit"]
    assert [(a["program"], a["mode"], a["findings"]) for a in audits] == \
        [("train_step", "record", 0)]
    assert audit_mode() == "none"          # fit disarms the run's audit


def test_mesh_wider_than_the_process_count_raises():
    """``mesh_shape=(2,)`` is two processes of one device each: in one
    process it is a geometry error, as a mesh wider than the device count
    is in the reference."""
    with pytest.raises(ValueError, match="one process per device"):
        Trainer(TrainConfig(**{**TINY, "mesh_shape": (2,)}), device="cpu")


def test_default_device_is_cuda_and_bad_archs_refuse():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(TrainConfig(**TINY))
    from tpu_dist_torch.models.registry import create_model

    # moe_lm is ported (models/moe.py): it builds, on CUDA by default
    assert type(create_model("moe_lm", device="cpu", vocab_size=64,
                             max_len=16)).__name__ == "MoETransformerLM"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_model("moe_lm")
    with pytest.raises(ValueError, match="language model"):
        Trainer(TrainConfig(**{**TINY, "arch": "tiny_lm"}), device="cpu")
    # the reference's config-time rule: quant only for the vit_* archs
    with pytest.raises(ValueError, match=r"vit_\*.*'resnet18' does not "
                                         "take it"):
        Trainer(TrainConfig(**{**TINY, "quant": "int8"}), device="cpu")


def test_entry_script_trains_on_the_cpu(tmp_path, capsys):
    from tpu_dist_torch.scripts import image_train

    tr = image_train.main([
        "--device", "cpu", "--arch", "lenet", "--dataset", "mnist",
        "--data", str(tmp_path / "no-data"), "--batch-size", "32",
        "--synth-train-size", "256", "--synth-val-size", "64",
        "--epochs", "2", "--precision", "fp32", "--optimizer", "fused_sgd",
        "--steps-per-dispatch", "4", "--log-csv", str(tmp_path / "e.csv"),
        "--checkpoint-dir", str(tmp_path / "ck"), "--lr", "0.05"])
    out = capsys.readouterr().out
    assert "data=device" in out and "best_acc1" in out
    assert tr.state.step == 16 and tr.best_acc1 > 0.5
    assert os.path.isfile(tmp_path / "ck" / "lenet-model_best.pt")
    assert dataclasses.asdict(tr.cfg)["arch"] == "lenet"


@pytest.mark.parametrize("cls", ["TrainConfig", "LMConfig"])
def test_parse_config_matches_reference(cls):
    """The port's ``add_args``/``parse_config`` give the reference's config
    field for field, for both config classes."""
    from tpu_dist import configs as ref_configs
    from tpu_dist_torch import configs

    argv = ["--batch-size", "64", "--lr", "0.3", "--seed", "5",
            "--mesh-shape", "1", "--health", "skip", "--print-freq", "3"]
    argv += (["--arch", "lenet", "--evaluate", "--no-lr-scale-by-world",
              "--norm-dtype", "bf16", "--synth-train-size", "100"]
             if cls == "TrainConfig" else
             ["--seq-len", "96", "--grad-clip", "0.5", "--attn", "flash"])
    got = configs.parse_config(argv, getattr(configs, cls)())
    want = ref_configs.parse_config(argv, getattr(ref_configs, cls)())
    assert type(got).__name__ == cls
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
