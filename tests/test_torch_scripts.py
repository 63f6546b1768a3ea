"""The port's cookbook scripts (``tpu_dist_torch.scripts``) on CPU at tiny
size: each keeps the reference script's ``DEFAULTS``; variant 1 trains in
one process and refuses a wider mesh; 2, 4, 5 and 5.2 train in one process
(a local launch); variant 6 trains on a tiny ImageFolder tree of JPEGs;
variant 3 spawns 2 gloo ranks that train in lockstep; the comm bench
prints one JSON line from 2 ranks; the data-rate tool prints one JSON line
with the routes it took."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from tpu_dist_torch.scripts import (allreduce_distributed, bf16_distributed,
                                    dataparallel, distributed,
                                    distributed_slurm, mnist,
                                    multiprocessing_spawn)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--arch", "lenet", "--dataset", "mnist",
        "--batch-size", "32", "--synth-train-size", "128",
        "--synth-val-size", "64", "--epochs", "1", "--print-freq", "100",
        "--log-csv", "", "--workers", "1"]
# the reference scripts' DEFAULTS, field by field where they set one
REFERENCE_DEFAULTS = {
    dataparallel: dict(arch="resnet101", epochs=5, batch_size=3200,
                       dataset="cifar10", variant="jit",
                       log_csv="dataparallel.csv"),
    distributed: dict(arch="resnet18", epochs=2, batch_size=3200,
                      dataset="cifar10", variant="jit"),
    multiprocessing_spawn: dict(arch="resnet18", epochs=2, batch_size=3200,
                                dataset="cifar10", variant="jit"),
    bf16_distributed: dict(arch="resnet18", epochs=10, batch_size=3200,
                           dataset="cifar10", variant="jit",
                           precision="bf16"),
    allreduce_distributed: dict(arch="resnet18", epochs=10, batch_size=3200,
                                dataset="cifar10", variant="shard_map",
                                grad_compression="bf16"),
    distributed_slurm: dict(arch="resnet50", epochs=90, batch_size=3200,
                            dataset="imagenet", variant="jit",
                            log_csv="distributed.csv"),
    mnist: dict(arch="lenet", epochs=10, batch_size=64, lr=0.01,
                momentum=0.5, weight_decay=0.0, dataset="mnist",
                variant="shard_map", grad_compression="bf16",
                lr_scale_by_world=True),
}


@pytest.mark.parametrize("module", list(REFERENCE_DEFAULTS),
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_defaults_are_the_reference_scripts(module):
    from tpu_dist_torch.configs import TrainConfig

    want = dataclasses.replace(TrainConfig(), **REFERENCE_DEFAULTS[module])
    assert module.DEFAULTS == want


def _files(tmp_path):
    return ["--data", str(tmp_path / "none"),
            "--checkpoint-dir", str(tmp_path / "ck")]


def test_dataparallel_trains_in_one_process_and_refuses_wider_mesh(
        tmp_path, capsys):
    tr = dataparallel.main(TINY + _files(tmp_path))
    assert tr.world == 1 and tr.state.step == 4
    assert "best_acc1" in capsys.readouterr().out
    with pytest.raises(ValueError, match="one process per device"):
        dataparallel.main(TINY + ["--mesh-shape", "2"])


@pytest.mark.parametrize("module,banner", [
    (distributed, "rendezvous=local"), (bf16_distributed, "precision=fp32"),
    (allreduce_distributed, "compression=bf16"), (mnist, None)],
    ids=["distributed", "bf16_distributed", "allreduce_distributed",
         "mnist"])
def test_launched_scripts_train_in_one_local_process(tmp_path, capsys,
                                                     module, banner):
    argv = TINY + _files(tmp_path) + ["--precision", "fp32"]
    tr = module.main(argv)
    out = capsys.readouterr().out
    assert tr.state.step == 4 and "best_acc1" in out
    assert banner is None or f"[proc 0/1] {banner}" in out
    assert tr.cfg.variant == module.DEFAULTS.variant
    assert tr.cfg.grad_compression == module.DEFAULTS.grad_compression


def test_multiprocessing_spawn_trains_two_ranks(tmp_path):
    """Variant 3 forks 2 workers with the rendezvous variables injected;
    both join one gloo group, train 2 steps of 16 rows each and report the
    same all-reduced acc@1."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_DIST", "SLURM_"))}
    env.update(TPU_DIST_NPROCS_SPAWN="2", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    code = ("import sys; from tpu_dist_torch.scripts import "
            "multiprocessing_spawn as m; m.main(sys.argv[1:])")
    res = subprocess.run(
        [sys.executable, "-c", code, *TINY, "--batch-size", "64",
         *_files(tmp_path), "--backend", "gloo"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    out = res.stdout
    assert "[proc 0/2] rendezvous=env" in out
    assert "[proc 1/2] rendezvous=env" in out
    best = [line for line in out.splitlines() if line.startswith("best_acc1")]
    assert len(best) == 2 and best[0] == best[1]
    # rank 0 alone prints the epoch line
    assert sum(line.startswith("Epoch 0:") for line in out.splitlines()) == 1


def test_comm_bench_prints_one_json_line_from_two_ranks():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_DIST", "SLURM_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    # the default --port 0: the bench binds a free port and holds it
    res = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.tools.comm_bench",
         "--nprocs", "2", "--device", "cpu", "--sizes-mb", "0.01", "0.1",
         "--bucket-mb", "0.02", "--iters", "2"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [line for line in res.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "torch_comm_bench" and out["world"] == 2
    assert out["backend"] == "gloo"
    for row in out["allreduce"]:
        assert row["ring_s"] > 0 and row["all_reduce_s"] > 0
    for row in out["grad_sync"]:
        assert row["bucketed_s"] > 0 and row["monolithic_s"] > 0
    assert set(out["latency"]) == {"0.01", "0.1"}


def test_distributed_slurm_trains_on_an_imagefolder_tree(tmp_path, capsys):
    """Variant 6 on ``--data`` holding ``train/`` and ``val/`` JPEG
    folders: 2 steps of 4 images at 224 px through the native decode."""
    Image = pytest.importorskip("PIL.Image")
    import numpy as np

    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 2)):
        for c in ("a", "b"):
            d = tmp_path / "imagenet" / split / c
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 255, (240, 320, 3),
                                             np.uint8)).save(d / f"{i}.jpg")
    tr = distributed_slurm.main([
        "--device", "cpu", "--data", str(tmp_path / "imagenet"),
        "--arch", "resnet18", "--batch-size", "4", "--epochs", "1",
        "--precision", "fp32", "--print-freq", "100", "--log-csv", "",
        "--workers", "1", "--checkpoint-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "[proc 0/1] via local" in out and "best_acc1" in out
    assert tr.state.step == 2 and tr.train_ds.name == "imagenet-train"
    assert tr.num_classes == 2 and tr.train_ds.image_shape == (224, 224, 3)
    from tpu_dist_torch import native
    if native.decode_available():
        assert tr.train_ds.routes == {"native": 8, "pil": 0}


def test_data_rate_prints_one_json_line_with_its_routes(tmp_path, capsys):
    from tpu_dist_torch.tools import data_rate

    data_rate.main(["--images", "16", "--batch", "8", "--device", "cpu",
                    "--seconds", "0.2", "--prefetch-batches", "2",
                    "--prefetch-mb", "0.5", "--step-ms", "2",
                    "--root", str(tmp_path / "tree"),
                    "--device-rate", "1e9"])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(lines) == 1
    out = lines[0]
    assert out["metric"] == "torch_host_data_path_images_per_sec"
    assert out["array_gather_native"] > 0 and out["array_gather_numpy"] > 0
    routes = out["routes"]
    assert routes["gather_native"] > 0 and routes["gather_numpy"] > 0
    from tpu_dist_torch import native
    if native.decode_available():
        assert out["imagefolder_decode_native"] > 0
        assert routes["folder"]["native"] > 0 == routes["folder"]["pil"]
    assert out["decode_keeps_up"] is False and out["device"] == "cpu"
    assert out["prefetch"]["batches"] == 2
