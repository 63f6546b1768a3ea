"""The image ``Trainer`` on a ``("data", "model")`` mesh under
``tp_impl="gspmd"`` (the reference's jit step, ``tpu_dist/engine/steps.py:
220-227``: the batch sharded over ``data``, the params replicated): two
gloo ranks through ``tests/torch_dp_worker.py``, spawned once for the
module, against the reference ``Trainer`` on a (1, 2) mesh of the suite's
virtual CPU devices from the same initial weights. ``vit_cifar`` is the
arch: BN- and dropout-free, so the two packages' steps compare exactly."""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from tpu_dist.engine.loop import Trainer as JaxTrainer  # noqa: E402
from torch_dp_worker import run_group  # noqa: E402
from torch_lm_ref import save_init  # noqa: E402

torch.set_num_threads(1)

CFG = dict(arch="vit_cifar", dataset="cifar10", batch_size=4, epochs=1,
           synth_train_size=16, synth_val_size=8, precision="fp32", seed=0,
           print_freq=1, workers=1, log_csv="", optimizer="sgd", lr=0.01,
           mesh_shape=(1, 2), mesh_axes=("data", "model"), tp_impl="gspmd")
TOL = 1e-4          # fp32 losses: |port - reference| <= TOL (1 + |ref|)


def _losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f) if r["event"] == "step"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gspmd")
    kw = dict(CFG, data=str(tmp / "no-data"))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                             ("data", "model"))
    ref = JaxTrainer(JaxTrainConfig(ledger_path=str(tmp / "j.jsonl"),
                                    checkpoint_dir=str(tmp / "jck"), **kw),
                     mesh=mesh)
    init = {"params": jax.tree_util.tree_map(
        np.asarray, jax.device_get(ref.state.params)), "batch_stats": None}
    ref.fit()
    port = run_group(2, {"jobs": [{
        "name": "gspmd", "kind": "image", "init": save_init(tmp, "vit", init),
        "cfg": dict(kw, mesh_shape=[1, 2], mesh_axes=["data", "model"])}]},
        str(tmp / "port"))
    return {"want": _losses(tmp / "j.jsonl"), "port": port,
            "out": str(tmp / "port")}


def test_gspmd_model_axis_matches_the_reference_trainer(runs):
    got = runs["port"][0]["gspmd"]["losses"]
    want = runs["want"]
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert abs(a - b) <= TOL * (1 + abs(b)), (got, want)
    for r in runs["port"]:
        res = r["gspmd"]
        assert res["step"] == 4 and res["world"] == 2
        # one data coordinate: each rank trains on the whole batch
        assert res["local_batch"] == CFG["batch_size"]


def test_gspmd_model_axis_ranks_hold_bit_equal_params(runs):
    out = runs["out"]
    with np.load(f"{out}/gspmd.rank0.npz") as a, \
            np.load(f"{out}/gspmd.rank1.npz") as b:
        assert a.files == b.files and len(a.files) > 4
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
