"""Multi-process data parallelism in the port's image ``Trainer`` against
the reference, on CPU: one gloo group of 2 ranks (``tests/torch_dp_worker.py``,
spawned once for the module) runs every port job, and the JAX ``Trainer``
runs on a ``data=2`` mesh of the suite's virtual CPU devices.

* ResNet-18, synthetic CIFAR-10, batch 16 = 2 x 8, fp32, one epoch from
  the JAX trainer's initial params, under ``jit`` (BatchNorm statistics
  over both ranks' rows), under ``shard_map`` with a predivide factor of 2
  (per-rank statistics, running stats averaged) and under ``shard_map``
  with bf16 compression: per-step losses within 1e-4 (1 + |loss|) of the
  JAX ``Trainer``'s (fp32 summation order, carried through BatchNorm's
  backward over four steps) and the same acc@1, on both ranks, which hold
  identical params. bf16 rounding is discontinuous: an fp32
  summation-order difference that moves a gradient entry across a bf16
  rounding boundary flips it by one bf16 ulp (2^-8 of its magnitude), and
  that update difference grows through the next steps. Steps 0 and 1
  (which see only step 0's update) stay within 1e-4 (1 + |loss|); all four
  within 1e-3 (1 + |loss|) (on this input step 3 is 3.4e-4 apart; without
  the compression the same step agrees to 4e-7);
* the ``jit`` 2-rank run equals the port's 1-rank run at the same global
  batch (the cross-rank BatchNorm)."""

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
from tpu_dist_torch.engine.loop import Trainer  # noqa: E402
from torch_dp_worker import run_group  # noqa: E402

torch.set_num_threads(1)

IMAGE = dict(arch="resnet18", dataset="cifar10", batch_size=16, epochs=1,
             synth_train_size=64, synth_val_size=32, precision="fp32",
             seed=0, print_freq=1, workers=1, log_csv="", optimizer="sgd")
VARIANTS = {"jit": {},
            "shard_map": dict(variant="shard_map",
                              gradient_predivide_factor=2.0),
            "shard_map_bf16": dict(variant="shard_map",
                                   grad_compression="bf16")}
BF16_LOSS_TOL = 1e-3
LOSS_TOL = 1e-4


def _losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f) if r["event"] == "step"]


def _mesh2():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("data",))


def _save_tree(path, tree):
    np.savez(path, tree=np.array(tree, dtype=object))
    return path


def _params(out, name, rank):
    with np.load(os.path.join(out, f"{name}.rank{rank}.npz")) as z:
        return [z[k] for k in sorted(z.files, key=lambda k: int(k[4:]))]


def _reference(tmp, data, name):
    """The JAX ``Trainer`` on a ``data=2`` mesh: (initial params and BN
    stats, per-step losses, acc@1)."""
    tr = JaxTrainer(JaxTrainConfig(
        **IMAGE, **VARIANTS[name], data=data,
        checkpoint_dir=str(tmp / f"j{name}"),
        ledger_path=str(tmp / f"j{name}.jsonl")), mesh=_mesh2())
    get = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))
    init = {"params": get(tr.state.params),
            "batch_stats": get(tr.state.batch_stats)}
    acc = tr.fit()
    return init, (_losses(tmp / f"j{name}.jsonl"), acc)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    data = str(tmp / "no-data")
    init, jit = _reference(tmp, data, "jit")
    ref = {"jit": jit, "shard_map": _reference(tmp, data, "shard_map")[1],
           "shard_map_bf16": _reference(tmp, data, "shard_map_bf16")[1]}
    img = _save_tree(str(tmp / "init.npz"), init)
    two = dict(IMAGE, data=data, mesh_shape=[2])
    jobs = [{"name": name, "kind": "image", "cfg": dict(two, **kw),
             "init": img} for name, kw in VARIANTS.items()]
    out = str(tmp / "port")
    port = run_group(2, {"jobs": jobs}, out)
    one = Trainer(TrainConfig(**IMAGE, data=data,
                              checkpoint_dir=str(tmp / "one-ck"),
                              ledger_path=str(tmp / "one.jsonl")),
                  device="cpu", init_params=init["params"],
                  init_batch_stats=init["batch_stats"])
    one_acc = one.fit()
    return {"ref": ref, "port": port, "out": out,
            "one": (_losses(tmp / "one.jsonl"), one_acc)}


def _close(got, want, tol=LOSS_TOL):
    assert len(got) == len(want) > 0, (got, want)
    for a, r in zip(got, want):
        assert abs(a - r) <= tol * (1 + abs(r)), (got, want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_rank_image_trainer_matches_reference_data2(runs, variant):
    want, ref_acc = runs["ref"][variant]
    r0, r1 = (r[variant] for r in runs["port"])
    assert (r0["world"], r0["rank"], r1["rank"]) == (2, 0, 1)
    assert r0["local_batch"] == r1["local_batch"] == 8
    assert r0["step"] == r1["step"] == 4
    if variant.endswith("bf16"):
        _close(r0["losses"][:2], want[:2])
        _close(r0["losses"], want, BF16_LOSS_TOL)
    else:
        _close(r0["losses"], want)
    assert r0["best"] == r1["best"] == pytest.approx(ref_acc, abs=1e-6)


def test_two_rank_ranks_hold_identical_params(runs):
    for name in VARIANTS:
        for a, b in zip(_params(runs["out"], name, 0),
                        _params(runs["out"], name, 1)):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_two_rank_jit_equals_one_rank(runs):
    """Cross-rank BatchNorm: 2 x 8 rows under ``jit`` train as 16 rows in
    one process do."""
    losses, acc = runs["one"]
    _close(runs["port"][0]["jit"]["losses"], losses, tol=1e-5)
    assert runs["port"][0]["jit"]["best"] == pytest.approx(acc, abs=1e-6)
