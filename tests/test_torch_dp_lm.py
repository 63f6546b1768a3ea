"""Multi-process data parallelism in the port, on CPU, beyond the image
parity of ``tests/test_torch_dp.py``: one gloo group of 2 ranks
(``tests/torch_dp_worker.py``, spawned once for the module) runs every
port job.

* the ``LMTrainer`` at ``mesh_shape=(2,)`` (batch 8 = 2 x 4), with and
  without ``grad_bucket_mb`` (buckets of 4 kB: several per step), against
  the JAX ``LMTrainer`` at ``data=2`` from the same initial params: losses
  within 1e-5 relative, as the 1-process parity test holds them, the same
  validation perplexity on both ranks, and a measured ``comm_s`` on the
  bucketed run's step records;
* the windowed device-data path of both trainers (K = 2 over the resident
  set, each rank gathering its rows) equals the per-batch host path;
* a mid-epoch checkpoint that rank 0 writes when both ranks are
  interrupted at step 3 resumes step-exact on both ranks (ResNet-18, two
  epochs of two steps)."""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist.configs import LMConfig as JaxLMConfig  # noqa: E402
from tpu_dist.engine.lm_loop import LMTrainer as JaxLMTrainer  # noqa: E402
from torch_dp_worker import run_group  # noqa: E402

torch.set_num_threads(1)

LM = dict(batch_size=8, seq_len=32, d_model=32, num_layers=2, num_heads=2,
          vocab_size=64, synth_tokens=3000, seed=3, print_freq=1, epochs=1,
          lr=1e-2, max_steps=4, mesh_shape=[2])
LM_VARIANTS = {"lm": {}, "lm_buckets": dict(grad_bucket_mb=0.004)}
IMAGE = dict(arch="resnet18", dataset="cifar10", batch_size=16, epochs=2,
             synth_train_size=32, synth_val_size=32, precision="fp32",
             seed=0, print_freq=1, workers=1, log_csv="", optimizer="sgd",
             mesh_shape=[2])


def _records(path):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["event"] == "step"]


def _params(out, name, rank):
    with np.load(os.path.join(out, f"{name}.rank{rank}.npz")) as z:
        return [z[k] for k in sorted(z.files, key=lambda k: int(k[4:]))]


def _reference(tmp, name):
    """The JAX ``LMTrainer`` at ``data=2``: (initial params, (best ppl,
    per-step losses))."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("data",))
    path = str(tmp / f"j{name}.jsonl")
    tr = JaxLMTrainer(JaxLMConfig(**{**LM, "mesh_shape": (2,)},
                                  **LM_VARIANTS[name], ledger_path=path),
                      mesh=mesh)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(tr.state.params))
    best = tr.fit()
    return init, (best, [r["loss"] for r in _records(path)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_lm")
    init, lm = _reference(tmp, "lm")
    ref = {"lm": lm, "lm_buckets": _reference(tmp, "lm_buckets")[1]}
    lm_init = str(tmp / "lm_init.npz")
    np.savez(lm_init, tree=np.array(init, dtype=object))
    image = dict(IMAGE, data=str(tmp / "no-data"))
    full = dict(image, checkpoint_dir="ck-full")
    jobs = [
        *({"name": name, "kind": "lm", "init": lm_init,
           "cfg": dict(LM, **kw)} for name, kw in LM_VARIANTS.items()),
        {"name": "lm_windowed", "kind": "lm", "init": lm_init,
         "cfg": dict(LM, steps_per_dispatch=2, data_placement="device")},
        {"name": "full", "kind": "image", "cfg": full},
        {"name": "windowed", "kind": "image",
         "cfg": dict(image, steps_per_dispatch=2, data_placement="device")},
        {"name": "cut", "kind": "image", "interrupt_at": 3,
         "cfg": dict(full, checkpoint_dir="ck-cut")},
        {"name": "resumed", "kind": "image",
         "cfg": dict(full, checkpoint_dir="ck-resumed",
                     resume="ck-cut/resnet18-checkpoint.pt")},
    ]
    out = str(tmp / "port")
    return {"ref": ref, "port": run_group(2, {"jobs": jobs}, out),
            "out": out}


@pytest.mark.parametrize("name", list(LM_VARIANTS))
def test_two_rank_lm_matches_reference_data2(runs, name):
    want_ppl, want = runs["ref"][name]
    r0, r1 = (r[name] for r in runs["port"])
    assert r0["step"] == r1["step"] == 4 and r0["local_batch"] == 4
    assert len(want) == 4
    np.testing.assert_allclose(r0["losses"], want, rtol=1e-5)
    assert r0["best"] == r1["best"] == pytest.approx(want_ppl, rel=1e-5)
    for a, b in zip(_params(runs["out"], name, 0),
                    _params(runs["out"], name, 1)):
        np.testing.assert_array_equal(a, b)
    comm = [r["comm_s"] for r in _records(os.path.join(runs["out"],
                                                       f"{name}.jsonl"))]
    if name == "lm_buckets":
        assert all(c is not None and c > 0 for c in comm), comm
    else:
        assert comm == [None] * 4


@pytest.mark.parametrize("host,windowed", [("lm", "lm_windowed"),
                                           ("full", "windowed")])
def test_two_rank_windowed_device_path_equals_host_path(runs, host,
                                                        windowed):
    per_step = runs["port"][0][host]["losses"]
    windows = runs["port"][0][windowed]["losses"]
    assert len(windows) == len(per_step) // 2 >= 2
    np.testing.assert_allclose(
        windows, np.asarray(per_step).reshape(-1, 2).mean(axis=1),
        rtol=1e-6)
    for rank in (0, 1):
        for a, b in zip(_params(runs["out"], host, rank),
                        _params(runs["out"], windowed, rank)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_rank0_checkpoint_resumes_step_exact_on_both_ranks(runs):
    full, cut, resumed = (runs["port"][0][k] for k in
                          ("full", "cut", "resumed"))
    meta = cut["ckpt_meta"]
    assert meta["mid_epoch"] and meta["step"] == 3 and meta["epoch"] == 1
    assert "best" not in cut and full["step"] == resumed["step"] == 4
    np.testing.assert_allclose(resumed["losses"], full["losses"][3:],
                               rtol=1e-6)
    for rank in (0, 1):
        for a, b in zip(_params(runs["out"], "full", rank),
                        _params(runs["out"], "resumed", rank)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert runs["port"][0]["resumed"]["best"] == \
        runs["port"][1]["resumed"]["best"]
