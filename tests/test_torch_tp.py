"""Tensor parallelism in the port (``parallel.tp``, ``tp_impl="gspmd"``,
and ``parallel.overlap``'s ring, ``tp_impl="ring"``) against the
reference, on CPU: one gloo group of 2 ranks (``tests/torch_dp_worker.py``,
spawned once for the module) runs every port job, the JAX side runs on the
suite's virtual CPU devices from the same numpy-seeded params.

Held (mirroring ``tests/test_overlap.py:54,152,283``):

* the rules leaf by leaf against the reference's ``lm_param_specs``, and
  the fused ``qkv`` kept as each rank's heads of q, of k and of v;
* the ring collective matmuls against the plain products;
* one step's loss and every leaf's gradient (gathered) under both impls
  against ``jax.value_and_grad`` of the reference's objective, also with
  the chunked head;
* the ``LMTrainer`` at ``data=1,model=2`` in both impls: the reference's
  mode string, per-step losses (adamw with a clip that binds) against the
  JAX ``LMTrainer`` on the same mesh, and against the port's own dp twin
  (``data=2``, the same global batch), within 1e-4 (1 + |loss|);
* a tp checkpoint resumes under dp and a dp checkpoint under tp, at the
  exact step.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from torch_dp_worker import run_group  # noqa: E402
from torch_lm_ref import (LM, assert_losses, jax_grads,  # noqa: E402
                          jax_trainer, named, save_init, spec_tuple)

torch.set_num_threads(1)

TP = dict(mesh_shape=[1, 2], mesh_axes=["data", "model"])
DP2 = dict(mesh_shape=[2], mesh_axes=["data"])
GRADS = dict(seed=7, batch=4, seq_len=32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    init, tp_losses, tp_mode = jax_trainer(tmp, "tp", LM, (1, 2),
                                           ("data", "model"))
    _, ring_losses, ring_mode = jax_trainer(
        tmp, "ring", dict(LM, tp_impl="ring"), (1, 2), ("data", "model"))
    path = save_init(tmp, "lm", init)
    cut = dict(LM, max_steps=4, checkpoint_dir="ck", epochs=1)
    jobs = [
        {"name": "tp", "kind": "lm", "init": path, "cfg": dict(LM, **TP)},
        {"name": "ring", "kind": "lm", "init": path,
         "cfg": dict(LM, tp_impl="ring", **TP)},
        {"name": "dp", "kind": "lm", "init": path, "cfg": dict(LM, **DP2)},
        {"name": "tp_windowed", "kind": "lm", "init": path,
         "cfg": dict(LM, steps_per_dispatch=3, data_placement="device",
                     **TP)},
        {"name": "ring_matmul", "kind": "ring_matmul", "seed": 5,
         "dims": [2, 8, 6, 4]},
        *({"name": f"grads_{n}", "kind": "lm_grads", "init": path,
           "cfg": dict(LM, **TP, **kw), **GRADS}
          for n, kw in (("tp", {}), ("ring", dict(tp_impl="ring")),
                        ("tp_chunked", dict(loss_chunk=24)))),
        # checkpoint round trips: 4 steps whole, cut at 2, resumed across
        {"name": "tp4", "kind": "lm", "init": path,
         "cfg": dict(cut, checkpoint_dir="ck-tp4", **TP)},
        {"name": "tp_cut", "kind": "lm", "init": path, "interrupt_at": 2,
         "cfg": dict(cut, checkpoint_dir="ck-tp", **TP)},
        {"name": "dp_from_tp", "kind": "lm",
         "cfg": dict(cut, checkpoint_dir="ck-dp-r",
                     resume="ck-tp/lm-checkpoint.pt", **DP2)},
        {"name": "dp_cut", "kind": "lm", "init": path, "interrupt_at": 2,
         "cfg": dict(cut, checkpoint_dir="ck-dp", **DP2)},
        {"name": "tp_from_dp", "kind": "lm",
         "cfg": dict(cut, checkpoint_dir="ck-tp-r",
                     resume="ck-dp/lm-checkpoint.pt", **TP)},
    ]
    out = str(tmp / "port")
    return {"ref": {"tp": (tp_losses, tp_mode),
                    "ring": (ring_losses, ring_mode)},
            "init": init, "port": run_group(2, {"jobs": jobs}, out),
            "out": out, "tmp": tmp}


def test_specs_match_reference_leaf_by_leaf(runs):
    from tpu_dist.parallel.tp import lm_param_specs as jax_specs
    from tpu_dist_torch.parallel.tp import lm_param_specs

    init = runs["init"]
    want = {n: spec_tuple(s, a.ndim) for (n, a), s in zip(
        named(init).items(),
        jax.tree.leaves(jax_specs(init),
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec)))}
    got = lm_param_specs((n, a.shape) for n, a in named(init).items())
    assert got == want
    assert got["blocks.0.qkv.kernel"] == (None, "model")
    assert got["blocks.0.mlp_in.bias"] == (None,)


def test_fused_qkv_shard_holds_whole_heads():
    from tpu_dist_torch.parallel.mesh import Axis, Mesh, shard_leaf

    mesh = Mesh({"model": 2}, 1, 2, torch.device("cpu"),
                {"model": Axis("model", 2, 1)})
    w = torch.arange(3 * 8).reshape(1, 24)       # [q | k | v], 8 each
    got = shard_leaf(w, (None, "model"), mesh, fused=3)
    assert got.tolist() == [[4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]]


def test_ring_collective_matmuls_match_plain_products(runs):
    rng = np.random.default_rng(5)
    b, l, d, f = 2, 8, 6, 4
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    w1 = rng.normal(size=(d, f)).astype(np.float32)
    h = rng.normal(size=(b, l, f)).astype(np.float32)
    w2 = rng.normal(size=(f, d)).astype(np.float32)
    for r, res in enumerate(p["ring_matmul"] for p in runs["port"]):
        np.testing.assert_allclose(res["ag"], (x @ w1)[..., 2 * r:2 * r + 2],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["rs"], (h @ w2)[:, 4 * r:4 * r + 4],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,kw", [("tp", {}),
                                     ("ring", dict(tp_impl="ring")),
                                     ("tp_chunked", dict(loss_chunk=24))])
def test_step_loss_and_gradients_match_reference(runs, name, kw):
    from tpu_dist.models.transformer import tiny_lm

    model = tiny_lm(vocab_size=64, num_layers=2, d_model=32, num_heads=2,
                    max_len=32)
    loss, want, hits = jax_grads(model, runs["init"], GRADS)
    res = runs["port"][0][f"grads_{name}"]
    assert res["loss"] == pytest.approx(loss, rel=1e-5)
    assert res["correct1"] == hits      # the argmax across vocab shards
    with np.load(os.path.join(runs["out"], f"grads_{name}.grads.npz")) as z:
        assert set(z.files) == set(want)
        for n in want:
            np.testing.assert_allclose(z[n], want[n], rtol=1e-4, atol=2e-6,
                                       err_msg=n)
    if name == "tp":   # the shards each rank holds
        shapes = res["local_shapes"]
        assert [16, 32] in shapes and [32, 32] in shapes  # proj, lm_head


@pytest.mark.parametrize("name", ["tp", "ring"])
def test_two_rank_trainer_matches_reference_and_dp_twin(runs, name):
    want, mode = runs["ref"][name]
    r0, r1 = (r[name] for r in runs["port"])
    assert r0["mode"] == r1["mode"] == mode == \
        {"tp": "tp", "ring": "tp-ring"}[name]
    assert r0["step"] == r1["step"] == 3 and r0["local_batch"] == 4
    assert_losses(r0["losses"], want, f"{name} vs the JAX LMTrainer")
    assert_losses(r0["losses"], runs["port"][0]["dp"]["losses"],
                  f"{name} vs the port's dp twin")
    assert r0["best"] == pytest.approx(r1["best"], rel=1e-6)


def test_windowed_path_under_tp_equals_host_path(runs):
    per_step = runs["port"][0]["tp"]["losses"]
    window = runs["port"][0]["tp_windowed"]["losses"]
    assert len(window) == 1
    assert window[0] == pytest.approx(np.mean(per_step), rel=1e-5)


@pytest.mark.parametrize("whole,cut,resumed", [
    ("tp4", "tp_cut", "dp_from_tp"), ("tp4", "dp_cut", "tp_from_dp")])
def test_checkpoint_round_trip_across_layouts(runs, whole, cut, resumed):
    a, b, c = (runs["port"][0][k] for k in (whole, cut, resumed))
    assert b["ckpt_meta"]["step"] == 2 and b["ckpt_meta"]["mid_epoch"]
    assert a["step"] == c["step"] == 4
    assert len(c["losses"]) == 2
    assert_losses(c["losses"], a["losses"][2:], f"{resumed} vs {whole}")


def test_ring_decode_and_the_stage_axis_refuse():
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.generate import generate
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.models.transformer import tiny_lm

    lm = tiny_lm(vocab_size=64, max_len=16, device="cpu", tp_impl="ring")
    with pytest.raises(ValueError, match="tp_impl='ring' is a training"):
        generate(lm, np.zeros((1, 2), np.int32), 2, use_cache=True)
    # the stage axis is ported (tests/test_torch_pp.py); the reference's
    # refusal of it with fsdp (lm_loop.py:416) stands
    with pytest.raises(ValueError, match="'stage' mesh axis does not "
                                         "compose with fsdp"):
        LMTrainer(LMConfig(**{**LM, "mesh_shape": [1, 2], "fsdp": True,
                              "mesh_axes": ["data", "stage"]}),
                  device="cpu")
