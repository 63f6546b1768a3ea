"""FSDP in the port (``parallel.fsdp``) against the reference, on CPU: one
gloo group of 2 ranks (``tests/torch_dp_worker.py``, spawned once for the
module) runs every port job; the JAX side runs on the suite's virtual CPU
devices from the same numpy-seeded params.

Held:

* the sharding rule leaf by leaf against the reference's ``fsdp_specs``
  (the largest dim divisible by the axis, the earliest on ties, leaves
  under 1024 elements replicated), for the params and the optimizer
  state alike;
* one step's loss and every leaf's gradient (the shards' reduce-scatters
  and the replicated leaves' sums, gathered) against
  ``jax.value_and_grad`` of the reference's objective;
* the ``LMTrainer`` at ``data=2`` with ``fsdp=True``: the mode string,
  per-step losses (adamw with a clip that binds, so the clip's norm sums
  the shards' squares over the axis) against the JAX ``LMTrainer`` on the
  same mesh and against the port's dp twin, within 1e-4 (1 + |loss|); the
  ``fused_adamw`` step on the shards against its dp twin; each rank's
  state holding only its shards;
* an fsdp checkpoint resumes under dp and a dp checkpoint under fsdp, at
  the exact step.
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

FSDP = dict(mesh_shape=[2], mesh_axes=["data"], fsdp=True)
DP2 = dict(mesh_shape=[2], mesh_axes=["data"])
GRADS = dict(seed=7, batch=4, seq_len=32)
FUSED = dict(optimizer="fused_adamw", weight_decay=0.1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    init, losses, mode = jax_trainer(tmp, "fsdp", dict(LM, fsdp=True), (2,),
                                     ("data",))
    path = save_init(tmp, "lm", init)
    cut = dict(LM, max_steps=4)
    jobs = [
        {"name": "fsdp", "kind": "lm", "init": path,
         "cfg": dict(LM, **FSDP)},
        {"name": "dp", "kind": "lm", "init": path, "cfg": dict(LM, **DP2)},
        {"name": "fsdp_fused", "kind": "lm", "init": path,
         "cfg": dict(LM, **FSDP, **FUSED)},
        {"name": "dp_fused", "kind": "lm", "init": path,
         "cfg": dict(LM, **DP2, **FUSED)},
        {"name": "grads", "kind": "lm_grads", "init": path,
         "cfg": dict(LM, **FSDP), **GRADS},
        {"name": "fsdp4", "kind": "lm", "init": path,
         "cfg": dict(cut, checkpoint_dir="ck-f4", **FSDP)},
        {"name": "fsdp_cut", "kind": "lm", "init": path, "interrupt_at": 2,
         "cfg": dict(cut, checkpoint_dir="ck-f", **FSDP)},
        {"name": "dp_from_fsdp", "kind": "lm",
         "cfg": dict(cut, checkpoint_dir="ck-d-r",
                     resume="ck-f/lm-checkpoint.pt", **DP2)},
        {"name": "dp_cut", "kind": "lm", "init": path, "interrupt_at": 2,
         "cfg": dict(cut, checkpoint_dir="ck-d", **DP2)},
        {"name": "fsdp_from_dp", "kind": "lm",
         "cfg": dict(cut, checkpoint_dir="ck-f-r",
                     resume="ck-d/lm-checkpoint.pt", **FSDP)},
    ]
    out = str(tmp / "port")
    return {"ref": (losses, mode), "init": init, "out": out,
            "port": run_group(2, {"jobs": jobs}, out)}


def test_specs_match_reference_leaf_by_leaf(runs):
    from tpu_dist.parallel.fsdp import fsdp_specs as jax_specs
    from tpu_dist_torch.parallel.fsdp import fsdp_specs

    init = runs["init"]
    leaves = named(init)
    want = {n: spec_tuple(s, a.ndim) for (n, a), s in zip(
        leaves.items(), jax.tree.leaves(
            jax_specs(init, 2),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))}
    got = fsdp_specs(((n, a.shape) for n, a in leaves.items()), 2)
    assert got == want
    assert got["tok_emb.weight"] == ("data", None)        # 64 > 32
    assert got["blocks.0.qkv.kernel"] == (None, "data")   # 96 > 32
    assert got["blocks.0.ln1.scale"] == (None,)           # < 1024
    # ties take the earliest dim; nothing divisible replicates
    assert fsdp_specs([("w", (64, 64)), ("u", (33, 35))], 2) == {
        "w": ("data", None), "u": (None, None)}


def test_step_loss_and_gradients_match_reference(runs):
    from tpu_dist.models.transformer import tiny_lm

    model = tiny_lm(vocab_size=64, num_layers=2, d_model=32, num_heads=2,
                    max_len=32)
    loss, want, hits = jax_grads(model, runs["init"], GRADS)
    assert runs["port"][0]["grads"]["loss"] == pytest.approx(loss, rel=1e-5)
    assert runs["port"][0]["grads"]["correct1"] == hits
    with np.load(os.path.join(runs["out"], "grads.grads.npz")) as z:
        assert set(z.files) == set(want)
        for n in want:
            np.testing.assert_allclose(z[n], want[n], rtol=1e-4, atol=2e-6,
                                       err_msg=n)


def test_state_holds_only_the_shards(runs):
    shapes = runs["port"][0]["grads"]["local_shapes"]
    assert [32, 32] in shapes          # tok_emb (64, 32) over 2 ranks
    assert [32, 48] in shapes          # qkv (32, 96)
    assert [32] in shapes              # LayerNorms stay whole


@pytest.mark.parametrize("name,twin", [("fsdp", "dp"),
                                       ("fsdp_fused", "dp_fused")])
def test_two_rank_trainer_matches_reference_and_dp_twin(runs, name, twin):
    want, mode = runs["ref"]
    r0, r1 = (r[name] for r in runs["port"])
    assert r0["mode"] == r1["mode"] == "fsdp" == mode
    assert r0["step"] == r1["step"] == 3 and r0["local_batch"] == 2
    if name == "fsdp":
        assert_losses(r0["losses"], want, "fsdp vs the JAX LMTrainer")
    assert_losses(r0["losses"], runs["port"][0][twin]["losses"],
                  f"{name} vs the port's dp twin")
    assert r0["best"] == pytest.approx(r1["best"], rel=1e-6)


@pytest.mark.parametrize("whole,cut,resumed", [
    ("fsdp4", "fsdp_cut", "dp_from_fsdp"), ("fsdp4", "dp_cut",
                                            "fsdp_from_dp")])
def test_checkpoint_round_trip_across_layouts(runs, whole, cut, resumed):
    a, b, c = (runs["port"][0][k] for k in (whole, cut, resumed))
    assert b["ckpt_meta"]["step"] == 2 and b["ckpt_meta"]["mid_epoch"]
    assert a["step"] == c["step"] == 4 and len(c["losses"]) == 2
    assert_losses(c["losses"], a["losses"][2:], f"{resumed} vs {whole}")
