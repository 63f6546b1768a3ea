"""Expert parallelism in the port (``parallel.ep``, ``models.moe``)
against the reference, on CPU: gloo groups of 2 and 4 ranks
(``tests/torch_dp_worker.py``, each spawned once for the module) against
the JAX ``LMTrainer`` on the suite's virtual CPU devices, from the same
numpy-seeded params (mirroring ``tests/test_moe.py:73,286``).

Held: ``ep-moe`` at ``data=1,expert=2`` and ``ep-moe+tp`` at
``data=1,expert=2,model=2`` (4 ranks): the reference's mode strings, each
rank holding E/2 experts, per-step losses (top-2, adamw with a clip that
binds: the clip's norm sums the expert shards' squares over ``expert``)
against the JAX ``LMTrainer`` on the same mesh and against the port's dp
twin (``dp-moe`` at ``data=2``, whose balance loss is the whole batch's,
as GSPMD's is) within 1e-4 (1 + |loss|); one ep step's loss and every
leaf's gradient (the expert shards gathered) against
``jax.value_and_grad`` of the reference's objective, router aux
included; an ep checkpoint resumes under dp and a dp checkpoint under
ep, at the exact step.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist.models import moe as jmoe  # noqa: E402
from torch_dp_worker import run_group  # noqa: E402
from torch_lm_ref import (LM, assert_losses, jax_grads,  # noqa: E402
                          jax_trainer, save_init)

torch.set_num_threads(1)

E = 4
MOE = dict(LM, num_experts=E, moe_group_size=32, router_top_k=2)
EP = dict(mesh_shape=[1, 2], mesh_axes=["data", "expert"])
EPTP = dict(mesh_shape=[1, 2, 2], mesh_axes=["data", "expert", "model"])
DP2 = dict(mesh_shape=[2], mesh_axes=["data"])
GRADS = dict(seed=7, batch=4, seq_len=32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    init, ep_losses, ep_mode = jax_trainer(tmp, "ep", MOE, (1, 2),
                                           ("data", "expert"))
    _, eptp_losses, eptp_mode = jax_trainer(tmp, "eptp", MOE, (1, 2, 2),
                                            ("data", "expert", "model"))
    path = save_init(tmp, "moe", init)
    two = [{"name": "ep", "kind": "lm", "init": path,
            "cfg": dict(MOE, **EP)},
           {"name": "dp", "kind": "lm", "init": path,
            "cfg": dict(MOE, **DP2)},
           {"name": "grads", "kind": "lm_grads", "init": path,
            "cfg": dict(MOE, **EP), **GRADS},
           # checkpoint round trips: 4 steps whole, cut at 2, resumed
           {"name": "ep4", "kind": "lm", "init": path,
            "cfg": dict(MOE, max_steps=4, checkpoint_dir="ck-e4", **EP)},
           {"name": "ep_cut", "kind": "lm", "init": path, "interrupt_at": 2,
            "cfg": dict(MOE, max_steps=4, checkpoint_dir="ck-e", **EP)},
           {"name": "dp_from_ep", "kind": "lm",
            "cfg": dict(MOE, max_steps=4, checkpoint_dir="ck-d-r",
                        resume="ck-e/lm-checkpoint.pt", **DP2)},
           {"name": "dp_cut", "kind": "lm", "init": path, "interrupt_at": 2,
            "cfg": dict(MOE, max_steps=4, checkpoint_dir="ck-d", **DP2)},
           {"name": "ep_from_dp", "kind": "lm",
            "cfg": dict(MOE, max_steps=4, checkpoint_dir="ck-e-r",
                        resume="ck-d/lm-checkpoint.pt", **EP)}]
    four = [{"name": "eptp", "kind": "lm", "init": path,
             "cfg": dict(MOE, **EPTP)}]
    out = str(tmp / "port")
    return {"ref": {"ep": (ep_losses, ep_mode),
                    "eptp": (eptp_losses, eptp_mode)},
            "init": init, "out": out,
            "two": run_group(2, {"jobs": two}, out),
            "four": run_group(4, {"jobs": four}, str(tmp / "port4"))}


def test_two_rank_ep_matches_reference_and_dp_twin(runs):
    want, mode = runs["ref"]["ep"]
    r0, r1 = (r["ep"] for r in runs["two"])
    assert r0["mode"] == r1["mode"] == mode == "ep-moe"
    assert r0["step"] == 3
    assert_losses(r0["losses"], want, "ep-moe vs the JAX LMTrainer")
    assert_losses(r0["losses"], runs["two"][0]["dp"]["losses"],
                  "ep-moe vs the port's dp twin")


def test_ep_step_gradients_match_reference(runs):
    model = jmoe.MoETransformerLM(vocab_size=64, num_layers=2, d_model=32,
                                  num_heads=2, num_experts=E, max_len=32,
                                  router_top_k=2, group_size=32)
    loss, want, hits = jax_grads(model, runs["init"], GRADS)
    res = runs["two"][0]["grads"]
    assert res["loss"] == pytest.approx(loss, rel=1e-5)
    assert res["correct1"] == hits
    with np.load(os.path.join(runs["out"], "grads.grads.npz")) as z:
        assert set(z.files) == set(want)
        for n in want:
            np.testing.assert_allclose(z[n], want[n], rtol=1e-4, atol=2e-6,
                                       err_msg=n)
    assert [2, 32, 128] in res["local_shapes"]      # E/2 experts a rank


def test_four_rank_ep_tp_matches_reference(runs):
    want, mode = runs["ref"]["eptp"]
    got = [r["eptp"] for r in runs["four"]]
    assert {g["mode"] for g in got} == {mode} == {"ep-moe+tp"}
    assert_losses(got[0]["losses"], want, "ep-moe+tp vs the JAX LMTrainer")
    assert_losses(got[0]["losses"], runs["two"][0]["dp"]["losses"],
                  "ep-moe+tp vs the port's dp twin")


@pytest.mark.parametrize("whole,cut,resumed", [
    ("ep4", "ep_cut", "dp_from_ep"), ("ep4", "dp_cut", "ep_from_dp")])
def test_checkpoint_round_trip_across_layouts(runs, whole, cut, resumed):
    a, b, c = (runs["two"][0][k] for k in (whole, cut, resumed))
    assert b["ckpt_meta"]["step"] == 2 and b["ckpt_meta"]["mid_epoch"]
    assert a["step"] == c["step"] == 4 and len(c["losses"]) == 2
    assert_losses(c["losses"], a["losses"][2:], f"{resumed} vs {whole}")
