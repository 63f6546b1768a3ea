"""Pipeline parallelism's compositions in the port against the reference,
on CPU: gloo groups of 2 and 4 ranks (``tests/torch_dp_worker.py``, each
spawned once for the module) against the JAX ``LMTrainer`` on the suite's
virtual CPU devices, from the same initial params (mirroring
``tests/test_pp.py:127,264`` and ``tests/test_quant.py:319``).

Held, 3 steps of adamw with a clip that binds, losses within 1e-4
(1 + |loss|):

* pp x tp at ``data=1,stage=2,model=2`` (4 ranks), both schedules: the
  reference's mode strings, against the JAX pp trainer and the port's dp
  twin;
* the MoE LM under both schedules at ``data=1,stage=2`` against the JAX
  MoE pp trainer (each stage's router aux with its ``aux_weight / M``
  cotangent);
* the chunked head under 1F1B against the JAX pp trainer;
* ``quant="int8"`` under both schedules against the JAX int8 pp trainer
  (``tests/test_quant.py:319``), and under GPipe against the port's int8
  dp twin.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from torch_dp_worker import run_group  # noqa: E402
from torch_lm_ref import LM, assert_losses, jax_trainer, save_init  # noqa

torch.set_num_threads(1)

PP = dict(mesh_shape=[1, 2], mesh_axes=["data", "stage"], pp_microbatches=2)
PPTP = dict(mesh_shape=[1, 2, 2], mesh_axes=["data", "stage", "model"],
            pp_microbatches=2)
DP2 = dict(mesh_shape=[2], mesh_axes=["data"])
MOE = dict(LM, num_experts=4, moe_group_size=32, router_top_k=2)
PP_KW = dict(pp_microbatches=2)      # the JAX trainers' pp knobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tpu_dist_torch.interop import pp_unstack_tree

    tmp = tmp_path_factory.mktemp("ppmodes")
    stacked, pp_losses, _ = jax_trainer(tmp, "pp", dict(LM, **PP_KW),
                                        (1, 2), ("data", "stage"))
    moe_stacked, moe_losses, _ = jax_trainer(
        tmp, "moe", dict(MOE, **PP_KW), (1, 2), ("data", "stage"))
    q_stacked, q_losses, q_mode = jax_trainer(
        tmp, "int8", dict(LM, quant="int8", **PP_KW), (1, 2),
        ("data", "stage"))
    path = save_init(tmp, "lm", pp_unstack_tree(stacked))
    moe_path = save_init(tmp, "moe", pp_unstack_tree(moe_stacked))
    q_path = save_init(tmp, "int8", pp_unstack_tree(q_stacked))
    two = [
        {"name": f"moe_{s}", "kind": "lm", "init": moe_path,
         "cfg": dict(MOE, pp_schedule=s, **PP)} for s in ("gpipe", "1f1b")
    ] + [
        {"name": "chunked", "kind": "lm", "init": path,
         "cfg": dict(LM, pp_schedule="1f1b", loss_chunk=24, **PP)},
        {"name": "dp", "kind": "lm", "init": path, "cfg": dict(LM, **DP2)},
        {"name": "dp_int8", "kind": "lm", "init": q_path,
         "cfg": dict(LM, quant="int8", **DP2)},
    ] + [
        {"name": f"int8_{s}", "kind": "lm", "init": q_path,
         "cfg": dict(LM, quant="int8", pp_schedule=s, **PP)}
        for s in ("gpipe", "1f1b")
    ]
    four = [{"name": f"pptp_{s}", "kind": "lm", "init": path,
             "cfg": dict(LM, pp_schedule=s, **PPTP)}
            for s in ("gpipe", "1f1b")]
    out = str(tmp / "port")
    return {"ref": {"pp": pp_losses, "moe": moe_losses,
                    "int8": (q_losses, q_mode)},
            "two": run_group(2, {"jobs": two}, out),
            "four": run_group(4, {"jobs": four}, str(tmp / "port4"))}


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_pp_x_tp_matches_reference_and_dp_twin(runs, sched):
    got = [r[f"pptp_{sched}"] for r in runs["four"]]
    assert {g["mode"] for g in got} == {f"pp-{sched}+tp"}
    assert {g["step"] for g in got} == {3}
    assert_losses(got[0]["losses"], runs["ref"]["pp"],
                  f"pp x tp {sched} vs the JAX pp LMTrainer")
    assert_losses(got[0]["losses"], runs["two"][0]["dp"]["losses"],
                  f"pp x tp {sched} vs the port's dp twin")


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_moe_under_pp_matches_reference(runs, sched):
    r0 = runs["two"][0][f"moe_{sched}"]
    assert r0["mode"] == f"pp-{sched}" and r0["step"] == 3
    assert_losses(r0["losses"], runs["ref"]["moe"],
                  f"MoE pp {sched} vs the JAX MoE pp LMTrainer")


def test_1f1b_chunked_head_matches_reference(runs):
    r0 = runs["two"][0]["chunked"]
    assert r0["mode"] == "pp-1f1b"
    assert_losses(r0["losses"], runs["ref"]["pp"],
                  "1f1b chunked vs the JAX pp LMTrainer")


def test_int8_gpipe_matches_int8_dp(runs):
    pp, dp = runs["two"][0]["int8_gpipe"], runs["two"][0]["dp_int8"]
    assert pp["mode"] == "pp-gpipe" and dp["mode"] == "dp"
    assert np.isfinite(pp["losses"]).all()
    assert_losses(pp["losses"], dp["losses"], "int8 gpipe vs int8 dp")


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_int8_under_pp_matches_reference(runs, sched):
    want, mode = runs["ref"]["int8"]
    r0 = runs["two"][0][f"int8_{sched}"]
    assert mode == "pp-gpipe" and r0["mode"] == f"pp-{sched}"
    assert r0["step"] == 3
    assert_losses(r0["losses"], want, f"int8 pp {sched} vs the JAX int8 "
                  "pp LMTrainer")
