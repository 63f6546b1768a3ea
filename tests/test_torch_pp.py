"""Pipeline parallelism in the port (``parallel.pp``, ``LMTrainer`` with a
``stage`` axis) against the reference, on CPU: one gloo group of 2 ranks
(``tests/torch_dp_worker.py``, spawned once for the module) runs every
port job; the JAX ``LMTrainer`` runs on the suite's virtual CPU devices
from the same initial params (mirroring ``tests/test_pp.py``).

Held, at ``data=1,stage=2`` with 4 microbatches (a clip that binds;
sgd for the one-step parity, adamw for the multi-step runs):

* ``pp-gpipe`` and ``pp-1f1b``: the reference's mode strings, the step's
  loss, and every parameter after one step (gathered from both stages)
  against the JAX pp step and the JAX dp step, within 1e-5;
* the clip binds: the same step without it moves the params elsewhere;
* the windowed path (2 steps a dispatch over device rows) equals the host
  path, and a pp checkpoint cut at step 2 resumes at the exact step;
* structure: 1F1B stashes at most 2(S-1)+1 stage inputs at M=4 and at
  M=16; stage 0 never runs the head, stage S-1 never embeds, and the
  stages run their blocks once a microbatch (GPipe) or twice (1F1B: the
  recompute), so no bubble tick runs a block;
* the interop's stage trees: a JAX stage-stacked tree splits into rank
  s's stage tree and back, and unstacks to the whole model's.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from torch_dp_worker import run_group  # noqa: E402
from torch_lm_ref import LM, assert_losses, jax_trainer, save_init  # noqa

torch.set_num_threads(1)

M = 4
# the one-step parity runs take sgd: adam's first step moves a weight by
# about lr x sign(g), so a gradient within rounding of zero would move it
# by lr either way
ONE = dict(LM, max_steps=1, optimizer="sgd", lr=0.05)
PP = dict(mesh_shape=[1, 2], mesh_axes=["data", "stage"],
          pp_microbatches=M)
DP2 = dict(mesh_shape=[2], mesh_axes=["data"])
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tpu_dist_torch.interop import pp_unstack_tree

    tmp = tmp_path_factory.mktemp("pp")
    ref = {}
    for sched in ("gpipe", "1f1b"):
        ref[sched] = jax_trainer(tmp, sched, dict(ONE, pp_schedule=sched),
                                 (1, 2), ("data", "stage"), final=True)
    ref["dp"] = jax_trainer(tmp, "dp", ONE, (1,), ("data",), final=True)
    stacked = ref["gpipe"][0]
    path = save_init(tmp, "lm", pp_unstack_tree(stacked))
    four = dict(LM, max_steps=4, checkpoint_dir="ck")
    jobs = [
        {"name": "gpipe", "kind": "lm", "init": path, "cfg": dict(ONE, **PP)},
        {"name": "1f1b", "kind": "lm", "init": path,
         "cfg": dict(ONE, pp_schedule="1f1b", **PP)},
        {"name": "noclip", "kind": "lm", "init": path,
         "cfg": dict(ONE, grad_clip=0.0, **PP)},
        {"name": "dp", "kind": "lm", "init": path, "cfg": dict(ONE, **DP2)},
        {"name": "host2", "kind": "lm", "init": path,
         "cfg": dict(LM, max_steps=2, **PP)},
        {"name": "window2", "kind": "lm", "init": path,
         "cfg": dict(LM, max_steps=2, steps_per_dispatch=2,
                     data_placement="device", **PP)},
        {"name": "m16", "kind": "lm", "init": path,
         "cfg": dict(ONE, pp_schedule="1f1b", batch_size=16,
                     **{**PP, "pp_microbatches": 16})},
        # checkpoint round trip: 4 steps whole, cut at 2, resumed
        {"name": "pp4", "kind": "lm", "init": path,
         "cfg": dict(four, checkpoint_dir="ck-4", **PP)},
        {"name": "pp_cut", "kind": "lm", "init": path, "interrupt_at": 2,
         "cfg": dict(four, checkpoint_dir="ck-c", pp_schedule="1f1b", **PP)},
        {"name": "pp_resumed", "kind": "lm",
         "cfg": dict(four, checkpoint_dir="ck-r",
                     resume="ck-c/lm-checkpoint.pt", **PP)},
    ]
    out = str(tmp / "port")
    return {"ref": ref, "stacked": stacked, "out": out,
            "port": run_group(2, {"jobs": jobs}, out)}


def _whole(runs, name):
    with np.load(os.path.join(runs["out"], f"{name}.whole.npz")) as z:
        return dict(z)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_pp_step_matches_reference_pp_and_dp(runs, sched):
    r0, r1 = (r[sched] for r in runs["port"])
    _, pp_losses, pp_mode, pp_params = runs["ref"][sched]
    _, dp_losses, _, dp_params = runs["ref"]["dp"]
    assert r0["mode"] == r1["mode"] == pp_mode == f"pp-{sched}"
    assert r0["step"] == r1["step"] == 1 and r0["local_batch"] == 4
    np.testing.assert_allclose(r0["losses"], pp_losses, rtol=1e-5)
    np.testing.assert_allclose(r0["losses"], dp_losses, rtol=1e-5)
    got = _whole(runs, sched)
    assert set(got) == set(pp_params)
    for n in pp_params:
        np.testing.assert_allclose(got[n], pp_params[n], err_msg=n,
                                   **PARAM_TOL)
        np.testing.assert_allclose(got[n], dp_params[n], err_msg=n,
                                   **PARAM_TOL)
    assert r0["best"] == pytest.approx(r1["best"], rel=1e-6)


def test_pp_clip_binds_by_the_cross_stage_norm(runs):
    """The step with the clip equals dp's (whose clip reads the true
    global norm) and differs from the same step without it."""
    clip, noclip = _whole(runs, "gpipe"), _whole(runs, "noclip")
    dp = runs["ref"]["dp"][3]
    moved = max(float(np.abs(clip[n] - noclip[n]).max()) for n in clip)
    assert moved > 1e-4
    for n in dp:
        np.testing.assert_allclose(clip[n], dp[n], err_msg=n, **PARAM_TOL)


def test_pp_windowed_path_equals_host_path(runs):
    host = runs["port"][0]["host2"]["losses"]
    window = runs["port"][0]["window2"]["losses"]
    assert len(host) == 2 and len(window) == 1
    assert window[0] == pytest.approx(np.mean(host), rel=1e-5)


def test_pp_checkpoint_resumes_at_the_exact_step(runs):
    whole, cut, resumed = (runs["port"][0][k]
                           for k in ("pp4", "pp_cut", "pp_resumed"))
    meta = cut["ckpt_meta"]
    assert meta["step"] == 2 and meta["mid_epoch"] and meta["pp_stages"] == 2
    assert whole["step"] == resumed["step"] == 4
    assert len(resumed["losses"]) == 2
    assert_losses(resumed["losses"], whole["losses"][2:],
                  "resumed pp vs uninterrupted")


@pytest.mark.parametrize("name,m", [("1f1b", M), ("m16", 16)])
def test_1f1b_stash_bounded_independent_of_microbatches(runs, name, m):
    s = 2
    for r in runs["port"]:
        pp = r[name]["pp"]
        assert 1 <= pp["stash_peak"] <= 2 * (s - 1) + 1
        assert pp["work"]["ticks"] == m + 2 * (s - 1)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_pp_dead_work_is_skipped(runs, sched):
    """Stage 0 never runs the head, the last stage never embeds, and the
    blocks run once a microbatch (twice under 1F1B: the recompute), so no
    bubble tick runs a block. Each validation batch adds M heads (last
    stage), embeddings (stage 0) and block runs (every stage)."""
    per_step = 2 if sched == "1f1b" else 1
    r0, r1 = (r[sched]["pp"] for r in runs["port"])
    assert (r0["stage"], r1["stage"]) == (0, 1)
    assert r0["work"]["head"] == 0 and r1["work"]["embed"] == 0
    evals = (r1["work"]["stage_fwd"] - per_step * M) // M
    assert evals >= 1
    # the train step's heads (one a microbatch under 1F1B, one over the
    # batch under GPipe), then one a microbatch of each validation batch
    assert r1["work"]["head"] == (M if sched == "1f1b" else 1) + evals * M
    runs_of_blocks = per_step * M + evals * M
    assert r0["work"]["embed"] == runs_of_blocks
    for w in (r0["work"], r1["work"]):
        assert w["stage_fwd"] == runs_of_blocks
        assert w["ticks"] == (M + 2 if sched == "1f1b" else 2 * (M + 1))


def test_interop_stage_trees_round_trip(runs):
    from tpu_dist.parallel.pp import (stack_pipeline_params,
                                      unstack_pipeline_params)
    from tpu_dist_torch.interop import (pp_stack_trees, pp_stage_tree,
                                        pp_unstack_tree)

    stacked = runs["stacked"]
    stages = [pp_stage_tree(stacked, s) for s in range(2)]
    assert sorted(stages[1]) == ["block0", "lm_head", "ln_f", "pos_emb",
                                 "tok_emb"]
    back = pp_stack_trees(stages)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)  # noqa: E731
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(stacked), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    whole = pp_unstack_tree(stacked)
    c, d = flat(whole), flat(unstack_pipeline_params(stacked))
    assert c.keys() == d.keys()
    for k in c:
        np.testing.assert_array_equal(c[k], d[k])
    e = flat(stack_pipeline_params(whole, 2))
    for k in a:
        np.testing.assert_array_equal(a[k], e[k])
