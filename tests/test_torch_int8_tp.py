"""Tensor parallelism under ``quant="int8"`` in the port against the
reference's GSPMD program, on CPU (``tests/test_quant.py:262``'s setup):
gloo groups of 2 and 4 ranks (``tests/torch_dp_worker.py``, each spawned
once for the module), the JAX side on the suite's virtual CPU devices from
the same numpy-seeded params.

Under ``tp_impl="gspmd"`` a row-parallel product (``proj``, ``mlp_out``,
the MoE experts' ``w_out`` under ``ep-moe+tp``) holds a shard of its
contracted dim; the reference's one GSPMD program quantizes it by the
whole dim's row and column scales, and so does the port
(``ops.pallas_quant.fused_quant_matmul(group=)``: the maxima max-reduced
over ``model`` between the kernel's two phases). Held: one step's loss and
every leaf's gradient (gathered) at ``data=1,model=2`` against
``jax.value_and_grad`` of the reference's int8 objective within 1e-5; the
``LMTrainer`` losses there against the JAX ``LMTrainer`` on the same mesh;
the MoE's ``ep-moe+tp`` step at ``data=1,expert=2,model=2`` likewise; both
again at every init key below 8 (``KEYS``); and the two phases' plain
versions against the one-call plain version.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from torch_dp_worker import run_group  # noqa: E402
from torch_lm_ref import (LM, assert_losses, jax_grads,  # noqa: E402
                          jax_trainer, save_init)

torch.set_num_threads(1)

Q = dict(LM, quant="int8")
TP = dict(mesh_shape=[1, 2], mesh_axes=["data", "model"])
E = 4
MOE = dict(Q, num_experts=E, moe_group_size=32, router_top_k=2)
EPTP = dict(mesh_shape=[1, 2, 2], mesh_axes=["data", "expert", "model"])
DP2 = dict(mesh_shape=[2], mesh_axes=["data"])
GRADS = dict(seed=7, batch=4, seq_len=32)
# The int8 objective rounds to integers, so an fp32 difference of an ulp
# between torch and XLA can move a value that sits on a rounding tie by
# one step, and a gradient by 1e-4 (the one-device port against JAX shows
# it at some inits as much as tp does). The gradient checks start from
# inits where the one-device product has no such tie: the dp twin's
# gradients are held to the same 1e-5, so a tie would show there too.
GRADS_KEY, MOE_KEY = 2, 1
# Every init key below 8, unchosen: a tie moves one of the three products
# (tp, the port's dp twin, the reference) off the other two, by up to
# 4.3e-4 at these keys (the dp twin at dense key 1; the reference at dense
# keys 0, 3, 4 and MoE keys 0, 3, 5). So tp is held within 1e-5 of the
# reference or of its dp twin, and within TIE of both: a tp fault (the
# local scales of a rank's shard) moves it off both.
KEYS = range(8)
TIE = 1e-3


def _dense():
    from tpu_dist.models.transformer import tiny_lm

    return tiny_lm(vocab_size=64, num_layers=2, d_model=32, num_heads=2,
                   max_len=32, quant="int8")


def _moe():
    from tpu_dist.models import moe as jmoe

    return jmoe.MoETransformerLM(vocab_size=64, num_layers=2, d_model=32,
                                 num_heads=2, num_experts=E, max_len=32,
                                 router_top_k=2, group_size=32, quant="int8")


def _init(model, key):
    return jax.tree_util.tree_map(np.asarray, model.init(
        {"params": jax.random.PRNGKey(key)}, np.zeros((1, 32), np.int32),
        train=False)["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("int8tp")
    init, tp_losses, tp_mode = jax_trainer(tmp, "tp", Q, (1, 2),
                                           ("data", "model"))
    path = save_init(tmp, "lm", init)
    grads_init = _init(_dense(), GRADS_KEY)
    grads_path = save_init(tmp, "grads", grads_init)
    moe_init = _init(_moe(), MOE_KEY)
    moe_path = save_init(tmp, "moe", moe_init)
    two = [{"name": "tp", "kind": "lm", "init": path, "cfg": dict(Q, **TP)},
           {"name": "grads", "kind": "lm_grads", "init": grads_path,
            "cfg": dict(Q, **TP), **GRADS},
           {"name": "grads_dp", "kind": "lm_grads", "init": grads_path,
            "cfg": dict(Q, **DP2), **GRADS},
           {"name": "grads_moe_dp", "kind": "lm_grads", "init": moe_path,
            "cfg": dict(MOE, **DP2), **GRADS}]
    four = [{"name": "grads_moe", "kind": "lm_grads", "init": moe_path,
             "cfg": dict(MOE, **EPTP), **GRADS}]
    inits = {}
    for k in KEYS:
        inits[k] = _init(_dense(), k), _init(_moe(), k)
        d, m = (save_init(tmp, f"{n}{k}", t) for n, t in zip("dm", inits[k]))
        two += [{"name": f"{n}{k}", "kind": "lm_grads", "init": i,
                 "cfg": dict(c, **mesh), **GRADS} for n, i, c, mesh in (
                     ("tp", d, Q, TP), ("dp", d, Q, DP2),
                     ("moe_dp", m, MOE, DP2))]
        four.append({"name": f"moe_tp{k}", "kind": "lm_grads", "init": m,
                     "cfg": dict(MOE, **EPTP), **GRADS})
    out = str(tmp / "port")
    return {"ref": (tp_losses, tp_mode), "init": grads_init,
            "moe_init": moe_init, "inits": inits, "out": out,
            "two": run_group(2, {"jobs": two}, out),
            "four": run_group(4, {"jobs": four}, out)}


def _held(runs, name, res, model, init):
    loss, want, hits = jax_grads(model, init, GRADS)
    assert res["loss"] == pytest.approx(loss, rel=1e-5)
    assert res["correct1"] == hits
    with np.load(os.path.join(runs["out"], f"{name}.grads.npz")) as z:
        assert set(z.files) == set(want)
        for n in want:
            np.testing.assert_allclose(z[n], want[n], rtol=1e-5, atol=1e-6,
                                       err_msg=n)


@pytest.mark.parametrize("name,mode", [("grads", "tp"),
                                       ("grads_dp", "dp")])
def test_int8_tp_step_loss_and_gradients_match_reference(runs, name, mode):
    res = runs["two"][0][name]
    assert res["mode"] == mode
    _held(runs, name, res, _dense(), runs["init"])


@pytest.mark.parametrize("group,name,mode", [
    ("four", "grads_moe", "ep-moe+tp"), ("two", "grads_moe_dp", "dp-moe")])
def test_int8_ep_tp_step_loss_and_gradients_match_reference(runs, group,
                                                           name, mode):
    res = runs[group][0][name]
    assert res["mode"] == mode
    _held(runs, name, res, _moe(), runs["moe_init"])


def _grads(runs, name):
    with np.load(os.path.join(runs["out"], f"{name}.grads.npz")) as z:
        return {n: z[n] for n in z.files}


def _within(got, want, rtol, atol):
    return set(got) == set(want) and all(
        np.allclose(got[n], want[n], rtol=rtol, atol=atol) for n in want)


@pytest.mark.parametrize("key", KEYS)
def test_int8_tp_gradients_at_every_init_key(runs, key):
    """Dense tp and ``ep-moe+tp`` at one init key (``KEYS``): loss and
    gradients within 1e-5 of the reference's or of the port's dp twin's,
    within ``TIE`` of both."""
    for i, (model, tp, dp, group) in enumerate((
            (_dense(), f"tp{key}", f"dp{key}", "two"),
            (_moe(), f"moe_tp{key}", f"moe_dp{key}", "four"))):
        res = runs[group][0][tp]
        assert res["mode"] == ("tp", "ep-moe+tp")[i]
        loss, want, _ = jax_grads(model, runs["inits"][key][i], GRADS)
        twin = runs["two"][0][dp]
        got, twin_g = _grads(runs, tp), _grads(runs, dp)
        near = [(res["loss"] == pytest.approx(l, rel=1e-5)
                 and _within(got, g, 1e-5, 1e-6))
                for l, g in ((loss, want), (twin["loss"], twin_g))]
        assert any(near), (tp, res["loss"], loss, twin["loss"])
        for l, g in ((loss, want), (twin["loss"], twin_g)):
            assert res["loss"] == pytest.approx(l, abs=TIE)
            assert _within(got, g, 0.0, TIE), tp


def test_int8_tp_trainer_matches_reference(runs):
    want, mode = runs["ref"]
    r0 = runs["two"][0]["tp"]
    assert r0["mode"] == mode == "tp" and r0["step"] == 3
    assert_losses(r0["losses"], want, "int8 tp vs the JAX LMTrainer")


@pytest.mark.parametrize("m,k,n", [(8, 40, 24), (33, 96, 17)])
def test_scaled_pair_plain_versions_compose_to_the_one_call(m, k, n):
    """The two phases' plain versions: with the local maxima, bit-equal to
    the one-call plain version; with a group's (larger) maxima, the
    quantization by those scales (``quant_einsum``'s math over the whole
    K)."""
    from tpu_dist_torch.ops import pallas_quant as pq
    from tpu_dist_torch.ops.quant import quantize_by_amax

    rng = np.random.default_rng(m * k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    xa, wa = pq.fused_quant_amax_plain(x, w)
    assert torch.equal(pq.fused_quant_scaled_plain(x, w, xa, wa),
                       pq.fused_quant_matmul_plain(x, w))
    gxa, gwa = xa * 1.5, wa * 2.0
    qx, sx = quantize_by_amax(x, gxa[:, None])
    qw, sw = quantize_by_amax(w, gwa[None, :])
    want = (qx.double() @ qw.double()).float() * (sx * sw)
    assert torch.equal(pq.fused_quant_scaled_plain(x, w, gxa, gwa), want)
