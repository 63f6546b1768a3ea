"""Ring attention and sequence parallelism in the port
(``parallel.ring_attention``, ``parallel.collectives.ppermute``, the
``sp-ring`` mode) against the reference, on CPU: gloo groups of 2 and 4
ranks (``tests/torch_dp_worker.py``, each spawned once for the module);
the JAX side runs under ``shard_map`` and the JAX ``LMTrainer`` on the
suite's virtual CPU devices.

Held (mirroring ``tests/test_ring_attention.py:23-59``):

* ring attention over 2 and 4 sequence chunks equals the reference's full
  attention, causal and not (forward within 2e-5), and its gradients
  through ``ppermute``'s reverse-shift backward equal full attention's
  (5e-4 relative, as the reference holds its own ring), and the
  reference's ring under ``shard_map`` gives the same chunks;
* ``ppermute`` on CPU tensors over gloo takes the ``host`` route;
* one sp step's loss and every leaf's gradient against
  ``jax.value_and_grad`` of the reference's objective;
* the ``LMTrainer`` at ``data=1,seq=2``: the mode string, per-step
  losses against the JAX ``LMTrainer`` on the same mesh and against the
  port's dp twin, within 1e-4 (1 + |loss|); its windowed path (rows
  gathered and cut on the device, ``_sp_window_slices``) equals the host
  path.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from tpu_dist._compat import shard_map  # noqa: E402
from tpu_dist.models.transformer import full_attention  # noqa: E402
from tpu_dist.parallel.ring_attention import \
    ring_attention as jax_ring  # noqa: E402
from torch_dp_worker import run_group  # noqa: E402
from torch_lm_ref import (LM, assert_losses, jax_grads,  # noqa: E402
                          jax_trainer, save_init)

torch.set_num_threads(1)

SP = dict(mesh_shape=[1, 2], mesh_axes=["data", "seq"])
DP2 = dict(mesh_shape=[2], mesh_axes=["data"])
GRADS = dict(seed=7, batch=4, seq_len=32)
QKV = dict(seed=0, shape=[2, 32, 4, 16])
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    init, losses, mode = jax_trainer(tmp, "sp", LM, (1, 2), ("data", "seq"))
    path = save_init(tmp, "lm", init)
    ring = {"name": "ring", "kind": "ring_attention", **QKV}
    jobs = [
        ring,
        {"name": "sp", "kind": "lm", "init": path, "cfg": dict(LM, **SP)},
        {"name": "dp", "kind": "lm", "init": path, "cfg": dict(LM, **DP2)},
        {"name": "sp_windowed", "kind": "lm", "init": path,
         "cfg": dict(LM, steps_per_dispatch=3, data_placement="device",
                     **SP)},
        {"name": "grads", "kind": "lm_grads", "init": path,
         "cfg": dict(LM, **SP), **GRADS},
    ]
    out = str(tmp / "port")
    port = {2: run_group(2, {"jobs": jobs}, out),
            4: run_group(4, {"jobs": [ring]}, str(tmp / "port4"))}
    return {"ref": (losses, mode), "init": init, "port": port, "out": out}


def _qkv():
    rng = np.random.default_rng(QKV["seed"])
    return [rng.normal(size=QKV["shape"]).astype(np.float32)
            for _ in range(3)]


def _chunks(port, world, causal, key):
    return np.concatenate([np.asarray(r["ring"][f"causal={causal}"][key])
                           for r in port[world]], axis=1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_full_attention(runs, world, causal):
    q, k, v = map(jnp.asarray, _qkv())
    ref = np.asarray(full_attention(q, k, v, causal=causal))
    got = _chunks(runs["port"], world, causal, "out")
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:world]), ("seq",))
    ring = jax.jit(shard_map(
        lambda q, k, v: jax_ring(q, k, v, "seq", causal=causal), mesh=mesh,
        in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"),
        check_vma=False))
    np.testing.assert_allclose(got, np.asarray(ring(q, k, v)), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", [True, False])
def test_ring_gradients_match_full_attention(runs, world, causal):
    q, k, v = map(jnp.asarray, _qkv())

    def loss(q, k, v):
        return jnp.sum(full_attention(q, k, v, causal=causal) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for name, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(_chunks(runs["port"], world, causal, name),
                                   np.asarray(w), rtol=5e-4, atol=5e-5,
                                   err_msg=name)


def test_ppermute_route_on_cpu_gloo(runs):
    from tpu_dist_torch.parallel.collectives import p2p_route

    assert {r["ring"]["route"] for r in runs["port"][2]} == {"host"}
    assert p2p_route(None, "cpu") == "none"     # one process: no transfer


def test_sp_step_loss_and_gradients_match_reference(runs):
    from tpu_dist.models.transformer import tiny_lm

    model = tiny_lm(vocab_size=64, num_layers=2, d_model=32, num_heads=2,
                    max_len=32)
    loss, want, hits = jax_grads(model, runs["init"], GRADS)
    assert runs["port"][2][0]["grads"]["loss"] == pytest.approx(loss,
                                                               rel=1e-5)
    assert runs["port"][2][0]["grads"]["correct1"] == hits
    with np.load(os.path.join(runs["out"], "grads.grads.npz")) as z:
        assert set(z.files) == set(want)
        for n in want:
            np.testing.assert_allclose(z[n], want[n], rtol=1e-4, atol=2e-6,
                                       err_msg=n)


def test_two_rank_sp_trainer_matches_reference_and_dp_twin(runs):
    want, mode = runs["ref"]
    r0, r1 = (r["sp"] for r in runs["port"][2])
    assert r0["mode"] == r1["mode"] == "sp-ring" == mode
    assert r0["step"] == r1["step"] == 3 and r0["local_batch"] == 4
    assert_losses(r0["losses"], want, "sp vs the JAX LMTrainer")
    assert_losses(r0["losses"], runs["port"][2][0]["dp"]["losses"],
                  "sp vs the port's dp twin")
    assert r0["best"] == pytest.approx(r1["best"], rel=1e-6)


def test_sp_windowed_path_equals_host_path(runs):
    per_step = runs["port"][2][0]["sp"]["losses"]
    window = runs["port"][2][0]["sp_windowed"]["losses"]
    assert len(window) == 1
    assert window[0] == pytest.approx(np.mean(per_step), rel=1e-5)
