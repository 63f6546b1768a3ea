"""The port's ViT (``tpu_dist_torch/models/vit.py``) against the flax
reference on the CPU, from the same params:

* a small ViT (4 px patches on 16 px images, 2 blocks, width 32): the
  eval logits and the gradient of the summed cross entropy, for ``quant``
  none (within ``1e-4 * (1 + |ref|)``) and int8 (``1e-3``: the two
  frameworks sum the fp32 dequant products in different orders, and a
  difference can move a value across an int8 rounding boundary in the
  next layer). The reference's int8 path on the CPU is its non-fused XLA
  product, the port's the plain version of ``csrc/fused_quant.cu``; both
  backward passes are the straight-through estimator;
* the port's ``Trainer(arch="vit_cifar")`` against the JAX ``Trainer``:
  one ``sgd`` step of 8 images and the validation that follows, for
  ``quant`` none and int8: the step's loss at the same tolerances and the
  same acc@1; the updated params element by element (none), or (int8)
  each leaf's update within 3e-2 of the reference's in relative L2: over
  8 blocks a few values cross an int8 rounding boundary in one framework
  and not the other, each moving by one quant step (1/127 of its row's
  amax), and the straight-through gradients move with them (1.5e-2 seen
  here). The step record's ``fused`` flag is false on the CPU;
* ``quant`` on a conv arch raises the reference's ``ValueError``; ring
  tensor parallelism on a conv arch, or with no ``model`` axis, raises the
  reference's ``ValueError`` (``tpu_dist/engine/loop.py:125-170``), and a
  ``model`` axis under ``tp_impl="gspmd"`` raises ``NotImplementedError``;
* ``tp_impl="ring"`` (the ``ring_ar`` flavour) on a gloo group of 2 ranks
  (``tests/torch_dp_worker.py``, spawned once for the module): the logits
  against the reference's ring ViT under ``shard_map`` on 2 virtual
  devices (``tests/test_overlap.py:176``) and the summed cross entropy's
  gradient against the plain reference, within 1e-5 (int8: the logits
  within 1e-3 of the reference's ring, which quantizes each row shard by
  its own scales too); the ring ``Trainer`` at ``data=1,model=2`` against
  its ``data=2`` twin, step for step (``tests/test_overlap.py:353``).
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from tpu_dist.engine.loop import Trainer as JaxTrainer  # noqa: E402
from tpu_dist.engine.steps import cross_entropy_sum as jax_ce  # noqa: E402
from tpu_dist.models import vit as jvit  # noqa: E402
from tpu_dist_torch.configs import TrainConfig  # noqa: E402
from tpu_dist_torch.engine.loop import Trainer  # noqa: E402
from tpu_dist_torch.engine.steps import cross_entropy_sum  # noqa: E402
from tpu_dist_torch.interop import export_flax_image_params  # noqa: E402
from tpu_dist_torch.models import vit  # noqa: E402

torch.set_num_threads(1)

TOL = {"none": 1e-4, "int8": 1e-3}
SMALL = dict(num_classes=10, patch_size=4, num_layers=2, d_model=32,
             num_heads=2)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    bad = diff > tol * (1 + np.abs(want))
    assert not bad.any(), f"{what}: max |diff| {diff.max()} ({bad.sum()} bad)"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_vit_forward_and_grads_match_flax(quant):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    y = np.array([1, 4, 7], np.int32)
    port = vit.ViT(image_shape=(16, 16, 3), quant=quant, device="cpu",
                   seed=0, **SMALL)
    params, _ = export_flax_image_params(port)
    ref = jvit.ViT(quant=quant, **SMALL)

    def loss(p):
        logits = ref.apply({"params": p}, jnp.asarray(x), train=True)
        return jax_ce(logits, jnp.asarray(y)), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    port.requires_grad_(True)
    logits = port(torch.from_numpy(x))
    grads = torch.autograd.grad(
        cross_entropy_sum(logits, torch.from_numpy(y).long()),
        list(port.parameters()))
    tol = TOL[quant]
    _close(logits.detach().numpy(), jlogits, tol, "logits")
    with torch.no_grad():
        for p, g in zip(port.parameters(), grads):
            p.copy_(g)
    got, want = _flat(export_flax_image_params(port)[0]), _flat(jgrads)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], tol, f"grad {k}")


def _losses(path):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["event"] == "step"]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_vit_trainer_step_matches_reference_trainer(tmp_path, quant):
    kw = dict(arch="vit_cifar", dataset="cifar10", batch_size=8, epochs=1,
              synth_train_size=8, synth_val_size=8, precision="fp32",
              seed=0, print_freq=1, workers=1, log_csv="", optimizer="sgd",
              quant=quant, data=str(tmp_path / "no-data"))
    one_device = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    ref = JaxTrainer(JaxTrainConfig(
        checkpoint_dir=str(tmp_path / "jck"),
        ledger_path=str(tmp_path / "j.jsonl"), **kw), mesh=one_device)
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(ref.state.params))
    ref_acc = ref.fit()
    want_params = _flat(jax.device_get(ref.state.params))
    start = _flat(init)
    port = Trainer(TrainConfig(checkpoint_dir=str(tmp_path / "tck"),
                               ledger_path=str(tmp_path / "t.jsonl"), **kw),
                   device="cpu", init_params=init)
    port_acc = port.fit()
    tol = TOL[quant]
    (want,), (got,) = _losses(tmp_path / "j.jsonl"), _losses(
        tmp_path / "t.jsonl")
    assert abs(got["loss"] - want["loss"]) <= tol * (1 + abs(want["loss"]))
    assert got["fused"] is False and port.state.step == 1
    got_params = _flat(export_flax_image_params(port.model)[0])
    assert got_params.keys() == want_params.keys()
    for k, want_p in want_params.items():
        if quant == "none":
            _close(got_params[k], want_p, tol, f"param {k}")
            continue
        du, dg = want_p - start[k], got_params[k] - start[k]
        assert np.linalg.norm(dg - du) <= 3e-2 * np.linalg.norm(du), k
    assert port_acc == pytest.approx(ref_acc, abs=1e-6)


def test_quant_is_refused_for_conv_archs_and_ring_tp_for_vit():
    cfg = dict(dataset="cifar10", batch_size=8, synth_train_size=8,
               synth_val_size=8, quant="int8", log_csv="")
    with pytest.raises(ValueError, match=r"applies to the transformer-family"
                                         r" image archs \(vit_\*\); arch "
                                         "'resnet18' does not take it"):
        Trainer(TrainConfig(arch="resnet18", **cfg), device="cpu")
    with pytest.raises(ValueError, match="unknown quant mode"):
        Trainer(TrainConfig(arch="vit_cifar", **{**cfg, "quant": "int4"}),
                device="cpu")
    # the reference's ring checks (loop.py:125-170): vit archs only, and a
    # model axis of 2 or more; gspmd image tp is not ported
    with pytest.raises(ValueError, match="--tp-impl ring applies to the "
                                         "transformer-family"):
        Trainer(TrainConfig(arch="resnet18", tp_impl="ring",
                            **{**cfg, "quant": "none"}), device="cpu")
    with pytest.raises(ValueError, match="'model' mesh axis of size >= 2"):
        Trainer(TrainConfig(arch="vit_cifar", tp_impl="ring",
                            mesh_shape=(1, 1), mesh_axes=("data", "model"),
                            **cfg), device="cpu")
    # a model axis under tp_impl="gspmd" is the reference's jit step:
    # the params replicated, the batch over 'data' (any arch)
    tr = Trainer(TrainConfig(arch="vit_cifar", mesh_shape=(1, 1),
                             mesh_axes=("data", "model"), **cfg),
                 device="cpu")
    assert tr.compiled.plan.layout == "dp" and tr.mesh.shape["model"] == 1
    with pytest.raises(ValueError, match="mesh_axes"):
        Trainer(TrainConfig(arch="vit_cifar", mesh_shape=(1,),
                            mesh_axes=("seq",), **cfg), device="cpu")
    with pytest.raises(ValueError, match="tp_impl='ring'"):
        vit.ViT(device="cpu", **SMALL).set_tp(None)


RING = dict(num_classes=5, patch_size=4, num_layers=2, d_model=32,
            num_heads=4)
RING_JOB = dict(seed=3, batch=2, image_shape=[8, 8, 3])


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    from torch_dp_worker import run_group
    from torch_lm_ref import save_init

    tmp = tmp_path_factory.mktemp("vitring")
    x0 = np.zeros([1] + RING_JOB["image_shape"], np.float32)
    inits = {q: jax.tree_util.tree_map(np.asarray, jvit.ViT(
        quant=q, **RING).init({"params": jax.random.PRNGKey(0)}, x0,
                              train=False)["params"])
             for q in ("none", "int8")}
    jobs = [{"name": f"ring_{q}", "kind": "vit_ring", "quant": q,
             "init": save_init(tmp, q, inits[q]), "model": RING, **RING_JOB}
            for q in ("none", "int8")]
    tr = dict(arch="vit_cifar", dataset="cifar10", batch_size=8, epochs=1,
              synth_train_size=16, synth_val_size=8, precision="fp32",
              seed=0, print_freq=1, workers=1, log_csv="", optimizer="sgd",
              data=str(tmp / "no-data"))
    jobs += [{"name": "tr_ring", "kind": "image",
              "cfg": dict(tr, tp_impl="ring", mesh_shape=[1, 2],
                          mesh_axes=["data", "model"])},
             {"name": "tr_dp", "kind": "image",
              "cfg": dict(tr, mesh_shape=[2], mesh_axes=["data"])}]
    out = str(tmp / "port")
    return {"inits": inits, "out": out,
            "port": run_group(2, {"jobs": jobs}, out)}


def _ring_inputs():
    rng = np.random.default_rng(RING_JOB["seed"])
    x = rng.standard_normal([RING_JOB["batch"]] + RING_JOB["image_shape"])
    y = rng.integers(0, RING["num_classes"], RING_JOB["batch"])
    return x.astype(np.float32), y


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_ring_vit_step_matches_reference_ring(ring_runs, quant):
    from tpu_dist._compat import shard_map
    from jax.sharding import PartitionSpec as P

    params = ring_runs["inits"][quant]
    x, y = _ring_inputs()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("model",))
    ring = jvit.ViT(quant=quant, tp_impl="ring", **RING)
    f = jax.jit(shard_map(
        lambda p, t: ring.apply({"params": p}, t, train=False),
        mesh=mesh, in_specs=(P(), P()), out_specs=P(), check_vma=False))
    want = np.asarray(f(params, x))
    tol = 1e-5 if quant == "none" else TOL["int8"]
    for r in ring_runs["port"]:
        _close(r[f"ring_{quant}"]["logits"], want, tol, "ring logits")
    if quant != "none":
        return
    plain = jvit.ViT(**RING)

    def loss(p):
        return jax_ce(plain.apply({"params": p}, jnp.asarray(x),
                                  train=True), jnp.asarray(y))

    grads = _flat(jax.jit(jax.grad(loss))(params))
    with np.load(f"{ring_runs['out']}/ring_none.grads.npz") as z:
        assert set(z.files) == set(grads)
        for k in grads:
            _close(z[k], grads[k], 1e-5, f"grad {k}")


def test_ring_vit_trainer_matches_its_dp_twin(ring_runs):
    ring, dp = (_losses(f"{ring_runs['out']}/{n}.jsonl")
                for n in ("tr_ring", "tr_dp"))
    assert len(ring) == len(dp) == 2
    for a, b in zip(ring, dp):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    r0, r1 = (r["tr_ring"] for r in ring_runs["port"])
    assert r0["best"] == pytest.approx(r1["best"], abs=1e-9)
