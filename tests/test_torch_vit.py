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
* ``quant`` on a conv arch raises the reference's ``ValueError``, and
  ``tp_impl="ring"`` raises ``NotImplementedError`` naming itself.
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
    with pytest.raises(NotImplementedError, match="tp_impl='ring'"):
        vit.ViT(tp_impl="ring", device="cpu", **SMALL)
