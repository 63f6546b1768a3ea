"""The image trainer's one-device knobs in the port, on CPU: gradient
accumulation, the fp16 dynamic loss scale and the warm start, each held
against the JAX package on the same inputs.

* a one-hidden-layer MLP (BN-free and dropout-free, the reference's
  ``tests/test_engine.py`` ``_MLP``) from the JAX init: K accumulated
  microbatches equal one step over the whole batch (``:213``), and the
  port's accumulation step equals the JAX one; fp32, 1e-5 relative plus
  1e-7 absolute (summation order);
* ``LossScaleState`` halves on overflow (never below 1), grows after
  ``growth_interval`` finite steps and unscales exactly, step for step as
  the reference's (``tests/test_precision.py:27-37``); a loss-scaled step
  equals an unscaled one (the scale is a power of two, so the scaling is
  exact) and the JAX loss-scaled step; a planted overflow is skipped, the
  old params and momentum kept, the probes zero, and no health trip
  (``tests/test_health.py:72``);
* the warm start grafts a 1000-class donor into a 10-class model: every
  leaf but the classifier's two, exactly, BN stats included, as the
  reference's ``graft_params`` does on the same trees; a missing file
  raises first."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.data import make_transform as jax_transform  # noqa: E402
from tpu_dist.engine import checkpoint as jax_ckpt  # noqa: E402
from tpu_dist.engine import steps as jax_steps  # noqa: E402
from tpu_dist.engine.state import TrainState as JaxState  # noqa: E402
from tpu_dist.engine.state import init_model  # noqa: E402
from tpu_dist.ops import make_optimizer as jax_optimizer  # noqa: E402
from tpu_dist.ops import precision as jax_prec  # noqa: E402
from tpu_dist_torch.configs import TrainConfig  # noqa: E402
from tpu_dist_torch.data.pipeline import make_transform  # noqa: E402
from tpu_dist_torch.engine import checkpoint as ckpt  # noqa: E402
from tpu_dist_torch.engine.loop import Trainer  # noqa: E402
from tpu_dist_torch.engine.state import TrainState  # noqa: E402
from tpu_dist_torch.engine.steps import (apply_update,  # noqa: E402
                                         image_train_step)
from tpu_dist_torch.obs.health import HealthSentry  # noqa: E402
from tpu_dist_torch.ops import precision as prec  # noqa: E402
from tpu_dist_torch.ops.optim import make_optimizer  # noqa: E402
from tpu_dist_torch.ops.pallas_sgd import FusedSGD  # noqa: E402
from tpu_dist_torch.ops.quant import QuantDense  # noqa: E402

torch.set_num_threads(1)

SHAPE = (28, 28, 1)
TOL = dict(rtol=1e-5, atol=1e-7)


class _FlaxMLP:
    def __new__(cls):
        import flax.linen as nn

        class MLP(nn.Module):
            @nn.compact
            def __call__(self, x, train: bool = True):
                x = x.reshape((x.shape[0], -1))
                x = nn.relu(nn.Dense(32)(x))
                return nn.Dense(10)(x)

        return MLP()


class _MLP(torch.nn.Module):
    """The same model in the port's layers (flax's (in, out) layout)."""

    def __init__(self, params):
        super().__init__()
        self.d0 = QuantDense(784, 32, device="cpu")
        self.d1 = QuantDense(32, 10, device="cpu")
        with torch.no_grad():
            for mod, name in ((self.d0, "Dense_0"), (self.d1, "Dense_1")):
                mod.kernel.copy_(torch.from_numpy(
                    np.array(params[name]["kernel"])))
                mod.bias.copy_(torch.from_numpy(
                    np.array(params[name]["bias"])))
        self.requires_grad_(True)

    def forward(self, x):
        return self.d1(torch.relu(self.d0(x.reshape(x.shape[0], -1))))


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (n,) + SHAPE).astype(np.uint8)
    labels = (imgs.astype(np.int32).sum(axis=(1, 2, 3)) % 10).astype(
        np.int32)
    return imgs, labels


def _setup():
    model = _FlaxMLP()
    params, stats = init_model(model, jax.random.PRNGKey(0), (2,) + SHAPE)
    return model, jax.device_get(params), stats


def _port_step(params, imgs, labels, accum=1, loss_scale=None, steps=1):
    model = _MLP(params)
    state = TrainState.create(
        model, make_optimizer(0.1, 0.9, 1e-4, steps_per_epoch=1000),
        prec.LossScaleState.create(loss_scale) if loss_scale else None)
    tx = make_optimizer(0.1, 0.9, 1e-4, steps_per_epoch=1000)
    transform = make_transform(np.full((1,), 0.5, np.float32),
                               np.full((1,), 0.25, np.float32))
    for _ in range(steps):
        m = image_train_step(model, tx, state, torch.from_numpy(imgs),
                             torch.from_numpy(labels), transform,
                             accum=accum)
    return state, m


def _jax_step(model, params, stats, imgs, labels, accum=1, loss_scale=None):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    tx = jax_optimizer(0.1, 0.9, 1e-4, steps_per_epoch=1000)
    state = JaxState.create(params, stats, tx,
                            jax_prec.LossScaleState.create(loss_scale)
                            if loss_scale else None)
    transform = jax_transform(np.full((1,), 0.5, np.float32),
                              np.full((1,), 0.25, np.float32))
    if accum > 1:
        step = jax_steps.make_grad_accum_train_step(model, tx, transform,
                                                    mesh, donate=False)
        imgs = imgs.reshape(accum, -1, *imgs.shape[1:])
        labels = labels.reshape(accum, -1)
        sh = NamedSharding(mesh, P(None, "data"))
    else:
        step = jax_steps.make_train_step(model, tx, transform, mesh,
                                         donate=False)
        sh = NamedSharding(mesh, P("data"))
    return step(state, jax.device_put(imgs, sh), jax.device_put(labels, sh),
                jax.random.PRNGKey(3))


def _flat_port(state):
    return np.concatenate([p.detach().numpy().ravel() for p in state.params])


def _flat_jax(state):
    p = jax.device_get(state.params)
    return np.concatenate([np.asarray(p[d][k]).ravel()
                           for d in ("Dense_0", "Dense_1")
                           for k in ("kernel", "bias")])


# ---- gradient accumulation ------------------------------------------------

def test_accum_equals_big_batch_and_the_reference_step():
    model, params, stats = _setup()
    imgs, labels = _batch(16)
    big, m_big = _port_step(params, imgs, labels)
    acc, m_acc = _port_step(params, imgs, labels, accum=4)
    assert float(m_acc["count"]) == 16 and acc.step == 1
    assert float(m_acc["loss_sum"]) == pytest.approx(
        float(m_big["loss_sum"]), rel=1e-5)
    np.testing.assert_allclose(_flat_port(acc), _flat_port(big), **TOL)
    ref, m_ref = _jax_step(model, params, stats, imgs, labels, accum=4)
    np.testing.assert_allclose(_flat_port(acc), _flat_jax(ref), **TOL)
    assert float(m_acc["correct1"]) == float(jax.device_get(
        m_ref["correct1"]))


# ---- the loss scale --------------------------------------------------------

def test_loss_scale_roundtrip():
    s = prec.LossScaleState.create(1024.0)
    assert float(prec.scale_loss(torch.tensor(2.0), s)) == 2048.0
    grads, s2, finite = prec.unscale_and_update([torch.full((3,), 1024.0)],
                                                s)
    assert bool(finite) and torch.equal(grads[0], torch.ones(3))
    g, none, ok = prec.unscale_and_update([torch.ones(2)], None)
    assert none is None and bool(ok) and g[0] is not None


def test_loss_scale_halves_and_grows_as_the_reference():
    """A sequence of finite and overflowing grads through both packages'
    ``unscale_and_update`` (growth_interval 3): the same scale, run of good
    steps, finite flag and unscaled grads at every step, the floor of 1
    included."""
    seq = [[1.0, 2.0], [np.inf, 1.0], [3.0, -1.0], [0.5, 0.5], [1.0, 1.0],
           [np.nan, 0.0], [2.0, 2.0]] + [[np.inf, 0.0]] * 6
    s = prec.LossScaleState.create(8.0)
    r = jax_prec.LossScaleState.create(8.0)
    for vals in seq:
        g = np.asarray(vals, np.float32)
        got, s, fin = prec.unscale_and_update([torch.from_numpy(g)], s, 3)
        want, r, rfin = jax_prec.unscale_and_update({"w": jnp.asarray(g)},
                                                    r, 3)
        assert float(s.scale) == float(r.scale)
        assert int(s.good_steps) == int(r.good_steps)
        assert bool(fin) == bool(rfin)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want["w"]))
    assert float(s.scale) == 1.0                       # the floor


def test_loss_scaled_step_equals_unscaled_and_the_reference():
    model, params, stats = _setup()
    imgs, labels = _batch(8, seed=1)
    plain, _ = _port_step(params, imgs, labels, steps=2)
    scaled, m = _port_step(params, imgs, labels, loss_scale=2.0 ** 15,
                           steps=2)
    np.testing.assert_array_equal(_flat_port(scaled), _flat_port(plain))
    assert float(scaled.loss_scale.scale) == 2.0 ** 15
    assert int(scaled.loss_scale.good_steps) == 2
    ref, _ = _jax_step(model, params, stats, imgs, labels,
                       loss_scale=2.0 ** 15)
    one, _ = _port_step(params, imgs, labels, loss_scale=2.0 ** 15)
    np.testing.assert_allclose(_flat_port(one), _flat_jax(ref), **TOL)
    assert float(m["nonfinite_count"]) == 0


@pytest.mark.parametrize("optimizer", ["sgd", "fused_sgd"])
def test_planted_overflow_is_skipped_without_a_health_trip(optimizer):
    """Inf in one grad under a loss scale of 2: params and momentum kept,
    the scale halved to 1, the probes zero (the reference's
    ``_apply_update`` on the same inputs agrees), and a ``halt`` sentry
    does not trip."""
    w = torch.arange(4.0).requires_grad_(True)
    tx = (FusedSGD(lambda step: 0.1, 0.9, 0.0) if optimizer == "fused_sgd"
          else make_optimizer(0.1, 0.9, 0.0))
    state = TrainState(step=0, params=[w], opt_state=tx.init([w]),
                       loss_scale=prec.LossScaleState.create(2.0))
    apply_update(tx, state, [torch.ones(4)], {}, "halt")   # momentum != 0
    p0 = w.detach().clone()
    m0 = [t.clone() for t in state.opt_tensors()]
    bad = torch.ones(4)
    bad[0] = float("inf")
    m = apply_update(tx, state, [bad], {}, "halt")
    assert torch.equal(w, p0) and state.step == 2
    assert all(torch.equal(a, b) for a, b in zip(state.opt_tensors(), m0))
    assert float(state.loss_scale.scale) == 1.0
    assert {k: float(v) for k, v in m.items()} == {
        "grad_norm": 0.0, "nonfinite_count": 0.0, "update_norm": 0.0}
    HealthSentry("halt").observe(1, 2.3, nonfinite=0.0, grad_norm=0.0,
                                 update_norm=0.0)
    import optax

    rs = JaxState.create({"w": jnp.arange(4.0)}, {}, optax.sgd(0.1),
                         jax_prec.LossScaleState.create(2.0))
    rs2, rm = jax_steps._apply_update(optax.sgd(0.1), rs,
                                      {"w": jnp.asarray(bad.numpy())}, {},
                                      {}, "halt")
    assert {k: float(v) for k, v in jax.device_get(rm).items()} == {
        k: float(v) for k, v in m.items()}
    assert float(jax.device_get(rs2.loss_scale.scale)) == 1.0


# ---- the trainer ------------------------------------------------------------

LENET = dict(arch="lenet", dataset="mnist", batch_size=16, epochs=1,
             synth_train_size=64, synth_val_size=32, precision="fp32",
             seed=0, print_freq=1, workers=1, log_csv="",
             optimizer="fused_sgd")


def test_trainer_runs_accum_loss_scale_and_warm_start(tmp_path):
    """``TrainConfig(grad_accum_steps=2, loss_scale=2**15, pretrained=...)``
    builds and trains; the checkpoint carries the scale, a resume restores
    it, and a run without a scale refuses that checkpoint."""
    kw = dict(LENET, data=str(tmp_path / "no-data"))
    donor = Trainer(TrainConfig(checkpoint_dir=str(tmp_path / "d"), **kw),
                    device="cpu")
    donor.fit()
    best = str(tmp_path / "d" / "lenet-model_best.pt")
    cfg = TrainConfig(checkpoint_dir=str(tmp_path / "c"),
                      grad_accum_steps=2, loss_scale=2.0 ** 15,
                      pretrained=best, **kw)
    tr = Trainer(cfg, device="cpu")
    for p, q in zip(tr.state.params, donor.state.params):
        assert torch.equal(p, q)
    tr.fit()
    assert tr.state.step == 4 and int(tr.state.loss_scale.good_steps) == 4
    path = str(tmp_path / "c" / "lenet-checkpoint.pt")
    res = Trainer(TrainConfig(**{**kw, "resume": path, "epochs": 2,
                                 "loss_scale": 2.0 ** 15,
                                 "checkpoint_dir": ""}), device="cpu")
    assert int(res.state.loss_scale.good_steps) == 4
    with pytest.raises(ValueError, match="loss scale"):
        Trainer(TrainConfig(**{**kw, "resume": path, "checkpoint_dir": ""}),
                device="cpu")


def test_warm_start_grafts_a_1000_class_donor(tmp_path):
    from tpu_dist_torch.interop import export_flax_image_params
    from tpu_dist_torch.models.registry import create_model

    donor = create_model("resnet18", num_classes=1000, device="cpu", seed=5)
    donor.requires_grad_(True)
    st = TrainState.create(donor, make_optimizer(0.1))
    path = ckpt.save_checkpoint(str(tmp_path), st, 1, 0.0, "resnet18",
                                False)
    kw = dict(arch="resnet18", dataset="cifar10", batch_size=16, epochs=1,
              synth_train_size=32, synth_val_size=16, precision="fp32",
              seed=0, workers=1, log_csv="", data=str(tmp_path / "no-data"))
    tr = Trainer(TrainConfig(pretrained=path, **kw), device="cpu")
    fresh = Trainer(TrainConfig(**kw), device="cpu")
    donor_p = dict(donor.named_parameters())
    fresh_p = dict(fresh.model.named_parameters())
    skipped = []
    for name, p in tr.model.named_parameters():
        if p.shape == donor_p[name].shape:
            assert torch.equal(p, donor_p[name]), name
        else:
            skipped.append(name)
            assert torch.equal(p, fresh_p[name]), name
    assert sorted(skipped) == ["fc.bias", "fc.kernel"]
    for (name, b), (_, d) in zip(tr.model.named_buffers(),
                                 donor.named_buffers()):
        assert torch.equal(b, d), name
    assert tr.state.step == 0
    assert all(float(t.abs().sum()) == 0 for t in tr.state.opt_tensors())
    # the reference's graft on the same trees skips the same two leaves
    fresh_tree = export_flax_image_params(fresh.model)
    donor_tree = export_flax_image_params(donor)
    out, n, ref_skipped = jax_ckpt.graft_params(fresh_tree[0], donor_tree[0])
    assert sorted(ref_skipped) == ["fc/bias", "fc/kernel"]
    assert n == len(list(tr.model.parameters())) - 2
    _, n_s, _ = jax_ckpt.graft_params(fresh_tree[1], donor_tree[1])
    assert n_s == sum(1 for _ in tr.model.named_buffers())


@pytest.mark.parametrize("kw,err,match", [
    (dict(pretrained="nope.pt"), FileNotFoundError, "--pretrained"),
    (dict(grad_accum_steps=2, steps_per_dispatch=2), ValueError,
     "mutually exclusive"),
    (dict(grad_accum_steps=2, data_placement="device"), ValueError,
     "data_placement"),
    (dict(grad_accum_steps=3), ValueError, "not divisible"),
    (dict(grad_accum_steps=0), ValueError, "grad_accum_steps must be"),
])
def test_knob_refusals(tmp_path, kw, err, match):
    if "pretrained" in kw:
        kw = dict(kw, pretrained=str(tmp_path / kw["pretrained"]))
    with pytest.raises(err, match=match):
        Trainer(TrainConfig(**{**LENET, **kw}), device="cpu")


def test_create_model_refuses_an_unhandled_pretrained_path():
    from tpu_dist_torch.models.registry import create_model

    for pretrained in ("x.pt", True):
        with pytest.raises(ValueError, match="does not load weights"):
            create_model("lenet", pretrained=pretrained, device="cpu")
