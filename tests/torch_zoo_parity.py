"""Shared by ``tests/test_torch_zoo_parity*.py``: one arch per family of
the port's model zoo against the flax model, on the CPU, from the same
params (the port's random init with its 1-D leaves and running stats moved
off their initial values, carried to flax by ``interop``).

The families (:data:`FAMILIES`): VGG (vgg11), DenseNet (the DenseNet class
at blocks [2, 2, 2, 2]: densenet121's 58 layers alone take half a minute
to compile, and its tree is held in ``tests/test_torch_zoo.py``), AlexNet,
SqueezeNet (squeezenet1_0, whose 64 px map takes a padded last pool
window), MobileNetV2, ShuffleNetV2 (x0.5), EfficientNet-B0 (train-mode
stats at ``sd_max=0``, since stochastic depth draws inside the trunk;
``test_torch_zoo_parity_mobile.py`` holds its eval at the default),
GoogLeNet, InceptionV3, MnasNet (0.5) and MobileNetV3 (small). Inputs are
64 px (InceptionV3: 128), 2 images: smaller, the last stages reach 1 x 1,
and a train BatchNorm over 2 values turns summation-order
noise into 1e-3 of the logits.

What is held, and at what tolerance. Deep nets with BatchNorm over two
images are ill-conditioned: a channel of near-constant values turns the
order of a sum into a visible difference. So where a quantity carries
that noise it is held against the reference's own: the same flax program
on the batch in reverse order (mathematically the same result) gives a
second reference, and each leaf of the port may differ from the first in
L2 norm by at most twice the two references' distance plus ``tol`` times
the leaf's norm ("noise-held" below).

* **fp32** (``tol`` 1e-4): the running statistics a train-mode forward
  leaves behind (all taken ahead of the head's dropout), noise-held; the
  eval-mode logits over them, element by element within
  ``1e-4 * (1 + |ref|)``; for the archs without dropout, the train-mode
  logits likewise and the gradient of the summed cross entropy,
  noise-held. JAX's and torch's dropout draws never agree, so a
  train-mode forward with dropout is not compared;
* **bf16** compute (``tests/test_torch_resnet.py``'s rules): both
  frameworks round every conv output to bf16 after summing in different
  orders, so the forwards drift apart by a few bf16 ulps a layer. Each
  running-stat leaf is held to the fp32 reference's: its relative L2
  error may be at most twice the reference's own bf16 error plus 2e-2.
  The eval logits are held within ``2e-2 * (1 + max |ref|)``.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tpu_dist.engine.steps import cross_entropy_sum as jax_ce
from tpu_dist.models import cnn_zoo as jzoo
from tpu_dist.models.registry import create_model as jax_create
from tpu_dist_torch.engine.steps import cross_entropy_sum
from tpu_dist_torch.models import cnn_zoo
from tpu_dist_torch.interop import (export_flax_image_params,
                                    load_flax_image_params)
from tpu_dist_torch.models.registry import create_model

TOL = {"fp32": 1e-4, "bf16": 2e-2}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _registered(arch):
    return (lambda dt, **kw: jax_create(arch, num_classes=10, dtype=dt,
                                        **kw),
            lambda dt, **kw: create_model(arch, num_classes=10, dtype=dt,
                                          device="cpu", **kw))


def _densenet(dt, port=False, **kw):
    ctor = cnn_zoo.DenseNet if port else jzoo.DenseNet
    return ctor(block_sizes=[2, 2, 2, 2], num_classes=10, dtype=dt, **kw)


# family -> (flax ctor, port ctor, input px, dropout-free)
FAMILIES = {
    "vgg11": (*_registered("vgg11"), 64, False),
    "densenet": (_densenet, lambda dt, **kw: _densenet(
        dt, port=True, device="cpu", **kw), 64, True),
    "alexnet": (*_registered("alexnet"), 64, False),
    "squeezenet1_0": (*_registered("squeezenet1_0"), 64, False),
    "mobilenet_v2": (*_registered("mobilenet_v2"), 64, False),
    "shufflenet_v2_x0_5": (*_registered("shufflenet_v2_x0_5"), 64, True),
    "efficientnet_b0": (*_registered("efficientnet_b0"), 64, False),
    "googlenet": (*_registered("googlenet"), 64, False),
    "inception_v3": (*_registered("inception_v3"), 128, False),
    "mnasnet0_5": (*_registered("mnasnet0_5"), 64, False),
    "mobilenet_v3_small": (*_registered("mobilenet_v3_small"), 64, False),
}


def check_family(family, precision):
    """:func:`check` of one family from the port's seeded init."""
    jctor, pctor, px, dropout_free = FAMILIES[family]
    kw = {"sd_max": 0.0} if family == "efficientnet_b0" else {}
    params, stats = params_of(pctor(torch.float32, seed=0, **kw))
    x, y = inputs((px, px, 3))
    check(jctor(JDT[precision], **kw), jctor(JDT["fp32"], **kw),
          pctor(TDT[precision], seed=None, **kw), params, stats, x, y,
          precision, dropout_free)


def close(got, want, tol, what, scale=False):
    """Every element within tol * (1 + |want|), or with ``scale`` within
    tol * (1 + max |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = np.abs(got - want)
    bad = diff > tol * (1 + (np.abs(want).max() if scale else np.abs(want)))
    assert not bad.any(), f"{what}: max |diff| {diff.max()} ({bad.sum()} bad)"


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _nudge(tree, amount):
    """1-D leaves (norm scales and biases, conv and dense biases, the
    running stats) plus ``amount * cos(i)``, so every leaf matters."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _nudge(v, amount)
        elif np.ndim(v) == 1:
            out[k] = (v + amount * np.abs(np.cos(np.arange(v.size)))
                      ).astype(np.float32)
        else:
            out[k] = v
    return out


def inputs(shape, n=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, *shape)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def params_of(port_fp32):
    """(params, batch_stats) numpy trees from a port model's seeded init,
    with the 1-D leaves and stats moved off 0 and 1."""
    params, stats = export_flax_image_params(port_fp32)
    return _nudge(params, 0.1), _nudge(stats, 0.05)


def flax_run(ref, params, stats, x, y, grads: bool):
    """One jitted program: the train-mode logits, the new batch_stats and
    (``grads``) the gradient of the summed CE, then the eval logits over
    the new stats."""
    def variables(p, s):
        return {"params": p, **({"batch_stats": s} if s else {})}

    def run(p, s):
        def loss(p):
            logits, mut = ref.apply(
                variables(p, s), jnp.asarray(x), train=True,
                mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)})
            return jax_ce(logits, jnp.asarray(y)), (
                logits, mut.get("batch_stats", {}))

        if grads:
            (_, (logits, new)), g = jax.value_and_grad(loss, has_aux=True)(p)
        else:
            _, (logits, new) = loss(p)
            g = None
        ev = ref.apply(variables(p, new), jnp.asarray(x), train=False)
        return logits, new, g, ev

    return jax.jit(run)(params, stats)


def noise_held(got, want, want2, tol, what):
    """Each leaf: |got - want| <= 2 |want2 - want| + tol |want| (L2)."""
    assert got.keys() == want.keys() == want2.keys()
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        bound = (2 * np.linalg.norm(want2[k] - want[k])
                 + tol * np.linalg.norm(want[k]) + 1e-7)
        assert err <= bound, f"{what} {k}: |diff| {err} > {bound}"


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check(ref, ref32, port, params, stats, x, y, precision: str,
          dropout_free: bool):
    """Run both, hold what the module docstring says (``ref32``: the
    flax model at fp32)."""
    grads = precision == "fp32" and dropout_free
    jlogits, jstats, jgrads, jeval = flax_run(ref, params, stats, x, y,
                                              grads)
    if precision == "fp32":     # the reference's own noise
        _, jstats2, jgrads2, _ = flax_run(ref, params, stats,
                                          x[::-1].copy(), y[::-1].copy(),
                                          grads)
    else:                       # the fp32 reference
        _, jstats32, _, _ = flax_run(ref32, params, stats, x, y, False)
    load_flax_image_params(port, params, stats)
    port.requires_grad_(grads)
    port.train()
    tx = torch.from_numpy(x)
    logits = port(tx)
    tol, bf16 = TOL[precision], precision == "bf16"
    if grads:
        loss = cross_entropy_sum(logits, torch.from_numpy(y).long())
        g = torch.autograd.grad(loss, list(port.parameters()))
        close(logits.detach().numpy(), jlogits, tol, "train logits")
    got_s, want_s = flat(export_flax_image_params(port)[1]), flat(jstats)
    assert got_s.keys() == want_s.keys()
    if bf16:
        s32 = flat(jstats32)
        for k in s32:
            ref_err = _rel(want_s[k], s32[k])
            assert _rel(got_s[k], s32[k]) <= 2 * ref_err + tol, \
                (k, _rel(got_s[k], s32[k]), ref_err)
    else:
        noise_held(got_s, want_s, flat(jstats2), tol, "running stat")
    port.eval()
    with torch.inference_mode():
        close(port(tx).numpy(), jeval, tol, "eval logits", bf16)
    if grads:
        clone_p = [p.detach().clone() for p in port.parameters()]
        with torch.no_grad():
            for p, gi in zip(port.parameters(), g):
                p.copy_(gi)
        got_g = flat(export_flax_image_params(port)[0])
        with torch.no_grad():
            for p, c in zip(port.parameters(), clone_p):
                p.copy_(c)
        noise_held(got_g, flat(jgrads), flat(jgrads2), tol, "grad")
