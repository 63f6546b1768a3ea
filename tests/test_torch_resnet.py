"""The port's image models against the flax reference, on CPU, from the
same params (carried across by ``tpu_dist_torch.interop``):

* ResNet at ``stage_sizes=[1,1,1,1]`` with Bottleneck and BasicBlock, the
  ``imagenet``/``cifar``/``s2d`` stems, BatchNorm and GroupNorm, fp32 and
  bf16 compute with fp32 and bf16 norm outputs: train-mode logits, the new
  BN running stats (flax's mutated ``batch_stats``), eval-mode logits and
  the gradient of the summed cross entropy against ``jax.grad``;
* LeNet in eval mode; the param-tree round trip; the ResNet-50 leaf and
  buffer counts of the bench geometry.

Tolerances. fp32: every element within 1e-4 * (1 + |ref|) (conv and
reduction summation order). bf16 compute: both frameworks round every conv
output (and, under bf16 norm outputs, every activation) to bf16 after
summing in different orders, so the two forwards drift apart by a few bf16
ulps of the activations at each layer. The running stats hold within
2e-2 * (1 + |ref|) element by element. The logits are held within
2e-2 * (1 + max |ref|): the drift reaches them at the scale of the logits,
not of each one (a logit near 0 differs by as much as a large one). The
gradients are not held element by element to the reference's bf16
gradients: BatchNorm's backward over a batch of 8 (1x1 spatial at layer 4)
amplifies the drift until the two bf16 gradients of an early conv differ
by tens of percent of their scale -- each about as far from the fp32
gradient as the other. So each bf16 gradient leaf is held to the fp32
reference gradient: its relative L2 error may be at most twice the
reference's own bf16 error plus 0.05.
"""

import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.engine.steps import cross_entropy_sum as jax_ce  # noqa: E402
from tpu_dist.models import lenet as jlenet  # noqa: E402
from tpu_dist.models import resnet as jres  # noqa: E402
from tpu_dist_torch.engine.steps import cross_entropy_sum  # noqa: E402
from tpu_dist_torch.interop import (export_flax_image_params,  # noqa: E402
                                    load_flax_image_params)
from tpu_dist_torch.models import lenet, resnet  # noqa: E402
from tpu_dist_torch.models.registry import create_model  # noqa: E402

torch.set_num_threads(1)

TOL = {"fp32": 1e-4, "bf16": 2e-2}
BLOCKS = {"bottleneck": (jres.Bottleneck, resnet.Bottleneck),
          "basic": (jres.BasicBlock, resnet.BasicBlock)}
CASES = [
    # (block, stem, norm, compute, norm_dtype)
    ("bottleneck", "s2d", "bn", "fp32", "fp32"),
    ("basic", "imagenet", "bn", "fp32", "fp32"),
    ("basic", "cifar", "gn", "fp32", "fp32"),
    ("bottleneck", "s2d", "bn", "bf16", "bf16"),      # the bench geometry
    ("bottleneck", "imagenet", "gn", "bf16", "fp32"),
]
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _close(got, want, tol, what, scale=False):
    """Every element within tol * (1 + |want|), or with ``scale`` within
    tol * (1 + max |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    bad = diff > tol * (1 + (np.abs(want).max() if scale else np.abs(want)))
    assert not bad.any(), f"{what}: max |diff| {diff.max()} ({bad.sum()} bad)"


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _grad_tree(model, grads):
    """The port's grads in the flax param layout (through the export)."""
    clone = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(clone.parameters(), grads):
            p.copy_(g)
    return export_flax_image_params(clone)[0]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(shape, n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, *shape)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def _flax_resnet(block, stem, norm, compute, ndt):
    return jres.ResNet(stage_sizes=[1, 1, 1, 1], block_cls=BLOCKS[block][0],
                       num_classes=10, dtype=JDT[compute], stem=stem,
                       norm=norm,
                       norm_dtype=jnp.bfloat16 if ndt == "bf16" else None)


def _flax_train(ref, params, stats, x, y):
    """(train logits, mutated batch_stats, grads) of the summed CE."""
    def loss(p):
        logits, mut = ref.apply({"params": p, "batch_stats": stats},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(y)), (logits, mut["batch_stats"])

    (_, (logits, new_stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return logits, new_stats, grads


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(c))
def test_resnet_matches_flax(case):
    block, stem, norm, compute, ndt = case
    ref = _flax_resnet(*case)
    x, y = _inputs((32, 32, 3))
    variables = jax.jit(lambda k: ref.init(k, jnp.asarray(x), train=False))(
        jax.random.PRNGKey(1))
    # non-trivial affine and running stats, so every leaf matters
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.cos(jnp.arange(a.size).reshape(a.shape)),
        variables["params"])
    stats = jax.tree_util.tree_map(lambda a: a + 0.05,
                                   variables.get("batch_stats", {}))
    jlogits, jstats, jgrads = _flax_train(ref, params, stats, x, y)
    # eval reads the running stats this train forward left behind
    jeval = jax.jit(lambda p, s: ref.apply({"params": p, "batch_stats": s},
                                           jnp.asarray(x), train=False))(
        params, jstats)

    port = resnet.ResNet([1, 1, 1, 1], BLOCKS[block][1], num_classes=10,
                         dtype=TDT[compute], stem=stem, norm=norm,
                         norm_dtype=TDT[ndt] if ndt == "bf16" else None,
                         device="cpu", seed=None)
    load_flax_image_params(port, jax.tree_util.tree_map(np.asarray, params),
                           jax.tree_util.tree_map(np.asarray, stats))
    port.requires_grad_(True)
    tx = torch.from_numpy(x)
    port.train()
    logits = port(tx)
    loss = cross_entropy_sum(logits, torch.from_numpy(y).long())
    grads = torch.autograd.grad(loss, list(port.parameters()))
    tol, bf16 = TOL[compute], compute == "bf16"
    _close(logits.detach().numpy(), jlogits, tol, "train logits", bf16)
    got_s, want_s = _flat(export_flax_image_params(port)[1]), _flat(jstats)
    assert got_s.keys() == want_s.keys()
    for k, v in got_s.items():
        _close(v, want_s[k], tol, f"running stat {k}")
    port.eval()
    with torch.inference_mode():
        _close(port(tx).numpy(), jeval, tol, "eval logits", bf16)
    got_g, want_g = _flat(_grad_tree(port, grads)), _flat(jgrads)
    assert got_g.keys() == want_g.keys()
    if not bf16:
        for k in want_g:
            _close(got_g[k], want_g[k], tol, f"grad {k}")
        return
    # bf16: both gradients against the fp32 gradient (module docstring)
    _, _, g32 = _flax_train(_flax_resnet(block, stem, norm, "fp32", "fp32"),
                            params, stats, x, y)
    g32 = _flat(g32)
    for k in g32:
        ref_err = _rel(want_g[k], g32[k])
        assert _rel(got_g[k], g32[k]) <= 2 * ref_err + 0.05, \
            (k, _rel(got_g[k], g32[k]), ref_err)


def test_lenet_eval_matches_flax():
    ref = jlenet.LeNet(num_classes=10)
    x, _ = _inputs((28, 28, 1), n=3)
    params = ref.init(jax.random.PRNGKey(2), jnp.asarray(x),
                      train=False)["params"]
    want = ref.apply({"params": params}, jnp.asarray(x), train=False)
    port = lenet.LeNet(num_classes=10, device="cpu", seed=None)
    load_flax_image_params(port, jax.tree_util.tree_map(np.asarray, params))
    port.eval()
    with torch.inference_mode():
        _close(port(torch.from_numpy(x)).numpy(), want, TOL["fp32"],
               "lenet logits")
    got, _ = export_flax_image_params(port)
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(got)[k], v)


def test_param_tree_round_trip_and_mismatch():
    ref = jres.ResNet18(num_classes=10)
    variables = jax.jit(lambda k: ref.init(k, jnp.zeros((1, 32, 32, 3)),
                                           train=False))(
        jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    port = create_model("resnet18", num_classes=10, device="cpu", seed=None)
    load_flax_image_params(port, params, stats)
    got_p, got_s = export_flax_image_params(port)
    for want, got in ((params, got_p), (stats, got_s)):
        assert _flat(got).keys() == _flat(want).keys()
        for k, v in _flat(want).items():
            np.testing.assert_array_equal(_flat(got)[k], v)
    bad = dict(params)
    bad.pop("fc")
    with pytest.raises(ValueError, match="children"):
        load_flax_image_params(port, bad, stats)


def test_resnet50_bench_geometry_counts():
    """ResNet-50, 10 classes, s2d stem: 161 param leaves holding
    23,531,402 params and 106 BN buffers holding 53,120 values (the
    reference's counts under jax.eval_shape)."""
    m = create_model("resnet50", num_classes=10, stem="s2d",
                     norm_dtype=torch.bfloat16, dtype=torch.bfloat16,
                     device="cpu", seed=0)
    params = list(m.parameters())
    bufs = list(m.buffers())
    assert len(params) == 161
    assert sum(p.numel() for p in params) == 23_531_402
    assert max(p.numel() for p in params) == 2_359_296
    assert len(bufs) == 106 and sum(b.numel() for b in bufs) == 53_120
    ref = jres.ResNet50(num_classes=10, stem="s2d")
    shapes = jax.eval_shape(lambda: ref.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    assert len(jax.tree_util.tree_leaves(shapes["params"])) == 161
