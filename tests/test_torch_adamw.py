"""Kernel 8's plain version and the port's optimizers against the
reference, on CPU tensors fed the same numpy inputs:

* ``fused_adamw_plain`` (one leaf) and ``FusedAdamW`` (a tree, 5 steps,
  with and without the clip slot) against the reference ``FusedAdamW``
  in interpret mode, within 1e-6 (fp32: the same operations in the same
  order, so only the last bit of ``x ** t`` and XLA's fusion may differ);
  also over the leaves of a tiny LM for 3 steps with the clip live, both
  through ``FusedAdamW.apply`` and through ``csrc/adamw.cu``'s one
  multi-leaf call a step, compiled against the CPU emulation of
  ``tools/cuda_emu.py``;
* ``make_optimizer`` sgd / adamw against the reference's optax chains over
  5 steps, within 1e-6;
* ``lm_lr_schedule`` against the reference for each kind, and
  ``clip_scale`` against ``ops/pallas_sgd.py:clip_scale``."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.ops import optim as jopt  # noqa: E402
from tpu_dist.ops import pallas_adamw as jadam  # noqa: E402
from tpu_dist.ops.pallas_sgd import clip_scale as jax_clip_scale  # noqa: E402
from tpu_dist_torch.ops import optim as topt  # noqa: E402
from tpu_dist_torch.ops import pallas_adamw as tadam  # noqa: E402
from tpu_dist_torch.ops import pallas_sgd as tsgd  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"w": (7, 33), "b": (33,), "e": (300,)}   # ragged vs the 128 lanes
STEPS = 5


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(seed):
    rng = np.random.default_rng(seed)
    return [_tree(rng, 0.5) for _ in range(STEPS)]


def _np(t):
    return {k: np.asarray(v) for k, v in t.items()}


def test_fused_adamw_plain_matches_reference_leaf():
    rng = np.random.default_rng(0)
    p, g, m = (rng.standard_normal((5, 200)).astype(np.float32)
               for _ in range(3))
    v = rng.random((5, 200)).astype(np.float32)
    row = [3e-3, 0.9, 0.95, 1e-8, 0.1, 1 - 0.9 ** 3, 1 - 0.95 ** 3, 0.5]
    jp, jm, jv = jadam.fused_adamw_leaf(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        jnp.asarray(row, jnp.float32).reshape(1, 8), interpret=True)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    tadam.fused_adamw_plain(tp, torch.from_numpy(g), tm, tv,
                            torch.tensor(row, dtype=torch.float32))
    for a, r in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_fused_adamw_matches_reference_over_steps(clip):
    """Five steps of the whole-tree optimizer: the scalar row (warmup
    schedule, bias corrections with a 1-indexed t, the clip scale) and
    every leaf's update agree with the reference."""
    sched = lambda s: 1e-2 * (s + 1) / 4.0
    init = _tree(np.random.default_rng(1))
    grads = _grads(2)
    ref = jadam.FusedAdamW(sched, weight_decay=0.1, clip_norm=clip,
                           interpret=True)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = ref.init(jparams)
    port = tadam.FusedAdamW(sched, weight_decay=0.1, clip_norm=clip)
    names = list(SHAPES)
    tparams = [torch.from_numpy(init[k].copy()) for k in names]
    tstate = port.init(tparams)
    for step, g in enumerate(grads):
        jparams, jstate = ref.apply(
            jparams, {k: jnp.asarray(v) for k, v in g.items()}, jstate,
            jnp.int32(step))
        port.apply(tparams, [torch.from_numpy(g[k]) for k in names], tstate,
                   step)
    for i, k in enumerate(names):
        np.testing.assert_allclose(tparams[i].numpy(),
                                   np.asarray(jparams[k]), err_msg=k, **TOL)
        np.testing.assert_allclose(tstate.mu[i].numpy(),
                                   np.asarray(jstate.mu[k]), **TOL)
        np.testing.assert_allclose(tstate.nu[i].numpy(),
                                   np.asarray(jstate.nu[k]), **TOL)


@pytest.mark.parametrize("route", ["apply", "emulated_kernel"])
def test_fused_adamw_matches_reference_on_tiny_lm_leaves(route):
    """The leaves of a tiny LM (embeddings, attention and MLP kernels,
    LayerNorm vectors, biases) over 3 steps with the clip live: the
    reference ``FusedAdamW`` against the port's ``FusedAdamW.apply`` (CPU
    tensors: the plain loop), or against the same scalar rows fed to the
    emulated kernel, one multi-leaf call a step."""
    import shutil

    from tpu_dist_torch.models.transformer import tiny_lm
    from tpu_dist_torch.tools import cuda_emu

    if route == "emulated_kernel" and not (shutil.which("g++")
                                           or shutil.which("clang++")):
        pytest.skip("no host C++ compiler for the CUDA emulation")
    shapes = [tuple(p.shape) for p in tiny_lm(
        vocab_size=64, num_layers=1, d_model=32, num_heads=2, max_len=16,
        device="cpu", seed=0).parameters()]
    rng = np.random.default_rng(6)
    names = [f"{i:03d}" for i in range(len(shapes))]
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in zip(names, shapes)}
    grads = [{k: (rng.standard_normal(s) * 0.5).astype(np.float32)
              for k, s in zip(names, shapes)} for _ in range(3)]
    sched = lambda s: 1e-2 * (s + 1) / 4.0
    clip = 1.0
    ref = jadam.FusedAdamW(sched, weight_decay=0.1, clip_norm=clip,
                           interpret=True)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = ref.init(jparams)
    port = tadam.FusedAdamW(sched, weight_decay=0.1, clip_norm=clip)
    tparams = [torch.from_numpy(init[k].copy()) for k in names]
    tstate = port.init(tparams)
    fn = (cuda_emu.function("adamw", "tdt_adamw_multi", tsgd.MULTI_ARGS)
          if route == "emulated_kernel" else None)
    for step, g in enumerate(grads):
        jparams, jstate = ref.apply(
            jparams, {k: jnp.asarray(v) for k, v in g.items()}, jstate,
            jnp.int32(step))
        tg = [torch.from_numpy(g[k]) for k in names]
        if fn is None:
            port.apply(tparams, tg, tstate, step)
        else:
            row = tadam.scalar_row(sched(step), port.b1, port.b2, port.eps,
                                   port.weight_decay, step + 1,
                                   tadam.clip_scale(tg, clip))
            assert tsgd.launch_groups(fn, "adamw", (tparams, tg, tstate.mu,
                                                     tstate.nu), row,
                                      None) == 1
    for i, k in enumerate(names):
        np.testing.assert_allclose(tparams[i].numpy(),
                                   np.asarray(jparams[k]), err_msg=k, **TOL)
        np.testing.assert_allclose(tstate.mu[i].numpy(),
                                   np.asarray(jstate.mu[k]), **TOL)
        np.testing.assert_allclose(tstate.nu[i].numpy(),
                                   np.asarray(jstate.nu[k]), **TOL)


def test_fused_adamw_writes_bf16_params_in_their_dtype():
    p = torch.randn(40).to(torch.bfloat16)
    state = tadam.FusedAdamW(lambda s: 1e-3).init([p])
    tadam.FusedAdamW(lambda s: 1e-3).apply([p], [torch.randn(40)], state, 0)
    assert p.dtype == torch.bfloat16
    assert state.mu[0].dtype == state.nu[0].dtype == torch.float32


@pytest.mark.parametrize("kind,clip,wd", [
    ("sgd", 0.0, 1e-4), ("sgd", 1.0, 0.0),
    ("adamw", 0.0, 0.1), ("adamw", 1.0, 0.0)])
def test_make_optimizer_matches_optax(kind, clip, wd):
    import optax

    sched = jopt.lm_lr_schedule(3e-2, "cosine", warmup_steps=2,
                                total_steps=6)
    tsched = topt.lm_lr_schedule(3e-2, "cosine", warmup_steps=2,
                                 total_steps=6)
    kw = dict(momentum=0.9, weight_decay=wd, kind=kind, grad_clip=clip)
    ref = jopt.make_optimizer(3e-2, schedule=sched, **kw)
    port = topt.make_optimizer(3e-2, schedule=tsched, **kw)
    init = _tree(np.random.default_rng(3))
    names = list(SHAPES)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = ref.init(jparams)
    tparams = [torch.from_numpy(init[k].copy()) for k in names]
    tstate = port.init(tparams)
    for g in _grads(4):
        upd, jstate = ref.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tupd, tstate = port.update([torch.from_numpy(g[k]) for k in names],
                                   tstate, tparams)
        tparams = [p + u for p, u in zip(tparams, tupd)]
    assert tstate.count == STEPS
    for i, k in enumerate(names):
        np.testing.assert_allclose(tparams[i].numpy(),
                                   np.asarray(jparams[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("kw", [
    dict(kind="constant"),
    dict(kind="constant", warmup_steps=3),
    dict(kind="cosine", warmup_steps=2, total_steps=10, min_frac=0.1),
    dict(kind="cosine", total_steps=7),
    dict(kind="step", steps_per_epoch=3, step_epochs=2, factor=0.5,
         warmup_steps=1),
], ids=str)
def test_lm_lr_schedule_matches_reference(kw):
    ref = jopt.lm_lr_schedule(0.1, **kw)
    port = topt.lm_lr_schedule(0.1, **kw)
    for step in range(14):
        assert port(step) == pytest.approx(float(ref(step)), rel=1e-6)
    with pytest.raises(ValueError, match="cosine"):
        topt.lm_lr_schedule(0.1, "cosine", warmup_steps=4, total_steps=4)


@pytest.mark.parametrize("clip", [0.0, 0.5, 1e3])
def test_clip_scale_matches_reference(clip):
    g = _grads(5)[0]
    ref = float(jax_clip_scale({k: jnp.asarray(v) for k, v in g.items()},
                               clip))
    port = tadam.clip_scale([torch.from_numpy(v) for v in g.values()], clip)
    assert port.dtype == torch.float32 and port.dim() == 0
    assert float(port) == pytest.approx(ref, rel=1e-6)
    if clip == 1e3:
        assert float(port) == 1.0   # under the norm: no clip
