"""Kernel 7's plain version and the port's ``FusedSGD`` against the
reference's Pallas kernel in interpret mode, on CPU tensors fed the same
numpy inputs:

* ``fused_sgd_plain`` against ``fused_sgd_leaf(..., interpret=True)`` at
  sizes that are not multiples of the 128 lanes, fp32 and bf16 ``p``, clip
  scale 1 and 0.3: fp32 within 1e-6 * (1 + |ref|) (the same operations in
  the same order; XLA may fuse a multiply-add), a bf16 ``p`` within one
  bf16 ulp (the fp32 result may sit on a rounding boundary), the fp32
  momentum within 1e-6 * (1 + |ref|);
* ``FusedSGD.apply`` over a tree, 3 steps with a step-decay schedule and
  the clip slot, against the reference ``FusedSGD``, within 1e-6; and one
  step over a tree of fp32 and bf16 leaves with bf16 grads (the CPU side
  of the multi-leaf kernel's dtype groups), within the tolerances
  above."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.ops import optim as jopt  # noqa: E402
from tpu_dist.ops import pallas_sgd as jsgd  # noqa: E402
from tpu_dist_torch.ops import optim as topt  # noqa: E402
from tpu_dist_torch.ops import pallas_adamw, pallas_sgd  # noqa: E402

torch.set_num_threads(1)

LR, MU, WD = 0.1, 0.9, 1e-4


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("shape", [(5,), (300,), (7, 33), (3, 3, 8, 16)],
                         ids=str)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("cs", [1.0, 0.3])
def test_plain_matches_reference_kernel(shape, dtype, cs):
    rng = np.random.default_rng(sum(shape))
    p, g, m = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jp, jm = jsgd.fused_sgd_leaf(jnp.asarray(p, jdt), jnp.asarray(g),
                                 jnp.asarray(m), LR, MU, WD, interpret=True,
                                 clip=cs)
    tp = torch.from_numpy(p).to(tdt)
    tm = torch.from_numpy(m.copy())
    row = pallas_sgd.scalar_row(LR, MU, WD, torch.tensor(cs))
    pallas_sgd.fused_sgd_leaf(tp, torch.from_numpy(g), tm, row)
    assert tp.dtype == tdt and tm.dtype == torch.float32
    want_p = np.asarray(jp, np.float32)
    got_p = tp.float().numpy()
    if dtype == "fp32":
        assert np.all(np.abs(got_p - want_p) <= 1e-6 * (1 + np.abs(want_p)))
    else:
        assert np.all(np.abs(got_p - want_p) <= _bf16_ulp(want_p))
    want_m = np.asarray(jm)
    assert np.all(np.abs(tm.numpy() - want_m) <= 1e-6 * (1 + np.abs(want_m)))


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_fused_sgd_matches_reference_over_steps(clip):
    shapes = {"w": (7, 33), "b": (33,), "k": (3, 3, 4, 8)}
    rng = np.random.default_rng(4)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    ref = jsgd.FusedSGD(jopt.step_decay_schedule(LR, 1, 2), MU, WD,
                        clip_norm=clip, interpret=True)
    port = pallas_sgd.FusedSGD(topt.step_decay_schedule(LR, 1, 2), MU, WD,
                               clip_norm=clip)
    names = list(shapes)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = ref.init(jparams)
    tparams = [torch.from_numpy(init[k].copy()) for k in names]
    tstate = port.init(tparams)
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jparams, jstate = ref.apply(jparams, {k: jnp.asarray(v)
                                              for k, v in g.items()},
                                    jstate, jnp.int32(step))
        port.apply(tparams, [torch.from_numpy(g[k]) for k in names], tstate,
                   step)
    for i, k in enumerate(names):
        np.testing.assert_allclose(tparams[i].numpy(),
                                   np.asarray(jparams[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(tstate.trace[i].numpy(),
                                   np.asarray(jstate.trace[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_fused_sgd_mixed_tree_matches_reference(clip):
    """One ``FusedSGD.apply`` over a tree of fp32 and bf16 leaves of ragged
    sizes, with bf16 grads (cast to fp32 first, as the reference casts
    them), against the reference: fp32 leaves within 1e-6 (1 + |ref|), bf16
    leaves within one bf16 ulp, the momentum within 1e-6 (1 + |ref|)."""
    shapes = {"a": (1,), "b": (3,), "c": (64,), "d": (4097,), "e": (5, 7)}
    dtypes = {"a": "fp32", "b": "bf16", "c": "fp32", "d": "bf16",
              "e": "bf16"}
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}
    rng = np.random.default_rng(7)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32) * 3
             for k, s in shapes.items()}
    names = list(shapes)
    ref = jsgd.FusedSGD(lambda step: LR, MU, WD, clip_norm=clip,
                        interpret=True)
    jparams = {k: jnp.asarray(init[k], jdt[dtypes[k]]) for k in names}
    jgrads = {k: jnp.asarray(grads[k], jnp.bfloat16) for k in names}
    jparams, jstate = ref.apply(jparams, jgrads, ref.init(jparams),
                                jnp.int32(0))
    port = pallas_sgd.FusedSGD(lambda step: LR, MU, WD, clip_norm=clip)
    tparams = [torch.from_numpy(init[k]).to(tdt[dtypes[k]]) for k in names]
    tstate = port.init(tparams)
    port.apply(tparams, [torch.from_numpy(grads[k]).to(torch.bfloat16)
                         for k in names], tstate, 0)
    for i, k in enumerate(names):
        want_p = np.asarray(jparams[k], np.float32)
        got_p = tparams[i].float().numpy()
        assert tparams[i].dtype == tdt[dtypes[k]]
        if dtypes[k] == "fp32":
            assert np.all(np.abs(got_p - want_p)
                          <= 1e-6 * (1 + np.abs(want_p))), k
        else:
            assert np.all(np.abs(got_p - want_p) <= _bf16_ulp(want_p)), k
        want_m = np.asarray(jstate.trace[k])
        assert np.all(np.abs(tstate.trace[i].numpy() - want_m)
                      <= 1e-6 * (1 + np.abs(want_m))), k


def test_clip_scale_lives_in_pallas_sgd():
    assert pallas_adamw.clip_scale is pallas_sgd.clip_scale
    g = [torch.full((4,), 6.0), torch.full((1,), 9.0)]   # norm = 15
    assert float(pallas_sgd.clip_scale(g, 5.0)) == pytest.approx(1 / 3)
    assert float(pallas_sgd.clip_scale(g, 20.0)) == 1.0
    assert float(pallas_sgd.clip_scale(g, 0.0)) == 1.0


def test_cuda_wrapper_refuses_cpu_tensors():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        pallas_sgd.fused_sgd_cuda(p, p, p, torch.zeros(4))
