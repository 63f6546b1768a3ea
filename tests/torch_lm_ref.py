"""The JAX side of the port's model-parallel LM tests
(``tests/test_torch_{fsdp,tp,moe,ring_attention}.py``): the reference's
``LMTrainer`` on a mesh of the suite's virtual CPU devices, its gradients
on one batch, and its param trees under the port's leaf names. Imported
only by test files that have skipped already without JAX and flax."""

import json

import jax
import numpy as np

from tpu_dist.configs import LMConfig as JaxLMConfig
from tpu_dist.engine.lm_loop import LMTrainer as JaxLMTrainer
from tpu_dist_torch.interop import _lm_name

# the tiny LM every model-parallel test trains: 2 layers, d 32, 2 heads,
# L 32, V 64, global batch 4, adamw with a clip that binds
LM = dict(batch_size=4, seq_len=32, d_model=32, num_layers=2, num_heads=2,
          vocab_size=64, synth_tokens=3000, seed=3, print_freq=1, epochs=1,
          lr=1e-2, max_steps=3, optimizer="adamw", grad_clip=0.5)
# fp32 losses, port against reference: |a - b| <= TOL (1 + |b|)
TOL = 1e-4


def step_losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f) if r["event"] == "step"]


def jax_trainer(tmp, name, cfg, shape, axes, final=False):
    """The reference ``LMTrainer`` on a ``shape`` mesh over ``axes``:
    (its initial params as numpy, its per-step losses, its mode), and with
    ``final`` its trained params under the port's leaf names (a pipeline
    state unstacked) as a fourth item."""
    n = int(np.prod(shape))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                             axes)
    path = str(tmp / f"j{name}.jsonl")
    tr = JaxLMTrainer(JaxLMConfig(**{**cfg, "mesh_shape": tuple(shape),
                                     "mesh_axes": tuple(axes)},
                                  ledger_path=path), mesh=mesh)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(tr.state.params))
    tr.fit()
    out = (init, step_losses(path), tr.mode)
    if not final:
        return out
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.device_get(tr.state.params))
    if "embed_head" in params:
        from tpu_dist.parallel.pp import unstack_pipeline_params

        params = unstack_pipeline_params(params)
    return out + (named(params),)


def save_init(tmp, name, tree) -> str:
    path = str(tmp / f"{name}_init.npz")
    np.savez(path, tree=np.array(tree, dtype=object))
    return path


def named(tree):
    """{port leaf name: numpy array} of a flax LM tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_lm_name(tuple(str(getattr(k, "key", k)) for k in path)):
            np.asarray(v) for path, v in flat}


def spec_tuple(spec, ndim):
    """A PartitionSpec as the port's tuple, one entry per dim."""
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def jax_grads(model, params, job, aux_weight=0.01):
    """(mean loss, {port name: gradient}, argmax hits) of the reference
    objective
    (``lm_steps._lm_grads_and_metrics``: mean CE + aux_weight x router
    aux) on the job's whole numpy-seeded batch."""
    from tpu_dist.engine.lm_steps import _lm_grads_and_metrics

    rows = np.random.default_rng(job["seed"]).integers(
        0, model.vocab_size, (job["batch"], job["seq_len"] + 1)
    ).astype(np.int32)
    fn = jax.jit(lambda p, i, t: _lm_grads_and_metrics(
        model, aux_weight, p, i, t, jax.random.PRNGKey(0)))
    grads, m = fn(params, rows[:, :-1], rows[:, 1:])
    return (float(m["loss_sum"] / m["count"]), named(grads),
            float(m["correct1"]))


def assert_losses(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got, want)
    bad = np.abs(got - want) > TOL * (1 + np.abs(want))
    assert not bad.any(), f"{what}: {got.tolist()} vs {want.tolist()}"
