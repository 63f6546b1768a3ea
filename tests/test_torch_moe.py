"""The MoE LM and expert parallelism in the port (``models.moe``,
``parallel.ep``, ``ops.quant.moe_expert_matmul``) against the reference,
on CPU. The layer-level cases run in this process on the flax module's
own params; the trainers run on gloo groups of 2 and 4 ranks
(``tests/torch_dp_worker.py``, each spawned once for the module) against
the JAX ``LMTrainer`` on the suite's virtual CPU devices.

Held (mirroring ``tests/test_moe.py:19-197,286,328``):

* the MoE MLP's output, aux loss (within 1e-5 (1 + |aux|)) and combine
  mass against the flax module's, top-1 and top-2, with and without
  capacity drops, the z-loss's share;
* the routing itself, expert by expert and slot by slot: the tokens the
  dispatch places in each expert's capacity slots (the first expert
  matmul's input, captured on both sides) are equal;
* dropped tokens pass through as zeros; top-2 renormalizes the two gates;
  under tight capacity the second choices drop first;
* the int8 expert path (``fused_quant``'s plain version per expert) is
  bit-equal to the port's plain ``quant_einsum`` and equal to the
  reference's, with the straight-through gradient;
* the expert-parallel rules against ``ep_param_specs`` (with and without
  a model axis) and the analytical FLOPs against ``moe_lm_flops_per_token``;
* ``dp-moe`` on one process: the reference's mode string and per-step
  losses against the JAX ``LMTrainer`` within 1e-4 (1 + |loss|); the
  cached decode of the MoE LM equals its full recompute.

Expert parallelism's trainers (``ep-moe`` on 2 ranks, ``ep-moe+tp`` on 4)
are in ``tests/test_torch_ep.py``, so that each file keeps to its time.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.models import moe as jmoe  # noqa: E402
from torch_lm_ref import (LM, assert_losses, jax_trainer,  # noqa: E402
                          named, spec_tuple, step_losses)
from tpu_dist_torch.models import moe as tmoe  # noqa: E402

torch.set_num_threads(1)

E = 4
MOE = dict(LM, num_experts=E, moe_group_size=32, router_top_k=2)


def _pair(x, **kw):
    """(the flax MoEMLP and its params, the port MoEMLP on them)."""
    jm = jmoe.MoEMLP(num_experts=E, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = tmoe.MoEMLP(x.shape[-1], E, device="cpu", **kw)
    with torch.no_grad():
        for dst, src in ((tm.gate.kernel, params["gate"]["kernel"]),
                         (tm.w_in, params["w_in"]),
                         (tm.w_out, params["w_out"])):
            dst.copy_(torch.from_numpy(np.array(src)))
    return jm, params, tm


def _run(jm, params, tm, x):
    out, muts = jm.apply({"params": params}, jnp.asarray(x),
                         mutable=["intermediates"])
    (aux,), (mass,) = (muts["intermediates"][k]
                       for k in ("aux_loss", "combine_mass"))
    t_out, (t_aux, t_mass, _) = tm(torch.from_numpy(x))
    return (np.asarray(out), float(aux), np.asarray(mass).sum()), \
        (t_out.detach().numpy(), float(t_aux), float(t_mass))


def _x(seed, shape=(2, 16, 16)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, dict(router_top_k=2),
                                dict(capacity_factor=1e-9),
                                dict(router_top_k=2, capacity_factor=0.3,
                                     group_size=8),
                                dict(z_loss_coef=10.0)])
def test_moe_mlp_matches_flax(kw):
    x = _x(0)
    (out, aux, mass), (t_out, t_aux, t_mass) = _run(*_pair(x, **kw), x)
    np.testing.assert_allclose(t_out, out, rtol=1e-5, atol=1e-6)
    assert abs(t_aux - aux) <= 1e-5 * (1 + abs(aux))
    assert t_mass == pytest.approx(mass, rel=1e-6)
    assert aux >= 0.99      # the balanced-uniform bound, plus the z-loss


@pytest.mark.parametrize("kw", [{}, dict(router_top_k=2),
                                dict(router_top_k=2, capacity_factor=0.3,
                                     group_size=8)])
def test_routing_equals_reference_slot_by_slot(monkeypatch, kw):
    """The first expert matmul's input is each expert's capacity slots
    filled with the tokens routed there: equal on both sides means every
    token went to the same expert and slot."""
    x = _x(1, (2, 16, 16))
    jm, params, tm = _pair(x, **kw)
    seen = {}

    def spy(side, fn):
        def wrapped(spec, acts, w, *a, **k):
            seen.setdefault(side, np.asarray(
                acts.detach() if torch.is_tensor(acts) else acts))
            return fn(spec, acts, w, *a, **k)
        return wrapped

    monkeypatch.setattr(jmoe, "moe_expert_matmul",
                        spy("jax", jmoe.moe_expert_matmul))
    monkeypatch.setattr(tmoe, "moe_expert_matmul",
                        spy("torch", tmoe.moe_expert_matmul))
    _run(jm, params, tm, x)
    got, want = seen["torch"], seen["jax"]
    assert got.shape == want.shape          # (G, E, C, D)
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    filled = (want != 0).any(-1)               # (G, E, C) slots in use
    assert 0 < filled.sum() <= x.shape[0] * x.shape[1] * tm.router_top_k


def test_capacity_drops_pass_through_and_top2_renormalizes():
    x = np.ones((1, 8, 16), np.float32)
    (out, _, _), (t_out, _, _) = _run(*_pair(x, capacity_factor=1e-9), x)
    assert (np.abs(t_out.reshape(8, 16)).sum(-1) > 0).sum() <= E
    np.testing.assert_allclose(t_out, out, atol=1e-6)
    x = _x(2)
    tm = _pair(x, router_top_k=2, capacity_factor=4.0)[2]
    t = torch.from_numpy(x).reshape(1, 32, 16)
    _, combine, _, mass = tm.route(t, 32)
    np.testing.assert_allclose(mass.numpy(), 1.0, atol=1e-5)
    # tight capacity: second choices queue behind first ones and drop
    tight = _pair(x, router_top_k=2, capacity_factor=0.3)[2]
    _, _, _, mass = tight.route(t, 2)
    assert float(mass.min()) < 0.999 and float(mass.max()) <= 1 + 1e-5


@pytest.mark.parametrize("spec", ["gecd,edf->gecf", "gecf,efd->gecd"])
def test_int8_expert_path_is_quant_einsum(spec):
    from tpu_dist.ops.quant import quant_einsum as jax_qe
    from tpu_dist_torch.ops.quant import moe_expert_matmul, quant_einsum

    rng = np.random.default_rng(3)
    acts = rng.normal(size=(2, E, 5, 12)).astype(np.float32)
    w = rng.normal(size=(E, 12, 8)).astype(np.float32)
    a = torch.from_numpy(acts).requires_grad_()
    b = torch.from_numpy(w).requires_grad_()
    got = moe_expert_matmul(spec, a, b, "int8")
    plain = quant_einsum(spec, a, b)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jax_qe(spec, acts, w)), rtol=1e-6,
                               atol=1e-6)
    g1 = torch.autograd.grad(got.sum(), (a, b))
    g2 = torch.autograd.grad(torch.einsum(spec, a, b).sum(), (a, b))
    for u, v in zip(g1, g2):
        torch.testing.assert_close(u, v)


@pytest.mark.parametrize("model_axis", [None, "model"])
def test_ep_specs_match_reference_leaf_by_leaf(model_axis):
    from tpu_dist.parallel.ep import ep_param_specs as jax_specs
    from tpu_dist_torch.parallel.ep import ep_param_specs

    model = jmoe.MoETransformerLM(vocab_size=64, max_len=32, num_experts=E)
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, 32), jnp.int32), train=False)["params"]
    leaves = named(params)
    want = {n: spec_tuple(s, a.ndim) for (n, a), s in zip(
        leaves.items(), jax.tree.leaves(
            jax_specs(params, "expert", model_axis),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))}
    got = ep_param_specs(((n, a.shape) for n, a in leaves.items()),
                         "expert", model_axis)
    assert got == want
    assert got["blocks.0.moe.gate.kernel"] == (None, None)


def test_analytical_flops_match_reference():
    from tpu_dist.utils.mfu import moe_lm_flops_per_token as jax_flops
    from tpu_dist_torch.engine.lm_loop import moe_lm_flops_per_token

    model = jmoe.MoETransformerLM(vocab_size=64, max_len=32, num_experts=E,
                                  router_top_k=2)
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, 32), jnp.int32), train=False)["params"]
    kw = dict(num_layers=2, seq_len=32, d_model=64, num_experts=E,
              router_top_k=2, total_tokens=256, group_size=64)
    want = jax_flops(params, **kw)
    got = moe_lm_flops_per_token(
        [(n, a.shape) for n, a in named(params).items()], **kw)
    assert got == pytest.approx(want, rel=1e-12)


def test_moe_lm_cached_decode_equals_full_recompute():
    from tpu_dist_torch.engine.generate import generate

    lm = tmoe.MoETransformerLM(vocab_size=64, num_layers=2, d_model=32,
                               num_heads=2, num_experts=E, max_len=24,
                               capacity_factor=float(E), device="cpu",
                               seed=1)
    prompt = np.random.default_rng(0).integers(0, 64, (2, 5)).astype(
        np.int32)
    assert torch.equal(generate(lm, prompt, 8, use_cache=True),
                       generate(lm, prompt, 8, use_cache=False))


def test_one_process_dp_moe_matches_reference(tmp_path):
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    init, want, mode = jax_trainer(tmp_path, "dpmoe", MOE, (1,), ("data",))
    ledger = str(tmp_path / "dpmoe.jsonl")
    tr = LMTrainer(LMConfig(**MOE, ledger_path=ledger), device="cpu",
                   init_params=init)
    tr.fit()
    assert tr.mode == mode == "dp-moe"
    assert_losses(step_losses(ledger), want, "dp-moe vs the JAX LMTrainer")
