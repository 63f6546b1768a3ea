"""Kernels 3 and 4's plain version (``flash_backward_plain``, reached
through the port's ``FlashAttention`` autograd Function on CPU tensors)
against the reference: ``jax.grad`` of the Pallas ``flash_attention_fn``
(interpret mode off-TPU) and of ``full_attention``, for the same inputs and
output cotangent. dq, dk, dv in fp32 within the reference's own flash
gradient tolerance (``tests/test_flash.py``: rtol 2e-4, atol 2e-5) --
causal and not, with q/kv offsets, and with rows or keys no score reaches,
whose gradients must be exactly zero on both sides."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.models.transformer import full_attention as jax_full  # noqa: E402
from tpu_dist.ops import flash_attention as jfa  # noqa: E402
from tpu_dist_torch.models.transformer import full_attention  # noqa: E402
from tpu_dist_torch.ops import flash_attention as tfa  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)

CASES = [
    # (b, lq, lk, h, d, causal, q_offset, kv_offset)
    (2, 32, 32, 2, 16, True, 0, 0),
    (1, 24, 40, 3, 8, False, 0, 0),
    (2, 16, 48, 2, 16, True, 32, 0),     # q block after the kv prefix
    (1, 16, 32, 1, 8, True, 8, 24),      # rows 0..15 see no key at all
    (1, 32, 32, 2, 16, True, 0, 16),     # half the rows see no key
]


def _inputs(case):
    b, lq, lk, h, d = case[:5]
    rng = np.random.default_rng(sum(case[:5]))
    mk = lambda l: rng.standard_normal((b, l, h, d)).astype(np.float32)
    return mk(lq), mk(lk), mk(lk), mk(lq)


def _jax_grads(fn, q, k, v, w, causal, qo, ko):
    def loss(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_, causal=causal, q_offset=qo,
                          kv_offset=ko) * w)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _torch_grads(fn, q, k, v, w, causal, qo, ko):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts, causal=causal, q_offset=qo, kv_offset=ko)
    (out * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_grads_match_pallas_backward(case):
    causal, qo, ko = case[5:]
    q, k, v, w = _inputs(case)
    ref = _jax_grads(jfa.flash_attention_fn(block_q=8, block_k=8), q, k, v,
                     w, causal, qo, ko)
    got = _torch_grads(tfa.flash_attention_fn(), q, k, v, w, causal, qo, ko)
    for name, a, r in zip("qkv", got, ref):
        np.testing.assert_allclose(a, r, err_msg=f"d{name}", **TOL)
    if causal:
        # rows that see no key, and keys no row sees: exact zeros on both
        # sides (the p = 0 guard)
        lq, lk = q.shape[1], k.shape[1]
        dead_rows = qo + np.arange(lq) < ko
        dead_keys = ko + np.arange(lk) > qo + lq - 1
        for grads in (got, ref):
            assert np.all(grads[0][:, dead_rows] == 0)
            assert np.all(grads[1][:, dead_keys] == 0)
            assert np.all(grads[2][:, dead_keys] == 0)
        assert dead_rows.any() == (ko > qo)


@pytest.mark.parametrize("case", [c for c in CASES if c[7] <= c[6]],
                         ids=str)
def test_flash_grads_match_full_attention(case):
    """Where every row sees a key, the flash gradients equal both
    packages' full-attention gradients."""
    causal, qo, ko = case[5:]
    q, k, v, w = _inputs(case)
    ref = _jax_grads(jax_full, q, k, v, w, causal, qo, ko)
    got = _torch_grads(tfa.flash_attention_fn(), q, k, v, w, causal, qo, ko)
    full = _torch_grads(full_attention, q, k, v, w, causal, qo, ko)
    for name, a, r, f in zip("qkv", got, ref, full):
        np.testing.assert_allclose(a, r, err_msg=f"d{name}", **TOL)
        np.testing.assert_allclose(f, r, err_msg=f"full d{name}", **TOL)


def test_backward_plain_rounds_like_the_tpu_kernels():
    """bf16 inputs: the plain backward rounds ds to K's and Q's type and p
    to dO's before the products, as the Pallas kernels do, and returns
    each gradient in its input's dtype."""
    q, k, v, w = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs(CASES[0]))
    out, lse = tfa.flash_forward_plain(q, k, v, True)
    dq, dk, dv = tfa.flash_backward_plain(q, k, v, out, lse, w, True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    ref = jfa._fa_backward(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                             for t in (q, k, v, out)),
                           jnp.broadcast_to(
                               jnp.asarray(lse.numpy())[..., None],
                               (*lse.shape, 8)),
                           jnp.asarray(w.float().numpy(), jnp.bfloat16),
                           True, 0, 0, 16, 16, True)
    for a, r in zip((dq, dk, dv), ref):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(a.float().numpy(), r, rtol=2e-2,
                                   atol=2e-2)


def test_inference_mode_records_nothing():
    """Serving calls skip the Function: no graph, nothing saved."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    with torch.inference_mode():
        out = tfa.flash_attention_fn()(q, k, v)
    assert out.grad_fn is None
    out = tfa.flash_attention_fn()(q.requires_grad_(), k, v)
    assert "FlashAttention" in type(out.grad_fn).__name__
