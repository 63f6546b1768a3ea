"""Kernel 1's plain version (tpu_dist_torch.ops.flash_attention) against the
reference's Pallas FA-2 forward (tpu_dist.ops.flash_attention._fa_forward,
interpret mode off-TPU): out and the per-row logsumexp in fp32 within
2e-5, causal and not, with q/kv offsets -- including rows whose every key
is masked, which must come out exactly zero on both sides. Kernel 5's
plain version (``int8kv_flash_attention_fn``) against the reference's
int8-KV Pallas forward on the cases of ``tests/test_flash.py``, within
2e-5 (fp32 summation order)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.ops import flash_attention as jfa  # noqa: E402
from tpu_dist_torch.ops import flash_attention as tfa  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b, lq, lk, h, d):
    rng = np.random.default_rng(seed)
    mk = lambda l: rng.standard_normal((b, l, h, d)).astype(np.float32)
    return mk(lq), mk(lk), mk(lk)


CASES = [
    # (b, lq, lk, h, d, causal, q_offset, kv_offset)
    (2, 32, 32, 2, 16, True, 0, 0),
    (1, 24, 40, 3, 8, False, 0, 0),
    (1, 32, 32, 2, 16, True, 0, 16),     # rows 0..15 see no key at all
    (2, 16, 48, 2, 16, True, 32, 0),     # q block after the kv prefix
    (1, 16, 32, 1, 8, True, 8, 24),      # partly masked rows
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_flash_matches_pallas_forward(case):
    b, lq, lk, h, d, causal, qo, ko = case
    q, k, v = _qkv(sum(case[:5]), b, lq, lk, h, d)
    jout, jlse = jfa._fa_forward(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, qo, ko, 16, 16,
                                 True)
    tout, tlse = tfa.flash_forward(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   q_offset=qo, kv_offset=ko)
    jout = np.asarray(jout)
    np.testing.assert_allclose(jout, tout.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jlse)[..., 0], tlse.numpy(), **TOL)
    dead = np.all(jout == 0, axis=-1)
    np.testing.assert_array_equal(dead, np.all(tout.numpy() == 0, axis=-1))
    if ko > qo:
        assert dead.any()                     # the fully-masked rows exist


def test_attn_fn_matches_reference_flash_fn():
    q, k, v = _qkv(7, 2, 24, 24, 2, 16)
    jo = jfa.flash_attention_fn(block_q=8, block_k=8)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    to = tfa.flash_attention_fn(block_q=8, block_k=8)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), **TOL)
    # memoized per config (the model's attn_fn compares equal)
    assert tfa.flash_attention_fn(8, 8) is tfa.flash_attention_fn(8, 8)


def test_ragged_lengths_need_no_divisible_blocks():
    """The TPU path shrinks blocks to divisors of the length; the port
    masks ragged edges, so any length works."""
    q, k, v = _qkv(3, 1, 13, 13, 2, 16)
    out, lse = tfa.flash_forward(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v))
    ref = jfa.blockwise_attention_fn(13)(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), **TOL)
    assert lse.shape == (2, 13)


def test_quantize_kv_matches_reference():
    q, k, v = _qkv(5, 1, 8, 8, 2, 16)
    jk = jfa.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    tk = tfa.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    for a, b in zip(jk, tk):
        if b.dtype == torch.int8:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-7)


def test_autograd_goes_through_flash_attention_backward():
    """A call autograd records goes through ``FlashAttention``, whose
    gradients equal ``flash_backward_plain`` (the port of the TPU's
    ``_fa_bwd_dq_kernel`` and ``_fa_bwd_dkv_kernel``;
    tests/test_torch_flash_bwd.py holds them against the reference), and an
    inference call records nothing."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(1, 1, 8, 8, 1, 8))
    out = tfa.flash_attention_fn()(q, k, v)
    g = torch.ones_like(out)
    grads = torch.autograd.grad(out, (q, k, v), g)
    o, lse = tfa.flash_forward_plain(q.detach(), k.detach(), v.detach())
    for a, r in zip(grads, tfa.flash_backward_plain(
            q.detach(), k.detach(), v.detach(), o, lse, g)):
        assert torch.equal(a, r)
    with torch.inference_mode():
        out = tfa.flash_attention_fn()(q.detach(), k.detach(), v.detach())
    assert out.shape == (1, 8, 1, 8) and out.grad_fn is None


# ---- the int8-K/V forward (kernel 5) --------------------------------------

INT8KV_CASES = [
    # (seed, b, lq, lk, h, d, causal, q_offset, kv_offset, q rows kept)
    (7, 2, 128, 128, 2, 64, True, 0, 0, 0),     # test_flash.py:146-171
    (8, 2, 128, 128, 2, 64, True, 64, 0, 64),   # :174-190, decode offsets
    (9, 1, 40, 72, 2, 16, False, 0, 0, 0),
    (10, 1, 32, 32, 1, 16, True, 0, 16, 0),     # rows that see no key
]


@pytest.mark.parametrize("case", INT8KV_CASES, ids=str)
def test_int8kv_plain_matches_pallas_forward(case):
    seed, b, lq, lk, h, d, causal, qo, ko, keep = case
    q, k, v = _qkv(seed, b, lq, lk, h, d)
    q = q[:, keep:]
    jkv = jfa.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    jout = np.asarray(jfa.int8kv_flash_attention_fn(block_q=64, block_k=64)(
        jnp.asarray(q), jkv, causal=causal, q_offset=qo, kv_offset=ko))
    tkv = tfa.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    tout = tfa.int8kv_flash_attention_fn(block_q=64, block_k=64)(
        torch.from_numpy(np.ascontiguousarray(q)), tkv, causal=causal,
        q_offset=qo, kv_offset=ko)
    assert tout.dtype == torch.float32 and tout.shape == q.shape
    np.testing.assert_allclose(jout, tout.numpy(), **TOL)
    np.testing.assert_array_equal(np.all(jout == 0, axis=-1),
                                  np.all(tout.numpy() == 0, axis=-1))
