"""The port's blockwise attention (``ops/flash_attention.py
blockwise_attention_fn``) against the reference's
(``tpu_dist/ops/flash_attention.py:41-104``), on CPU.

The same numpy (B, L, H, D) inputs go through both: fp32 online softmax
in both, so outputs and gradients differ by summation order only, within
2e-5 relative plus 2e-5 absolute (the reference's own tolerance against
full attention, ``tests/test_flash.py:22-30``). Block sizes that do not
divide the kv length fit to the gcd (``tests/test_flash.py:130``), rows
that see no key are exact zeros under q/kv offsets, and the port's
``LMTrainer(attn="blockwise")`` trains as its full-attention twin."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.ops.flash_attention import \
    blockwise_attention_fn as ref_blockwise  # noqa: E402
from tpu_dist_torch.models.transformer import full_attention  # noqa: E402
from tpu_dist_torch.ops.flash_attention import \
    blockwise_attention_fn  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b=1, lq=64, lk=64, h=2, d=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, lq, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, lk, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, lk, h, d)).astype(np.float32))


def _both(blk, q, k, v, **kw):
    got = blockwise_attention_fn(blk)(*map(torch.from_numpy, (q, k, v)),
                                      **kw)
    want = ref_blockwise(blk)(*map(jnp.asarray, (q, k, v)), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("blk", [8, 16, 64, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_reference(blk, causal):
    q, k, v = _qkv(0)
    got, want = _both(blk, q, k, v, causal=causal)
    np.testing.assert_allclose(got, want, **TOL)
    full = full_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got, full.numpy(), **TOL)


def test_non_dividing_block_fits_to_the_gcd():
    """kv length 96 with block 64 runs blocks of gcd(64, 96) = 32."""
    q, k, v = _qkv(1, lq=96, lk=96)
    got, want = _both(64, q, k, v)
    np.testing.assert_allclose(got, want, **TOL)
    full = full_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got, full.numpy(), **TOL)


@pytest.mark.parametrize("q_offset,kv_offset", [(24, 0), (0, 20), (5, 30)])
def test_offsets_and_dead_rows_are_exact_zeros(q_offset, kv_offset):
    q, k, v = _qkv(2, lq=40, lk=48)
    got, want = _both(16, q, k, v, q_offset=q_offset, kv_offset=kv_offset)
    np.testing.assert_allclose(got, want, **TOL)
    dead = q_offset + np.arange(40) < kv_offset       # rows that see no key
    assert (got[:, dead] == 0).all()
    assert (got[:, ~dead] != 0).any()


def test_grads_match_reference():
    q, k, v = _qkv(3, lq=48, lk=48)
    g = np.random.default_rng(4).normal(0, 1, q.shape).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = blockwise_attention_fn(16)(*ts, q_offset=8)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)
    want = jax.grad(lambda *a: jnp.sum(ref_blockwise(16)(*a, q_offset=8)
                                       * g), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


def test_bf16_inputs_keep_the_fp32_softmax():
    """bf16 q/k/v: both packages upcast to fp32 and return v's dtype; the
    outputs round to bf16 from fp32 values that agree to summation order,
    so they land within one bf16 ulp (2^-8 relative)."""
    q, k, v = (a.astype(jnp.bfloat16).astype(np.float32)
               for a in _qkv(5))
    out = blockwise_attention_fn(16)(*(torch.from_numpy(a).bfloat16()
                                       for a in (q, k, v)))
    want = ref_blockwise(16)(*(jnp.asarray(a, jnp.bfloat16)
                               for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=1e-6)


def test_memoized_per_config():
    assert blockwise_attention_fn(32) is blockwise_attention_fn(32)
    assert blockwise_attention_fn(32) is not blockwise_attention_fn(64)


def test_lm_trainer_blockwise_equals_full_attention():
    """``LMConfig(attn="blockwise")``: from the same seed, 4 fp32 steps give
    the same losses and params as ``attn="full"`` to summation order (and
    no kernel is involved)."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    kw = dict(batch_size=4, seq_len=32, d_model=32, num_layers=2,
              num_heads=2, vocab_size=64, synth_tokens=2000, seed=1,
              print_freq=100, epochs=1, lr=1e-2, max_steps=4, attn_block=12)
    runs = []
    for attn in ("full", "blockwise"):
        tr = LMTrainer(LMConfig(attn=attn, **kw), device="cpu")
        tr.fit()
        runs.append(torch.cat([p.detach().flatten()
                               for p in tr.state.params]).numpy())
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5, atol=1e-6)
