"""Port TransformerLM (tpu_dist_torch.models.transformer) against the
reference flax model: weights pass through tpu_dist_torch.interop, and the
fp32 logits agree within 1e-4 under full attention, under the flash
attn_fn (kernel 1's plain version vs the Pallas kernel in interpret mode)
and for a wo-quantized tree."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.models import transformer as jtr  # noqa: E402
from tpu_dist.ops.flash_attention import \
    flash_attention_fn as jax_flash  # noqa: E402
from tpu_dist.ops.quant import wo_quantize_params  # noqa: E402
from tpu_dist_torch.interop import load_flax_params  # noqa: E402
from tpu_dist_torch.models import transformer as ttr  # noqa: E402
from tpu_dist_torch.ops.flash_attention import \
    flash_attention_fn as torch_flash  # noqa: E402

torch.set_num_threads(1)

V, L = 64, 32
GEOM = dict(vocab_size=V, num_layers=2, d_model=64, num_heads=4, max_len=L)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(seed, jattn=jtr.full_attention, tattn=ttr.full_attention,
          quant="none"):
    jlm = jtr.tiny_lm(attn_fn=jattn, quant=quant, **GEOM)
    params = jlm.init({"params": jax.random.PRNGKey(seed)},
                      jnp.zeros((1, L), jnp.int32), train=False)["params"]
    tlm = ttr.tiny_lm(attn_fn=tattn, quant=quant, device="cpu", seed=None,
                      **GEOM)
    return jlm, params, tlm


def _tokens(seed, b=2, l=L):
    return np.random.default_rng(seed).integers(0, V, (b, l)).astype(np.int32)


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_logits_match_reference(attn):
    kw = ({} if attn == "full" else
          dict(jattn=jax_flash(block_q=16, block_k=16), tattn=torch_flash()))
    jlm, params, tlm = _pair(1, **kw)
    load_flax_params(tlm, _numpy_tree(params))
    tok = _tokens(2)
    jl = jlm.apply({"params": params}, jnp.asarray(tok), train=False)
    with torch.inference_mode():
        tl = tlm(torch.from_numpy(tok))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_logits_match_reference_int8_wo_tree():
    jlm, params, tlm = _pair(3, quant="int8_wo")
    qparams = wo_quantize_params(params)
    load_flax_params(tlm, _numpy_tree(qparams))
    assert tlm.blocks[0].qkv.kernel.dtype == torch.int8
    tok = _tokens(4)
    jl = jlm.apply({"params": qparams}, jnp.asarray(tok), train=False)
    with torch.inference_mode():
        tl = tlm(torch.from_numpy(tok))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_fake_quant_int8_wo_mode_matches_reference():
    """quant='int8_wo' with fp weights fake-quantizes at every call."""
    jlm, params, tlm = _pair(5, quant="int8_wo")
    load_flax_params(tlm, _numpy_tree(params))
    tok = _tokens(6, b=1, l=12)
    jl = jlm.apply({"params": params}, jnp.asarray(tok), train=False)
    with torch.inference_mode():
        tl = tlm(torch.from_numpy(tok))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_pos_offset_and_per_row_positions():
    jlm, params, tlm = _pair(7)
    load_flax_params(tlm, _numpy_tree(params))
    tok = _tokens(8, b=2, l=4)
    jl = jlm.apply({"params": params}, jnp.asarray(tok), train=False,
                   pos_offset=jnp.asarray([3, 9], jnp.int32))
    with torch.inference_mode():
        tl = tlm(torch.from_numpy(tok),
                 pos_offset=torch.tensor([3, 9], dtype=torch.int32))
        t5 = tlm(torch.from_numpy(tok), pos_offset=5)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-4,
                               atol=1e-4)
    j5 = jlm.apply({"params": params}, jnp.asarray(tok), train=False,
                   pos_offset=5)
    np.testing.assert_allclose(np.asarray(j5), t5.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_layer_norm_and_gelu_follow_flax():
    import flax.linen as nn

    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 64)) * 4 + 2).astype(np.float32)
    jy = nn.LayerNorm(dtype=jnp.float32).apply(
        {"params": {"scale": np.full(64, 1.5, np.float32),
                    "bias": np.full(64, 0.25, np.float32)}}, x)
    ln = ttr.LayerNorm(64)
    with torch.no_grad():
        ln.scale.fill_(1.5)
        ln.bias.fill_(0.25)
    np.testing.assert_allclose(np.asarray(jy), ln(torch.from_numpy(x)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(nn.gelu(jnp.asarray(x))),
        torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh"),
        rtol=1e-6, atol=1e-6)


def test_interop_rejects_a_mismatched_tree():
    _, params, tlm = _pair(0)
    tree = _numpy_tree(params)
    del tree["block1"]
    with pytest.raises(ValueError, match="param tree keys"):
        load_flax_params(tlm, tree)
    tree = _numpy_tree(params)
    tree["block0"]["qkv"]["kernel"] = tree["block0"]["qkv"]["kernel"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(tlm, tree)
