"""Port int8 quantization (tpu_dist_torch.ops.quant) against the reference
(tpu_dist.ops.quant): int8 values bit-equal, scales within 1e-7 relative
(same formula in fp32; only the division may round differently)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.models.transformer import tiny_lm as jax_tiny_lm  # noqa: E402
from tpu_dist.ops import quant as jq  # noqa: E402
from tpu_dist_torch.ops import quant as tq  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,dims", [((33, 17), (0,)), ((4, 5, 64), (-1,)),
                                        ((3, 7, 2, 16), (-1,))])
def test_quantize_int8_bit_equal(shape, dims):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x.reshape(-1)[:5] = [0.5, -0.5, 1.5, 2.5, 0.0]   # half-way cases
    x[(0,) * (x.ndim - 1)] = 0.0                     # an all-zero slice
    qj, sj = jq.quantize_int8(jnp.asarray(x), dims)
    qt, st = tq.quantize_int8(torch.from_numpy(x), dims)
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    np.testing.assert_allclose(np.asarray(sj), st.numpy(), rtol=1e-7, atol=0)
    np.testing.assert_allclose(
        np.asarray(jq.dequantize(qj, sj)),
        tq.dequantize(qt, st).numpy(), rtol=1e-7, atol=0)


def test_round_is_half_to_even():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, 127.0]])
    q, s = tq.quantize_int8(x, (-1,))
    assert s.item() == pytest.approx(1.0)
    assert q.tolist() == [[0, 2, 2, 0, -2, 127]]


def test_wo_quantize_params_bit_equal():
    lm = jax_tiny_lm(vocab_size=64, num_layers=2, d_model=64, num_heads=4,
                     max_len=32)
    params = lm.init({"params": jax.random.PRNGKey(3)},
                     jnp.zeros((1, 32), jnp.int32), train=False)["params"]
    qj = jq.wo_quantize_params(params)
    tree = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  params)
    qt = tq.wo_quantize_params(tree)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(qj)[0])
    flat_j = {jax.tree_util.keystr(k): v for k, v in flat_j.items()}

    def walk(t, prefix=""):
        for k, v in t.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from walk(v, key)
            else:
                yield key, v
    flat_t = dict(walk(qt))
    assert set(flat_j) == set(flat_t)
    for k, vj in flat_j.items():
        vj = np.asarray(vj)
        vt = flat_t[k].numpy()
        assert vj.dtype == vt.dtype, k
        if vj.dtype == np.int8:
            np.testing.assert_array_equal(vj, vt, err_msg=k)
        else:
            np.testing.assert_allclose(vj, vt, rtol=1e-7, atol=0, err_msg=k)
    assert tq.params_are_wo_quantized(qt)
    assert not tq.params_are_wo_quantized(tree)
    assert jq.params_are_wo_quantized(qj)


def test_quant_dense_modes_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal((24, 40)).astype(np.float32)
    b = rng.standard_normal((40,)).astype(np.float32)
    for mode in ("none", "int8_wo"):
        mod = jq.QuantDense(40, mode=mode)
        yj = mod.apply({"params": {"kernel": w, "bias": b}}, jnp.asarray(x))
        dense = tq.make_dense(24, 40, quant=mode, device="cpu")
        with torch.no_grad():
            dense.kernel.copy_(torch.from_numpy(w))
            dense.bias.copy_(torch.from_numpy(b))
        yt = dense(torch.from_numpy(x))
        np.testing.assert_allclose(np.asarray(yj), yt.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # the pre-quantized (int8 kernel + kernel_scale) decode path
    qw, sw = jq.quantize_int8(jnp.asarray(w), (0,))
    mod = jq.QuantDense(40, mode="int8_wo")
    yj = mod.apply({"params": {"kernel": qw, "kernel_scale": sw,
                               "bias": b}}, jnp.asarray(x))
    dense = tq.make_dense(24, 40, quant="int8_wo", device="cpu")
    dense.load_quantized(torch.from_numpy(np.array(qw)),
                         torch.from_numpy(np.array(sw)))
    with torch.no_grad():
        dense.bias.copy_(torch.from_numpy(b))
    assert tq.params_are_wo_quantized(dense)
    np.testing.assert_allclose(np.asarray(yj), dense(torch.from_numpy(x)),
                               rtol=1e-5, atol=1e-5)


def test_int8_mode_names_the_unported_kernel():
    """The int8 mode's kernel is ported (tests/test_torch_pallas_quant.py):
    the mode builds and runs; what it still refuses is a pre-quantized
    kernel (the reference's ValueError: its fp weights are gone), and an
    unknown mode."""
    dense = tq.make_dense(8, 4, quant="int8", device="cpu")
    assert dense.mode == "int8"
    y = tq.quant_matmul(torch.ones(2, 8), torch.ones(8, 4), "int8")
    assert torch.equal(y, torch.full((2, 4), 8.0))
    q, s = tq.quantize_int8(torch.ones(8, 4), (0,))
    dense.load_quantized(q, s)
    with pytest.raises(ValueError, match="pre-quantized"):
        dense(torch.ones(2, 8))
    with pytest.raises(ValueError, match="unknown quant"):
        tq.validate_quant("int4")
