"""Kernel 6's plain version (tpu_dist_torch.ops.pallas_quant) against the
reference's Pallas fused int8 matmul (tpu_dist.ops.pallas_quant, interpret
mode on the CPU).

Both quantize with the same scales, round half to even, accumulate exactly
(int32 there, float64 here) and dequantize by ``sx * sw`` in fp32, so fp32
outputs agree at the reference test's own 1e-6; bf16 I/O at 2e-2 (one
rounding of the output, and bf16's fp32 upcast quantized alike). The STE
backward against ``jax.grad`` at 1e-5 (fp32 summation order of the fp
matmul's vjp). Also: ``QuantDense(mode="int8")`` from the same params as
the JAX ``QuantDense``, and the no-fallback rule: a CUDA tensor never
reaches the plain version, and a failed build or launch raises."""

import os
import stat

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.ops import quant as jq  # noqa: E402
from tpu_dist.ops.pallas_quant import \
    fused_quant_matmul as jax_fused  # noqa: E402
from tpu_dist_torch import kernels  # noqa: E402
from tpu_dist_torch.ops import pallas_quant as pq  # noqa: E402
from tpu_dist_torch.ops import quant as tq  # noqa: E402

torch.set_num_threads(1)


def _xw(xs, ws, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=xs) * 2.0).astype(np.float32),
            rng.normal(size=ws).astype(np.float32))


@pytest.mark.parametrize("xs,ws", [
    ((8, 16), (16, 8)),          # single tile, sub-block
    ((130, 48), (48, 136)),      # both output dims ragged
    ((3, 5, 32), (32, 64)),      # leading batch dims fold
])
def test_plain_matches_pallas_kernel_fp32(xs, ws):
    x, w = _xw(xs, ws)
    want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(w),
                                interpret=True))
    got = pq.fused_quant_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_plain_matches_pallas_kernel_bf16_io():
    x, w = _xw((24, 32), (32, 48), seed=1)
    want = jax_fused(jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(w, jnp.bfloat16), interpret=True)
    got = pq.fused_quant_matmul(torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_all_zero_rows_give_exact_zeros():
    x = np.zeros((5, 16), np.float32)
    x[0] = 1.0
    _, w = _xw((5, 16), (16, 8), seed=4)
    want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(w),
                                interpret=True))
    got = pq.fused_quant_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert bool((got[1:] == 0).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_backward_is_the_ste_of_the_reference():
    x, w = _xw((2, 5, 16), (16, 12), seed=2)

    def loss(a, b):
        return jnp.sum(jax_fused(a, b, interpret=True) ** 2)

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (pq.fused_quant_matmul(tx, tw) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-5)


def test_quant_dense_int8_matches_reference_dense():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 7, 24)).astype(np.float32)
    mod = jq.QuantDense(40, mode="int8")
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": jnp.asarray(rng.normal(size=(40,)), jnp.float32)}
    want = mod.apply({"params": params}, jnp.asarray(x))
    dense = tq.make_dense(24, 40, quant="int8", device="cpu")
    with torch.no_grad():
        dense.kernel.copy_(torch.from_numpy(np.array(params["kernel"])))
        dense.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    got = dense(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # through the mode dispatch too
    np.testing.assert_array_equal(
        tq.quant_matmul(torch.from_numpy(x), dense.kernel, "int8").numpy(),
        pq.fused_quant_matmul(torch.from_numpy(x), dense.kernel).numpy())


def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    """The wrapper picks the plain version by the tensor's device alone:
    a CUDA tensor goes to the kernel path, whose checks raise on what it
    does not take (here on a CPU-side stand-in the check refuses)."""
    calls = []
    monkeypatch.setattr(pq, "fused_quant_matmul_plain",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(pq, "fused_quant_cuda",
                        lambda x, w: ("kernel", x.shape, w.shape))

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    x = torch.ones(2, 8).as_subclass(FakeCuda)
    assert pq._forward_2d(x, torch.ones(8, 4))[0] == "kernel"
    assert not calls
    with pytest.raises(ValueError, match="CUDA"):
        pq._check_fused_quant(torch.ones(2, 8), torch.ones(8, 4))


def test_failed_build_and_failed_launch_raise(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'nvcc: refused' >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(kernels, "nvcc", lambda: str(fake))
    monkeypatch.setenv("TPU_DIST_TORCH_BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="build failed"):
        kernels.build(["fused_quant", "flash_fwd_int8kv"])
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]
    x, w = torch.ones(2, 8), torch.ones(8, 4)
    with pytest.raises(RuntimeError, match="launch failed"):
        pq._launch(lambda *a: 9, lambda *a: 0, x, w, None)
    with pytest.raises(RuntimeError, match="workspace"):
        pq._launch(lambda *a: 0, lambda *a: -1, x, w, None)
