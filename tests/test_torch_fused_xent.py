"""The port's chunked vocab cross entropy (``ops/fused_xent.py``) against
the reference's (``tpu_dist/ops/fused_xent.py``), on CPU.

The same numpy inputs go through both. In fp32 (fp32 head product in
both) what differs is summation order: loss and per-row statistics within
1e-5 relative, gradients within 1e-5 relative plus 1e-6 absolute. With a
bf16 compute dtype both multiply bf16 operands with an fp32 result (the
port upcasts: a product of two bf16 values is exact in fp32), so the
forward again differs by summation order only; the backward rounds
softmax - onehot to bf16 before its products, and an fp32 difference of a
few ulps in p can land that rounding one bf16 ulp (2^-8 relative) apart,
so the bf16 gradients are held within 2^-8 of the largest gradient entry.
Rows past N (``chunk`` not dividing it) and masked rows add nothing, and
the ``LMTrainer(loss_chunk=...)`` losses follow the JAX trainer's."""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.ops import fused_xent as ref  # noqa: E402
from tpu_dist_torch.engine.lm_steps import lm_loss_and_metrics  # noqa: E402
from tpu_dist_torch.ops import fused_xent as port  # noqa: E402
from tpu_dist_torch.ops.f32_product import mm_route  # noqa: E402

torch.set_num_threads(1)

B, L, D, V = 2, 12, 16, 40
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed=0, masked=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, L, D)).astype(np.float32)
    w = rng.normal(0, 0.5, (D, V)).astype(np.float32)
    t = rng.integers(0, V, (B, L)).astype(np.int32)
    m = np.ones((B, L), np.float32)
    if masked:
        m[0, 3:7] = 0.0
        m[1, -2:] = 0.0
    return x, w, t, m


def _port(x, w, t, m, chunk, dt):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss, correct = port.chunked_softmax_xent(
        xt, wt, torch.from_numpy(t), torch.from_numpy(m), chunk, TDT[dt])
    dx, dw = torch.autograd.grad(loss, (xt, wt))
    return float(loss.detach()), float(correct), dx.numpy(), dw.numpy()


def _ref(x, w, t, m, chunk, dt):
    def f(xx, ww):
        return ref.chunked_softmax_xent(xx, ww, jnp.asarray(t),
                                        jnp.asarray(m), chunk, JDT[dt])
    (loss, correct), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp((jnp.float32(1.0), jnp.float32(0.0)))
    return float(loss), float(correct), np.asarray(dx), np.asarray(dw)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("chunk,masked", [(8, False), (6, True), (10, False),
                                          (10, True), (100, False)],
                         ids=["divides", "divides-masked", "ragged",
                              "ragged-masked", "one-chunk"])
def test_loss_hits_and_grads_match_reference(dt, chunk, masked):
    x, w, t, m = _inputs(1, masked)
    got, want = _port(x, w, t, m, chunk, dt), _ref(x, w, t, m, chunk, dt)
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    assert got[1] == want[1]                          # argmax hits: exact
    for g, r in zip(got[2:], want[2:]):
        if dt == "fp32":
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=2.0 ** -8 * np.abs(r).max())


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_chunk_statistics_match_reference(dt):
    """One chunk's per-row logsumexp and target logit (within 1e-5
    relative) and argmax hits (exact)."""
    x, w, t, _ = _inputs(2)
    xc, tc = x.reshape(-1, D)[:10], t.reshape(-1)[:10]
    got = port._chunk_stats(torch.from_numpy(xc).to(TDT[dt]),
                            torch.from_numpy(w).to(TDT[dt]),
                            torch.from_numpy(tc).long())
    want = ref._chunk_stats(jnp.asarray(xc), jnp.asarray(w), jnp.asarray(tc),
                            JDT[dt])
    for g, r in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_fp32_matches_the_unchunked_loss():
    """In fp32 the chunked loss and its gradients equal the full-logits
    objective to summation order (1e-5 relative)."""
    x, w, t, m = _inputs(3, masked=True)
    got = _port(x, w, t, m, 7, "fp32")
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss, metrics = lm_loss_and_metrics(xt @ wt, torch.from_numpy(t),
                                        torch.from_numpy(m))
    dx, dw = torch.autograd.grad(loss, (xt, wt))
    assert got[0] == pytest.approx(float(loss.detach()), rel=1e-5)
    assert got[1] == float(metrics["correct1"])
    np.testing.assert_allclose(got[2], dx.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3], dw.numpy(), rtol=1e-5, atol=1e-6)


def test_no_grad_call_and_cpu_route():
    """Under inference mode the function runs its forward alone; on the
    CPU a bf16 product takes the upcast route."""
    x, w, t, m = _inputs(4)
    with torch.inference_mode():
        loss, _ = port.chunked_softmax_xent(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t),
            torch.from_numpy(m), 5)
    assert float(loss) == pytest.approx(_ref(x, w, t, m, 5, "fp32")[0],
                                        rel=1e-5)
    assert mm_route("cpu", torch.float32) == "fp32"
    assert mm_route("cpu", torch.bfloat16) in ("upcast", "out_dtype")


def test_lm_trainer_loss_chunk_matches_reference_trainer(tmp_path):
    """``LMConfig(loss_chunk=...)``: the port's trainer and the JAX one from
    the same initial params, 3 steps with a chunk that does not divide
    B*L: per-step losses within 1e-5 relative, validation perplexity too."""
    pytest.importorskip("flax")
    from tpu_dist.configs import LMConfig as JaxLMConfig
    from tpu_dist.engine.lm_loop import LMTrainer as JaxLMTrainer
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    kw = dict(batch_size=8, seq_len=32, d_model=32, num_layers=1,
              num_heads=2, vocab_size=64, synth_tokens=3000, seed=3,
              print_freq=1, epochs=1, lr=1e-2, loss_chunk=96, max_steps=3)
    refr = JaxLMTrainer(JaxLMConfig(ledger_path=str(tmp_path / "j.jsonl"),
                                    **kw))
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(refr.state.params))
    refr.fit()
    tr = LMTrainer(LMConfig(ledger_path=str(tmp_path / "t.jsonl"), **kw),
                   device="cpu", init_params=init)
    tr.fit()

    def losses(p):
        with open(p) as f:
            return [r["loss"] for r in map(json.loads, f)
                    if r["event"] == "step"]

    got, want = losses(tmp_path / "t.jsonl"), losses(tmp_path / "j.jsonl")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tr.best_ppl == pytest.approx(refr.best_ppl, rel=1e-5)
