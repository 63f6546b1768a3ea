"""The ``compile`` and ``cost_model`` events of the port's first dispatch
(``obs.attr``; the reference walks its step's HLO, the port watches its
step's aten operators). On a tiny LM the ``matmul`` bucket's flops are
exactly 2 M N K of every linear, forward and backward (6 M N K each), the
attention contraction lands in ``attention``, and ``compile`` carries the
buckets' total; without a ledger path the mode does not run and
``compile`` carries the analytic count. Imports neither JAX nor the JAX
package: the reference's real-HLO cases are not the comparison here."""

import pytest
import torch

from tpu_dist_torch.configs import LMConfig
from tpu_dist_torch.engine.lm_loop import LMTrainer
from tpu_dist_torch.obs.attr import CostModelMode, bucket_totals
from tpu_dist_torch.obs.ledger import read_ledger

torch.set_num_threads(1)

B, L, D, V, LAYERS = 4, 32, 32, 64, 2
TINY = dict(vocab_size=V, d_model=D, num_layers=LAYERS, num_heads=2,
            seq_len=L, batch_size=B, synth_tokens=2000, precision="fp32",
            optimizer="adamw", lr=3e-3, print_freq=1, seed=0, max_steps=2,
            watchdog_factor=0.0)


def _linears():
    """(K, N) of every linear of the LM: a block's qkv, proj, mlp_in and
    mlp_out, and the head."""
    block = [(D, 3 * D), (D, D), (D, 4 * D), (4 * D, D)]
    return block * LAYERS + [(D, V)]


@pytest.mark.parametrize("attn", ["full", "blockwise", "flash"])
def test_matmul_bucket_is_every_linear_forward_and_backward(attn, tmp_path):
    path = str(tmp_path / "run.jsonl")
    LMTrainer(LMConfig(**TINY, attn=attn, ledger_path=path),
              device="cpu").fit()
    recs = read_ledger(path)
    comp = [r for r in recs if r["event"] == "compile"]
    cost = [r for r in recs if r["event"] == "cost_model"]
    assert len(comp) == len(cost) == 1
    buckets = cost[0]["buckets"]
    m = B * L
    assert buckets["matmul"]["flops"] == sum(6 * m * k * n
                                             for k, n in _linears())
    # the contraction's products (q k^T and p v, 2 B L L D flops each, and
    # twice that in their gradients) are attention's
    assert buckets["attention"]["flops"] >= 12 * B * L * L * D * LAYERS \
        * (0.5 if attn == "blockwise" else 1.0)
    assert buckets["elementwise"]["flops"] > 0
    assert comp[0]["program"] == "train_step"
    assert comp[0]["flops"] == cost[0]["total_flops"] == \
        bucket_totals(buckets)["flops"]
    assert cost[0]["peak_is_nominal"] is True      # no card peaks on a CPU
    assert cost[0]["collective_bytes"] == 0
    assert comp[0]["hbm_bytes"] is None


def test_without_a_ledger_path_compile_carries_the_analytic_count():
    tr = LMTrainer(LMConfig(**TINY, attn="full"), device="cpu")
    seen = []
    tr.ledger.add_sink(seen.append)
    tr.fit()
    comp = [r for r in seen if r["event"] == "compile"]
    assert not [r for r in seen if r["event"] == "cost_model"]
    assert len(comp) == 1 and comp[0]["flops"] == tr._step_flops()


def test_mode_buckets_views_as_free_and_reads_bytes():
    x = torch.ones(8, 16)
    w = torch.ones(16, 4)
    with CostModelMode() as mode:
        y = (x.view(16, 8) @ w[:8]).relu()
    buckets = mode.buckets()
    assert y.shape == (16, 4)
    assert buckets["matmul"] == {"flops": 2.0 * 16 * 8 * 4,
                                 "bytes": 4.0 * (16 * 8 + 8 * 4 + 16 * 4),
                                 "count": 1}
    assert buckets["elementwise"]["count"] == 1     # the relu


def test_out_dtype_products_count_their_flops():
    """``mm``/``bmm(..., out_dtype=float32)`` (the fp32-output product of
    bf16 operands on the card) count 2 M N K like the plain product; meta
    tensors stand in for the card's, which this CPU build cannot run."""
    a = torch.empty(2, 3, 4, dtype=torch.bfloat16, device="meta")
    b = torch.empty(2, 4, 5, dtype=torch.bfloat16, device="meta")
    with CostModelMode() as mode:
        torch.bmm(a, b, out_dtype=torch.float32)
        torch.mm(a[0], b[0], out_dtype=torch.float32)
    assert mode.buckets()["matmul"]["flops"] == 2.0 * (2 + 1) * 3 * 4 * 5
