"""The decode bench's long-context replay in the port
(``tpu_dist_torch.tools.decode_bench.replay_long_context``) against the
reference's (``tools/decode_bench.py``), on CPU.

With no eos the schedule does not depend on the tokens, so every
virtual-clock number of the replay (ticks, chunk ticks, prefill token
work, the TTFT and TPOT percentiles, the interference and the
monolithic contrast) is schedule arithmetic, equal across the packages
exactly: held on a ``--prompt-len-dist`` trace with the real model, the
monolithic contrast included. On the checked-in
``tools/traces/longcontext_mix.json`` at phase 14's settings
(``chip_smoke.P14_LC_ARGV``) the reference gives ``chip_smoke.P14_LC_PINS``
(with an attention that returns its values: the prompt's monolithic
prefill would otherwise be a 16384 x 16384 score matrix on the CPU, and
the schedule does not read the tokens it changes); the port's CLI meets
the same pins in ``tests/test_torch_longcontext_cli.py``, which also runs
``--sp-capacity`` and script 8's ``--serve`` over ``seq``."""

import argparse
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

import chip_smoke  # noqa: E402
from tpu_dist_torch.tools import decode_bench  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=64, num_layers=1, d_model=32, num_heads=2)
SMALL = ["--prompt-len-dist", "8:3,80:1", "--trace", "6",
         "--prefill-chunk", "16", "--tick-floor", "64", "--long-threshold",
         "64", "--page-size", "8", "--serve-slots", "2", "--max-out", "12",
         "--long-monolithic"]


def values_only(q, k, v, **_):
    """An attention that returns its values: the replay's schedule does not
    read the tokens it makes."""
    return v


def _args(argv):
    return decode_bench.build_parser().parse_args(
        ["--device", "cpu", "--precision", "fp32",
         *(f"--{k.replace('_', '-')}={v}" for k, v in TINY.items()), *argv])


def _reference(args, trace, attn=None):
    """The reference's serving block of one replay (a tiny JAX LM)."""
    from tools import decode_bench as ref_bench
    from tpu_dist.models.transformer import TransformerLM as JaxLM

    max_len = max(r["prompt_len"] + r["out_len"] for r in trace["requests"])
    jlm = JaxLM(**TINY, max_len=max_len,
                **({} if attn is None else {"attn_fn": attn}))
    params = jlm.init({"params": jax.random.PRNGKey(0)},
                      np.zeros((1, 8), np.int32), train=False)["params"]
    return ref_bench.replay_long_context(argparse.Namespace(**vars(args)),
                                         jlm, params, trace=trace)


def virtual(block):
    """The serving block's virtual-clock and schedule fields (without the
    port's wall-clock ``runs``, its ``attn_read`` and ``sp_capacity``)."""
    return {k: v for k, v in block.items()
            if k not in ("runs", "attn_read", "sp_capacity")}


def test_replay_matches_reference_on_a_drawn_trace():
    from tpu_dist_torch.models.transformer import TransformerLM

    args = _args(SMALL)
    trace = decode_bench.long_context_trace(args)
    max_len = max(r["prompt_len"] + r["out_len"] for r in trace["requests"])
    got = decode_bench.replay_long_context(
        args, TransformerLM(**TINY, max_len=max_len, device="cpu", seed=0),
        trace)
    assert virtual(got) == virtual(_reference(args, trace))
    assert got["chunk_ticks"] > 0 and got["monolithic"]["ticks"] > 0
    assert got["runs"]["chunked"]["completed"] == got["requests"] == 6


def test_reference_gives_the_chip_pins_on_the_checked_in_trace():
    """The reference's replay of the checked-in trace at phase 14's
    settings gives ``chip_smoke.P14_LC_PINS``, the monolithic contrast
    included; the port's CLI gives them too
    (``tests/test_torch_longcontext_cli.py``, without the contrast, whose
    one 16384-token prefill is held on the card by phase 14a)."""
    argv = [os.path.join(ROOT, a) if a == chip_smoke.P14_TRACE else a
            for a in chip_smoke.P14_LC_ARGV]
    args = _args(argv)
    trace = decode_bench.long_context_trace(args)
    assert len(trace["requests"]) == 15
    ref = _reference(args, trace, attn=values_only)
    for k, want in chip_smoke.P14_LC_PINS.items():
        assert ref[k] == want, k
