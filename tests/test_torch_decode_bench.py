"""The decode bench's one-shot ``generate`` mode in the port
(``tpu_dist_torch/tools/decode_bench.py``), on CPU at a tiny fp32
geometry: the JSON line carries every key of the reference bench's
(``tools/decode_bench.py``, run here at the same geometry) under the
port's own metric name, the ledger has the reference's events, greedy
cached decode equals greedy full recompute token for token (fp32: the
cached path attends over its cache exactly), and the flags of later
slices raise naming themselves."""

import json
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference bench imports the package

from tpu_dist_torch.tools import decode_bench  # noqa: E402

torch.set_num_threads(1)

TINY = ["--vocab-size", "64", "--d-model", "32", "--num-layers", "2",
        "--num-heads", "2", "--precision", "fp32", "--batch", "2",
        "--prompt-len", "6", "--steps", "10", "--trials", "1",
        "--requests", "3"]


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_one_shot_line_has_the_reference_keys(tmp_path, capsys,
                                              monkeypatch):
    led = str(tmp_path / "dec.jsonl")
    decode_bench.main(["--device", "cpu", "--attn", "flash", "--ledger",
                       led] + TINY)
    out = capsys.readouterr()
    got = _last_json(out.out)
    assert got["metric"] == "torch_lm_decode_tokens_per_sec"
    assert got["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert got["kv_cache"] > 0 and got["full_recompute"] > 0
    assert (got["batch"], got["prompt_len"], got["steps"]) == (2, 6, 10)
    assert got["requests"] == 3 and got["serving"] is None
    lat = got["latency_ms"]
    assert 0 < lat["p50_ms"] <= lat["p99_ms"]
    assert "greedy outputs identical: True" in out.err
    with open(led) as f:
        events = [json.loads(line)["event"] for line in f]
    assert events == ["run_start", "decode", "decode", "decode", "run_end"]

    import tools.decode_bench as ref
    monkeypatch.setattr(sys, "argv", ["decode_bench"] + TINY)
    ref.main()
    want = _last_json(capsys.readouterr().out)
    assert want["metric"] == "lm_decode_tokens_per_sec"
    assert set(want) - set(got) == set()


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_skip_full_and_no_requests(capsys, precision):
    decode_bench.main(["--device", "cpu"] + TINY[:-6] + [
        "--precision", precision, "--steps", "4", "--skip-full",
        "--requests", "0", "--trials", "2"])
    got = _last_json(capsys.readouterr().out)
    assert got["full_recompute"] is None and got["latency_ms"] is None
    assert got["requests"] is None and got["precision"] == precision


def test_greedy_cached_decode_equals_full_recompute():
    from tpu_dist_torch.engine.generate import generate
    from tpu_dist_torch.models.transformer import TransformerLM

    model = TransformerLM(vocab_size=64, num_layers=2, d_model=32,
                          num_heads=2, max_len=24, device="cpu", seed=1)
    prompt = np.random.default_rng(0).integers(0, 64, (3, 5)).astype(
        np.int32)
    cached = generate(model, prompt, 12, use_cache=True)
    full = generate(model, prompt, 12, use_cache=False)
    assert torch.equal(cached, full)


@pytest.mark.parametrize("flags,exc,match", [
    # --tp/--dp and --long-context are ported
    # (tests/test_torch_{generate_mesh,longcontext}.py); what stays is the
    # reference's refusal of a --dp that does not divide the batch, and
    # --tp/--dp ride the one-shot mode only
    (["--tp", "2", "--trace", "4"], SystemExit, "one-shot mode"),
    (["--dp", "3"], SystemExit, "--dp 3 needs --batch divisible"),
    (["--tp", "2", "--long-context", "t.json"], SystemExit,
     "one-shot mode")])
def test_unported_flags_raise_and_name_themselves(flags, exc, match):
    with pytest.raises(exc, match=match):
        decode_bench.main(["--device", "cpu", *flags] + TINY)


def test_num_experts_one_shot_decodes_the_moe_lm(capsys):
    """``--num-experts`` and ``--capacity-factor`` are ported: the one-shot
    bench decodes the MoE LM (full attention, as the reference builds
    it); ``--trace`` with experts exits naming the serving engine."""
    decode_bench.main(["--device", "cpu", "--num-experts", "4",
                       "--capacity-factor", "4.0", "--trials", "1",
                       "--requests", "1"] + TINY)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["num_experts"] == 4 and line["kv_cache"] > 0
    with pytest.raises(SystemExit, match="dense TransformerLM"):
        decode_bench.main(["--device", "cpu", "--num-experts", "4",
                           "--trace", "2"] + TINY)
