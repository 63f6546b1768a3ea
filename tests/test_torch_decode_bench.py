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


@pytest.mark.parametrize("flag,value", [("--tp", "2"), ("--dp", "2"),
                                        ("--num-experts", "4"),
                                        ("--long-context", "t.json")])
def test_unported_flags_raise_and_name_themselves(flag, value):
    with pytest.raises(NotImplementedError, match=flag):
        decode_bench.main(["--device", "cpu", flag, value] + TINY)
