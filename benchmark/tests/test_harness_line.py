"""The run's last line: the keys the contract fixes, the compared
numbers last, and no line at all where there is no card or no port."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import core
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return tiny.make_layout(tmp_path_factory.mktemp("line"),
                            ("tiny-lm-train",))


@pytest.mark.parametrize("trace", [False, True])
def test_line_schema(layout, trace):
    cell, w = tiny.run(layout, "tiny-lm-train", trace=trace)
    entries = core.metrics_for(layout.spec(), cell.name, trace)
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": w.memory_peak_bytes}
    line = core.result_line(w, entries, device,
                            core.Run(cell, w.counters, w.trace, w.metrics),
                            trace)
    line = json.loads(json.dumps(line))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == w.attempted > 0
    units = {m["name"]: m["unit"] for m in entries}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if trace:
        # on the CPU only the host's figures read; device shares stay out
        assert set(line["metrics"]) == {"lm_dispatch_ms"}
        bd = line["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
        assert "breakdown" not in line


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gpt2-medium-train-b24-l1024", "--seed", str(tiny.SEED), "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run_py(tiny.ROOT)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run_py(tmp_path)
    assert r.returncode != 0 and r.stdout == ""
    assert "tpu_dist_torch" in r.stderr
