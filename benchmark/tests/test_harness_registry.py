"""The harness finds every part of a cell by name: a configuration, a
traffic mix, a limit file and a per-layer metric added as new files, with
entries in ``BENCHMARK.json``, run without an edit to any file that is
there. And the checkout's own ``BENCHMARK.json`` keeps to the contract's
shape."""

from __future__ import annotations

import hashlib
import json
import os
import re

from benchmark import core
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _digest(folder):
    h = hashlib.sha256()
    for base, _, files in sorted(os.walk(folder)):
        for f in sorted(files):
            if f.endswith(".pyc"):
                continue
            with open(os.path.join(base, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_new_config_mix_and_metric_from_new_files_alone(tmp_path):
    layout = tiny.make_layout(tmp_path, ("tiny-lm-train",))
    before = _digest(layout.bench)
    config, mix, limits = tiny.CELLS["tiny-lm-train"]
    cfg = config()
    cfg["model"]["num_layers"] = 1
    tiny.write(layout.bench, "configs", "added-lm", cfg)
    tiny.write(layout.bench, "traffic", "added-mix", dict(mix, batch=2))
    tiny.write(layout.bench, "limits", "added-lm-cell", limits)
    with open(os.path.join(layout.bench, "metrics", "added_steps.py"),
              "w") as f:
        f.write("def read(run):\n    return run.counters.get('steps')\n")
    spec = layout.spec()
    spec["workloads"].append({"name": "added-lm-cell", "config": "added-lm",
                              "traffic": "added-mix", "chips": 1,
                              "why": "added from files"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("added-lm-cell")
    spec["per_layer"].append({"name": "added_steps", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "LM train loop",
                              "moves": "train_tokens_per_s",
                              "workloads": ["added-lm-cell"]})
    tiny.write(layout.root, None, "BENCHMARK", spec)

    cell, w = tiny.run(layout, "added-lm-cell")
    assert cell.config["model"]["num_layers"] == 1
    assert cell.traffic["batch"] == 2
    assert w.correct
    entries = core.metrics_for(layout.spec(), "added-lm-cell", True)
    assert [m["name"] for m in entries] == ["added_steps"]
    run = core.Run(cell, w.counters, None, w.metrics)
    line = core.result_line(w, entries, {}, run, True)
    assert line["metrics"]["added_steps"] == {"value": w.attempted,
                                              "unit": "steps"}
    # the existing files were read, never written
    os.remove(os.path.join(layout.bench, "metrics", "added_steps.py"))
    for kind, name in (("configs", "added-lm"), ("traffic", "added-mix"),
                       ("limits", "added-lm-cell")):
        os.remove(os.path.join(layout.bench, kind, f"{name}.json"))
    assert _digest(layout.bench) == before


def test_a_metric_without_workloads_follows_the_metric_it_moves():
    spec = {"end_to_end": [{"name": "a", "workloads": ["x"]},
                           {"name": "setup_s"}],
            "per_layer": [{"name": "p", "moves": "a"},
                          {"name": "q", "moves": "setup_s",
                           "workloads": ["y"]}]}
    assert [m["name"] for m in core.metrics_for(spec, "x", False)] == [
        "a", "setup_s"]
    assert [m["name"] for m in core.metrics_for(spec, "x", True)] == ["p"]
    assert [m["name"] for m in core.metrics_for(spec, "y", True)] == ["q"]


def test_every_cell_of_the_checkout_resolves():
    layout = core.Layout(tiny.ROOT)
    spec = layout.spec()
    for w in spec["workloads"]:
        cell = core.find_cell(layout, w["name"])
        assert hasattr(cell.driver, "run")
        assert hasattr(cell.reference, "train_steps")
        assert cell.limits
        for trace in (False, True):
            assert core.metrics_for(spec, w["name"], trace)
    for m in spec["per_layer"]:
        assert callable(layout.metric(m["name"]))


def test_benchmark_json_keeps_the_contract_shape():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        assert os.path.exists(os.path.join(tiny.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in spec["workloads"]}
    assert used == set(configs)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for x in spec["configs"] + spec["workloads"]
             + spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    four = [w for w in spec["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(spec["workloads"]) // 4)
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in spec["workloads"]:
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        mine = [m for m in spec["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert core.metrics_for(spec, w["name"], True)
