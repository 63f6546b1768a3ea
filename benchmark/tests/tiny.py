"""Tiny cells for the benchmark's CPU tests: a copy of the benchmark's
drivers, references and metric readers in a temporary directory, with
configuration, traffic and limit files at sizes a CPU run holds, found
through ``core.Layout`` exactly as a checkout's files are."""

from __future__ import annotations

import copy
import json
import os
import shutil
import time

from benchmark import core

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SEED = 2 ** 33 + 7          # larger than 32 signed bits hold, as the driver's


def _load(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, f"{name}.json")) as f:
        return json.load(f)


def tiny_lm(precision: str = "fp32") -> dict:
    cfg = copy.deepcopy(_load("configs", "gpt2-medium"))
    # an odd vocabulary, as GPT-2's 50,257
    cfg["model"].update(vocab_size=67, n_layer=2, n_embd=32, n_head=2,
                        n_positions=64, n_ctx=64)
    cfg["precision"] = precision
    return cfg


def tiny_resnet() -> dict:
    cfg = copy.deepcopy(_load("configs", "resnet50-in224"))
    cfg["model"]["image_size"] = 64
    cfg["dataset_size"] = 64
    cfg["precision"] = "fp32"
    # small batches at a large rate make the loss chaotic: a tenth of it
    cfg["train"]["lr"] = 0.01
    return cfg


# name -> (config, traffic mix, limits); STANDS_FOR: the checkout's cell
# whose metrics each reports
STANDS_FOR = {"tiny-lm-train": "gpt2-medium-train-b24-l1024",
              "tiny-resnet-train": "resnet50-in224-train-b256"}
CELLS = {
    "tiny-lm-train": (
        tiny_lm,
        {"driver": "lm_train", "batch": 4, "seq_len": 64, "check_steps": 3},
        {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3}),
    "tiny-resnet-train": (
        tiny_resnet,
        {"driver": "image_train", "batch": 8, "window_steps": 2,
         "check_steps": 3},
        {"loss_gap": 2e-3, "update_gap": 0.25}),
}


def make_layout(tmp, names=tuple(CELLS)) -> core.Layout:
    """A layout in ``tmp``: the benchmark's code folders copied, the named
    tiny cells' files written, and a ``BENCHMARK.json`` that holds those
    cells and the checkout's metrics, each tiny cell in the metrics of the
    cell it stands for."""
    tmp = str(tmp)
    bench = os.path.join(tmp, "bench")
    for kind in ("drivers", "reference", "metrics"):
        shutil.copytree(os.path.join(BENCH, kind), os.path.join(bench, kind),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for kind in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(bench, kind), exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"] = []
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [n for n in names
                               if STANDS_FOR[n] in m["workloads"]]
    for name in names:
        config, mix, limits = CELLS[name]
        write(bench, "configs", name, config())
        write(bench, "traffic", name, mix)
        write(bench, "limits", name, limits)
        spec["workloads"].append({"name": name, "config": name,
                                  "traffic": name, "chips": 1, "why": "test"})
    write(tmp, None, "BENCHMARK", spec)
    return core.Layout(tmp, bench)


def write(base: str, kind, name: str, obj) -> str:
    path = os.path.join(base, kind or "", f"{name}.json")
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def run(layout: core.Layout, name: str, seed: int = SEED,
        seconds: float = 0.5, trace: bool = False, options=None):
    """One run of a tiny cell on the CPU, as ``run.py`` drives a cell."""
    cell = core.find_cell(layout, name)
    return cell, cell.driver.run(cell, seed, seconds, trace, "cpu",
                                 time.perf_counter(), options=options)
