"""The output check's control: the plain reference put in the program's
place and computed in float8 (``reference/precision``), the step below
the configurations' bfloat16, has to come out as not correct under each
cell's limits.

On the CPU at a size a test run holds; on the card at the cells' own
sizes through ``control.py`` (marked ``cuda``: it skips without a card).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import common, core, generate, weights, work
from benchmark.reference import resnet, transformer_lm
from benchmark.tests import tiny


def _limits(workload):
    return core.Layout(tiny.ROOT).limits(workload)


def _fails(readings, limits):
    return any(readings[k] > limits[k] for k in limits)


def _lm_batches(model, steps=3, rows=4):
    w = weights.lm_weights(work.lm_shapes(model), model, tiny.SEED, "cpu")
    batches = []
    for step in range(steps):
        r = generate.token_rows(tiny.SEED, step, rows,
                                model["max_len"] + 1, model["vocab_size"],
                                "cpu")
        batches.append((r[:, :-1], r[:, 1:]))
    return w, batches


def test_lm_reference_in_row_blocks_is_the_whole_batch(monkeypatch):
    cfg = tiny.tiny_lm()
    model, rec = work.lm_model(cfg["model"]), cfg["train"]
    w, batches = _lm_batches(model)
    length = batches[0][0].shape[1]
    monkeypatch.setattr(transformer_lm, "BLOCK_TOKENS", 4 * length)
    whole = transformer_lm.train_steps(w, batches, model, rec)
    monkeypatch.setattr(transformer_lm, "BLOCK_TOKENS", length)
    rows = transformer_lm.train_steps(w, batches, model, rec)
    for a, b in zip(whole["losses"], rows["losses"]):
        assert abs(a - b) <= 1e-6 * abs(a)
    assert common.leaf_gap(rows["grad_norms"], whole["grad_norms"]) < 1e-5
    assert common.leaf_gap(rows["change_norms"],
                           whole["change_norms"]) < 1e-4


def test_lm_training_control_fails_the_cell_limits():
    cfg = tiny.tiny_lm()
    model, rec = work.lm_model(cfg["model"]), cfg["train"]
    w, batches = _lm_batches(model)
    ref = transformer_lm.train_steps(w, batches, model, rec)
    again = transformer_lm.train_steps(w, batches, model, rec)
    ctl = transformer_lm.train_steps(w, batches, model, rec, mode="fp8")
    limits = _limits("gpt2-medium-train-b24-l1024")
    assert not _fails(common.readings(again, ref), limits)
    assert _fails(common.readings(ctl, ref), limits)


def test_image_training_control_fails_the_cell_limits():
    cfg = tiny.tiny_resnet()
    model, rec = cfg["model"], cfg["train"]
    w = weights.resnet_weights(model, tiny.SEED, "cpu")
    images, labels = generate.image_set(tiny.SEED, 16, model["image_size"],
                                        model["in_channels"],
                                        model["num_classes"], "cpu")
    batches = [(images[8 * s: 8 * s + 8], labels[8 * s: 8 * s + 8], s)
               for s in range(2)]
    ref = resnet.train_steps(w, batches, model, rec)
    ctl = resnet.train_steps(w, batches, model, rec, mode="fp8")
    assert _fails(common.readings(ctl, ref),
                  _limits("resnet50-in224-train-b256"))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["gpt2-medium-train-b24-l1024",
                                      "resnet50-in224-train-b256"])
def test_control_on_the_card_at_the_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    out = subprocess.run(
        [sys.executable, os.path.join(tiny.BENCH, "control.py"),
         "--workload", workload, "--seeds", "101,202,303", "--seconds", "5"],
        capture_output=True, text=True, check=True, cwd=tiny.ROOT).stdout
    limits = _limits(workload)
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert len(lines) == 3
    for line in lines:
        assert line["correct"], line["program"]
        assert _fails(line["control"]["fp8"], limits), line["control"]
