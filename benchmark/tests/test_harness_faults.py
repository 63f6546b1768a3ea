"""Each cell's output check against the faults its timed path can have.

A tiny copy of each kind of cell runs on the CPU through its driver, the
whole run but the look for a card. Sound, ``correct`` is true; with the
port's timed path broken underneath, false:

* a training step that returns its state unchanged;
* half of each batch left out, the mean taken over the rest.

(The exchange between chips is a fault only a cell on several chips can
have; the benchmark holds none yet.)
"""

from __future__ import annotations

import pytest
import torch

from benchmark.tests import tiny


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return tiny.make_layout(tmp_path_factory.mktemp("faults"))


def _state_tensors(state):
    return (list(state.params) + state.opt_tensors()
            + list(state.batch_stats))


def _unchanged(orig):
    """``CompiledPlan.advance`` that runs the step and hands back its
    state as it was."""
    def advance(self, fn, state, *args):
        saved = [t.detach().clone() for t in _state_tensors(state)]
        _, m = orig(self, fn, state, *args)
        with torch.no_grad():
            for t, s in zip(_state_tensors(state), saved):
                t.copy_(s)
        return state, m
    return advance


def _half_lm(orig):
    def advance(self, fn, state, inputs, targets):
        h = inputs.shape[0] // 2
        return orig(self, fn, state, inputs[:h], targets[:h])
    return advance


def _half_image(orig):
    def advance(self, fn, state, images, labels, idx, gstep):
        return orig(self, fn, state, images, labels,
                    idx[:, : idx.shape[1] // 2], gstep)
    return advance


@pytest.mark.parametrize("cell,fault", [
    ("tiny-lm-train", None), ("tiny-lm-train", "unchanged"),
    ("tiny-lm-train", "half"),
    ("tiny-resnet-train", None), ("tiny-resnet-train", "unchanged"),
    ("tiny-resnet-train", "half"),
])
def test_training_check_catches_fault(layout, monkeypatch, cell, fault):
    from tpu_dist_torch.plan.compile import CompiledPlan

    if fault is not None:
        make = {"unchanged": _unchanged,
                "half": _half_lm if "lm" in cell else _half_image}[fault]
        monkeypatch.setattr(CompiledPlan, "advance",
                            make(CompiledPlan.advance))
    _, w = tiny.run(layout, cell)
    assert w.correct is (fault is None), w.checks
