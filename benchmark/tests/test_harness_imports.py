"""No run loads JAX or the JAX package, compared by whole top-level
names (the port's name begins with the JAX package's), and the plain
reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import sys

import pytest

from benchmark import core, run
from benchmark.tests import tiny


def test_forbidden_names_are_compared_whole():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            "tpu_dist", "tpu_dist.engine", "tpu_dist_torch",
            "tpu_dist_torch.engine.serve", "jaxtyping", "tpu_distx"]
    assert core.forbidden_loaded(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "tpu_dist",
        "tpu_dist.engine"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", object())
    assert run._exit_checked({"correct": True}, None) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _py(folder):
    return [os.path.join(folder, f) for f in sorted(os.listdir(folder))
            if f.endswith(".py")]


@pytest.mark.parametrize("path", _py(os.path.join(tiny.BENCH, "reference")))
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "tpu_dist", "tpu_dist_torch"}


@pytest.mark.parametrize("path", _py(tiny.BENCH) + _py(os.path.join(
    tiny.BENCH, "drivers")) + _py(os.path.join(tiny.BENCH, "metrics")))
def test_harness_imports_no_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "tpu_dist"}
