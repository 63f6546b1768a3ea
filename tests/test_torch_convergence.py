"""The port's convergence tools (``tpu_dist_torch.tools.convergence`` and
``lm_convergence``) on the CPU, against the reference tools' contract:

* the image tool at the reference test's config (``tests/
  test_convergence.py``: lenet on synthetic MNIST, batch 64, 2048/512,
  fp32) reaches 90% val top-1 within its ``BOUND_STEPS`` (64);
* the LM tool at ``tests/test_scripts.py``'s tiny config reaches ppl 20;
* both JSON lines carry the reference tool's keys (read from the
  reference tools' source: no JAX runs here), and both entry points print
  one JSON line;
* their default device is CUDA: without it they raise.
"""

import ast
import io
import json
import os
from contextlib import redirect_stdout

import pytest
import torch

from tpu_dist_torch.tools import convergence, lm_convergence

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_convergence.py's bound for this config
BOUND_STEPS = 64
IMAGE_ARGS = ["--device", "cpu", "--arch", "lenet", "--dataset",
              "synthetic-mnist", "--precision", "fp32", "--batch-size", "64",
              "--synth-train-size", "2048", "--synth-val-size", "512",
              "--max-epochs", "2"]
LM_ARGS = ["--device", "cpu", "--synth-tokens", "60000", "--batch-size",
           "16", "--seq-len", "128", "--d-model", "64", "--threshold", "20",
           "--max-epochs", "4", "--vocab-size", "128"]


def _reference_keys(tool: str, branch: str) -> set:
    """The keys of the reference tool's JSON line when it reaches the
    threshold (``branch="result"``) or not (``"note"``): the ``out`` dict
    literal's keys and the keys of the merged branch's dict."""
    with open(os.path.join(REPO, "tools", tool)) as f:
        tree = ast.parse(f.read())
    keys, result, missed = set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            names = {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)}
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id == "out":
                keys |= names
            elif isinstance(target, ast.Name) and target.id == "result":
                result |= names
        if isinstance(node, ast.BoolOp) and len(node.values) == 2 and \
                isinstance(node.values[1], ast.Dict):
            missed = {k.value for k in node.values[1].keys}
    return keys | (result if branch == "result" else missed)


def _run_main(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    lines = buf.getvalue().splitlines()   # the trainer's lines, then one JSON
    assert sum(ln.startswith("{") for ln in lines) == 1
    return json.loads(lines[-1])


def test_image_tool_reaches_90pct_within_the_reference_bound():
    out = _run_main(convergence.main, IMAGE_ARGS)
    assert out["metric"] == "steps_to_90pct_top1"
    assert out["steps_to_threshold"] is not None
    assert out["steps_to_threshold"] <= BOUND_STEPS, out
    assert out["val_top1"] >= 0.90
    assert set(out) == _reference_keys("convergence.py", "result")


def test_lm_tool_reaches_ppl_20_at_the_scripts_config():
    out = _run_main(lm_convergence.main, LM_ARGS)
    assert out["metric"] == "steps_to_ppl_20"
    assert out["steps_to_threshold"] is not None and out["val_ppl"] <= 20
    assert out["mode"] == "dp"
    assert set(out) == _reference_keys("lm_convergence.py", "result")


@pytest.mark.parametrize("tool,module,argv,metric", [
    ("convergence.py", convergence,
     IMAGE_ARGS[:-2] + ["--max-epochs", "1", "--threshold", "1.01"],
     "steps_to_101pct_top1"),
    ("lm_convergence.py", lm_convergence,
     LM_ARGS[:-4] + ["--max-epochs", "1", "--threshold", "1.0",
                     "--vocab-size", "128", "--synth-tokens", "8000"],
     "steps_to_ppl_1")])
def test_a_threshold_not_reached_carries_the_reference_note(tool, module,
                                                            argv, metric):
    out = module.run(module.parser().parse_args(argv))
    assert out["metric"] == metric
    assert out["steps_to_threshold"] is None
    assert out["note"] == "not reached in 1 epochs"
    assert set(out) == _reference_keys(tool, "note")


@pytest.mark.parametrize("module", [convergence, lm_convergence])
def test_default_device_is_cuda(module):
    args = module.parser().parse_args([])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.run(args)
