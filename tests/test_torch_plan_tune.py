"""The port's plan tuner (``tpu_dist_torch/plan/tune.py``), its CLI
(``python -m tpu_dist_torch.tools.tune``) and the supervisor's ``retune``
against the reference's:

* over the canned measurement file at a device kind neither package knows,
  the port emits the reference's plan-file bytes exactly;
* ``estimate_step_seconds`` agrees for every candidate of both engines at
  one given peaks dict, with the file's comm estimates;
* the card's kind gives the port's data-sheet peaks (989 TFLOP/s bf16,
  3,350 GB/s, ``nominal`` false), and a kind the tables lack nominal ones;
* the CLI is byte-deterministic and ``--ledger`` appends one ``tune`` event;
* ``Supervisor(retune=...)`` stamps ``applied`` with the hash of ``tune()``
  at the new world size and writes ``plan_epoch<N>.json``; a retune without
  ``device_kind`` is refused by name."""

import json
import os

import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist.plan import tune as ref_tune  # noqa: E402
from tpu_dist_torch.obs.ledger import read_ledger  # noqa: E402
from tpu_dist_torch.plan import ir, tune  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUNE_CI = os.path.join(REPO, "scripts", "tune_ci.json")
H100 = "NVIDIA H100 80GB HBM3"


def test_plan_file_bytes_match_the_reference_at_an_unknown_kind():
    got, got_res = tune.tune(measurement_files=[TUNE_CI],
                             device_kinds=["unknown"])
    want, want_res = ref_tune.tune(measurement_files=[TUNE_CI],
                                   device_kinds=["unknown"])
    assert got == want
    assert got_res["unknown"]["peaks"]["nominal"] is True
    assert [c["hash"] for c in got_res["unknown"]["ranked"]] == \
        [c["hash"] for c in want_res["unknown"]["ranked"]]


@pytest.mark.parametrize("engine", ["lm", "image"])
def test_estimates_agree_for_every_candidate(engine):
    with open(TUNE_CI) as f:
        meas = json.load(f)
    peaks = {"tflops": 197.0, "gbps": 819.0, "nominal": False}
    for devices in (1, 8):
        w = ref_tune.normalize_workload({"engine": engine,
                                         "devices": devices})
        assert tune.normalize_workload({"engine": engine,
                                        "devices": devices}) == w
        comm = ref_tune.comm_estimates(meas, w)
        assert tune.comm_estimates(meas, w) == comm
        for plan in ref_tune.default_space(engine, devices):
            mine = ir.Plan.from_json(plan.to_json())
            assert tune.estimate_step_seconds(mine, w, peaks, comm) == \
                ref_tune.estimate_step_seconds(plan, w, peaks, comm)
    trials = [{"knobs": {"quant": "int8"}, "step_s": 0.25}]
    plan = ir.Plan(engine="lm", quant="int8")
    assert tune.trial_step_seconds(trials, plan, {}) == 0.25


def test_device_peaks_are_the_port_tables():
    assert tune.device_peaks(H100) == {"tflops": 989.0, "gbps": 3350.0,
                                       "nominal": False}
    assert tune.device_peaks("nvidia h100 pcie")["nominal"] is False
    for kind in ("cpu", "TPU v5 lite", ""):
        assert tune.device_peaks(kind) == {"tflops": 1.0, "gbps": 1.0,
                                           "nominal": True}


def test_cli_is_deterministic_and_writes_a_tune_event(tmp_path, capsys):
    from tpu_dist_torch.tools import tune as cli

    led = tmp_path / "tune.jsonl"
    argv = ["--device-kind", H100, "--workload",
            '{"n_params": 168372224, "tokens_per_step": 16384, '
            '"devices": 1}', "--json"]
    outs = []
    for i in range(2):
        assert cli.main(argv + (["--ledger", str(led)] if i == 0 else
                                ["--out", str(tmp_path / "p.json")])) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].strip()
    assert (tmp_path / "p.json").read_text() == outs[0]
    doc = json.loads(outs[0])
    entry = doc["plans"][H100]
    assert entry["score"]["peaks_nominal"] is False
    assert ir.plan_hash(ir.Plan.from_dict(entry)) == entry["hash"]
    tunes = [r for r in read_ledger(str(led)) if r["event"] == "tune"]
    assert len(tunes) == 1 and tunes[0]["device_kind"] == H100
    assert tunes[0]["best_hash"] == entry["hash"]
    assert tunes[0]["peaks_nominal"] is False


def test_supervisor_retune_stamps_applied_with_reproducible_hash(tmp_path):
    import sys

    from tpu_dist_torch.parallel import supervisor as sup
    from tpu_dist_torch.parallel.consensus import MeshView

    plan_dir = str(tmp_path / "plans")
    s = sup.Supervisor([sys.executable, "-c", "pass"],
                       ledger=str(tmp_path / "run.jsonl"),
                       retune={"device_kind": H100, "devices_per_host": 2,
                               "plan_dir": plan_dir})
    s._maybe_retune(MeshView(epoch=1, hosts=(0, 1, 2), planned=3),
                    "expand", "d0")
    recs = read_ledger(str(tmp_path / "run.sup.jsonl"))
    assert [r["event"] for r in recs] == ["applied"]
    app = recs[0]
    assert (app["decision"], app["action"], app["processes"],
            app["epoch"], app["devices"]) == ("d0", "expand", 3, 1, 6)
    _, results = tune.tune(device_kinds=[H100], workload={"devices": 6})
    assert results[H100]["best"]["hash"] == app["plan_hash"]
    with open(os.path.join(plan_dir, "plan_epoch1.json")) as f:
        assert app["plan_hash"] in f.read()
    with pytest.raises(ValueError, match="device_kind"):
        sup.Supervisor(["true"], ledger=str(tmp_path / "r2.jsonl"),
                       retune={"plan_dir": plan_dir})
