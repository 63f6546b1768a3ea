"""Each observer knob takes effect on both of the port's trainers: a tiny CPU
run a knob, whose ledger or files show it working (``metrics_port``,
``profile_dir``, ``telemetry_csv``, ``skew_every``, ``slo_steps_per_min``,
``slo_throughput``, ``flightrec_dir``). Imports neither JAX nor the JAX
package: the parity with the reference's observers is held in
``tests/test_torch_{obs_metrics,flightrec,obs_trace,trace_merge}.py``."""

import json
import os
import socket
import urllib.request

import pytest
import torch

from tpu_dist_torch.configs import LMConfig, TrainConfig
from tpu_dist_torch.engine.lm_loop import LMTrainer
from tpu_dist_torch.engine.loop import Trainer
from tpu_dist_torch.obs import faults
from tpu_dist_torch.obs.ledger import read_ledger
from tpu_dist_torch.utils.telemetry import CSV_HEADER

torch.set_num_threads(1)

TINY_LM = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2,
               seq_len=32, batch_size=4, synth_tokens=660, val_frac=0.2,
               precision="fp32", optimizer="adamw", lr=3e-3, print_freq=1,
               seed=0, max_steps=4, watchdog_factor=0.0)
TINY_IMAGE = dict(arch="lenet", dataset="mnist", batch_size=8,
                  synth_train_size=32, synth_val_size=16, epochs=1,
                  precision="fp32", print_freq=1, seed=0, workers=0,
                  log_csv="", checkpoint_dir="", watchdog_factor=0.0)
KNOBS = ("metrics_port", "profile_dir", "telemetry_csv", "skew_every",
         "slo_steps_per_min", "slo_throughput", "flightrec_dir")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("TPU_DIST_FAULTS", "TPU_DIST_ATTEMPT",
              "TPU_DIST_HEARTBEAT_FILE", "TPU_DIST_PEER_RESUME"):
        monkeypatch.delenv(k, raising=False)
    faults._reset_for_tests()
    yield
    faults._reset_for_tests()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _knob_value(knob, tmp_path):
    return {"metrics_port": _free_port(),
            "profile_dir": str(tmp_path / "profile"),
            "telemetry_csv": str(tmp_path / "hbm.csv"),
            "skew_every": 2,
            # floors no tiny run reaches: the first judged records breach
            "slo_steps_per_min": 1e9, "slo_throughput": 1e12,
            "flightrec_dir": str(tmp_path / "fr")}[knob]


def _build(trainer, knob, value, tmp_path):
    path = str(tmp_path / "run.jsonl")
    kw = {knob: value, "ledger_path": path}
    if knob == "flightrec_dir":
        kw["slo_steps_per_min"] = 1e9      # a trigger for the recorder
    if trainer == "lm":
        return LMTrainer(LMConfig(**TINY_LM, **kw), device="cpu"), path
    return Trainer(TrainConfig(**TINY_IMAGE, **kw), device="cpu"), path


@pytest.mark.parametrize("knob", KNOBS)
@pytest.mark.parametrize("trainer", ["lm", "image"])
def test_observer_knob_takes_effect(trainer, knob, tmp_path):
    value = _knob_value(knob, tmp_path)
    tr, path = _build(trainer, knob, value, tmp_path)
    if knob == "metrics_port":
        # the endpoint answers from construction to run_end
        with urllib.request.urlopen(f"http://127.0.0.1:{value}/metrics",
                                    timeout=10) as r:
            body = r.read().decode()
        assert "tpu_dist_steps_total 0" in body
    tr.fit()
    recs = read_ledger(path)
    events = [r["event"] for r in recs]
    steps = sum(r["steps_in_dispatch"] for r in recs
                if r["event"] == "step")
    assert steps == tr.state.step > 0
    assert events[-2:] == ["metrics_snapshot", "run_end"]
    diag = [r for r in recs if r["event"] == "diagnosis"]
    if knob == "metrics_port":
        assert tr.obs.metrics_server is None           # closed at run_end
        snap = recs[-2]["metrics"]
        assert snap["tpu_dist_steps_total"][""] == steps
        with pytest.raises(OSError):
            urllib.request.urlopen(f"http://127.0.0.1:{value}/metrics",
                                   timeout=2)
    elif knob == "profile_dir":
        with open(os.path.join(value, "trace.json")) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
        marks = {n for n in names if n.startswith("ProfilerStep#")}
        assert len(marks) == len([r for r in recs if r["event"] == "step"])
        assert "dispatch" in names and "device" in names
        # the recorder's window stands down under the session
        assert not diag
    elif knob == "telemetry_csv":
        with open(value) as f:
            lines = f.read().splitlines()
        assert lines[0] == CSV_HEADER and len(lines) >= 2
        # off the card the device columns stay empty, as in the reference
        assert all(line.split(",")[1:4] == ["", "", ""]
                   for line in lines[1:])
        hbm = [r for r in recs if r["event"] == "hbm"]
        assert len(hbm) == len(lines) - 1
    elif knob == "skew_every":
        skew = [r for r in recs if r["event"] == "skew"]
        assert len(skew) == steps // value
        assert {(r["n_procs"], r["straggler"], r["spread_s"])
                for r in skew} == {(1, 0, 0.0)}
    elif knob in ("slo_steps_per_min", "slo_throughput"):
        slo = [r for r in recs if r["event"] == "slo"]
        kind = knob[len("slo_"):]
        assert [r["kind"] for r in slo] == [kind]
        assert slo[0]["floor"] == value and slo[0]["value"] < value
        assert [d["reason"] for d in diag] == ["slo"]
        assert recs[-2]["metrics"]["tpu_dist_slo_breaches_total"][
            f'{{kind="{kind}"}}'] == 1
    elif knob == "flightrec_dir":
        assert [d["reason"] for d in diag] == ["slo"]
        bundle = diag[0]["bundle"]
        assert os.path.dirname(bundle) == value
        with open(os.path.join(bundle, "manifest.json")) as f:
            manifest = json.load(f)
        assert set(manifest["files"]) == {"stacks.txt", "hbm.json",
                                          "events_tail.jsonl"}
        assert manifest["trace"]["status"] in ("captured", "not-captured")
