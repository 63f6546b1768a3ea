"""The port's ``tools/trace_merge.py`` against the reference tool
(``tools/trace_merge.py``): on the same ledgers both write the same Chrome
trace (``otherData.tool`` names each tool): a job of two processes and two
attempts with a supervisor sibling, and the ledger of a port LMTrainer run
with its observers on; ``--no-discover`` and a torn last line alike."""

import importlib.util
import json
import os

import pytest

pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist_torch.configs import LMConfig  # noqa: E402
from tpu_dist_torch.engine.lm_loop import LMTrainer  # noqa: E402
from tpu_dist_torch.obs.ledger import Ledger  # noqa: E402
from tpu_dist_torch.tools import trace_merge  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "ref_trace_merge", os.path.join(REPO, "tools", "trace_merge.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _attempt(path, pidx, t_off, steps):
    led = Ledger(path, process_index=pidx)
    led.emit("run_start", kind="lm", config={}, mesh={"data": 2},
             devices=["NVIDIA H100 80GB HBM3"], process_count=2)
    led.emit("compile", program="train_step", seconds=1.5)
    for s in steps:
        led.emit("step", step=s, loss=2.0 - 0.1 * s, throughput=100.0 + s,
                 unit="tok/s", data_s=0.01 * (pidx + 1), dispatch_s=0.02,
                 device_s=0.3, comm_s=0.05 if pidx else None, mfu=0.4,
                 steps_in_dispatch=1, warm=s == steps[0])
        led.emit("skew", step=s, p50_s=0.3, p99_s=0.4, spread_s=0.1 * s,
                 straggler=1)
        led.emit("hbm", bytes_in_use=1000 * s + pidx)
    led.emit("stall", idle_s=12.0, threshold_s=5.0, stacks="...")
    led.emit("health", step=steps[-1], kind="nonfinite", policy="record",
             action="recorded", value=None)
    led.emit("span", trace_id="t", span_id="s1", parent_id=None,
             name="request", rid=3, start=1.0, end=1.5, ttft_s=0.2)
    led.emit("eval", epoch=0, loss=1.5)
    led.emit("epoch", epoch=0, start_ts=t_off, seconds=2.0, throughput=1.0,
             unit="tok/s", loss=1.9)
    led.emit("ckpt", epoch=1, path="ck", is_best=True)
    led.emit("run_end", steps=len(steps), seconds=3.0, status="ok")
    led.close()


def _job(tmp_path):
    base = str(tmp_path / "run.jsonl")
    for att, steps in ((0, [0, 1, 2]), (1, [3, 4])):
        stem = base if att == 0 else str(tmp_path / f"run.a{att}.jsonl")
        for pidx in (0, 1):
            root, ext = os.path.splitext(stem)
            _attempt(stem if pidx == 0 else f"{root}.p{pidx}{ext}", pidx,
                     0.0, steps)
    sup = Ledger(str(tmp_path / "run.sup.jsonl"))
    sup.emit("scale", action="shrink", processes=1, epoch=1, step=2)
    sup.emit("scale_decision", decision="d1", direction="up", hosts_from=1,
             target_hosts=2, signal="queue", value=3.0, threshold=2.0,
             window_ticks=4, bundle=None)
    sup.emit("scale", action="expand", processes=2, epoch=2, step=3)
    sup.close()
    return base


def _lm_run(tmp_path):
    path = str(tmp_path / "lm.jsonl")
    cfg = LMConfig(vocab_size=64, d_model=32, num_layers=1, num_heads=2,
                   seq_len=32, batch_size=4, synth_tokens=660, val_frac=0.2,
                   precision="fp32", optimizer="adamw", lr=3e-3,
                   print_freq=1, seed=0, max_steps=4, watchdog_factor=0.0,
                   skew_every=2, telemetry_csv=str(tmp_path / "hbm.csv"),
                   ledger_path=path)
    LMTrainer(cfg, device="cpu").fit()
    return path


def _both(paths, out_dir, extra=()):
    got_p, want_p = str(out_dir / "port.json"), str(out_dir / "ref.json")
    assert trace_merge.main(list(paths) + ["-o", got_p, *extra]) == 0
    assert _reference_tool().main(list(paths) + ["-o", want_p, *extra]) == 0
    with open(got_p) as f, open(want_p) as g:
        got, want = json.load(f), json.load(g)
    assert got["otherData"].pop("tool") == trace_merge.TOOL
    assert want["otherData"].pop("tool") == "tpu_dist tools/trace_merge.py"
    return got, want


@pytest.mark.parametrize("ledgers", ["job", "lm_run"])
def test_merged_trace_equals_the_reference_tools(ledgers, tmp_path):
    path = _job(tmp_path) if ledgers == "job" else _lm_run(tmp_path)
    got, want = _both([path], tmp_path)
    assert got == want
    other = got["otherData"]
    if ledgers == "job":
        assert (other["processes"], other["attempts"],
                other["scale_events"], other["autoscale_events"]) == \
            (4, 2, 2, 1)
        names = {e["name"] for e in got["traceEvents"]}
        assert {"restart gap", "scale:shrink", "decision:up",
                "skew spread (ms)", "hbm bytes", "STALL"} <= names
    else:
        assert other["processes"] == 1
        names = {e["name"] for e in got["traceEvents"]}
        assert {"compile", "skew spread (ms)", "hbm bytes"} <= names


def test_no_discover_and_a_torn_line_alike(tmp_path, capsys):
    base = _job(tmp_path)
    with open(base, "a") as f:
        f.write('{"event": "step", "ts": 1')         # a killed writer
    got, want = _both([base, str(tmp_path / "run.a1.p1.jsonl")], tmp_path,
                      ["--no-discover"])
    assert got == want and got["otherData"]["processes"] == 2
    err = capsys.readouterr().err
    assert err.count("skipping corrupt/truncated ledger line") == 2
