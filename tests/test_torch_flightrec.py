"""The port's flight recorder against the JAX package's
(``tpu_dist/obs/flightrec.py``): the same event stream through both
recorders gives equal manifests (paths and timestamps aside), equal
``diagnosis`` events, equal bundle tails and equal cooldown and cap
behaviour. The memory profile is each backend's own: the reference's
``memory.prof`` and the port's CUDA allocator snapshot, which the CPU does
not have, so the reference's entry is set aside in the comparison.

The profiler window (port only: the reference's ``jax.profiler`` window
pays a long one-time start on the CPU) advances on CPU ``torch.profiler``
over the next step records and stands down under a ``profile_dir``
session; ``SIGUSR1`` through ``RunObs`` gives a bundle."""

import json
import os
import shutil
import signal
import time

import pytest

pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist.obs import flightrec as ref  # noqa: E402
from tpu_dist.obs.ledger import Ledger as RefLedger  # noqa: E402

from tpu_dist_torch.configs import LMConfig  # noqa: E402
from tpu_dist_torch.obs import RunObs  # noqa: E402
from tpu_dist_torch.obs import flightrec as port  # noqa: E402
from tpu_dist_torch.obs.ledger import Ledger, read_ledger  # noqa: E402

T0 = 1_700_000_000.0


def _step(step):
    return {"event": "step", "ts": T0 + step, "pid": 0, "step": step,
            "loss": 2.0, "throughput": 10.0, "unit": "tok/s"}


# detector records, and whether the reference's rule makes each a trigger
DETECTORS = {
    "stall": ({"event": "stall", "idle_s": 31.5, "threshold_s": 10.0,
               "stacks": "..."}, True),
    "health": ({"event": "health", "step": 3, "kind": "nonfinite",
                "policy": "skip", "action": "skipped", "value": None}, True),
    "skew_spike": ({"event": "skew", "step": 3, "p50_s": 0.1, "p99_s": 2.0,
                    "spread_s": 1.9, "straggler": 2}, True),
    "skew_jitter": ({"event": "skew", "step": 3, "p50_s": 0.3,
                     "p99_s": 0.9, "spread_s": 0.6, "straggler": 1}, False),
    "slo": ({"event": "slo", "step": 3, "kind": "throughput", "value": 4.5,
             "floor": 9.0}, True),
    "eval": ({"event": "eval", "epoch": 0, "loss": 1.5}, False),
}


class _Pair:
    """The same records into the port's recorder and the reference's, each
    with its own bundle root and a ledger that captures its emits."""

    def __init__(self, tmp_path, **kw):
        self.emitted = {"port": [], "ref": []}
        self.rec = {}
        for name, mod, led_cls in (("port", port, Ledger),
                                   ("ref", ref, RefLedger)):
            led = led_cls(None)
            led.add_sink(self.emitted[name].append)
            self.rec[name] = mod.FlightRecorder(
                dir=str(tmp_path / name), ledger=led, trace_steps=0, **kw)

    def feed(self, rec):
        for r in self.rec.values():
            r.sink(dict(rec))

    def trigger(self, reason, note=None):
        return [self.rec[k].trigger(reason, note) for k in ("port", "ref")]

    def bundles(self):
        return {k: [os.path.basename(b) for b in r.bundles]
                for k, r in self.rec.items()}

    def diagnoses(self):
        return {k: [{**{f: v for f, v in d.items()
                        if f not in ("ts", "bundle")},
                     "bundle": os.path.basename(d["bundle"])}
                    for d in ev if d["event"] == "diagnosis"]
                for k, ev in self.emitted.items()}


def _manifest(bundle):
    with open(os.path.join(bundle, "manifest.json")) as f:
        m = json.load(f)
    m.pop("ts")
    m["files"].pop("memory.prof", None)     # the reference's memory profile
    return m


def _same_bundle(got, want):
    assert _manifest(got) == _manifest(want)
    for name in ("hbm.json", "events_tail.jsonl"):
        with open(os.path.join(got, name)) as f, \
                open(os.path.join(want, name)) as g:
            assert f.read() == g.read()
    with open(os.path.join(got, "stacks.txt")) as f:
        assert "--- thread" in f.read()


@pytest.mark.parametrize("kind", sorted(DETECTORS))
def test_detector_events_trigger_the_same_bundles(kind, tmp_path):
    rec, fires = DETECTORS[kind]
    pair = _Pair(tmp_path, cooldown_s=0.0)
    for s in range(3):
        pair.feed(_step(s))
    pair.feed({**rec, "ts": T0 + 10, "pid": 0})
    bundles = pair.bundles()
    assert bundles["port"] == bundles["ref"]
    assert len(bundles["port"]) == int(fires)
    diag = pair.diagnoses()
    assert diag["port"] == diag["ref"]
    if fires:
        assert diag["port"][0]["step"] == 2
        _same_bundle(pair.rec["port"].bundles[0], pair.rec["ref"].bundles[0])


def test_direct_trigger_with_a_note_matches(tmp_path):
    pair = _Pair(tmp_path)
    pair.feed(_step(7))
    got, want = pair.trigger("manual", note="operator asked")
    assert os.path.basename(got) == os.path.basename(want) == "001-manual-p0"
    assert pair.diagnoses()["port"] == pair.diagnoses()["ref"]
    _same_bundle(got, want)


def test_cooldown_drops_alike_with_one_note(tmp_path, capsys):
    pair = _Pair(tmp_path, cooldown_s=60.0)
    first = pair.trigger("a")
    assert all(first)
    assert pair.trigger("b") == [None, None]
    assert pair.trigger("c") == [None, None]    # silent: one note a window
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2
    assert err[0].replace("tpu_dist_torch ", "tpu_dist ") == err[1]
    assert pair.bundles()["port"] == pair.bundles()["ref"] == ["001-a-p0"]


def test_bundle_cap_drops_alike_with_one_note(tmp_path, capsys):
    pair = _Pair(tmp_path, cooldown_s=0.0, max_bundles=2)
    for reason in ("a", "b", "c", "d"):
        pair.trigger(reason)
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and "bundle cap 2" in err[0]
    assert err[0].replace("tpu_dist_torch ", "tpu_dist ") == err[1]
    assert pair.bundles()["port"] == pair.bundles()["ref"] == \
        ["001-a-p0", "002-b-p0"]
    assert pair.diagnoses()["port"] == pair.diagnoses()["ref"]


def test_bundle_root_derives_from_the_ledger_path(tmp_path):
    path = str(tmp_path / "run.jsonl")
    got = port.FlightRecorder(ledger=Ledger(path), trace_steps=0)
    want = ref.FlightRecorder(ledger=RefLedger(str(tmp_path / "r.jsonl")),
                              trace_steps=0)
    assert os.path.dirname(got.trigger("x")) == path + ".flightrec"
    assert os.path.dirname(want.trigger("x")) == \
        str(tmp_path / "r.jsonl") + ".flightrec"
    pathless = port.FlightRecorder(ledger=Ledger(None), trace_steps=0)
    root = os.path.dirname(pathless.trigger("y"))
    try:
        assert os.path.basename(root).startswith("tpu_dist_torch_flightrec.")
    finally:
        shutil.rmtree(root)


def test_trace_window_advances_on_the_cpu_profiler(tmp_path):
    import torch

    led = Ledger(None)
    diag = []
    led.add_sink(diag.append)
    fr = port.FlightRecorder(dir=str(tmp_path), ledger=led, trace_steps=2)
    bundle = fr.trigger("manual")
    assert _manifest(bundle)["trace"] == {"status": "armed", "steps": 2,
                                          "dir": "trace"}
    assert fr.window_open()
    fr.sink(_step(0))                  # starts the window
    assert fr._trace["state"] == "active"
    x = torch.ones(64, 64)
    for s in (1, 2):                   # the window's two records
        (x @ x).sum()
        fr.sink(_step(s))
    assert not fr.window_open()
    assert _manifest(bundle)["trace"] == {"status": "captured",
                                          "dir": "trace", "steps": 2}
    with open(os.path.join(bundle, "trace", "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    # a second trigger while no window is open arms a new one
    fr.cooldown_s = 0.0
    b2 = fr.trigger("again")
    fr.close()                         # the run ends before any step
    assert _manifest(b2)["trace"]["status"] == "not-captured"


def test_trace_window_stands_down_under_a_profile_dir_session(tmp_path):
    cfg = LMConfig(ledger_path=str(tmp_path / "run.jsonl"),
                   profile_dir=str(tmp_path / "profile"))
    obs = RunObs("lm", cfg)
    assert obs.profiling
    bundle = obs.flightrec.trigger("manual")
    assert _manifest(bundle)["trace"] == {
        "status": "skipped", "why": "a profile_dir session owns the profiler"}
    assert not obs.flightrec.window_open()
    # nor does the first dispatch's cost attribution run under it
    assert obs.first_dispatch().cost is False
    obs.run_end()


def test_sigusr1_through_runobs_captures_a_bundle(tmp_path):
    path = str(tmp_path / "run.jsonl")
    cfg = LMConfig(ledger_path=path, flightrec_trace_steps=0,
                   watchdog_factor=0.0)
    obs = RunObs("lm", cfg)
    obs.run_start(mesh={"data": 1}, devices=["cpu"], process_count=1)
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.time() + 10
        while not obs.flightrec.bundles and time.time() < deadline:
            time.sleep(0.01)
    finally:
        obs.run_end()
    recs = read_ledger(path)
    diag = [r for r in recs if r["event"] == "diagnosis"]
    assert [d["reason"] for d in diag] == ["sigusr1"]
    assert os.path.isdir(diag[0]["bundle"])
    assert [r["event"] for r in recs][-2:] == ["metrics_snapshot", "run_end"]
    # run_end gave the previous handler back
    assert signal.getsignal(signal.SIGUSR1) is not obs._on_sigusr1
