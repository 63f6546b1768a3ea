"""The port's metrics registry against the JAX package's
(``tpu_dist/obs/metrics.py``): the same event stream through both ledger
sinks renders byte-equal Prometheus text and equal snapshots, one case per
event kind the sink maps and one for the whole stream; scrapes of the two
endpoints on ephemeral ports match; a port that will not bind warns and
disables the endpoint on both sides."""

import socket
import time
import urllib.request

import pytest

pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist.obs import metrics as ref  # noqa: E402

from tpu_dist_torch.obs import metrics as port  # noqa: E402

T0 = 1_700_000_000.0
# one record per event kind the sink maps, with the fields it reads
STREAM = {
    "run_start": {"kind": "lm", "config": {"quant": "int8", "lr": 0.1},
                  "jax_version": "x", "process_count": 2, "degraded": True},
    "step": {"step": 3, "steps_in_dispatch": 2, "items": 4096,
             "throughput": 1234.5, "unit": "tok/s", "mfu": 0.4125,
             "loss": 2.5, "data_s": 0.01, "dispatch_s": 0.02,
             "device_s": 0.3, "comm_s": 0.05},
    "stall": {"idle_s": 12.5},
    "skew": {"spread_s": 0.75, "straggler": 1},
    "health": {"kind": "nonfinite"},
    "epoch": {"epoch": 2},
    "eval": {"loss": 1.75},
    "hbm": {"bytes_in_use": 123456789},
    "decode": {"tokens": 64},
    "admit": {"queue_depth": 3, "pages_free": 17, "accepted": False},
    "request": {"tokens": 33},
    "span": {"name": "request", "ttft_s": 0.125},
    "kv_cache": {"pages_free": 12, "active_seqs": 5},
    "goodput": {"ratio": 0.875, "categories": {"startup": 1.5,
                                               "data_wait": 0.25}},
    "slo": {"kind": "throughput"},
    "scale": {"processes": 3, "action": "shrink"},
    "scale_decision": {"direction": "up", "target_hosts": 4},
    "audit": {"detail": [{"check": "PL002", "waived": False},
                         {"check": "PL001", "waived": True}]},
    "fleet": {"hosts_live": 3, "goodput_ratio": 0.5, "slo_breaches": 7},
}


def _records(kinds):
    return [{"event": k, "ts": T0 + i, "pid": 0, **STREAM[k]}
            for i, k in enumerate(kinds)]


def _feed(mod, records):
    reg = mod.MetricsRegistry()
    sink = mod.metrics_ledger_sink(reg)
    for rec in records:
        sink(dict(rec))
    return reg


@pytest.fixture(autouse=True)
def _frozen_clock(monkeypatch):
    # the last-step-age gauge reads the clock at render time
    monkeypatch.setattr(time, "time", lambda: T0 + 100.0)


@pytest.mark.parametrize("kind", sorted(STREAM))
def test_each_event_kind_renders_byte_equal(kind):
    recs = _records(["run_start", kind] if kind != "run_start"
                    else ["run_start"])
    got, want = _feed(port, recs), _feed(ref, recs)
    assert got.render() == want.render()
    assert got.snapshot() == want.snapshot()


def test_the_whole_stream_renders_byte_equal_and_moves_the_series():
    recs = _records(list(STREAM) + ["step", "slo", "fleet", "step"])
    got, want = _feed(port, recs), _feed(ref, recs)
    text = got.render()
    assert text == want.render() and got.snapshot() == want.snapshot()
    assert "tpu_dist_steps_total 6" in text          # 3 records x 2 steps
    assert 'tpu_dist_slo_breaches_total{kind="throughput"} 2' in text
    assert got.read_value("tpu_dist_mfu") == 0.4125


def _scrape(port_no, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port_no}{path}",
                                timeout=10) as r:
        return r.read().decode(), r.headers["Content-Type"]


@pytest.mark.parametrize("path", ["/metrics", "/healthz", "/livez"])
def test_scrapes_of_both_endpoints_match(path):
    recs = _records(list(STREAM))
    servers = [mod.serve_metrics(_feed(mod, recs), 0, host="127.0.0.1")
               for mod in (port, ref)]
    try:
        got, want = (_scrape(s.port, path) for s in servers)
    finally:
        for s in servers:
            s.close()
    assert got == want
    if path == "/healthz":
        assert got[0] == "ok last_step_age_s=99.000\n"


def test_a_port_that_will_not_bind_warns_and_disables(capsys):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        taken = s.getsockname()[1]
        got = port.serve_metrics(port.MetricsRegistry(), taken,
                                 host="127.0.0.1")
        want = ref.serve_metrics(ref.MetricsRegistry(), taken,
                                 host="127.0.0.1")
    assert got is None and want is None
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0] == err[1]
    assert f"cannot bind port {taken}" in err[0]
