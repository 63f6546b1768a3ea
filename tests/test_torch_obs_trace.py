"""The port's step tracer, profiler session, skew monitor, telemetry and
FLOP counts against the JAX package's (``tpu_dist/obs/{trace,skew}.py``,
``tpu_dist/utils/{telemetry,mfu}.py``):

* ``StepTracer`` gives the reference's nested span paths and ``pop``;
  ``profile_session`` exports its Chrome trace and stops on an exception;
* ``SkewMonitor``'s events equal the reference's at one rank over
  parametrised window strides, and on two gloo ranks (one group for the
  module) equal the reference's with its ``process_allgather`` standing in
  for the two ranks;
* the telemetry CSV header is the reference's, its device columns stay
  empty off the card, and ``stop`` is idempotent;
* ``utils.mfu``'s counts equal the reference's on parameters carried
  across by ``interop.py``, for the dense and the MoE LM."""

import json
import os
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from tpu_dist.obs import skew as ref_skew  # noqa: E402
from tpu_dist.obs import trace as ref_trace  # noqa: E402
from tpu_dist.obs.ledger import Ledger as RefLedger  # noqa: E402
from tpu_dist.utils import mfu as ref_mfu  # noqa: E402
from tpu_dist.utils import telemetry as ref_telemetry  # noqa: E402

from tpu_dist_torch.obs import skew, trace  # noqa: E402
from tpu_dist_torch.obs.ledger import Ledger  # noqa: E402
from tpu_dist_torch.utils import mfu, telemetry  # noqa: E402

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# StepTracer and profile_session

def _spans(tr):
    with tr.span("data"):
        with tr.span("decode"):
            pass
        with tr.span("decode"):
            with tr.span("resize"):
                pass
    with tr.span("dispatch"):
        pass
    tr.add("device", 0.25)
    tr.add("device", 0.5)
    return tr.phases(), tr.pop(), tr.pop()


def test_step_tracer_paths_and_pop_equal_the_reference():
    got = _spans(trace.StepTracer())
    want = _spans(ref_trace.StepTracer())
    assert [sorted(p) for p in got] == [sorted(p) for p in want]
    assert sorted(got[1]) == ["data", "data/decode", "data/decode/resize",
                              "device", "dispatch"]
    assert got[1]["device"] == want[1]["device"] == 0.75
    assert got[2] == want[2] == {}
    assert got[1]["data"] >= got[1]["data/decode"] >= \
        got[1]["data/decode/resize"]


def test_annotated_spans_and_step_marks_land_on_the_trace(tmp_path):
    tr = trace.StepTracer(annotate=True)
    with trace.profile_session(str(tmp_path), process_index=2) as on:
        assert on
        for step in (4, 5):
            with trace.step_annotation(step), tr.span("dispatch"):
                with tr.span("inner"):
                    torch.ones(8).sum()
    path = tmp_path / "trace.p2.json"       # per_process_path's suffix
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert {"ProfilerStep#4", "ProfilerStep#5"} <= set(names)
    assert names.count("dispatch/inner") == 2
    assert sorted(tr.pop()) == ["dispatch", "dispatch/inner"]


def test_profile_session_stops_and_exports_on_an_exception(tmp_path):
    from torch.autograd import _profiler_enabled

    with pytest.raises(ZeroDivisionError):
        with trace.profile_session(str(tmp_path)):
            assert _profiler_enabled()
            torch.ones(4).sum()
            1 / 0
    assert not _profiler_enabled()
    assert os.path.getsize(tmp_path / "trace.json") > 0
    # off: no session, no file
    with trace.profile_session("") as on:
        assert not on and not _profiler_enabled()


# ---------------------------------------------------------------------------
# SkewMonitor

# (every, record strides): steps of one record each, windows of 3 that
# never land on every=4, mixed strides
CASES = {"every1": (1, [1] * 5), "every4": (4, [1] * 9),
         "every4_windows3": (4, [3] * 6),
         "every5_mixed": (5, [2, 1, 3, 2, 4, 1, 2, 3])}


def _times(rank, n):
    """(step_s, data_s) a record: rank 1 the slower on some records, rank
    0 on others."""
    return [(0.01 * (i + 1) + (0.05 * rank if i % 3 == 1 else 0.0)
             + (0.03 if rank == 0 and i % 4 == 3 else 0.0),
             0.001 * i + 0.02 * rank) for i in range(n)]


def _run(monitor, times, strides):
    return [s for s in (monitor.record(i, st, dt, n_steps=k)
                        for i, ((st, dt), k) in enumerate(zip(times,
                                                              strides)))
            if s is not None]


def _events(led_cls):
    led = led_cls(None)
    events = []
    led.add_sink(events.append)
    return led, events


def _strip(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


@pytest.mark.parametrize("case", sorted(CASES))
def test_skew_at_one_rank_equals_the_reference(case):
    every, strides = CASES[case]
    times = _times(0, len(strides))
    led, got_ev = _events(Ledger)
    ref_led, want_ev = _events(RefLedger)
    got = _run(skew.SkewMonitor(every, ledger=led), times, strides)
    want = _run(ref_skew.SkewMonitor(every, ledger=ref_led), times, strides)
    assert got == want and len(got) >= 1
    assert _strip(got_ev) == _strip(want_ev)
    assert {s["n_procs"] for s in got} == {1}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One gloo group of two ranks for the module: every CASES run."""
    from torch_dp_worker import run_group

    job = {"kind": "skew", "name": "skew", "cases": {
        name: {"every": every, "strides": strides,
               "times": [_times(r, len(strides)) for r in (0, 1)]}
        for name, (every, strides) in CASES.items()}}
    out = str(tmp_path_factory.mktemp("skew2"))
    return run_group(2, {"jobs": [job]}, out, timeout=240)


def _reference_two_ranks(monkeypatch, every, strides):
    """The reference monitor of rank 0 with its ``process_allgather``
    given the two ranks' rows: rank 1's windows come from a reference
    monitor of its own, run first."""
    from jax.experimental import multihost_utils

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    peer = []
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda x: (peer.append(np.array(x)),
                                   np.stack([x, x]))[1])
    _run(ref_skew.SkewMonitor(every), _times(1, len(strides)), strides)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda x: np.stack([x, peer.pop(0)]))
    led, events = _events(RefLedger)
    stats = _run(ref_skew.SkewMonitor(every, ledger=led),
                 _times(0, len(strides)), strides)
    assert not peer
    return stats, events


@pytest.mark.parametrize("case", sorted(CASES))
def test_skew_on_two_gloo_ranks_equals_the_reference(case, two_ranks,
                                                     monkeypatch):
    every, strides = CASES[case]
    want, want_ev = _reference_two_ranks(monkeypatch, every, strides)
    for rank, res in enumerate(two_ranks):
        got = res["skew"][case]
        assert got["stats"] == want
        assert [{k: v for k, v in e.items() if k not in ("ts", "pid")}
                for e in got["events"]] == \
            [{k: v for k, v in e.items() if k not in ("ts", "pid")}
             for e in want_ev]
    assert {s["n_procs"] for s in want} == {2}


def test_two_gloo_ranks_name_each_straggler(two_ranks):
    stats = two_ranks[0]["skew"]["every1"]["stats"]
    assert [s["straggler"] for s in stats] == [0, 1, 0, 0, 1]
    assert stats[1]["straggler_data_s"] == pytest.approx(0.021, abs=1e-6)


# ---------------------------------------------------------------------------
# telemetry

def test_telemetry_header_empty_cpu_columns_and_idempotent_stop(tmp_path):
    assert telemetry.CSV_HEADER == ref_telemetry.CSV_HEADER
    assert telemetry.device_memory_stats("cpu") == {}
    assert telemetry.peak_hbm_bytes("cpu") is None
    led, events = _events(Ledger)
    path = str(tmp_path / "hbm.csv")
    stop = telemetry.start_hbm_sampler(path, interval_s=0.02, ledger=led,
                                       device="cpu")
    time.sleep(0.15)
    stop()
    stop()                                   # idempotent
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == ref_telemetry.CSV_HEADER and len(lines) >= 3
    for line in lines[1:]:
        ts, used, peak, limit, rss = line.split(",")
        assert float(ts) > 0 and (used, peak, limit) == ("", "", "")
        assert int(rss) > 0
    assert len(events) == len(lines) - 1
    assert {(e["bytes_in_use"], e["peak_bytes"], e["bytes_limit"])
            for e in events} == {(None, None, None)}


def test_telemetry_of_a_reference_run_has_the_same_columns(tmp_path):
    path = str(tmp_path / "ref.csv")
    stop = ref_telemetry.start_hbm_sampler(path, interval_s=0.02)
    time.sleep(0.06)
    stop()
    with open(path) as f:
        want = f.read().splitlines()
    assert [len(line.split(",")) for line in want] == [5] * len(want)


# ---------------------------------------------------------------------------
# utils.mfu on parameters carried across by interop.py

def test_dense_lm_flops_equal_the_reference():
    from tpu_dist.models.transformer import TransformerLM as JaxLM

    from tpu_dist_torch.interop import load_flax_params
    from tpu_dist_torch.models.transformer import TransformerLM

    kw = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=2,
              max_len=16)
    params = JaxLM(**kw).init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 16), jnp.int32),
                              train=False)["params"]
    model = TransformerLM(**kw, device="cpu", seed=0)
    load_flax_params(model, params)
    got = mfu.lm_flops_per_token(
        [(n, tuple(p.shape)) for n, p in model.named_parameters()], 2, 16,
        32)
    assert got == ref_mfu.lm_flops_per_token(params, 2, 16, 32)


def test_moe_lm_flops_equal_the_reference():
    from tpu_dist.models.moe import MoETransformerLM as JaxMoE

    from tpu_dist_torch.interop import load_flax_params
    from tpu_dist_torch.models.moe import MoETransformerLM

    kw = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=2,
              max_len=16, num_experts=4, router_top_k=2)
    params = JaxMoE(**kw).init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 16), jnp.int32),
                               train=False)["params"]
    model = MoETransformerLM(**kw, device="cpu", seed=0)
    load_flax_params(model, params)
    geo = dict(num_layers=2, seq_len=16, d_model=32, num_experts=4,
               router_top_k=2, total_tokens=64, group_size=32)
    got = mfu.moe_lm_flops_per_token(
        [(n, tuple(p.shape)) for n, p in model.named_parameters()], **geo)
    assert got == ref_mfu.moe_lm_flops_per_token(params, **geo)


def test_peak_is_the_cards_and_none_off_it():
    assert mfu.peak_tflops_for("cpu") is None
    assert mfu.PEAK_FLOPS["H100"][torch.bfloat16] == 989e12
