"""The port's serving slice (tpu_dist_torch.engine.serve over the paged KV
pool) against the reference engine, and the reference's own serving
contracts re-proved inside the port.

Across packages: the same mixed-length greedy requests through the JAX
``ServeEngine`` and the port's ``ServeEngine(device="cpu")`` give equal
tokens for the slice's configuration (int8 pages, flash read, flash
prefill), for the fp pool and for chunked prefill. Inside the port:
paged greedy equals its contiguous ``generate``; pool accounting; the
fragmentation pin; SLO shedding emits ``slo``; prefix caching is
token-identical; the unported knobs raise and say so."""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.engine import serve as jserve  # noqa: E402
from tpu_dist.engine.generate import generate as jax_generate  # noqa: E402
from tpu_dist.models import transformer as jtr  # noqa: E402
from tpu_dist.ops.flash_attention import \
    flash_attention_fn as jax_flash  # noqa: E402
from tpu_dist_torch.engine.generate import generate  # noqa: E402
from tpu_dist_torch.engine.kv_cache import PagedKVPool  # noqa: E402
from tpu_dist_torch.engine.serve import (  # noqa: E402
    DecodeRequest, ServeConfig, ServeEngine)
from tpu_dist_torch.interop import load_flax_params  # noqa: E402
from tpu_dist_torch.models.transformer import (full_attention,  # noqa: E402
                                                tiny_lm)
from tpu_dist_torch.obs.ledger import Ledger, read_ledger  # noqa: E402
from tpu_dist_torch.ops.flash_attention import flash_attention_fn  # noqa: E402

torch.set_num_threads(1)

V, L = 64, 32
GEOM = dict(vocab_size=V, num_layers=2, d_model=64, num_heads=4, max_len=L)
PROMPTS = [np.array([1, 9, 17], np.int32), np.array([5], np.int32),
           (np.arange(11) * 7 % V).astype(np.int32)]
STEPS = [10, 12, 8]


def _lm(seed=0, **kw):
    return tiny_lm(device="cpu", seed=seed, **GEOM, **kw)


def _pair(seed, flash):
    jlm = jtr.tiny_lm(attn_fn=jax_flash() if flash else jtr.full_attention,
                      **GEOM)
    params = jlm.init({"params": jax.random.PRNGKey(seed)},
                      jnp.zeros((1, L), jnp.int32), train=False)["params"]
    tlm = tiny_lm(device="cpu", seed=None, **GEOM,
                  attn_fn=flash_attention_fn() if flash else full_attention)
    load_flax_params(tlm, jax.tree_util.tree_map(np.asarray, params))
    return jlm, params, tlm


CONFIGS = {
    "slice_int8_flash": (True, dict(kv_quant="int8", attn_read="flash")),
    "fp_pool": (False, dict()),
    "chunked_prefill": (False, dict(prefill_chunk=4)),
    "slice_chunked": (True, dict(kv_quant="int8", attn_read="flash",
                                 prefill_chunk=4)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_tokens_equal_reference_engine(name):
    flash, kw = CONFIGS[name]
    jlm, params, tlm = _pair(4, flash)
    cfg = dict(max_slots=2, page_size=8, num_pages=16, **kw)
    jcomps = jserve.ServeEngine(jlm, params, jserve.ServeConfig(**cfg)).run(
        [jserve.DecodeRequest(i, p, s)
         for i, (p, s) in enumerate(zip(PROMPTS, STEPS))])
    eng = ServeEngine(tlm, ServeConfig(**cfg), device="cpu")
    tcomps = eng.run([DecodeRequest(i, p, s)
                      for i, (p, s) in enumerate(zip(PROMPTS, STEPS))])
    ref = {c.rid: c.tokens for c in jcomps}
    assert sorted(ref) == sorted(c.rid for c in tcomps) == [0, 1, 2]
    for c in tcomps:
        np.testing.assert_array_equal(ref[c.rid], c.tokens)
    if "chunked" in name:
        assert eng.chunk_ticks > 0


def test_contiguous_generate_equals_reference():
    jlm, params, tlm = _pair(2, False)
    prompt = np.array([[3, 1, 4, 1], [5, 9, 2, 6]], np.int32)
    ref = np.asarray(jax_generate(jlm, params, jnp.asarray(prompt), 9,
                                  use_cache=True))
    np.testing.assert_array_equal(ref, generate(tlm, prompt, 9,
                                                use_cache=True).numpy())


# ------------------------------------------------ contracts inside the port
@pytest.mark.parametrize("kw", [dict(), dict(kv_quant="int8"),
                                dict(prefill_chunk=4)], ids=str)
def test_paged_greedy_equals_contiguous_generate(kw):
    lm = _lm(seed=4)
    refs = [generate(lm, p[None], s, use_cache=True)[0].numpy()
            for p, s in zip(PROMPTS, STEPS)]
    np.testing.assert_array_equal(
        refs[0], generate(lm, PROMPTS[0][None], STEPS[0])[0].numpy())
    if kw.get("kv_quant") == "int8":
        # int8 pages quantize the cache: the contiguous reference of that
        # path is the same engine's exact read
        eng = ServeEngine(lm, ServeConfig(max_slots=2, page_size=8,
                                          num_pages=16, **kw), device="cpu")
        refs = [c.tokens for c in sorted(
            eng.run([DecodeRequest(i, p, s) for i, (p, s)
                     in enumerate(zip(PROMPTS, STEPS))]),
            key=lambda c: c.rid)]
        kw = dict(kw, attn_read="flash")
    eng = ServeEngine(lm, ServeConfig(max_slots=2, page_size=8, num_pages=16,
                                      **kw), device="cpu")
    comps = eng.run([DecodeRequest(i, p, s)
                     for i, (p, s) in enumerate(zip(PROMPTS, STEPS))])
    assert len(comps) == 3
    for c in comps:
        np.testing.assert_array_equal(refs[c.rid], c.tokens)


def test_pool_alloc_free_and_high_water():
    pool = PagedKVPool(num_layers=1, num_pages=8, page_size=4,
                       num_heads=2, head_dim=8, device="cpu")
    a = pool.alloc(3)
    b = pool.alloc(4)
    assert len(a) == 3 and len(b) == 4 and not (set(a) & set(b))
    assert pool.alloc(2) is None          # 1 page left: all-or-nothing
    assert pool.pages_free == 1
    pool.free(a)
    assert pool.pages_free == 4
    assert pool.high_water_used == 7      # the peak, not the current
    assert pool.layers()[0].k.shape[0] == 9   # + the trash page
    assert pool.pages_needed(9) == 3
    with pytest.raises(ValueError, match="double-free"):
        pool.free([a[0]])
    with pytest.raises(ValueError, match="flash"):
        PagedKVPool(1, 8, 4, 2, 8, read="flash", device="cpu")


def test_mixed_lengths_fit_where_contiguous_cannot():
    """Totals {32, 12, 8, 8} need 15 pages of 4; a contiguous
    max_len-per-slot allocator needs 32 > the 20-page pool."""
    eng = ServeEngine(_lm(seed=9), ServeConfig(max_slots=4, page_size=4,
                                               num_pages=20), device="cpu")
    assert eng.pool.contiguous_pages_needed(4, L) > 20
    reqs = [DecodeRequest(0, np.arange(16, dtype=np.int32) % V, 16),
            DecodeRequest(1, np.array([7, 8, 9, 10], np.int32), 8),
            DecodeRequest(2, np.array([1, 2], np.int32), 6),
            DecodeRequest(3, np.array([3, 4], np.int32), 6)]
    comps = eng.run(reqs)
    assert {c.rid for c in comps} == {0, 1, 2, 3}
    assert eng.pool.high_water_used == 8 + 3 + 2 + 2   # all resident at once
    assert eng.pool.pages_free == 20


def test_continuous_batching_beats_static_drain():
    lm = _lm(seed=10)
    stats = {}
    for refill in ("continuous", "drain"):
        rng = np.random.default_rng(0)
        reqs = [DecodeRequest(
            i, rng.integers(0, V, (int(rng.integers(2, 8)),)).astype(np.int32),
            int(rng.integers(2, 20))) for i in range(12)]
        eng = ServeEngine(lm, ServeConfig(max_slots=4, page_size=8,
                                          num_pages=64, refill=refill),
                          device="cpu")
        assert len(eng.run(reqs)) == 12
        stats[refill] = (12 / eng.ticks, eng.occupancy)
    assert stats["continuous"][0] > stats["drain"][0], stats
    assert stats["continuous"][1] > stats["drain"][1], stats


def test_overload_sheds_and_emits_slo(tmp_path):
    path = str(tmp_path / "serve.jsonl")
    ledger = Ledger(path)
    clock = itertools.count()
    eng = ServeEngine(_lm(seed=12), ServeConfig(
        max_slots=1, page_size=4, num_pages=8, queue_depth_max=3,
        slo_queue_wait_s=0.5, slo_min_samples=1),
        ledger=ledger, now_fn=lambda: float(next(clock)), device="cpu")
    accepted = [eng.submit(DecodeRequest(i, np.array([1, 2, 3], np.int32), 4))
                for i in range(10)]
    assert not all(accepted)              # the queue cap rejected some
    for _ in range(50):
        eng.step()
        if eng.shedding:
            break
    assert eng.shedding
    assert not eng.submit(DecodeRequest(99, np.array([1], np.int32), 2))
    for _ in range(200):
        eng.step()
        if not eng.shedding and not eng.queue \
                and not any(s is not None for s in eng.slots):
            break
    assert not eng.shedding               # idle decay re-armed the breach
    assert eng.submit(DecodeRequest(100, np.array([1], np.int32), 2))
    eng.run()
    ledger.close()
    recs = read_ledger(path)
    events = {r["event"] for r in recs}
    assert {"admit", "request", "slo", "kv_cache", "span"} <= events
    reasons = {r.get("reason") for r in recs
               if r["event"] == "admit" and not r["accepted"]}
    assert {"queue_full", "slo_shedding"} <= reasons


def test_admission_rejects_impossible_requests():
    recs = []
    eng = ServeEngine(_lm(seed=11), ServeConfig(max_slots=1, page_size=4,
                                                num_pages=4),
                      ledger=Ledger(None, sinks=(recs.append,)), device="cpu")
    assert not eng.submit(DecodeRequest(0, np.arange(30, dtype=np.int32), 30))
    assert not eng.submit(DecodeRequest(1, np.arange(20, dtype=np.int32), 8))
    assert [r.get("reason") for r in recs if r["event"] == "admit"] == \
        ["too_long", "exceeds_pool"]


def test_prefix_cache_is_token_identical_and_forks():
    lm = _lm(seed=13)
    system = (np.arange(10) * 3 % V).astype(np.int32)
    # requests 0/2 and 1/3 repeat a whole prompt: full-page hits plus a
    # shared frontier page that must fork before the first decode write
    reqs = lambda: [DecodeRequest(i, np.concatenate(
        [system, np.array([1 + i % 2], np.int32)]), 6) for i in range(4)]
    outs = {}
    for cache in (False, True):
        eng = ServeEngine(lm, ServeConfig(max_slots=2, page_size=4,
                                          num_pages=32, prefix_cache=cache),
                          device="cpu")
        outs[cache] = {c.rid: c.tokens for c in eng.run(reqs())}
        if cache:
            assert eng.pool.prefix_hits > 0 and eng.prefix_hit_rate > 0
            assert eng.pool.cow_copies > 0
            assert eng.pool.pages_free == 32      # cached pages count free
    for rid in outs[False]:
        np.testing.assert_array_equal(outs[False][rid], outs[True][rid])


def test_drain_finishes_in_flight_and_sheds_queue():
    recs = []
    eng = ServeEngine(_lm(seed=14), ServeConfig(max_slots=1, page_size=4,
                                                num_pages=8),
                      ledger=Ledger(None, sinks=(recs.append,)), device="cpu")
    for i in range(3):
        eng.submit(DecodeRequest(i, np.array([1, 2], np.int32), 3))
    eng.step()                                   # rid 0 in flight
    done = eng.drain(reason="test")
    assert [c.rid for c in done] == [0]
    assert not eng.submit(DecodeRequest(9, np.array([1], np.int32), 2))
    assert eng.pool.pages_free == 8
    assert any(r["event"] == "run_end" and r["status"] == "preempted"
               for r in recs)


def test_sigterm_routes_run_into_drain():
    import os
    import signal

    recs = []
    eng = ServeEngine(_lm(seed=14), ServeConfig(max_slots=1, page_size=4,
                                                num_pages=16),
                      ledger=Ledger(None, sinks=(recs.append,)), device="cpu")
    uninstall = eng.install_sigterm_drain()
    try:
        for i in range(4):
            assert eng.submit(DecodeRequest(i, np.array([1, 2], np.int32), 4))
        eng.step()                                   # rid 0 in flight
        os.kill(os.getpid(), signal.SIGTERM)         # the preemption notice
        comps = eng.run()
    finally:
        uninstall()
    assert {c.rid for c in comps} == {0}
    assert sum(1 for r in recs if r["event"] == "admit"
               and r.get("reason") == "shed") == 3
    assert eng.pool.pages_free == eng.pool.num_pages


def test_sampling_is_deterministic_given_generator():
    lm = _lm(seed=7)
    cfg = ServeConfig(max_slots=1, page_size=8, num_pages=8, temperature=0.9,
                      top_k=20, top_p=0.9)
    run = lambda seed: ServeEngine(
        lm, cfg, generator=torch.Generator().manual_seed(seed),
        device="cpu").run([DecodeRequest(0, np.array([3, 1, 4], np.int32),
                                         8)])[0].tokens
    a, b, c = run(11), run(11), run(12)
    np.testing.assert_array_equal(a, b)
    assert 0 <= a.min() and a.max() < V
    assert not np.array_equal(a, c)


def test_decode_bench_replays_a_trace_on_cpu(capsys):
    import json

    from tpu_dist_torch.tools import decode_bench

    decode_bench.main(["--device", "cpu", "--vocab-size", "64", "--d-model",
                       "64", "--num-layers", "2", "--num-heads", "4",
                       "--precision", "fp32", "--trace", "6", "--max-out",
                       "12", "--kv-quant", "int8", "--attn-read", "flash",
                       "--attn", "flash", "--prefix-tenants", "2",
                       "--prefix-len", "16", "--page-size", "8"])
    head = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert head["metric"] == "torch_lm_serving"
    assert head["device"]["platform"] == "cpu"
    sv = head["serving"]
    assert sv["completed"] == sv["static"]["completed"] == 6
    assert sv["no_prefix_cache"]["completed"] == 6
    assert sv["requests_per_tick"] >= sv["static"]["requests_per_tick"]
    assert sv["prefix_hit_rate"] > 0
    assert "tail_attribution" not in sv


@pytest.mark.parametrize("kw,match", [
    (dict(spec_k=2), "spec_k"),
    (dict(sp_prefill_threshold=8), "sp_prefill_threshold"),
    (dict(quant="int8"), "_fused_quant_kernel"),
])
def test_unported_knobs_raise_and_name_themselves(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        ServeEngine(_lm(), ServeConfig(**kw), device="cpu")


def test_int8_wo_weights_serve_like_generate():
    lm = _lm(seed=6)
    recs = []
    ref = generate(lm, PROMPTS[0][None], STEPS[0], use_cache=True,
                   quant="int8_wo",
                   ledger=Ledger(None, sinks=(recs.append,)))[0].numpy()
    (rec,) = recs
    assert rec["event"] == "decode" and rec["tokens"] == STEPS[0]
    comp = ServeEngine(lm, ServeConfig(max_slots=1, page_size=8, num_pages=8,
                                       quant="int8_wo"), device="cpu").run(
        [DecodeRequest(0, PROMPTS[0], STEPS[0])])[0]
    np.testing.assert_array_equal(ref, comp.tokens)
