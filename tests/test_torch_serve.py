"""The port's serving slice (tpu_dist_torch.engine.serve over the paged KV
pool) against the reference engine, and the reference's own serving
contracts re-proved inside the port.

Across packages: the same mixed-length greedy requests through the JAX
``ServeEngine`` and the port's ``ServeEngine(device="cpu")`` give equal
tokens for the slice's configuration (int8 pages, flash read, flash
prefill), for the fp pool, for chunked prefill, for dynamic int8 weights
(``quant="int8"``) and for speculative decoding. Inside the port: paged
greedy equals its contiguous ``generate``, speculative or not; pool
accounting; the fragmentation pin; SLO shedding emits ``slo``; prefix
caching is token-identical; the request observatory's summary equals the
reference tool's on the same records; the unported knobs raise and say
so."""

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
    "int8_weights": (True, dict(quant="int8")),
    "spec_k3": (False, dict(spec_k=3)),
    "spec_k3_slice_int8": (True, dict(spec_k=3, kv_quant="int8",
                                      attn_read="flash", quant="int8")),
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
    if "spec" in name:
        assert eng.accepted_per_tick > 1.0


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


def test_bf16_paged_greedy_equals_contiguous_generate():
    """In bf16 the paged tick's exact read and the contiguous cache's
    attention take the one score product (bf16 q and k, fp32 result): the
    paged greedy tokens are contiguous ``generate``'s."""
    lm = _lm(seed=4, dtype=torch.bfloat16)
    refs = [generate(lm, p[None], s, use_cache=True)[0].numpy()
            for p, s in zip(PROMPTS, STEPS)]
    eng = ServeEngine(lm, ServeConfig(max_slots=2, page_size=8,
                                      num_pages=16), device="cpu")
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
    ta = sv["tail_attribution"]
    assert ta["requests"] == 6 and ta["sum_check"]["ok"]
    assert ta["coverage"] == pytest.approx(1.0, abs=1e-3)
    assert set(ta["shares"]) == {"queue", "prefill", "decode", "residue"}


def test_decode_bench_int8_spec_and_waterfalls_on_cpu(capsys):
    import json

    from tpu_dist_torch.tools import decode_bench

    decode_bench.main(["--device", "cpu", "--vocab-size", "64", "--d-model",
                       "64", "--num-layers", "2", "--num-heads", "4",
                       "--precision", "fp32", "--trace", "5", "--max-out",
                       "12", "--serve-quant", "int8", "--spec-k", "3",
                       "--waterfalls", "2"])
    out = capsys.readouterr()
    sv = json.loads(out.out.strip().splitlines()[-1])["serving"]
    assert sv["completed"] == 5 and sv["quant"] == "int8"
    assert sv["spec_k"] == 3 and sv["accepted_per_tick"] > 1.0
    assert sv["tail_attribution"]["sum_check"]["ok"]
    assert "2 slowest request waterfall(s)" in out.err
    assert out.err.count("    decode     |") >= 2


@pytest.mark.parametrize("kw,match", [
    (dict(sp_prefill_threshold=8), "sp_prefill_threshold > 0 needs"),
])
def test_unported_knobs_raise_and_name_themselves(kw, match):
    # sp-sharded serving is ported (tests/test_torch_sp_serve.py): what
    # stays is the reference's refusal of an sp threshold without a mesh
    # and of a mesh without the 'sp' axis
    with pytest.raises(ValueError, match=match):
        ServeEngine(_lm(), ServeConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="mesh needs the 'sp' axis"):
        ServeEngine(_lm(), ServeConfig(), mesh=object(), device="cpu")


# ------------------------------------------- speculative decoding
def _spec_refs(lm, prompts, steps, quant="none"):
    return [generate(lm, p[None], s, use_cache=True, quant=quant)[0].numpy()
            for p, s in zip(prompts, steps)]


def test_spec_decode_greedy_equals_generate():
    """Self-speculation with k=3 over mixed-length requests: every stream
    is the non-speculative greedy decode, more than one token per
    slot-tick, in fewer ticks than one token per tick would take."""
    lm = _lm(seed=16)
    prompts = [np.array([1, 9, 17], np.int32), np.array([5], np.int32)]
    steps = [10, 12]
    refs = _spec_refs(lm, prompts, steps)
    eng = ServeEngine(lm, ServeConfig(max_slots=2, page_size=8,
                                      num_pages=16, spec_k=3), device="cpu")
    comps = eng.run([DecodeRequest(i, p, s)
                     for i, (p, s) in enumerate(zip(prompts, steps))])
    assert len(comps) == 2
    for c in comps:
        np.testing.assert_array_equal(refs[c.rid], c.tokens)
    assert eng.accepted_per_tick > 1.0
    assert eng.ticks < max(steps)
    st = eng.stats()
    assert st["spec_k"] == 3 and st["spec_emitted"] == sum(steps) - 2


@pytest.mark.parametrize("quant", ["int8_wo", "int8"])
def test_spec_decode_equals_quantized_generate(quant):
    """The draft rides the base's quant mode; the verified stream equals
    the quantized ``generate``."""
    lm = _lm(seed=17)
    prompt = np.array([2, 11, 23], np.int32)
    ref = _spec_refs(lm, [prompt], [10], quant=quant)[0]
    eng = ServeEngine(lm, ServeConfig(max_slots=1, page_size=8,
                                      num_pages=16, quant=quant, spec_k=2),
                      device="cpu")
    comps = eng.run([DecodeRequest(0, prompt, 10)])
    np.testing.assert_array_equal(ref, comps[0].tokens)
    assert eng.accepted_per_tick > 1.0


def test_spec_reject_storm_still_progresses():
    """A wrong draft (same shape, other weights) rejects nearly every
    proposal; the base's correction still lands every tick, so the output
    is the non-speculative stream at >= 1 token per slot-tick."""
    lm = _lm(seed=18)
    prompt = np.array([1, 2, 3], np.int32)
    ref = _spec_refs(lm, [prompt], [10])[0]
    eng = ServeEngine(lm, ServeConfig(max_slots=1, page_size=8,
                                      num_pages=16, spec_k=3),
                      draft_model=_lm(seed=99), device="cpu")
    comps = eng.run([DecodeRequest(0, prompt, 10)])
    np.testing.assert_array_equal(ref, comps[0].tokens)
    assert 1.0 <= eng.accepted_per_tick < 3.0


def test_spec_with_a_smaller_draft_equals_generate():
    """A separate, shallower draft with its own page arenas."""
    lm = _lm(seed=22)
    draft = tiny_lm(device="cpu", seed=23, vocab_size=V, num_layers=1,
                    d_model=32, num_heads=2, max_len=L)
    prompts = [np.array([4, 8], np.int32), np.arange(9, dtype=np.int32)]
    refs = _spec_refs(lm, prompts, [9, 7])
    eng = ServeEngine(lm, ServeConfig(max_slots=2, page_size=4,
                                      num_pages=32, spec_k=2),
                      draft_model=draft, device="cpu")
    comps = eng.run([DecodeRequest(i, p, s) for i, (p, s)
                     in enumerate(zip(prompts, [9, 7]))])
    for c in comps:
        np.testing.assert_array_equal(refs[c.rid], c.tokens)
    assert eng.draft_pool.layers()[0].k.shape[-2:] == (2, 16)


def test_spec_guards_reject_bad_configs():
    lm = _lm(seed=19)
    small = tiny_lm(device="cpu", vocab_size=32, num_layers=1, d_model=32,
                    num_heads=2, max_len=L)
    short = tiny_lm(device="cpu", vocab_size=V, num_layers=1, d_model=32,
                    num_heads=2, max_len=L // 2)
    with pytest.raises(ValueError, match="vocab"):
        ServeEngine(lm, ServeConfig(spec_k=2), draft_model=small,
                    device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        ServeEngine(lm, ServeConfig(spec_k=2), draft_model=short,
                    device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(lm, ServeConfig(), draft_model=lm, device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        ServeEngine(lm, ServeConfig(spec_k=2, temperature=0.5),
                    device="cpu")


def test_spec_and_prefix_cache_compose():
    """Shared-prefix admissions (with a CoW fork in both pools) under
    speculative ticks, monolithic and chunked: the streams are the
    uncached, non-speculative ones."""
    lm = _lm(seed=21)
    prompt = ((np.arange(9, dtype=np.int32) * 7 + 1) % V).astype(np.int32)
    ref = _spec_refs(lm, [prompt], [8])[0]
    # chunked, one slot: the first prompt registers its pages on its final
    # chunk, so the second admission can only hit once the first is in
    for chunk, slots in ((0, 2), (4, 1)):
        eng = ServeEngine(lm, ServeConfig(
            max_slots=slots, page_size=4, num_pages=32, spec_k=2,
            prefix_cache=True, prefill_chunk=chunk), device="cpu")
        comps = eng.run([DecodeRequest(i, prompt, 8) for i in range(2)])
        assert len(comps) == 2
        for c in comps:
            np.testing.assert_array_equal(ref, c.tokens)
        assert eng.accepted_per_tick > 1.0
        assert eng.pool.prefix_hits > 0 and eng.pool.cow_copies > 0


def test_spec_spans_carry_drafted_counts():
    recs = []
    eng = ServeEngine(_lm(seed=24), ServeConfig(
        max_slots=1, page_size=8, num_pages=16, spec_k=3,
        trace_window_ticks=2), ledger=Ledger(None, sinks=(recs.append,)),
        device="cpu")
    eng.run([DecodeRequest(0, np.array([3, 4], np.int32), 9)])
    dec = [r for r in recs if r["event"] == "span"
           and r["name"] == "decode"]
    assert sum(r["tokens"] for r in dec) == 8
    assert sum(r["spec_drafted"] for r in dec) == 3 * eng.ticks
    kv = [r for r in recs if r["event"] == "kv_cache"][-1]
    assert kv["spec_emitted"] == 8 and kv["spec_slot_ticks"] == eng.ticks


# ------------------------------------------- the request observatory
def test_request_report_copy_equals_reference_tool():
    """The same span records through ``tools/request_report.py`` and the
    port's copy give equal summaries (with an SLO breach and a shed)."""
    from tools import request_report as ref_report
    from tpu_dist_torch.tools import request_report as port_report

    recs = []
    clock = itertools.count()
    eng = ServeEngine(_lm(seed=12), ServeConfig(
        max_slots=1, page_size=4, num_pages=8, queue_depth_max=3,
        slo_queue_wait_s=0.5, slo_min_samples=1, spec_k=2,
        trace_window_ticks=2),
        ledger=Ledger(None, sinks=(recs.append,)),
        now_fn=lambda: float(next(clock)), device="cpu")
    for i in range(6):
        eng.submit(DecodeRequest(i, np.array([1, 2, 3], np.int32), 5))
    eng.run()
    assert any(r["event"] == "slo" for r in recs)
    port = port_report.requests_summary(recs)
    assert port == ref_report.requests_summary(recs)
    assert port["tail_attribution"]["sum_check"]["ok"]
    assert port["sheds"] > 0 and port["slo_exemplars"]
    traces = port_report.reqtrace.traces(recs)
    slow = port_report.slowest_traces(traces, 2)
    assert [t["trace_id"] for t in slow] == [
        t["trace_id"] for t in ref_report.slowest_traces(
            ref_report.reqtrace.traces(recs), 2)]
    for t in slow:
        assert port_report.waterfall_lines(t) == \
            ref_report.waterfall_lines(t)


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
