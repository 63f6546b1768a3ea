"""sp-sharded serving in the port (``ServeEngine(mesh=)`` over the sharded
``PagedKVPool``, ``sp_paged_write``/``sp_gather_pages``, the sp prefill
over ring attention) against the reference, on CPU: gloo groups of 2 and
4 ranks (``tests/torch_dp_worker.py``, each spawned once for the module)
against the JAX package on the suite's virtual CPU devices, from the same
flax params (mirroring ``tests/test_serve.py:571-714``).

Held: the sharded allocator's grants, flat block tables and reclaim equal
the JAX sharded pool's at n = 2 and 4; the sp write and gather bit-equal
to the JAX pair under a 2-device mesh, int8 and fp32; a 2-rank sharded
engine with every prompt below the sp threshold gives the JAX sharded
engine's greedy tokens and arenas (fp32 and the int8 scales within 1e-6
of each arena's scale, int8 values bit-equal, the int8 flash read
included); the sp prefill at n = 2 (fp32, ``int8_wo``)
and n = 4 gives the JAX unsharded greedy stream, a context longer than
one device's pages and a second wave on the reclaimed pool included
(jax 0.9 cannot run the reference's own sp prefill: its ring attention's
scan fails the varying-axes check), with its K/V within 1e-5 of the JAX
unsharded prefill's; chunked prefill and prefix caching over the sharded
pool, with a copy-on-write fork from one rank's page to another's, equal
to the JAX sharded engine in tokens and arenas, the forked page included
(and to the port's unsharded engine in tokens); the reference's guards."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from torch_dp_worker import run_group, sp_ops_inputs  # noqa: E402
from torch_lm_ref import save_init  # noqa: E402

torch.set_num_threads(1)

V, L = 64, 32
MODEL = dict(vocab_size=V, num_layers=2, d_model=64, num_heads=4, max_len=L)
SEED = 25
# the reference's sp cases (tests/test_serve.py:640-695)
P12 = ((np.arange(12) * 5 + 2) % V).astype(np.int32)
P2 = np.array([5, 9], np.int32)
P14 = ((np.arange(14) * 3 + 5) % V).astype(np.int32)
P17 = ((np.arange(17) * 5 + 1) % V).astype(np.int32)
PREFIX = ((np.arange(10) * 7 + 3) % V).astype(np.int32)
BASE = dict(max_slots=2, page_size=8, num_pages=8)
# fp32 arenas and int8 scales, port against reference: |a - b| <= ARENA_TOL
# (1 + max |b|) over each arena; sp-prefilled K/V against the unsharded
# prefill's: |a - b| <= KV_TOL
ARENA_TOL = 1e-6
KV_TOL = 1e-5
TWO = [
    # every prompt below the threshold: the monolithic prefill and the
    # tick over the sharded pool, against the JAX sharded engine
    dict(name="engine_fp32", cfg=dict(BASE),
         requests=[[P12, 6], [P2, 6]]),
    dict(name="engine_int8_flash",
         cfg=dict(BASE, kv_quant="int8", attn_read="flash"),
         requests=[[P12, 6], [P2, 6]]),
    # the sp prefill (12 tokens, threshold 9) beside a monolithic one
    dict(name="sp_fp32", cfg=dict(BASE, sp_prefill_threshold=9),
         requests=[[P12, 6], [P2, 6]], kv_rows=True),
    dict(name="sp_int8_wo",
         cfg=dict(max_slots=1, page_size=8, num_pages=8,
                  sp_prefill_threshold=9, quant="int8_wo"),
         requests=[[P14, 5]]),
    # chunked prefill + prefix caching: the second prompt shares the
    # first's pages 0 and 1 and its frontier page 2 (rank 0), forked onto
    # page 4 (rank 1) before its first decode write
    dict(name="chunk_prefix",
         cfg=dict(max_slots=1, page_size=4, num_pages=8, prefill_chunk=4,
                  prefix_cache=True),
         requests=[[PREFIX, 2], [PREFIX, 6]]),
]
FOUR = [dict(name="sp4", cfg=dict(max_slots=1, page_size=4, num_pages=8,
                                  sp_prefill_threshold=9),
             requests=[[P17, 6]], waves=2, kv_rows=True)]


def _jax_lm(seed=SEED):
    from tpu_dist.models.transformer import tiny_lm

    lm = tiny_lm(**MODEL)
    params = lm.init({"params": jax.random.PRNGKey(seed)},
                     jnp.zeros((1, L), jnp.int32), train=False)["params"]
    return lm, params


def _sp_mesh(n):
    from tpu_dist.parallel.mesh import SP_AXIS, make_mesh

    return make_mesh((n,), (SP_AXIS,), devices=jax.devices()[:n])


def _jsonable(cases):
    return [dict(c, requests=[[p.tolist(), n] for p, n in c["requests"]])
            for c in cases]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spserve")
    _, params = _jax_lm()
    path = save_init(tmp, "lm", jax.tree_util.tree_map(np.asarray, params))
    job = dict(kind="sp_serve", init=path, model=MODEL)
    ops = [dict(name=f"ops_{dt}", kind="sp_ops", world=2, dtype=dt, seed=5)
           for dt in ("int8", "float32")]
    # the two groups run side by side (each holds its own store)
    with ThreadPoolExecutor(2) as ex:
        two = ex.submit(run_group, 2, {"jobs": [
            dict(job, name="serve", world=2, cases=_jsonable(TWO)), *ops]},
            str(tmp / "two"))
        four = ex.submit(run_group, 4, {"jobs": [
            dict(job, name="serve", world=4, cases=_jsonable(FOUR))]},
            str(tmp / "four"))
        return {"params": params, "tmp": tmp, "two": two.result(),
                "four": four.result()}


def _case(runs, group, name):
    recs = [r["serve"][name] for r in runs[group]]
    for r in recs[1:]:          # every rank serves the same stream
        assert r["waves"] == recs[0]["waves"]
        assert r["stats"] == recs[0]["stats"]
    return recs[0]


def _blocks(runs, group, name):
    """Every rank's arena blocks of case ``name``: {key: [block per rank]}."""
    out = {}
    for r in range(len(runs[group])):
        with np.load(str(runs["tmp"] / group / f"serve.{name}.rank{r}.npz")
                     ) as z:
            for k in z.files:
                out.setdefault(k, []).append(z[k])
    return out


def _greedy(params, prompt, steps, quant="none"):
    from tpu_dist.engine.generate import generate

    lm, _ = _jax_lm()
    return np.asarray(generate(lm, params, jnp.asarray(prompt[None]),
                               steps=steps, use_cache=True, quant=quant))[0]


# ---------------------------------------------------- the sharded allocator
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_allocator_matches_reference(n):
    from tpu_dist.engine.kv_cache import PagedKVPool as JaxPool
    from tpu_dist_torch.engine.kv_cache import PagedKVPool
    from tpu_dist_torch.parallel.mesh import Axis, Mesh

    mesh = Mesh({"sp": n}, 0, n, torch.device("cpu"),
                {"sp": Axis("sp", n, 0, None)})
    geom = dict(num_layers=1, num_pages=4 * n, page_size=4, num_heads=2,
                head_dim=8)
    ref = JaxPool(**geom, mesh=_sp_mesh(n))
    pool = PagedKVPool(**geom, mesh=mesh)
    assert pool.layers()[0].k.shape[0] == 5          # 4 pages + trash
    assert (pool.sharded_devices, pool.pages_per_device) == \
        (ref.sharded_devices, ref.pages_per_device) == (n, 4)

    def both(fn):
        a, b = fn(ref), fn(pool)
        assert a == b
        return a

    held = [both(lambda p: p.alloc(3)),
            both(lambda p: p.alloc_for_slots([n - 1, 0, n - 1, 1]))]
    both(lambda p: p.alloc(2))
    bt = np.array([held[0] + held[1] + [4 * n]], np.int32)
    np.testing.assert_array_equal(ref.flat_block_table(bt),
                                  pool.flat_block_table(bt))
    both(lambda p: p.free(held[1]))
    # reclaimed pages return to their owners' heaps
    both(lambda p: p.alloc_for_slots([n - 1, n - 1]))
    both(lambda p: p.alloc_for_slots([n - 1] * 4))      # one device short
    both(lambda p: [p.page_device(q) for q in range(4 * n)])
    both(lambda p: p.alloc(4 * n))                      # pool short: None
    assert {k: v for k, v in ref.stats().items() if k != "kv_quant"} == \
        {k: v for k, v in pool.stats().items() if k != "kv_quant"}
    with pytest.raises(ValueError, match="divide"):
        PagedKVPool(**dict(geom, num_pages=4 * n + 1), mesh=mesh)


# ------------------------------------------------------ sp write and gather
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_sp_gather_and_write_bit_equal_reference(runs, dtype):
    from tpu_dist.ops.paged_attention import sp_gather_pages, sp_paged_write
    from tpu_dist.parallel.mesh import SP_AXIS
    from jax.sharding import NamedSharding, PartitionSpec as P

    job = dict(world=2, dtype=dtype, seed=5)
    arena, bt, pos, vals, valid = sp_ops_inputs(job)
    mesh = _sp_mesh(2)
    a = jax.device_put(jnp.asarray(arena), NamedSharding(mesh, P(SP_AXIS)))
    a = jax.jit(sp_paged_write, static_argnums=5)(
        a, jnp.asarray(bt), jnp.asarray(pos, jnp.int32), jnp.asarray(vals),
        jnp.asarray(valid), mesh)
    want = np.asarray(jax.jit(sp_gather_pages, static_argnums=2)(
        a, jnp.asarray(bt), mesh))
    written = np.asarray(a)
    rows = arena.shape[0] // 2
    for rank, rec in enumerate(runs["two"]):
        got = rec[f"ops_{dtype}"]
        np.testing.assert_array_equal(np.asarray(got["gathered"], want.dtype),
                                      want)
        block = np.asarray(got["block"], want.dtype)
        mine = written[rank * rows:(rank + 1) * rows]
        # the local trash row takes whatever landed last: not compared
        np.testing.assert_array_equal(block[:-1], mine[:-1])


# ------------------------------------------- the whole engine, threshold 0
def _reference_sharded_engine(case):
    """The JAX sharded engine over a 2-device sp mesh, run on ``case``'s
    requests: (engine, {rid: tokens})."""
    from tpu_dist.engine import serve as jserve

    lm, params = _jax_lm()
    eng = jserve.ServeEngine(lm, params, jserve.ServeConfig(**case["cfg"]),
                             mesh=_sp_mesh(2))
    comps = eng.run([jserve.DecodeRequest(i, p, n)
                     for i, (p, n) in enumerate(case["requests"])])
    return eng, {str(c.rid): c.tokens.tolist() for c in comps}


def _assert_arenas_match(runs, name, eng):
    """Each rank's arena blocks of case ``name`` equal the JAX sharded
    pool's rows of that rank, row for row (the local trash row aside):
    int8 K/V bit-equal, fp32 arenas and int8 scales within ARENA_TOL."""
    blocks = _blocks(runs, "two", name)
    rows = eng.pool.pages_per_device + 1
    for i, layer in enumerate(eng.pool.layers()):
        names = ("k", "v", "ks", "vs") if layer.k_scale is not None \
            else ("k", "v")
        for key, arena in zip(names, (layer.k, layer.v, layer.k_scale,
                                      layer.v_scale)):
            want = np.asarray(arena)
            for rank, block in enumerate(blocks[f"{i}.{key}"]):
                mine = want[rank * rows:(rank + 1) * rows - 1]
                if key in ("k", "v") and want.dtype == np.int8:
                    np.testing.assert_array_equal(block[:-1], mine)
                else:
                    # fp32 summation order (the unsharded engines of the
                    # two packages differ by 1.7e-6 here already)
                    np.testing.assert_allclose(
                        block[:-1], mine, rtol=0,
                        atol=ARENA_TOL * (1 + np.abs(mine).max()))
    return blocks


@pytest.mark.parametrize("name", ["engine_fp32", "engine_int8_flash"])
def test_sharded_engine_matches_reference_engine(runs, name):
    case = next(c for c in TWO if c["name"] == name)
    eng, tokens = _reference_sharded_engine(case)
    got = _case(runs, "two", name)
    assert got["waves"][0] == tokens
    assert got["stats"]["sp_prefills"] == 0
    assert got["stats"]["sharded_devices"] == 2
    _assert_arenas_match(runs, name, eng)


# ---------------------------------------- the sp prefill, the contract
def _jax_prefill_kv(params, case):
    """The JAX unsharded engine's K/V of the first request's prompt rows
    after its prefill (one step), per layer."""
    from tpu_dist.engine import serve as jserve
    from tpu_dist.ops.paged_attention import gather_pages

    lm, _ = _jax_lm()
    cfg = {k: v for k, v in case["cfg"].items()
           if k != "sp_prefill_threshold"}
    eng = jserve.ServeEngine(lm, params, jserve.ServeConfig(**cfg))
    for i, (p, n) in enumerate(case["requests"]):
        eng.submit(jserve.DecodeRequest(i, p, n))
    eng.step()
    slot = eng.slots[0]
    bt = jnp.asarray(slot.block_table[None])
    return [[np.asarray(gather_pages(a, bt))[0, :slot.prompt_len]
             for a in (layer.k, layer.v)] for layer in eng.pool.layers()]


@pytest.mark.parametrize("group,name", [("two", "sp_fp32"),
                                        ("two", "sp_int8_wo"),
                                        ("four", "sp4")])
def test_sp_prefill_greedy_equals_reference_unsharded(runs, group, name):
    case = next(c for c in TWO + FOUR if c["name"] == name)
    quant = case["cfg"].get("quant", "none")
    got = _case(runs, group, name)
    refs = [_greedy(runs["params"], p, n, quant)
            for p, n in case["requests"]]
    for wave in got["waves"]:
        assert sorted(wave) == [str(i) for i in range(len(refs))]
        for rid, toks in wave.items():
            np.testing.assert_array_equal(toks, refs[int(rid)])
    st = got["stats"]
    # the long prompt went sp, the short one monolithic
    assert st["sp_prefills"] == len(got["waves"])
    assert st["prefills"] == len(got["waves"]) * len(refs)
    assert st["pages_free"] == st["pages_total"]      # every page back
    if name == "sp4":
        budget = st["pages_per_device"] * case["cfg"]["page_size"]
        assert P17.size + 6 > budget == 8   # more than one device holds
    if case.get("kv_rows"):
        want = _jax_prefill_kv(runs["params"], case)
        for got_l, want_l in zip(got["kv"], want):
            for g, w in zip(got_l, want_l):
                np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                           atol=KV_TOL)


def test_chunked_prefix_cache_cross_rank_fork_equals_unsharded(runs):
    """Chunked prefill and prefix caching over the sharded pool, with a
    copy-on-write fork from rank 0's page 2 to rank 1's page 4: the JAX
    sharded engine's tokens and arenas, the forked page included, and
    the port's unsharded engine's tokens as a second witness."""
    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.interop import load_flax_params
    from tpu_dist_torch.models.transformer import TransformerLM

    case = next(c for c in TWO if c["name"] == "chunk_prefix")
    got = _case(runs, "two", "chunk_prefix")
    assert got["forks"] == [[2, 4]]
    assert got["page_device"] == {"2": 0, "4": 1}     # across the ranks
    ref, tokens = _reference_sharded_engine(case)
    assert got["waves"][0] == tokens
    assert got["stats"]["prefix_hits"] == ref.pool.prefix_hits == 3
    assert got["stats"]["cow_copies"] == ref.pool.cow_copies == 1
    blocks = _assert_arenas_match(runs, "chunk_prefix", ref)
    # the forked page is rank 1's first row: written, so compared above
    # (the K/V of the prefix's frontier tokens)
    assert all(np.abs(blocks[f"{i}.k"][1][0]).max() > 0
               for i in range(MODEL["num_layers"]))

    model = load_flax_params(TransformerLM(device="cpu", seed=None, **MODEL),
                             jax.tree_util.tree_map(np.asarray,
                                                    runs["params"]))
    eng = ServeEngine(model, ServeConfig(**case["cfg"]), device="cpu")
    comps = eng.run([DecodeRequest(i, p, n)
                     for i, (p, n) in enumerate(case["requests"])])
    assert got["waves"][0] == {str(c.rid): c.tokens.tolist() for c in comps}
    assert got["stats"]["chunk_ticks"] == eng.chunk_ticks > 0


# ------------------------------------------------------------------- guards
def test_sp_and_chunked_guards():
    """The reference's four guards (tests/test_serve.py:698-714), with its
    exception types."""
    from tpu_dist_torch.engine.serve import ServeConfig, ServeEngine
    from tpu_dist_torch.models.transformer import tiny_lm
    from tpu_dist_torch.parallel.mesh import Axis, Mesh

    def mesh(name, n):
        return Mesh({name: n}, 0, n, torch.device("cpu"),
                    {name: Axis(name, n, 0, None)})

    lm = tiny_lm(device="cpu", seed=28, **MODEL)
    with pytest.raises(ValueError, match="mesh"):
        ServeEngine(lm, ServeConfig(sp_prefill_threshold=8), device="cpu")
    with pytest.raises(ValueError, match="sp"):
        ServeEngine(lm, ServeConfig(), mesh=mesh("data", 2))
    with pytest.raises(ValueError, match="divisible"):
        ServeEngine(lm, ServeConfig(sp_prefill_threshold=8, page_size=4,
                                    max_len=28), mesh=mesh("sp", 4))
    with pytest.raises(NotImplementedError, match="speculative"):
        ServeEngine(lm, ServeConfig(spec_k=2), mesh=mesh("sp", 2))
