"""The port's collectives (``tpu_dist_torch.parallel.collectives`` and
``overlap``) against the reference's, on CPU: the torch side runs on gloo
groups of 2 and 4 ranks (``tests/torch_dp_worker.py``, each group spawned
once for the module), the JAX side under ``shard_map`` over the same
numbers of the suite's virtual CPU devices, on the same numpy inputs (rank
r holds ``rng.normal(size=(world,) + shape)[r]`` of each leaf).

Held: ``reduce_mean`` (pmean), the bf16 compression round trip, Adasum in
both granularities (the recursive-halving formula, and leaf against tree
on a leaf identical across ranks and one orthogonal across them), the
power-of-two refusal, the explicit ring all-reduce against ``all_reduce``
and against the reference's ring, the ``grad_buckets`` rules, and bucketed
sync (every impl) against the monolithic mean. fp32 sums over 2 or 4 ranks
in another order differ by a few ulps: rtol 1e-6 (Adasum's inner products
and divisions, 1e-5)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from tpu_dist._compat import shard_map  # noqa: E402
from tpu_dist.parallel import collectives as JC  # noqa: E402
from tpu_dist.parallel import overlap as JO  # noqa: E402
from tpu_dist_torch.parallel import collectives as C  # noqa: E402
from tpu_dist_torch.parallel import overlap as O  # noqa: E402
from torch_dp_worker import run_group  # noqa: E402

torch.set_num_threads(1)

SHAPES = [[37], [3, 5], [501], [2]]
SEED = 0
BUCKET_MB = 0.001     # 1 kB buckets: several over these leaves
WORLDS = (2, 4)


def _inputs(world):
    rng = np.random.default_rng(SEED)
    return [rng.normal(size=(world,) + tuple(s)).astype(np.float32)
            for s in SHAPES]


def _jax(world, fn, full):
    """``fn`` (a list of per-device leaves -> a list) under shard_map over
    ``world`` devices; returns, per output leaf, the (world, ...) array."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:world]), ("data",))
    g = shard_map(lambda *xs: [v[None] for v in fn([x[0] for x in xs])],
                  mesh=mesh, in_specs=tuple(P("data") for _ in full),
                  out_specs=[P("data") for _ in full], check_vma=False)
    return [np.asarray(o) for o in jax.jit(g)(*map(jnp.asarray, full))]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coll")
    job = {"name": "c", "kind": "collectives", "seed": SEED,
           "shapes": SHAPES, "bucket_mb": BUCKET_MB}
    return {w: [r["c"] for r in run_group(w, {"jobs": [job]},
                                          str(tmp / f"w{w}"))]
            for w in WORLDS}


def _per_rank(port, world, key, want, rtol=1e-6, atol=1e-6):
    for r in range(world):
        for got, ref in zip(port[world][r][key], want):
            np.testing.assert_allclose(np.asarray(got), ref[r], rtol=rtol,
                                       atol=atol, err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_reduce_mean_matches_pmean(port, world):
    full = _inputs(world)
    want = _jax(world, lambda t: JC.reduce_mean(t, "data"), full)
    _per_rank(port, world, "reduce_mean", want)


@pytest.mark.parametrize("world", WORLDS)
def test_compress_grads_bf16_round_trip(port, world):
    full = _inputs(world)
    down, up = JC.compress_grads([jnp.asarray(a) for a in full], "bf16")
    want = [np.asarray(a) for a in up(down)]
    for r in range(world):
        assert port[world][r]["compress_dtypes"] == ["torch.bfloat16"] * 4
        for got, ref in zip(port[world][r]["compress_roundtrip"], want):
            np.testing.assert_array_equal(np.asarray(got, np.float32), ref[r])
    with pytest.raises(ValueError, match="compression"):
        C.compress_grads([torch.zeros(2)], "fp8")


@pytest.mark.parametrize("granularity", ["leaf", "tree"])
@pytest.mark.parametrize("world", WORLDS)
def test_adasum_matches_reference(port, world, granularity):
    full = _inputs(world)
    want = _jax(world, lambda t: JC.adasum_reduce(
        t, "data", world, granularity=granularity), full)
    _per_rank(port, world, f"adasum_{granularity}", want, rtol=1e-5)
    # the formula is symmetric: every rank holds the same result
    for r in range(1, world):
        assert port[world][r][f"adasum_{granularity}"] == \
            port[world][0][f"adasum_{granularity}"]


@pytest.mark.parametrize("world", WORLDS)
def test_adasum_leaf_averages_parallel_and_adds_orthogonal(port, world):
    leaf = port[world][0]["adasum_probe_leaf"]
    tree = port[world][0]["adasum_probe_tree"]
    np.testing.assert_allclose(leaf["par"], [1, 2, 3, 4], rtol=1e-6)
    np.testing.assert_allclose(leaf["orth"], [3.0] * world, rtol=1e-6)
    assert not np.allclose(tree["par"], leaf["par"], rtol=1e-4)
    assert not np.allclose(tree["orth"], leaf["orth"], rtol=1e-4)


def test_adasum_refuses_non_power_of_two_and_bad_granularity(port):
    for r in range(3):
        assert "power-of-two" in port[4][r]["three_error"]
    assert "three_error" not in port[4][3]
    with pytest.raises(ValueError, match="granularity"):
        C.adasum_reduce([torch.zeros(2)], granularity="bucket")


@pytest.mark.parametrize("world", WORLDS)
def test_ring_allreduce_matches_all_reduce_and_reference_ring(port, world):
    full = _inputs(world)
    _per_rank(port, world, "ring",
              [np.broadcast_to(a.sum(0), a.shape) for a in full])
    for r in range(world):
        for got, ref in zip(port[world][r]["ring"], port[world][r]["psum"]):
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    want = _jax(world, lambda t: [JC.ring_allreduce(x, "data", world)
                                  for x in t], full)
    _per_rank(port, world, "ring", want, rtol=1e-7, atol=1e-7)


def test_grad_buckets_rules_match_reference():
    """Consecutive fill, an oversized leaf alone, a dtype change closing a
    bucket; the same groups as the reference on the same leaves."""
    specs = [(100, "float32"), (100, "float32"), (10_000, "float32"),
             (50, "float32"), (50, "bfloat16"), (30, "bfloat16")]
    mine = [torch.zeros(n, dtype=getattr(torch, d)) for n, d in specs]
    ref = [jnp.zeros((n,), getattr(jnp, d)) for n, d in specs]
    groups = O.grad_buckets(mine, bucket_bytes=1000)
    assert groups == JO.grad_buckets(ref, bucket_bytes=1000)
    assert groups == [[0, 1], [2], [3], [4, 5]]
    assert O.grad_buckets([torch.zeros(10)], 1.0) == [[0]]


@pytest.mark.parametrize("impl", O.IMPLS)
@pytest.mark.parametrize("world", WORLDS)
def test_bucketed_sync_matches_monolithic_and_reference(port, world, impl):
    full = _inputs(world)
    mean = [np.broadcast_to(a.mean(0), a.shape) for a in full]
    _per_rank(port, world, f"bucketed_{impl}", mean)
    _per_rank(port, world, "monolithic", mean)
    if impl != "psum":    # the reference's bucketed impls: rs_ag and ring
        want = _jax(world, lambda t: JO.bucketed_grad_sync(
            t, "data", BUCKET_MB, mean=True, axis_size=world, impl=impl),
            full)
        _per_rank(port, world, f"bucketed_{impl}", want)
    with pytest.raises(ValueError, match="impl"):
        O.bucketed_grad_sync([torch.zeros(2)], impl="tree")


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_bench_reports_latency_and_bandwidth(port, world):
    for r in range(world):
        bench = port[world][r]["bench"]
        assert bench["us"] > 0 and bench["gbps"] > 0


def test_one_process_collectives_are_local():
    """Without a process group every collective is the identity over a
    world of one (the arithmetic of the mean and the casts still run)."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert torch.equal(C.psum(x), x) and torch.equal(C.pmean(x), x)
    assert torch.equal(C.ring_allreduce(x), x)
    assert torch.equal(C.adasum_reduce([x])[0], x)
    assert torch.equal(O.bucketed_grad_sync([x, x[0]])[1], x[0])
    C.barrier()
