"""Sharded decode in the port (``engine.generate(mesh=)``, the decode
bench's ``--tp``/``--dp``) against the reference, on CPU: gloo groups of 2
and 4 ranks (``tests/torch_dp_worker.py``, each spawned once for the
module), the JAX ``generate(mesh=)`` on the suite's virtual CPU devices,
from the same flax params (mirroring ``tests/test_generate.py`` and
``tests/test_quant.py:359``).

Held: greedy tokens at ``model=2`` (tp), ``data=2`` (dp) and
``data=2,model=2``, cached and full recompute, fp and ``int8_wo``, equal
to the JAX package's sharded decode and to the port's one-device decode;
the MoE LM with its experts over ``expert=2`` equal to its one-device
decode (drop-free capacity); the bench's JSON line under ``--tp 2``.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from torch_dp_worker import run_group  # noqa: E402
from torch_lm_ref import save_init  # noqa: E402

torch.set_num_threads(1)

MODEL = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
             max_len=24)
MOE = dict(MODEL, num_experts=4, capacity_factor=4.0)
JOB = dict(seed=11, batch=4, prompt_len=6, steps=10)
CASES = [[True, "none"], [False, "none"], [True, "int8_wo"]]
MESHES = {"tp": ((2,), ("model",)), "dp": ((2,), ("data",)),
          "dp_tp": ((2, 2), ("data", "model"))}


def _jax_model(**kw):
    from tpu_dist.models.transformer import TransformerLM

    return TransformerLM(**{**MODEL, **kw})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tpu_dist.models.moe import MoETransformerLM

    tmp = tmp_path_factory.mktemp("genmesh")
    tokens = np.zeros((1, 8), np.int32)
    init = jax.tree_util.tree_map(np.asarray, _jax_model().init(
        {"params": jax.random.PRNGKey(4)}, tokens, train=False)["params"])
    moe_init = jax.tree_util.tree_map(np.asarray, MoETransformerLM(
        **{k: v for k, v in MOE.items() if k != "capacity_factor"},
        capacity_factor=4.0).init({"params": jax.random.PRNGKey(4)}, tokens,
                                  train=False)["params"])
    path, moe_path = save_init(tmp, "lm", init), save_init(tmp, "moe",
                                                           moe_init)

    def job(name, mesh, **kw):
        shape, axes = MESHES.get(mesh, mesh)
        return {"name": name, "kind": "generate_mesh", "init": path,
                "model": MODEL, "shape": list(shape), "axes": list(axes),
                "cases": CASES, **JOB, **kw}

    two = [job("tp", "tp"), job("dp", "dp"),
           job("ep", ((2,), ("expert",)), init=moe_path, model=MOE,
               cases=[[True, "none"]])]
    out = str(tmp / "port")
    return {"init": init, "moe_init": moe_init,
            "two": run_group(2, {"jobs": two}, out),
            "four": run_group(4, {"jobs": [job("dp_tp", "dp_tp")]},
                              str(tmp / "port4"))}


def _prompt():
    return np.random.default_rng(JOB["seed"]).integers(
        0, MODEL["vocab_size"], (JOB["batch"], JOB["prompt_len"])).astype(
        np.int32)


def _jax_decode(params, mesh_name, use_cache, quant):
    from tpu_dist.engine.generate import generate
    from tpu_dist.parallel.mesh import make_mesh

    shape, axes = MESHES[mesh_name]
    mesh = make_mesh(shape, axes,
                     devices=jax.devices()[:int(np.prod(shape))])
    out = generate(_jax_model(), params, _prompt(), JOB["steps"],
                   use_cache=use_cache, quant=quant, mesh=mesh)
    return np.asarray(out)


def _port_one_device(init, use_cache, quant):
    from tpu_dist_torch.engine.generate import generate
    from tpu_dist_torch.interop import load_flax_params
    from tpu_dist_torch.models.transformer import TransformerLM

    model = load_flax_params(TransformerLM(device="cpu", seed=None, **MODEL),
                             init)
    return generate(model, _prompt(), JOB["steps"], use_cache=use_cache,
                    quant=quant).numpy()


@pytest.mark.parametrize("use_cache,quant", [tuple(c) for c in CASES])
@pytest.mark.parametrize("mesh_name", ["tp", "dp", "dp_tp"])
def test_sharded_greedy_tokens_match_reference_and_one_device(
        runs, mesh_name, use_cache, quant):
    group = runs["four"] if mesh_name == "dp_tp" else runs["two"]
    key = f"{use_cache}-{quant}"
    bufs = [np.asarray(r[mesh_name][key]) for r in group]
    for b in bufs[1:]:                    # every rank returns the whole
        np.testing.assert_array_equal(b, bufs[0])
    np.testing.assert_array_equal(
        bufs[0], _jax_decode(runs["init"], mesh_name, use_cache, quant))
    np.testing.assert_array_equal(
        bufs[0], _port_one_device(runs["init"], use_cache, quant))


def test_moe_experts_sharded_decode_matches_one_device(runs):
    """Experts over ``expert=2`` (each rank E/2 experts, the combine summed
    over the group) against the MoE LM decoded whole."""
    from tpu_dist_torch.engine.generate import generate
    from tpu_dist_torch.interop import load_flax_params
    from tpu_dist_torch.models.moe import MoETransformerLM

    ep = [np.asarray(r["ep"]["True-none"]) for r in runs["two"]]
    np.testing.assert_array_equal(ep[0], ep[1])
    model = load_flax_params(MoETransformerLM(device="cpu", seed=None,
                                              **MOE), runs["moe_init"])
    whole = generate(model, _prompt(), JOB["steps"], use_cache=True).numpy()
    np.testing.assert_array_equal(ep[0], whole)


def test_decode_bench_json_under_tp(capfd):
    from tpu_dist_torch.tools import decode_bench

    decode_bench.main(["--device", "cpu", "--vocab-size", "64", "--d-model",
                       "32", "--num-layers", "2", "--num-heads", "2",
                       "--precision", "fp32", "--batch", "2",
                       "--prompt-len", "4", "--steps", "6", "--trials", "1",
                       "--requests", "1", "--tp", "2"])
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1            # rank 0 alone prints it
    rec = json.loads(lines[0])
    assert rec["metric"] == "torch_lm_decode_tokens_per_sec"
    assert rec["tp"] == 2 and rec["dp"] == 0 and rec["kv_cache"] > 0
