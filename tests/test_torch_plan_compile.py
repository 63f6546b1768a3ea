"""The port's plan lowering (``tpu_dist_torch/plan/compile.py``) and the
``plan`` knob of both trainers, against the reference's:

* ``activate_plan`` sets the three switches (the fused int8 dispatch,
  ``fused_quant.cu``'s tile, the optimizer kernels' rows); the env seeds go
  through the validated setters and fail loudly at import;
* under ``fused_quant="off"`` ``quant_matmul(..., "int8")`` runs the
  unfused ``quant_einsum`` and equals the reference's under
  ``set_fused_quant(False)`` within one fp32 ulp; auto and on run
  ``fused_quant_matmul``;
* ``resolve_config_plan``: ``none`` is a no-op, ``auto`` carries the knobs
  it does not search, a plan of the other engine is refused;
* ``compile_plan`` train steps (dp, ``grad_accum_steps=2``, explicit
  bucketed dp, the indexed window) on a tiny LM and on a BN- and
  dropout-free MLP (the reference's own image parity model: LeNet's
  dropout draws from each package's own PRNG) run 3 steps within
  ``1e-5 (1 + |loss|)`` of the reference's ``compile_plan`` from the same
  weights; a ``donate=False`` step leaves the caller's state tensors as
  they were and gives the ``donate=True`` step's result bit for bit, in
  both engines' templates and windows and through both trainers; an
  unknown audit mode is refused by name;
* ``LMTrainer`` and ``Trainer`` accept a tuner-emitted plan file and
  ``auto`` (``tests/test_plan.py:622-698``), stamp ``run_start`` and one
  ``plan`` event, and the reference's ``tools/ledger_report.summarize``
  renders the port run's ``plan`` section."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

import jax.numpy as jnp  # noqa: E402

from tpu_dist.plan import compile as ref_compile  # noqa: E402
from tpu_dist.plan.ir import Plan as RefPlan  # noqa: E402
from tpu_dist_torch.engine.state import TrainState  # noqa: E402
from tpu_dist_torch.obs.ledger import read_ledger  # noqa: E402
from tpu_dist_torch.ops import pallas_quant, pallas_sgd  # noqa: E402
from tpu_dist_torch.ops import quant as port_quant  # noqa: E402
from tpu_dist_torch.plan import compile as pc  # noqa: E402
from tpu_dist_torch.plan.ir import Plan, PlanError  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUNE_CI = os.path.join(REPO, "scripts", "tune_ci.json")
TOL = 1e-5          # fp32 losses: |port - reference| <= TOL (1 + |ref|)
MODES = {           # the plans each engine's parity runs
    "dp": {}, "accum2": dict(grad_accum_steps=2),
    "bucketed": dict(sync="explicit", grad_bucket_mb=25.0),
    "indexed": dict(window="indexed", steps_per_dispatch=3),
}


@pytest.fixture
def clean_plan_globals():
    """Restore both packages' plan-owned switches after a test."""
    yield
    from tpu_dist.ops import pallas_quant as ref_pq
    from tpu_dist.ops import pallas_sgd as ref_sgd
    from tpu_dist.ops.quant import set_fused_quant

    set_fused_quant(None)
    ref_pq.set_quant_blocks()
    ref_sgd.set_block_rows()
    port_quant.set_fused_quant(None)
    pallas_quant.set_quant_blocks()
    pallas_sgd.set_block_rows()


def _close(got, want, what=""):
    assert abs(got - want) <= TOL * (1 + abs(want)), (what, got, want)


def test_activate_plan_sets_the_three_switches(clean_plan_globals):
    from tpu_dist_torch.ops import pallas_adamw

    assert pc.current_switches() == {"fused_quant": "auto",
                                     "quant_block": (128, 128, 0),
                                     "opt_block_rows": 512}
    pc.activate_plan(Plan(engine="lm", quant="int8", fused_quant="off",
                          quant_block=(64, 256, 128), opt_block_rows=1024))
    assert not port_quant.fused_quant_active()
    assert pallas_quant.quant_blocks() == (64, 256, 128)
    assert pallas_sgd.block_rows() == pallas_adamw.block_rows() == 1024
    pc.activate_plan(Plan(engine="lm", fused_quant="on"))
    assert port_quant.fused_quant_active()
    assert pc.current_switches()["fused_quant"] == "on"
    with pytest.raises(PlanError, match="bn=64"):
        pallas_quant.set_quant_blocks(128, 64, 0)


SEEDS = {   # env seed -> (module, the error it must raise at import)
    "bm": ({"TPU_DIST_QUANT_BLOCKS": "100,128,0"}, "pallas_quant", "bm=100"),
    "arity": ({"TPU_DIST_QUANT_BLOCKS": "256"}, "pallas_quant",
              "expected 'bm,bn,bk'"),
    "rows": ({"TPU_DIST_OPT_BLOCK_ROWS": "100"}, "pallas_sgd",
             "opt_block_rows=100"),
}


@pytest.fixture(scope="module")
def seed_errors():
    """Each seed's import error, from one fresh interpreter (the seeds
    are read at import; a failed import leaves no module behind)."""
    code = (
        "import importlib, json, os, sys\n"
        f"cases = {json.dumps({k: [v[0], v[1]] for k, v in SEEDS.items()})}\n"
        "out = {}\n"
        "for name, (env, mod) in cases.items():\n"
        "    os.environ.update(env)\n"
        "    try:\n"
        "        importlib.import_module('tpu_dist_torch.ops.' + mod)\n"
        "        out[name] = None\n"
        "    except Exception as e:\n"
        "        out[name] = f'{type(e).__name__}: {e}'\n"
        "    for k in env:\n"
        "        del os.environ[k]\n"
        "    for m in [m for m in sys.modules if m.startswith("
        "'tpu_dist_torch.ops.')]:\n"
        "        del sys.modules[m]\n"
        "print(json.dumps(out))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_DIST_")}
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(env, PYTHONPATH=REPO), cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(SEEDS))
def test_env_seeds_fail_loudly_at_import(seed_errors, name):
    assert seed_errors[name] is not None and SEEDS[name][2] in \
        seed_errors[name]


def test_fused_quant_switch_routes_and_matches_reference(
        clean_plan_globals, monkeypatch):
    from tpu_dist.ops import quant as ref_quant

    rng = np.random.RandomState(0)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    ref_quant.set_fused_quant(False)
    want = np.asarray(ref_quant.quant_matmul(jnp.asarray(x), jnp.asarray(w),
                                             "int8"))
    calls = []
    real = pallas_quant.fused_quant_matmul
    monkeypatch.setattr(pallas_quant, "fused_quant_matmul",
                        lambda *a: calls.append(1) or real(*a))
    pc.activate_plan(Plan(engine="lm", quant="int8", fused_quant="off"))
    got = port_quant.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  "int8").numpy()
    assert calls == []
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert bool((np.abs(got - want) <= ulp).all())
    for fq in ("auto", "on"):
        pc.activate_plan(Plan(engine="lm", quant="int8", fused_quant=fq))
        on = port_quant.quant_matmul(torch.from_numpy(x),
                                     torch.from_numpy(w), "int8").numpy()
        assert bool((np.abs(on - want) <= ulp).all())
    assert len(calls) == 2


def test_resolve_config_plan_none_auto_and_engine(tmp_path,
                                                  clean_plan_globals):
    from tpu_dist_torch.configs import LMConfig, TrainConfig

    cfg = LMConfig()
    assert pc.resolve_config_plan(cfg, "cpu") == (cfg, None)
    assert pc.resolve_config_plan(LMConfig(plan="none"), "cpu")[1] is None
    cfg = LMConfig(plan="auto", precision="bf16", grad_accum_steps=4,
                   loss_chunk=1024, health="skip", seq_len=32,
                   vocab_size=64, num_layers=1, d_model=32)
    out, info = pc.resolve_config_plan(cfg, "cpu")
    assert info["source"] == "auto" and info["device_kind"] == "cpu"
    assert (out.precision, out.grad_accum_steps, out.loss_chunk,
            out.health) == ("bf16", 4, 1024, "skip")
    assert out.steps_per_dispatch == 1 and out.grad_bucket_mb == 0.0
    path = tmp_path / "image.json"
    path.write_text(Plan(engine="image").to_json())
    with pytest.raises(PlanError, match="does not drive the lm engine"):
        pc.resolve_config_plan(LMConfig(plan=str(path)), "cpu")
    out, info = pc.resolve_config_plan(TrainConfig(plan=str(path)), "cpu")
    assert info["hash"] and out.variant == "jit"


# ---- compile_plan against the reference's, step for step ------------------

V, L, D, B = 32, 16, 32, 8


@pytest.fixture(scope="module")
def lm_setup():
    from tpu_dist.models.transformer import tiny_lm

    model = tiny_lm(vocab_size=V, num_layers=1, d_model=D, num_heads=4,
                    max_len=L)
    params = model.init({"params": jax.random.PRNGKey(0)},
                        np.zeros((1, L), np.int32), train=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rows = np.random.RandomState(1).randint(0, V, (3 * B, L + 1)).astype(
        np.int32)
    return model, params, rows


def _ref_lm(model, params, rows, plan):
    """Losses of 3 steps (or one 3-step window) through the reference's
    compile_plan."""
    from tpu_dist.engine.state import TrainState as RefState
    from tpu_dist.ops import make_optimizer
    from tpu_dist.parallel.mesh import make_mesh

    tx = make_optimizer(0.01, 0.9, 0.0)
    mesh = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    step = ref_compile.compile_plan(
        RefPlan(engine="lm", **plan),
        ref_compile.Bindings(mesh=mesh, model=model, tx=tx)).train_step
    state = RefState.create(jax.tree_util.tree_map(jnp.asarray, params), {},
                            tx)
    rng = jax.random.PRNGKey(0)
    k = plan.get("grad_accum_steps", 1)
    if plan.get("window") == "indexed":
        idx = np.arange(3 * B, dtype=np.int32).reshape(3, B)
        _, m = step(state, jnp.asarray(rows), idx, rng)
        return [float(m["loss_sum"]) / float(m["count"])]
    out = []
    for i in range(3):
        r = rows[i * B:(i + 1) * B]
        inp, tgt = r[:, :-1], r[:, 1:]
        if k > 1:
            inp, tgt = (a.reshape(k, B // k, L) for a in (inp, tgt))
        state, m = step(state, inp, tgt, rng)
        out.append(float(m["loss_sum"]) / float(m["count"]))
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_lm_compile_plan_matches_the_reference(lm_setup, mode):
    from tpu_dist_torch.interop import load_flax_params
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.ops.optim import make_optimizer

    model, params, rows = lm_setup
    want = _ref_lm(model, params, rows, MODES[mode])
    port = load_flax_params(TransformerLM(
        vocab_size=V, num_layers=1, d_model=D, num_heads=4, max_len=L,
        device="cpu", seed=None), params).requires_grad_(True)
    tx = make_optimizer(0.01, 0.9, 0.0)
    state = TrainState.create(port, tx)
    cp = pc.compile_plan(Plan(engine="lm", **MODES[mode]),
                         pc.Bindings(model=port, tx=tx))
    t = torch.from_numpy(rows.astype(np.int64))
    if mode == "indexed":
        m = cp.train_step(state, t, torch.arange(3 * B).reshape(3, B))
        got = [float(m["loss_sum"]) / float(m["count"])]
    else:
        got = []
        for i in range(3):
            r = t[i * B:(i + 1) * B]
            m = cp.train_step(state, r[:, :-1], r[:, 1:])
            got.append(float(m["loss_sum"]) / float(m["count"]))
    assert state.step == 3 and len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b, mode)
    ev = cp.eval_step(state, t[:B, :-1], t[:B, 1:], torch.ones(B))
    assert float(ev["count"]) == B * L


H, W, C, NCLS = 8, 8, 1, 10


class _TorchMLP(torch.nn.Module):
    """The reference test's image MLP (Dense 32, relu, Dense 10) with
    flax's (in, out) kernels."""

    def __init__(self, params):
        super().__init__()
        for name in ("Dense_0", "Dense_1"):
            mod = torch.nn.Module()
            mod.kernel = torch.nn.Parameter(torch.from_numpy(
                np.array(params[name]["kernel"])))
            mod.bias = torch.nn.Parameter(torch.from_numpy(
                np.array(params[name]["bias"])))
            self.add_module(name, mod)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(x @ self.Dense_0.kernel + self.Dense_0.bias)
        return x @ self.Dense_1.kernel + self.Dense_1.bias


@pytest.fixture(scope="module")
def image_setup():
    import flax.linen as nn

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            h = nn.Dense(32)(x.reshape((x.shape[0], -1)))     # Dense_0
            return nn.Dense(NCLS)(nn.relu(h))                  # Dense_1

    model = MLP()
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((2, H, W, C)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 255, (3 * B, H, W, C)).astype(np.uint8)
    lbls = (np.arange(3 * B) % NCLS).astype(np.int32)
    return model, params, imgs, lbls


def _ref_image(model, params, imgs, lbls, plan):
    from tpu_dist.engine.state import TrainState as RefState
    from tpu_dist.ops import make_optimizer
    from tpu_dist.parallel.mesh import make_mesh

    tx = make_optimizer(0.1, 0.9, 0.0)
    mesh = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    step = ref_compile.compile_plan(
        RefPlan(engine="image", **plan), ref_compile.Bindings(
            mesh=mesh, model=model, tx=tx, image_shape=(H, W, C),
            transform=lambda x, r: x.astype(jnp.float32) / 255.0)
    ).train_step
    state = RefState.create(jax.tree_util.tree_map(jnp.asarray, params), {},
                            tx)
    rng = jax.random.PRNGKey(0)
    if plan.get("window") == "indexed":
        idx = np.arange(3 * B, dtype=np.int32).reshape(3, B)
        _, m = step(state, imgs, lbls, idx, rng)
        return [float(m["loss_sum"]) / float(m["count"])]
    k = plan.get("grad_accum_steps", 1)
    out = []
    for i in range(3):
        x, y = imgs[i * B:(i + 1) * B], lbls[i * B:(i + 1) * B]
        if k > 1:
            x, y = x.reshape(k, B // k, H, W, C), y.reshape(k, B // k)
        state, m = step(state, x, y, rng)
        out.append(float(m["loss_sum"]) / float(m["count"]))
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_image_compile_plan_matches_the_reference(image_setup, mode):
    from tpu_dist_torch.engine.steps import DataParallel
    from tpu_dist_torch.ops.optim import make_optimizer

    model, params, imgs, lbls = image_setup
    want = _ref_image(model, params, imgs, lbls, MODES[mode])
    port = _TorchMLP(params)
    tx = make_optimizer(0.1, 0.9, 0.0)
    state = TrainState.create(port, tx)
    plan = Plan(engine="image", **MODES[mode])
    dp = DataParallel(variant="shard_map" if plan.sync == "explicit"
                      else "jit", bucket_mb=plan.grad_bucket_mb)
    cp = pc.compile_plan(plan, pc.Bindings(
        model=port, tx=tx, dp=dp, transform=lambda x, g=None: x.float() / 255))
    ti, tl = torch.from_numpy(imgs), torch.from_numpy(lbls.astype(np.int64))
    if mode == "indexed":
        m = cp.train_step(state, ti, tl, torch.arange(3 * B).reshape(3, B), 0)
        got = [float(m["loss_sum"]) / float(m["count"])]
    else:
        got = []
        for i in range(3):
            m = cp.train_step(state, ti[i * B:(i + 1) * B],
                              tl[i * B:(i + 1) * B], i)
            got.append(float(m["loss_sum"]) / float(m["count"]))
    assert state.step == 3 and len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b, mode)
    ev = cp.eval_step(ti[:B], tl[:B], torch.ones(B))
    assert float(ev["count"]) == B


def _donation_steps(cp, model, state, calls):
    """Dispatch ``cp.train_step`` once per argument tuple of ``calls``
    through ``cp.advance``, from ``state``: the caller's view before and
    after (its tensor objects and their values, its step counter), the
    final state's tensors and step, the metric sums, and whether the
    model computes with the final state's parameters."""
    objs = pc._state_tensors(state)
    saved = [t.detach().clone() for t in objs]
    step0, cur, sums = state.step, state, []
    for args in calls:
        cur, m = cp.advance(cp.train_step, cur, *args)
        sums.append(m)
    return dict(
        saved=saved, step0=step0, objs=objs,
        caller_after=pc._state_tensors(state), caller_step=state.step,
        final=[t.detach().clone() for t in pc._state_tensors(cur)],
        final_step=cur.step, same=cur is state, sums=sums,
        bound=all(p is q for p, q in zip(model.parameters(), cur.params)))


def _lm_donation_run(params, rows, donate, window="none"):
    """3 LM steps (or one 3-step window) under ``donate``
    (:func:`_donation_steps`)."""
    from tpu_dist_torch.interop import load_flax_params
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.ops.optim import make_optimizer

    port = load_flax_params(TransformerLM(
        vocab_size=V, num_layers=1, d_model=D, num_heads=4, max_len=L,
        device="cpu", seed=None), params).requires_grad_(True)
    tx = make_optimizer(0.01, 0.9, 0.0)
    state = TrainState.create(port, tx)
    kw = dict(window="indexed", steps_per_dispatch=3) if window != "none" \
        else {}
    cp = pc.compile_plan(Plan(engine="lm", donate=donate, **kw),
                         pc.Bindings(model=port, tx=tx))
    t = torch.from_numpy(rows.astype(np.int64))
    if window != "none":
        calls = [(t, torch.arange(3 * B).reshape(3, B))]
    else:
        calls = [(t[i * B:(i + 1) * B, :-1], t[i * B:(i + 1) * B, 1:])
                 for i in range(3)]
    return _donation_steps(cp, port, state, calls)


def _bit_equal(xs, ys):
    return len(xs) == len(ys) and all(torch.equal(x, y)
                                      for x, y in zip(xs, ys))


def _assert_undonated(donated, undonated):
    """The donated run wrote the caller's state in place; the undonated
    one left the caller's state object, its tensors (the same objects)
    and its step counter as they were, and stepped a new state that ends
    bit-equal to the donated one, with bit-equal metric sums and the
    model rebound onto it."""
    d, u = donated, undonated
    assert d["same"] and d["caller_step"] == d["final_step"] == 3
    assert not _bit_equal(d["caller_after"], d["saved"])    # in place
    assert not u["same"] and u["final_step"] == 3
    assert u["caller_step"] == u["step0"] == 0               # untouched
    assert all(a is b for a, b in zip(u["caller_after"], u["objs"]))
    assert len(u["caller_after"]) == len(u["objs"])
    assert _bit_equal(u["caller_after"], u["saved"])
    assert _bit_equal(u["saved"], d["saved"])                # same start
    assert _bit_equal(u["final"], d["final"])
    assert d["bound"] and u["bound"]
    for a, b in zip(d["sums"], u["sums"], strict=True):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)


def test_compile_plan_refuses_donate_false_and_the_audit(lm_setup):
    _, params, rows = lm_setup
    _assert_undonated(_lm_donation_run(params, rows, True),
                      _lm_donation_run(params, rows, False))
    with pytest.raises(PlanError, match="model"):
        pc.compile_plan(Plan(engine="lm", layout="tp"), pc.Bindings())
    # the audit is ported (analysis.proglint): an unknown mode is refused
    # by name, the known ones arm it
    with pytest.raises(ValueError, match="'none', 'record', 'halt'"):
        pc.set_audit("loud")
    pc.set_audit("record")
    assert pc.audit_mode() == "record"
    pc.set_audit("none")
    assert pc.audit_program("train_step", None) == []


def _image_donation_run(params, imgs, lbls, donate, window="none"):
    """As :func:`_lm_donation_run` for the image template (the reference
    test's MLP), 3 steps or one ``stacked`` 3-step window."""
    from tpu_dist_torch.engine.steps import DataParallel
    from tpu_dist_torch.ops.optim import make_optimizer

    port = _TorchMLP(params)
    tx = make_optimizer(0.1, 0.9, 0.0)
    state = TrainState.create(port, tx)
    kw = dict(window=window, steps_per_dispatch=3) if window != "none" \
        else {}
    cp = pc.compile_plan(Plan(engine="image", donate=donate, **kw),
                         pc.Bindings(model=port, tx=tx,
                                     dp=DataParallel(variant="jit"),
                                     transform=lambda x, g=None:
                                     x.float() / 255))
    ti, tl = torch.from_numpy(imgs), torch.from_numpy(lbls.astype(np.int64))
    if window == "stacked":
        calls = [(ti.reshape(3, B, H, W, C), tl.reshape(3, B), 0)]
    else:
        calls = [(ti[i * B:(i + 1) * B], tl[i * B:(i + 1) * B], i)
                 for i in range(3)]
    return _donation_steps(cp, port, state, calls)


@pytest.mark.parametrize("engine,window", [("lm", "indexed"),
                                           ("image", "none"),
                                           ("image", "stacked")], ids=str)
def test_compile_plan_donate_false_steps_on_copies(lm_setup, image_setup,
                                                   engine, window):
    """``donate=False`` through the other templates and windows: the
    caller's state tensors stay bit-equal to saved copies, and the result
    is bit-equal to ``donate=True``'s."""
    if engine == "lm":
        _, params, rows = lm_setup
        run = lambda donate: _lm_donation_run(params, rows, donate, window)
    else:
        _, params, imgs, lbls = image_setup
        run = lambda donate: _image_donation_run(params, imgs, lbls, donate,
                                                 window)
    _assert_undonated(run(True), run(False))


@pytest.mark.parametrize("engine", ["lm", "image"])
def test_trainers_fit_under_donate_false(tmp_path, clean_plan_globals,
                                         engine):
    """``LMTrainer`` and ``Trainer`` on a plan file with ``donate=False``
    fit without raising and leave their first state as it was, and their
    per-step losses and final parameters are bit-equal to the same plan's
    with ``donate=True``."""
    from tpu_dist_torch.configs import LMConfig, TrainConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.engine.loop import Trainer

    out = {}
    for donate in (True, False):
        path = tmp_path / f"plan-{donate}.json"
        path.write_text(Plan(engine=engine, donate=donate).to_json())
        ledger = tmp_path / f"run-{donate}.jsonl"
        if engine == "lm":
            t = LMTrainer(LMConfig(
                seq_len=32, vocab_size=64, num_layers=1, d_model=32,
                num_heads=4, batch_size=8, synth_tokens=3000, epochs=1,
                max_steps=3, ledger_path=str(ledger), watchdog_factor=0,
                seed=0, plan=str(path)), device="cpu")
        else:
            t = Trainer(TrainConfig(
                dataset="synthetic", arch="lenet", batch_size=32,
                synth_train_size=96, synth_val_size=32, epochs=1, seed=0,
                watchdog_factor=0, data=str(tmp_path / "no-data"),
                plan=str(path), ledger_path=str(ledger)), device="cpu")
        assert t.compiled.plan.donate is donate
        first = t.state
        saved = [p.detach().clone() for p in first.params]
        t.fit()
        losses = [r["loss"] for r in read_ledger(str(ledger))
                  if r["event"] == "step"]
        assert losses
        # the trainer's first state: stepped in place, or left as it was
        assert (t.state is first) is donate
        assert first.step == (t.state.step if donate else 0)
        assert _bit_equal(first.params, saved) is not donate
        out[donate] = (losses, [p.detach().clone()
                                for p in t.state.params])
    assert out[False][0] == out[True][0]
    assert _bit_equal(out[False][1], out[True][1])


# ---- the trainers' plan knob ----------------------------------------------

def test_lm_trainer_accepts_emitted_plan_file(tmp_path, clean_plan_globals):
    """The reference tuner's plan file over the canned measurements drives
    a port LM run: the plan's knobs land in the config, run_start and one
    ``plan`` event carry the hash, the reference's ledger_report renders
    it."""
    sys.path.insert(0, REPO)
    from tools.ledger_report import summarize

    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.plan.tune import tune

    text, results = tune(measurement_files=[TUNE_CI])
    best_hash = results["TPU v5 lite"]["best"]["hash"]
    doc = json.loads(text)
    path = tmp_path / "plans.json"
    path.write_text(json.dumps(
        {"version": 1, "plans": {"default": doc["plans"]["TPU v5 lite"]}}))
    ledger = tmp_path / "run.jsonl"
    t = LMTrainer(LMConfig(seq_len=32, vocab_size=64, num_layers=1,
                           d_model=32, num_heads=4, batch_size=16,
                           synth_tokens=6000, epochs=1, max_steps=2,
                           ledger_path=str(ledger), watchdog_factor=0,
                           plan=str(path)), device="cpu")
    assert t.cfg.quant == "int8" and t.cfg.grad_bucket_mb == 25.0
    assert t.cfg.steps_per_dispatch == 16 and t.mode == "dp-bucketed"
    assert t.compiled.plan.window == "indexed"
    assert pc.current_switches()["quant_block"] == tuple(
        doc["plans"]["TPU v5 lite"]["quant_block"])
    t.fit()
    recs = read_ledger(str(ledger))
    assert [r["event"] for r in recs[:2]] == ["run_start", "plan"]
    assert recs[0]["plan_hash"] == best_hash
    assert recs[0]["plan_source"] == str(path)
    assert [r for r in recs if r["event"] == "plan"][0]["knobs"]["quant"] \
        == "int8"
    summary = summarize(recs, out=lambda s: None)
    assert summary["plan"]["plan_hash"] == best_hash
    assert summary["run"]["plan_hash"] == best_hash
    auto = LMTrainer(LMConfig(seq_len=32, vocab_size=64, num_layers=1,
                              d_model=32, num_heads=4, batch_size=16,
                              synth_tokens=6000, plan="auto",
                              precision="bf16"), device="cpu")
    assert auto._plan_info["source"] == "auto"
    assert auto.cfg.precision == "bf16"        # carried, not searched


def test_image_trainer_accepts_plan_and_auto(tmp_path, clean_plan_globals):
    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine.loop import Trainer
    from tpu_dist_torch.plan.ir import plan_hash

    plan = Plan(engine="image", sync="explicit", grad_bucket_mb=25.0)
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    ledger = tmp_path / "img.jsonl"
    kw = dict(dataset="synthetic", arch="lenet", batch_size=64,
              synth_train_size=128, synth_val_size=64, epochs=1,
              watchdog_factor=0, data=str(tmp_path / "no-data"))
    t = Trainer(TrainConfig(**kw, plan=str(path), ledger_path=str(ledger)),
                device="cpu")
    assert t.cfg.variant == "shard_map" and t.cfg.grad_bucket_mb == 25.0
    assert t._plan_info["hash"] == plan_hash(plan)
    t.fit()
    recs = read_ledger(str(ledger))
    assert recs[0]["plan_hash"] == plan_hash(plan)
    assert [r["event"] for r in recs].count("plan") == 1
    t2 = Trainer(TrainConfig(**kw, plan="auto"), device="cpu")
    assert t2._plan_info["source"] == "auto" and t2.cfg.quant == "none"
