"""The port's fault injection (``tpu_dist_torch/obs/faults.py``) against
the JAX package's (``tpu_dist/obs/faults.py``): the same spec strings parse
to equal entries or raise the same error, scripted ``fire``/``fire_step``
sequences fire the same entries in the same order with the same ``fault``
ledger events, and ``poison_params`` poisons exactly the first floating
parameter, in place."""

import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both

from tpu_dist.obs import faults as ref_faults  # noqa: E402

from tpu_dist_torch.obs import faults  # noqa: E402
from tpu_dist_torch.obs.ledger import Ledger  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    monkeypatch.delenv("TPU_DIST_FAULTS", raising=False)
    monkeypatch.delenv("TPU_DIST_ATTEMPT", raising=False)
    faults._reset_for_tests()
    ref_faults._reset_for_tests()
    yield
    faults._reset_for_tests()
    ref_faults._reset_for_tests()


def test_sites_and_step_sites_are_the_reference():
    assert faults.SITES == ref_faults.SITES
    assert faults.STEP_SITES == ref_faults.STEP_SITES
    assert faults.ENV_VAR == ref_faults.ENV_VAR == "TPU_DIST_FAULTS"


SPECS = [
    "", "nan_batch", "hard_exit@step=10,attempt=0,code=7",
    "hang@step=3,secs=0.5;preempt_sigterm@epoch=2",
    "ckpt_enospc@nth=2;rendezvous_fail@times=3",
    "preempt_deadline@step=9,attempt=1,secs=4.5",
    " host_return@host=2 ; nan_batch@step=6,attempt=0 ;",
    "hang@step=6,attempt=0;preempt_deadline@step=9,attempt=1;"
    "hard_exit@step=10,attempt=2",
    "nan_batch@step=1e1", "hard_exit@step=-1", "nan_batch@=3",
]
BAD = ["bogus_site", "nan_batch@step", "nan_batch@step=", "hang@secs=abc",
       "hard_exit@step=1;oops@x=1", "nan_batch@step=1,,"]


@pytest.mark.parametrize("spec", SPECS)
def test_grammar_parses_to_the_reference_entries(spec):
    got = faults.FaultPlan.parse(spec).faults
    want = ref_faults.FaultPlan.parse(spec).faults
    assert [(f.site, f.when, f.args, f.spec, f.times) for f in got] == \
        [(f.site, f.when, f.args, f.spec, f.times) for f in want]


@pytest.mark.parametrize("spec", BAD)
def test_grammar_refuses_what_the_reference_refuses(spec):
    with pytest.raises(ValueError) as want:
        ref_faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        faults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def _script(seed):
    """A scripted sequence of (site, context) checks drawn from a numpy
    seed over the data-level sites (the process-level ones would act)."""
    rng = np.random.default_rng(seed)
    sites = ("nan_batch", "ckpt_enospc", "rendezvous_fail",
             "preempt_deadline", "host_return")
    out = []
    for _ in range(40):
        ctx = {}
        for key in ("step", "epoch", "attempt"):
            if rng.random() < 0.7:
                ctx[key] = int(rng.integers(0, 12))
        out.append((sites[int(rng.integers(len(sites)))], ctx))
    return out


PLANS = [
    "nan_batch@step=4;nan_batch@step=8,times=2",
    "ckpt_enospc@nth=2;ckpt_enospc@nth=5,times=2",
    "rendezvous_fail@times=3;preempt_deadline@epoch=3,attempt=1",
    "host_return@attempt=2,times=4;nan_batch@step=2,epoch=1",
    "preempt_deadline@step=5,attempt=0,secs=3;nan_batch@attempt=1",
]


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fire_sequences_equal_the_reference(plan, seed):
    """``FaultPlan.fire`` over the same scripted checks fires the same
    entries (by spec, in order) and records the same ``fault`` events."""
    got_ev, want_ev = [], []
    p = faults.FaultPlan.parse(plan)
    r = ref_faults.FaultPlan.parse(plan)
    led = Ledger(None, sinks=(got_ev.append,))

    class RefLedger:
        def emit(self, event, **kw):
            want_ev.append({"event": event, **kw})

    got, want = [], []
    for site, ctx in _script(seed):
        f = p.fire(site, ledger=led, **ctx)
        g = r.fire(site, ledger=RefLedger(), **ctx)
        got.append(None if f is None else (f.spec, f.fired))
        want.append(None if g is None else (g.spec, g.fired))
    assert got == want
    assert p.seen == r.seen
    strip = [{k: v for k, v in e.items() if k not in ("ts", "pid")}
             for e in got_ev]
    assert strip == want_ev
    assert any(x is not None for x in got) or seed > 0


@pytest.mark.parametrize("plan,attempt", [
    ("nan_batch@step=6,attempt=0;preempt_deadline@step=9,attempt=1,secs=2",
     0),
    ("nan_batch@step=6,attempt=0;preempt_deadline@step=9,attempt=1,secs=2",
     1),
    ("hang@step=3,secs=0;nan_batch@step=5,times=2", 0),
    ("preempt_deadline@epoch=1", 0),
])
def test_fire_step_effects_equal_the_reference(plan, attempt, monkeypatch):
    """The module-level plan (``install``, ``set_context`` with the
    attempt, ``fire_step`` once a step) gives the same effects a step and
    the same ``fault`` events; ``TPU_DIST_ATTEMPT`` seeds the context of
    sites that fire before a run sets it."""
    monkeypatch.setenv("TPU_DIST_ATTEMPT", str(attempt))
    got_ev, want_ev = [], []
    faults.install(plan, ledger=Ledger(None, sinks=(got_ev.append,)))

    class RefLedger:
        def emit(self, event, **kw):
            want_ev.append({"event": event, **kw})

    ref_faults.install(plan, ledger=RefLedger())
    got, want = [], []
    for step in range(12):
        ctx = {"epoch": step // 4}
        got.append({k: (f.spec, f.args) for k, f in
                    faults.fire_step(step, **ctx).items()})
        want.append({k: (f.spec, f.args) for k, f in
                     ref_faults.fire_step(step, **ctx).items()})
    assert got == want
    assert [{k: v for k, v in e.items() if k not in ("ts", "pid")}
            for e in got_ev] == want_ev
    for e in got_ev:
        assert set(e) >= {"site", "step", "spec", "attempt"}


def test_env_plan_is_read_once_and_explicit_install_wins(monkeypatch):
    monkeypatch.setenv("TPU_DIST_FAULTS", "ckpt_enospc@nth=1")
    assert faults.active_plan().sites() == {"ckpt_enospc"}
    assert ref_faults.active_plan().sites() == {"ckpt_enospc"}
    faults.install("nan_batch")
    assert faults.active_plan().sites() == {"nan_batch"}
    faults.install("")
    assert faults.active_plan() is None
    assert faults.fire("nan_batch") is None and faults.fire_step(3) == {}


def test_poison_params_poisons_exactly_the_first_floating_parameter():
    gen = torch.Generator().manual_seed(0)
    ints = torch.arange(6)
    a = torch.randn(3, 4, generator=gen)
    b = torch.randn(5, generator=gen)
    c = torch.randn(2, 2, generator=gen).bfloat16()
    before = [t.clone() for t in (ints, a, b, c)]
    params = [ints, a, b, c]
    assert faults.poison_params(params) is None
    assert params[1] is a                      # in place
    assert torch.isnan(a).all()
    for t, old in ((ints, before[0]), (b, before[2]), (c, before[3])):
        assert torch.equal(t, old)


def test_poison_params_reaches_the_trainers_loss():
    """In a trainer the first fp32 master is the token embedding: the next
    step's loss goes non-finite, as a NaN batch would make it."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    tr = LMTrainer(LMConfig(vocab_size=32, d_model=16, num_layers=1,
                            num_heads=2, seq_len=16, batch_size=2,
                            synth_tokens=400, precision="bf16",
                            max_steps=1, print_freq=1), device="cpu")
    faults.poison_params(tr.state.params)
    assert tr.state.params[0].dtype == torch.float32
    assert torch.isnan(tr.state.params[0]).all()
    assert all(torch.isfinite(p).all() for p in tr.state.params[1:])
    idx, _ = tr._epoch_indices(tr.train_ds, True, 0)
    m = tr._step(*tr._batch(tr.train_ds, idx[0]))
    assert not math.isfinite(float(m["loss_sum"]))
