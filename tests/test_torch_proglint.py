"""The port's program audit (``tpu_dist_torch.analysis.proglint`` and the
``audit`` knob of ``plan.compile``) against the reference's, on the CPU.

* the parts that need no program (waiver grammar, waivers, rendering,
  SARIF) give the reference's results on the same texts;
* each check trips on an injected hazard and stays silent on its control:
  PL001 and PL002 over two gloo ranks (``tests/torch_dp_worker.py``,
  spawned once for the module), PL003, PL004 and PL005 in this process;
  the int8 tiny LM is clean because the kernels' plain versions are not
  the program's compute;
* the modes (``none`` emits nothing, ``record`` one event a program,
  ``halt`` raises, an unknown mode is a ValueError) and the events'
  consumers (the metrics counter, ``tools/ledger_report.py``);
* against the reference's real findings, with ``jax.core.ClosedJaxpr`` and
  ``Jaxpr`` pointed at ``jax.extend.core``'s for this module (the
  reference's ``_sub_jaxprs`` reads them from ``jax.core``, which newer JAX
  no longer has): the tune-space audit's plans, programs, names and
  findings, and a tiny LM step's check IDs in both packages.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference trainer needs both

from tpu_dist.analysis import proglint as ref  # noqa: E402
from tpu_dist_torch.analysis import proglint  # noqa: E402
from tpu_dist_torch.analysis.proglint import (AuditError, Finding,  # noqa: E402
                                              ProgramRecorder,
                                              RecompileSentry,
                                              audit_recording,
                                              audit_tune_space,
                                              mesh_axis_authority)
from tpu_dist_torch.plan import compile as pc  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_LM = dict(epochs=1, batch_size=8, seq_len=32, vocab_size=64,
               num_layers=1, d_model=32, num_heads=2, synth_tokens=2048,
               print_freq=4, seed=0, max_steps=3, checkpoint_dir="")

WAIVER_TEXTS = {
    "reference_file": open(os.path.join(REPO, "scripts",
                                        "proglint_waivers.txt")).read(),
    "port_file": open(proglint.DEFAULT_WAIVERS).read(),
    "debt": ("# comment line\n\n"
             "PL003 serve_* -- bucket shardings differ by design\n"
             "PL001 train_step   # no reason at all\n"
             "PL004 -- reason but no program glob\n"
             "DL003 x -- wrong namespace\n"
             "PL002 *   --   \n"
             "PL005 serve_prefill -- buckets -- two dashes\n"),
}


@pytest.fixture(autouse=True)
def _audit_off():
    """Every test leaves the process-wide audit switch disarmed."""
    yield
    pc.set_audit("none")


class _Led:
    """Ledger stub: records emits."""

    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append({"event": event, **fields})

    def audits(self):
        return [e for e in self.events if e["event"] == "audit"]


def _checks(findings):
    return [f.check for f in findings]


# ---- the parts that need no program --------------------------------------

@pytest.mark.parametrize("name", sorted(WAIVER_TEXTS))
def test_waiver_parsing_matches_reference(name):
    text = WAIVER_TEXTS[name]
    got_w, got_m = proglint.parse_waivers(text, origin="w.txt")
    want_w, want_m = ref.parse_waivers(text, origin="w.txt")
    assert [(w.check, w.pattern, w.reason, w.line) for w in got_w] == \
        [(w.check, w.pattern, w.reason, w.line) for w in want_w]
    assert [m.to_json() for m in got_m] == [m.to_json() for m in want_m]
    if name == "port_file":          # the port waives nothing
        assert got_w == [] and got_m == []
    if name == "debt":
        assert _checks(got_m) == ["PL000"] * 4


def test_waivers_render_json_and_sarif_match_reference():
    text = ("PL001 serve_* -- draft axis is synthetic\n"
            "PL003 train_* -- measured: no second copy\n")
    rows = [("PL001", "serve_tick", "x"), ("PL001", "train_step", "y"),
            ("PL002", "serve_tick", "z"), ("PL003", "train_step", "d"),
            ("PL005", "serve_prefill", "p")]
    got = proglint.apply_waivers([Finding(*r) for r in rows],
                                 proglint.parse_waivers(text)[0])
    want = ref.apply_waivers([ref.Finding(*r) for r in rows],
                             ref.parse_waivers(text)[0])
    assert [f.to_json() for f in got] == [f.to_json() for f in want]
    assert [f.render() for f in got] == [f.render() for f in want]
    assert [f.program for f in proglint.unwaivered(got)] == \
        [f.program for f in ref.unwaivered(want)]
    assert json.dumps(proglint.to_sarif(got), sort_keys=True) == \
        json.dumps(ref.to_sarif(want), sort_keys=True)
    assert proglint.CHECKS == ref.CHECKS
    assert mesh_axis_authority() == ref.mesh_axis_authority()


# ---- PL001 and PL002 over two gloo ranks ---------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One gloo group of two ranks for the module: every case of the
    worker's ``proglint`` job."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_dp_worker import run_group

    job = {"kind": "proglint", "name": "pl", "lm": TINY_LM}
    out = str(tmp_path_factory.mktemp("proglint2"))
    return [r["pl"] for r in run_group(2, {"jobs": [job]}, out,
                                       timeout=240)]


@pytest.mark.parametrize("axis,trips", [("batch", True), ("data", False),
                                        ("sp", False), ("spd", True),
                                        (None, True)])
def test_pl001_collective_axis_against_the_authority(ranks, axis, trips):
    for res in ranks:
        got = res[f"pl001_{axis}"]
        assert got["checks"] == (["PL001"] if trips else []), got
        if trips:
            want = (f"axis {axis!r}" if axis is not None
                    else "no mesh axis owns")
            assert want in got["messages"][0]


@pytest.mark.parametrize("case,trips", [("swap", True), ("symmetric", False),
                                        ("loop", False)])
def test_pl002_divergent_order_trips_on_every_rank(ranks, case, trips):
    for rank, res in enumerate(ranks):
        got = res[f"pl002_{case}"]
        assert got["checks"] == (["PL002"] if trips else []), got
        if trips:
            msg = got["messages"][0]
            assert "at position 0" in msg and f"ranks [{1 - rank}]" in msg
            op = ("SUM", "MAX")[rank]
            assert f"allreduce[{op}] over ['data']" in msg


def test_halt_raises_on_both_ranks_and_record_emits_one_event(ranks):
    for res in ranks:
        assert "PL002" in res["pl002_swap_halt"]["halt"]
        progs = [e["program"] for e in res["events"]]
        # one event per audited program (the halted one included)
        assert progs.count("pl002_swap") == 2
        assert progs.count("pl001_data") == 1
        (lm,) = res["lm_audits"]          # the dp step over 'data': clean
        assert (lm["program"], lm["findings"]) == ("train_step", 0)


# ---- PL003: the state's storage ------------------------------------------

def _tiny_state(tx_kind):
    from tpu_dist_torch.engine.state import TrainState
    from tpu_dist_torch.ops.optim import make_optimizer
    from tpu_dist_torch.ops.pallas_sgd import FusedSGD

    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(4, 4, generator=gen) for _ in range(3)]
    tx = (FusedSGD(lambda step: 0.1, 0.9, 0.0) if tx_kind == "fused"
          else make_optimizer(0.1, 0.9, 0.0))
    return TrainState(step=0, params=params, opt_state=tx.init(params),
                      param_names=["a", "b", "c"]), tx


@pytest.mark.parametrize("kind,trips", [("fused", False), ("optax", False),
                                        ("rebind", True)])
def test_pl003_rebinding_update_trips_in_place_is_clean(kind, trips):
    from tpu_dist_torch.engine.steps import apply_update

    state, tx = _tiny_state("optax" if kind == "rebind" else kind)
    grads = [torch.ones_like(p) for p in state.params]

    def step(state):
        if kind == "rebind":      # the hazard: one parameter rebound
            state.params[1] = state.params[1] - 0.1 * grads[1]
            return
        apply_update(tx, state, grads, {})

    led = _Led()
    pc.set_audit("record", led)
    fs = pc.audit_program("train_step", step, state, state=state)
    assert _checks(fs) == (["PL003"] if trips else [])
    if trips:
        assert "rebinds 1 of" in fs[0].message and "b" in fs[0].message
    # donate=False (the step writes copies of the state) checks nothing
    assert pc.audit_program("train_step", step, state, state=state,
                            donate=False) == []


# ---- PL004: precision ------------------------------------------------------

def _mm_findings(dtype, precision):
    a = torch.ones(4, 4, dtype=dtype)
    with ProgramRecorder() as rec:
        a @ a
    return audit_recording("p", rec, precision=precision)


@pytest.mark.parametrize("dtype,precision,trips", [
    (torch.float32, "bf16", True), (torch.float32, "int8", True),
    (torch.float32, "fp32", False), (torch.float32, "bf16_params", False),
    (torch.bfloat16, "bf16", False)])
def test_pl004_fp32_matmul_in_low_precision_program(dtype, precision, trips):
    fs = _mm_findings(dtype, precision)
    assert _checks(fs) == (["PL004"] if trips else [])
    if trips:
        assert "mm op(s) compute in f32" in fs[0].message
        assert f"inside a {precision} program" in fs[0].message


def test_pl004_fp32_output_product_records_its_bf16_operands():
    """``full_attention``'s scores are bf16 q and k with an fp32 result,
    the reference's ``preferred_element_type=float32`` einsum: its forward
    and backward record bf16 in every product (clean under bf16, where
    this PyTorch computes them by upcasting), and its numbers are the
    reference's."""
    import jax.numpy as jnp
    from tpu_dist.models.transformer import full_attention as jax_attention
    from tpu_dist_torch.models.transformer import full_attention
    from tpu_dist_torch.ops.f32_product import matmul_f32

    rng = np.random.RandomState(0)
    arrs = [rng.randn(2, 8, 2, 16).astype(np.float32) for _ in range(3)]
    q, k, v = (torch.from_numpy(a).bfloat16().requires_grad_() for a in arrs)
    with ProgramRecorder() as rec:
        out = full_attention(q, k, v)
        out.float().square().sum().backward()
    assert rec.compute and all("bfloat16" in dts for _, dts in rec.compute)
    assert audit_recording("p", rec, precision="bf16") == []
    # the card's route, bmm(..., out_dtype=float32), on meta tensors: the
    # same recording as the upcast's
    qm, km, vm = (torch.empty(t.shape, dtype=torch.bfloat16, device="meta",
                              requires_grad=True) for t in (q, k, v))
    with ProgramRecorder() as meta:
        full_attention(qm, km, vm).float().square().sum().backward()
    assert sorted(set(meta.compute)) == sorted(set(rec.compute))
    a, b = q.detach().transpose(1, 2), k.detach().transpose(1, 2).mT
    scores = matmul_f32(a, b)              # fp32 scores, never rounded
    assert scores.dtype == torch.float32
    torch.testing.assert_close(scores, a.float() @ b.float(), rtol=0, atol=0)
    # the output is the fp32-score attention's (both take the exact upcast
    # on this CPU): scores rounded to bf16 would move it by a bf16 ulp
    mask = torch.ones(8, 8, dtype=torch.bool).tril()
    w = torch.softmax((scores / 4.0).masked_fill(~mask, float("-inf")), -1)
    torch.testing.assert_close(out.detach(), (w.to(v.dtype) @ v.detach(
        ).transpose(1, 2)).transpose(1, 2), rtol=0, atol=0)

    def loss(q, k, v):
        return jnp.sum(jax_attention(q, k, v).astype(jnp.float32) ** 2)

    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    want = [jax_attention(jq, jk, jv),
            *jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]
    for got, ref_ in zip([out, q.grad, k.grad, v.grad], want):
        ref_ = np.asarray(ref_.astype(jnp.float32))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_less(
            np.abs(got.detach().float().numpy() - ref_),
            0.02 * (1 + np.abs(ref_)))


def test_fit_disarms_the_audit_for_later_engines(tmp_path):
    """A trainer's audit is its run's: ``fit`` disarms it, so a
    ``ServeEngine`` built later in the process registers nothing and
    emits nothing into the finished run's ledger."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.obs.ledger import read_ledger

    path = str(tmp_path / "lm.jsonl")
    tr = LMTrainer(LMConfig(**TINY_LM, audit="halt", ledger_path=path),
                   device="cpu")
    tr.fit()
    assert pc.audit_mode() == "none" and pc._AUDIT["sentry"] is None
    before = read_ledger(path)
    eng = ServeEngine(tr.model, ServeConfig(max_slots=2, page_size=8,
                                            num_pages=16), device="cpu")
    assert len(eng.run([DecodeRequest(i, np.arange(1, 2 + 5 * i), 3)
                        for i in range(3)])) == 3
    assert pc._AUDIT["sentry"] is None and read_ledger(path) == before


def test_pl004_float64_result_and_the_plain_version_skip():
    from tpu_dist_torch.ops.pallas_quant import fused_quant_matmul_plain

    x = torch.randn(8, 16, dtype=torch.bfloat16)
    w = torch.randn(16, 4, dtype=torch.bfloat16)
    with ProgramRecorder() as rec:
        fused_quant_matmul_plain(x, w)     # multiplies in float64
    assert rec.f64 == [] and rec.compute == []
    assert audit_recording("p", rec, precision="bf16") == []
    with ProgramRecorder() as rec:
        x.double() @ w.double()            # the same, as program compute
    fs = audit_recording("p", rec, precision="bf16")
    # the casts and the product, one finding per operator
    assert set(_checks(fs)) == {"PL004"}
    assert any("mm op(s) compute in f64" in f.message for f in fs)


@pytest.mark.parametrize("quant,attn", [("int8", "full"), ("none", "flash")])
def test_pl004_low_precision_tiny_lm_is_clean_on_the_cpu(tmp_path, quant,
                                                         attn):
    """The int8 tiny LM's products are the fused kernel's plain version
    here (float64) and the flash pair's (fp32): out of the program's
    compute, as the kernels' ctypes launches are on the card."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.obs.ledger import read_ledger

    path = str(tmp_path / "lm.jsonl")
    LMTrainer(LMConfig(**TINY_LM, precision="bf16", quant=quant, attn=attn,
                       audit="halt", ledger_path=path), device="cpu").fit()
    (ev,) = [r for r in read_ledger(path) if r["event"] == "audit"]
    assert (ev["program"], ev["mode"], ev["findings"]) == \
        ("train_step", "halt", 0)


# ---- PL005: the recompile sentry -------------------------------------------

def test_pl005_sentry_latches_one_finding_per_program():
    sentry = RecompileSentry()
    sentry.register("vary", allowed=1)
    sentry.note("vary", (torch.ones(2),))
    sentry.note("vary", (torch.zeros(2),))    # same signature
    assert sentry.check() == []
    sentry.note("vary", (torch.ones(3),))
    sentry.note("vary", (torch.ones(4, dtype=torch.float64),))
    fs = sentry.check()
    assert _checks(fs) == ["PL005"] and "3 distinct input signatures" in \
        fs[0].message
    assert sentry.check() == []               # latched
    sentry2 = RecompileSentry()
    sentry2.register("prefill", allowed=3)    # the bucket ladder
    for n in (2, 3, 4):
        sentry2.note("prefill", (np.zeros((1, n), np.int32),))
    assert sentry2.check() == []


# ---- the modes and the events' consumers -----------------------------------

def test_set_audit_rejects_unknown_mode_naming_the_modes():
    with pytest.raises(ValueError, match="none.*record.*halt"):
        pc.set_audit("loud")


def test_audit_program_modes_record_halt_none():
    led = _Led()
    pc.set_audit("record", led)
    bad = lambda x: x @ x                 # noqa: E731 (an fp32 product)
    x = torch.ones(4, 4)
    fs = pc.audit_program("bad_step", bad, x, precision="bf16")
    assert _checks(fs) == ["PL004"]
    (ev,) = led.audits()
    assert ev["program"] == "bad_step" and ev["mode"] == "record"
    assert ev["findings"] == 1 and ev["waived"] == 0
    assert ev["detail"][0]["check"] == "PL004"
    pc.audit_program("good_step", lambda x: x.sum(), x, precision="bf16")
    assert [e["findings"] for e in led.audits()] == [1, 0]
    assert led.audits()[1]["detail"] is None
    pc.set_audit("halt", led)
    with pytest.raises(AuditError, match="PL004"):
        pc.audit_program("bad_step", bad, x, precision="bf16")
    assert len(led.audits()) == 3          # halt emits, then raises
    pc.set_audit("none", led)
    assert pc.audit_program("bad_step", bad, x, precision="bf16") == []
    assert len(led.audits()) == 3


def test_check_audit_sentry_record_once_then_halt_raises():
    led = _Led()
    pc.set_audit("record", led)
    pc.register_audit_program("vary")
    pc.note_audit_dispatch("vary", torch.ones(2))
    pc.note_audit_dispatch("vary", torch.ones(3))
    pc.check_audit_sentry()
    pc.check_audit_sentry()               # latched: no second event
    (ev,) = led.audits()
    assert ev["program"] == "vary" and ev["findings"] == 1
    assert ev["detail"][0]["check"] == "PL005"
    pc.set_audit("halt", led)             # a fresh sentry
    pc.note_audit_dispatch("vary2", torch.ones(2))
    pc.note_audit_dispatch("vary2", torch.ones(3))
    with pytest.raises(AuditError, match="PL005"):
        pc.check_audit_sentry()


def test_serve_programs_register_and_stay_within_their_signatures(tmp_path):
    """A ServeEngine under the audit: the prefill signatures stay within
    the bucket ladder and no PL005 event is emitted over a run."""
    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.models.transformer import tiny_lm

    led = _Led()
    pc.set_audit("record", led)
    model = tiny_lm(vocab_size=64, num_layers=1, d_model=32, num_heads=2,
                    max_len=64, device="cpu", seed=0)
    eng = ServeEngine(model, ServeConfig(max_slots=2, page_size=8,
                                         num_pages=32,
                                         prefill_buckets=(8, 16, 32)),
                      device="cpu")
    rng = np.random.RandomState(0)
    reqs = [DecodeRequest(rid=i, prompt=rng.randint(0, 64, 3 + 5 * i),
                          max_new_tokens=4) for i in range(5)]
    done = eng.run(reqs)
    assert len(done) == 5
    sentry = pc._AUDIT["sentry"]
    assert 1 < sentry.signatures("serve_prefill") <= len(eng.buckets)
    assert sentry.signatures("serve_tick") == 1
    assert led.audits() == []


def test_audit_events_feed_metrics_and_report_sections():
    from tpu_dist_torch.obs.metrics import MetricsRegistry, metrics_ledger_sink

    reg = MetricsRegistry()
    sink = metrics_ledger_sink(reg)
    assert 'tpu_dist_audit_findings_total{check="PL003"} 0' in reg.render()
    led = _Led()
    pc.set_audit("record", led)
    pc.audit_program("train_step", lambda x: x.double(), torch.ones(2),
                     precision="int8")
    pc.audit_program("serve_tick", lambda x: x + 1, torch.ones(2),
                     precision="int8")
    for r in led.events:
        sink(r)
    text = reg.render()
    assert 'tpu_dist_audit_findings_total{check="PL004"} 1' in text
    assert 'tpu_dist_audit_findings_total{check="PL001"} 0' in text
    sys.path.insert(0, REPO)
    from tools.ledger_report import audit_section

    lines = []
    sec = audit_section(led.events, out=lines.append)
    assert sec["mode"] == "record" and len(sec["programs"]) == 2
    assert sec["findings"] == 1
    assert sec["programs"]["train_step"]["checks"] == ["PL004"]
    assert any("train_step" in ln and "PL004" in ln for ln in lines)


# ---- against the reference's real findings --------------------------------

@pytest.fixture(scope="module")
def reference_shim():
    """The reference's program walk on this JAX: ``jax.core``'s closed and
    open jaxpr types pointed at ``jax.extend.core``'s, for this module."""
    import jax.extend

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "ClosedJaxpr", jax.extend.core.ClosedJaxpr,
                   raising=False)
        mp.setattr(jax.core, "Jaxpr", jax.extend.core.Jaxpr, raising=False)
        yield


@pytest.fixture(scope="module")
def reference_tune_space(reference_shim):
    return ref.audit_tune_space()


def test_tune_space_audit_matches_the_reference(reference_tune_space,
                                                tmp_path):
    """The CLI over the tuner's space at 8 ranks: the reference's plans,
    programs, names and (no) findings."""
    out = tmp_path / "report.json"
    rc = proglint._main(["--devices", "8", "--json", str(out),
                         "--sarif-out", str(tmp_path / "r.sarif")])
    got = json.loads(out.read_text())
    want = reference_tune_space
    assert rc == 0 and want["unwaivered"] == got["unwaivered"] == 0
    assert (got["plans"], got["programs"]) == (want["plans"],
                                               want["programs"]) == (72, 8)
    assert got["program_names"] == want["program_names"]
    assert got["findings"] == want["findings"] == []
    sarif = json.loads((tmp_path / "r.sarif").read_text())
    assert sarif["runs"][0]["results"] == []


def test_tune_space_report_is_byte_deterministic():
    one = json.dumps(audit_tune_space(devices=2), indent=1, sort_keys=True)
    two = json.dumps(audit_tune_space(devices=2), indent=1, sort_keys=True)
    assert one == two and json.loads(one)["programs"] == 8


@pytest.mark.parametrize("attn", ["full", "blockwise"])
def test_tiny_bf16_lm_step_flags_the_reference_checks(reference_shim,
                                                      tmp_path, attn):
    """One bf16 train step of the same tiny LM (the reference's initial
    weights carried across) under audit=record in both packages: the same
    set of check IDs (blockwise: PL004 in both, its fp32 score products;
    full: none)."""
    from tpu_dist.configs import LMConfig as JaxLMConfig
    from tpu_dist.engine.lm_loop import LMTrainer as JaxLMTrainer
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    kw = dict(TINY_LM, max_steps=1, precision="bf16", attn=attn,
              attn_block=16, audit="record")
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jtr = JaxLMTrainer(JaxLMConfig(**kw, ledger_path=jpath))
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jtr.state.params))
    jtr.fit()
    LMTrainer(LMConfig(**kw, ledger_path=tpath), device="cpu",
              init_params=init).fit()

    def ids(path):
        recs = [json.loads(ln) for ln in open(path)]
        (ev,) = [r for r in recs if r["event"] == "audit"]
        return ev["program"], sorted({d["check"]
                                      for d in ev["detail"] or ()})

    got, want = ids(tpath), ids(jpath)
    assert got == want
    assert want[1] == (["PL004"] if attn == "blockwise" else [])
