"""LM training in the port against the reference, on CPU:

* the corpus and the sampler are numpy copies: token rows and row order
  are bit-equal to the reference's;
* ``LMTrainer`` at the reference's ``TINY`` (``tests/test_lm_loop.py``),
  started from the JAX trainer's initial params, for ``(attn, optimizer)``
  in ``{(full, sgd), (flash, fused_adamw)}``: per-step losses within 1e-5
  relative and final params leaf by leaf (tolerances at the test);
* eval is exact under sampler padding, ``max_steps`` caps the run, the
  ``audit`` knob records one event (an unknown mode raises
  ``ValueError``), and a data axis wider than the process count raises
  ``ValueError``;
* training-mode details: fp32 masters under bf16, remat, ``health=skip``,
  and the entry script end to end."""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.configs import LMConfig as JaxLMConfig  # noqa: E402
from tpu_dist.data import tokens as jtok  # noqa: E402
from tpu_dist.data.sampler import DistributedSampler as JaxSampler  # noqa: E402
from tpu_dist.engine.lm_loop import LMTrainer as JaxLMTrainer  # noqa: E402
from tpu_dist_torch.configs import LMConfig  # noqa: E402
from tpu_dist_torch.data import tokens as ttok  # noqa: E402
from tpu_dist_torch.data.sampler import DistributedSampler  # noqa: E402
from tpu_dist_torch.engine.lm_loop import LMTrainer  # noqa: E402
from tpu_dist_torch.interop import export_flax_params  # noqa: E402

torch.set_num_threads(1)

TINY = dict(batch_size=8, seq_len=32, d_model=32, num_layers=2, num_heads=2,
            vocab_size=64, synth_tokens=3000, seed=3, print_freq=100,
            epochs=1, lr=1e-2)


def _losses(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r["loss"] for r in recs if r["event"] == "step"]


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---- corpus and sampler ---------------------------------------------------

@pytest.mark.parametrize("seq_len,val_frac", [(32, 0.05), (17, 0.21)])
def test_token_rows_bit_equal(tmp_path, seq_len, val_frac):
    kw = dict(val_frac=val_frac, synth_tokens=5000, seed=7)
    for ref, port in zip(jtok.load_token_dataset("", seq_len, 97, **kw),
                         ttok.load_token_dataset("", seq_len, 97, **kw)):
        assert (len(ref), ref.vocab_size) == (len(port), port.vocab_size)
        np.testing.assert_array_equal(ref.rows_array(), port.rows_array())
        idx = np.array([0, len(ref) - 1, 3])
        np.testing.assert_array_equal(ref.get_rows(idx), port.get_rows(idx))
    path = str(tmp_path / "toks.npy")
    np.save(path, jtok.synthetic_stream(4000, 300, seed=1))
    ref = jtok.load_token_dataset(path, seq_len, 64)
    port = ttok.load_token_dataset(path, seq_len, 64)
    assert ref[0].vocab_size == port[0].vocab_size > 64   # inferred
    np.testing.assert_array_equal(ref[1].rows_array(), port[1].rows_array())


@pytest.mark.parametrize("n,world,rank,shuffle,batch,drop", [
    (90, 1, 0, True, 8, False), (90, 1, 0, False, 8, False),
    (37, 2, 1, True, 4, False), (50, 3, 2, True, None, False),
    (64, 2, 0, True, 8, True)])
def test_sampler_rows_bit_equal(n, world, rank, shuffle, batch, drop):
    for epoch in range(3):
        got = []
        for cls in (JaxSampler, DistributedSampler):
            s = cls(n, world, rank, shuffle=shuffle, seed=3, batch_size=batch,
                    drop_last=drop)
            s.set_epoch(epoch)
            got.append(s.indices_with_valid())
        np.testing.assert_array_equal(got[0][0], got[1][0])
        np.testing.assert_array_equal(got[0][1], got[1][1])


# ---- the trainer against the reference -----------------------------------

# fused_adamw: Adam divides each update by sqrt(v), so a gradient entry near
# zero moves its parameter by up to lr whichever way its sign falls; fp32
# summation-order differences in such entries can move a parameter by a
# fraction of lr (3e-3 here). Every other entry agrees to fp32 rounding.
PARITY = {("full", "sgd"): dict(lr=1e-2, atol=1e-6),
          ("flash", "fused_adamw"): dict(lr=3e-3, atol=5e-4)}


@pytest.mark.parametrize("attn,optimizer", list(PARITY), ids=str)
def test_trainer_matches_reference_trainer(tmp_path, attn, optimizer):
    par = PARITY[(attn, optimizer)]
    kw = dict(TINY, attn=attn, optimizer=optimizer, lr=par["lr"],
              attn_block=16, max_steps=6, print_freq=2,
              **({"grad_clip": 0.5, "weight_decay": 0.1}
                 if optimizer == "fused_adamw" else {}))
    ref = JaxLMTrainer(JaxLMConfig(ledger_path=str(tmp_path / "j.jsonl"),
                                   **kw))
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(ref.state.params))
    ref.fit()
    port = LMTrainer(LMConfig(ledger_path=str(tmp_path / "t.jsonl"), **kw),
                     device="cpu", init_params=init)
    port.fit()
    assert port.state.step == int(jax.device_get(ref.state.step)) == 6
    np.testing.assert_allclose(_losses(tmp_path / "t.jsonl"),
                               _losses(tmp_path / "j.jsonl"), rtol=1e-5)
    got = _flat(export_flax_params(port.model))
    want = _flat(jax.device_get(ref.state.params))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-5,
                                   atol=par["atol"], err_msg=path)
    assert port.best_ppl == pytest.approx(ref.best_ppl, rel=1e-5)


def test_int8_trainer_matches_reference_trainer(tmp_path):
    """``quant="int8"``: every dense layer through the fused int8 matmul
    (the plain version on the CPU; the JAX trainer's CPU path is
    ``quant_einsum``, the same numerics), STE backward. Step 0's loss agrees
    to fp32 rounding. After it, int8 rounding is discontinuous: an fp32
    rounding difference that moves an activation or weight across a
    rounding boundary flips one int8 value by one step (1/127 of its row's
    or column's range), so losses drift apart by up to about 1e-4 relative
    over 3 sgd steps; 2e-4 bounds it."""
    kw = dict(TINY, quant="int8", optimizer="sgd", max_steps=3,
              print_freq=1)
    ref = JaxLMTrainer(JaxLMConfig(ledger_path=str(tmp_path / "j.jsonl"),
                                   **kw))
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(ref.state.params))
    ref.fit()
    port = LMTrainer(LMConfig(ledger_path=str(tmp_path / "t.jsonl"), **kw),
                     device="cpu", init_params=init)
    assert port.model.blocks[0].qkv.mode == "int8"
    port.fit()
    got, want = _losses(tmp_path / "t.jsonl"), _losses(tmp_path / "j.jsonl")
    assert len(got) == len(want) == 3
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    with open(tmp_path / "t.jsonl") as f:
        steps = [json.loads(line) for line in f]
    # the fused flag marks the kernel, which only a CUDA run launches
    assert [r["fused"] for r in steps if r["event"] == "step"] == [False] * 3


def test_eval_exact_under_padding():
    """Held-out loss masks sampler wrap-padding: validate() equals a
    forward over exactly the real val rows."""
    from tpu_dist_torch.engine.lm_steps import (lm_loss_and_metrics,
                                                make_lm_batches)

    tr = LMTrainer(LMConfig(**{**TINY, "val_frac": 0.21}), device="cpu")
    n_val = len(tr.val_ds)
    assert n_val % tr.cfg.batch_size != 0    # padding actually exercised
    tr.train_epoch(0)
    loss, _, acc = tr.validate(0)
    inputs, targets = make_lm_batches(tr.val_ds.rows_array())
    with torch.inference_mode():
        logits = tr.model(torch.from_numpy(inputs).long())
        _, ref = lm_loss_and_metrics(logits, torch.from_numpy(targets),
                                     torch.ones(targets.shape))
    assert float(ref["count"]) == n_val * tr.cfg.seq_len
    assert loss == pytest.approx(float(ref["loss_sum"] / ref["count"]),
                                 rel=1e-5)
    assert acc == pytest.approx(float(ref["correct1"] / ref["count"]),
                                rel=1e-5)


def test_max_steps_caps_run(tmp_path):
    path = str(tmp_path / "run.jsonl")
    tr = LMTrainer(LMConfig(max_steps=3, ledger_path=path, **TINY),
                   device="cpu")
    tr.fit()
    assert tr.state.step == 3
    assert len(_losses(path)) == 3
    with open(path) as f:
        events = [json.loads(line)["event"] for line in f]
    assert events[0] == "run_start" and events[-1] == "run_end"
    assert {"eval", "epoch"} <= set(events)


@pytest.mark.parametrize("mode", ["record", "x"])
def test_audit_knob_records_one_event_or_names_the_modes(tmp_path, mode):
    """The ``audit`` knob: ``record`` emits one ``audit`` event for the
    run's one program (``train_step``, clean); an unknown mode raises
    ValueError naming the modes."""
    path = str(tmp_path / "run.jsonl")
    cfg = LMConfig(**TINY, audit=mode, ledger_path=path, max_steps=3)
    if mode == "x":
        with pytest.raises(ValueError,
                           match=r"audit='x'.*'none', 'record', 'halt'"):
            LMTrainer(cfg, device="cpu")
        return
    LMTrainer(cfg, device="cpu").fit()
    with open(path) as f:
        audits = [r for r in map(json.loads, f) if r["event"] == "audit"]
    assert [(a["program"], a["mode"], a["findings"]) for a in audits] == \
        [("train_step", "record", 0)]


def test_mesh_wider_than_the_process_count_raises():
    with pytest.raises(ValueError, match="one process per device"):
        LMTrainer(LMConfig(**{**TINY, "mesh_shape": (2,)}), device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LMTrainer(LMConfig(**TINY))


# ---- training-mode details ------------------------------------------------

def test_bf16_keeps_fp32_masters_and_remat_changes_nothing():
    kw = dict(TINY, precision="bf16", attn="flash")
    a = LMTrainer(LMConfig(**kw), device="cpu")
    b = LMTrainer(LMConfig(remat=True, **kw), device="cpu")
    b.model.load_state_dict(a.model.state_dict())
    assert all(p.dtype == torch.float32 for p in a.state.params)
    assert a.model.blocks[0].qkv.dtype == torch.bfloat16
    tok = torch.from_numpy(a.train_ds.get_rows(np.arange(4))).long()
    grads = []
    for tr in (a, b):
        loss = tr.model(tok[:, :-1]).float().logsumexp(-1).mean()
        grads.append(torch.autograd.grad(loss, tr.state.params))
    for ga, gb in zip(*grads):
        torch.testing.assert_close(ga, gb, rtol=0, atol=0)


def test_health_skip_keeps_state_on_nonfinite_grads():
    from tpu_dist_torch.engine.steps import apply_update

    tr = LMTrainer(LMConfig(**{**TINY, "optimizer": "fused_adamw",
                               "health": "skip"}), device="cpu")
    before = [p.detach().clone() for p in tr.state.params]
    grads = [torch.ones_like(p) for p in tr.state.params]
    grads[3] = grads[3].clone()
    grads[3].view(-1)[0] = float("inf")
    m = apply_update(tr.tx, tr.state, grads, {}, health="skip")
    assert tr.state.step == 1 and float(m["nonfinite_count"]) == 1.0
    for p, b in zip(tr.state.params, before):
        assert torch.equal(p, b)
    assert all(float(t.abs().sum()) == 0 for t in tr.state.opt_tensors())
    m = apply_update(tr.tx, tr.state, [torch.ones_like(p)
                                       for p in tr.state.params], {},
                     health="skip")
    assert float(m["update_norm"]) > 0 and tr.state.step == 2


def test_export_matches_the_flax_tree_layout():
    ref = JaxLMTrainer(JaxLMConfig(**TINY))
    tree = jax.device_get(ref.state.params)
    port = LMTrainer(LMConfig(**TINY), device="cpu",
                     init_params=jax.tree_util.tree_map(np.asarray, tree))
    got, want = _flat(export_flax_params(port.model)), _flat(tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    logits = ref.model.apply({"params": tree}, jnp.zeros((1, 8), jnp.int32),
                             train=False)
    with torch.inference_mode():
        tl = port.model(torch.zeros((1, 8), dtype=torch.long))
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), rtol=1e-5,
                               atol=1e-5)


def test_entry_script_trains_generates_and_serves(capsys):
    from tpu_dist_torch.scripts import lm_longcontext

    lm_longcontext.main([
        "--device", "cpu", "--batch-size", "8", "--seq-len", "48",
        "--d-model", "32", "--num-layers", "1", "--num-heads", "2",
        "--vocab-size", "64", "--synth-tokens", "6000", "--epochs", "2",
        "--attn", "flash", "--optimizer", "fused_adamw", "--lr", "3e-3",
        "--print-freq", "100", "--mesh", "data=1", "--generate", "8",
        "--serve", "2"])
    out = capsys.readouterr().out
    assert "mode=dp" in out and "throughput" in out
    gen = [line for line in out.splitlines() if line.startswith("generated")]
    assert gen and int(gen[0].split(",")[1].split("/")[0]) >= 4
    assert "served 3/3 requests" in out and "chunk ticks" in out
    # the stage axis is ported; the reference's own refusal of it with
    # fsdp (lm_loop.py:416) stands, before any group is needed
    with pytest.raises(ValueError, match="'stage' mesh axis does not "
                                         "compose with fsdp"):
        lm_longcontext.main(["--device", "cpu", "--mesh", "data=1,stage=2",
                             "--fsdp"])
