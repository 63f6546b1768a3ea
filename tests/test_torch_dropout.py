"""Dropout in the port's image trainer draws as the reference's keys do
(``tpu_dist/engine/steps.py:174``, ``tpu_dist/plan/compile.py:260-266``):
from a generator that is a function of the seed, the global step, the
microbatch under ``grad_accum_steps`` and the data rank, never from
torch's global one. On LeNet (synthetic MNIST) and SqueezeNet 1.1
(synthetic CIFAR-10, 32 px), both with dropout, on the CPU:

* two runs with one seed give bit-equal per-step losses and the same
  masks; another seed draws other masks from step 0;
* a run stopped at step 5 and resumed from its checkpoint gives the
  uninterrupted run's losses and masks from step 5 on, bit-equal;
* with ``grad_accum_steps=2`` the two microbatches draw different masks;
* windowed dispatch (4 steps a dispatch from device-resident data) draws
  the per-batch run's masks, step by step;
* on two gloo ranks (``tests/torch_dp_worker.py``) the ranks draw
  different masks at every step;
* a model called outside a trainer draws from its own generator, seeded
  from ``seed``, and eval draws nothing.

torch and JAX never draw the same masks, so parity with the JAX package
stays in eval mode (``test_torch_resnet.py``, ``test_torch_zoo*.py``).
Masks are recorded by ``torch_dp_worker.dropout_recorder``, which replays
each draw from the generator's state and checks it against the output.
"""

import json
import os
import sys

import pytest
import torch

from tpu_dist_torch.configs import TrainConfig
from tpu_dist_torch.engine import checkpoint as ckpt
from tpu_dist_torch.engine.loop import Trainer
from tpu_dist_torch.engine.steps import dropout_from, fold_seed
from tpu_dist_torch.models import cnn_zoo, lenet
from tpu_dist_torch.models.registry import create_model

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dp_worker import dropout_recorder, run_group  # noqa: E402

torch.set_num_threads(1)

# 4 steps an epoch, 2 epochs; one draw a step for SqueezeNet, two for LeNet
ARCHS = {
    "lenet": dict(arch="lenet", dataset="mnist"),
    "squeezenet1_1": dict(arch="squeezenet1_1", dataset="cifar10"),
}
DRAWS_A_STEP = {"lenet": 2, "squeezenet1_1": 1}
TINY = dict(batch_size=16, epochs=2, synth_train_size=64,
            synth_val_size=32, precision="fp32", seed=0, print_freq=1,
            workers=1, log_csv="", optimizer="sgd", lr=0.05)
STEPS = 8


def _losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f)
                if r["event"] == "step"]


def _run(tmp_path, monkeypatch, arch, name, **kw):
    """Fit a trainer; returns (trainer, per-step losses, recorded draws)."""
    masks = []
    rec = dropout_recorder(masks)
    monkeypatch.setattr(cnn_zoo, "dropout", rec)
    monkeypatch.setattr(lenet, "dropout", rec)
    cfg = TrainConfig(**{**TINY, **ARCHS[arch],
                         "data": str(tmp_path / "no-data"),
                         "checkpoint_dir": str(tmp_path / f"{name}-ck"),
                         "ledger_path": str(tmp_path / f"{name}.jsonl"),
                         **kw})
    tr = Trainer(cfg, device="cpu")
    tr.fit()
    return tr, _losses(tmp_path / f"{name}.jsonl"), masks


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_same_seed_runs_are_bit_equal(tmp_path, monkeypatch, arch):
    a, la, ma = _run(tmp_path, monkeypatch, arch, "a")
    b, lb, mb = _run(tmp_path, monkeypatch, arch, "b")
    assert a.state.step == b.state.step == STEPS
    assert len(la) == STEPS and la == lb
    assert len(ma) == STEPS * DRAWS_A_STEP[arch] and ma == mb
    for p, q in zip(a.state.params, b.state.params):
        assert torch.equal(p, q)
    # a step's draws come from its own generator: no two steps share one
    assert len({seed for seed, _ in ma}) == STEPS


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_another_seed_draws_other_masks_from_step_0(tmp_path, monkeypatch,
                                                    arch):
    _, la, ma = _run(tmp_path, monkeypatch, arch, "a")
    _, lb, mb = _run(tmp_path, monkeypatch, arch, "b", seed=1)
    assert la[0] != lb[0]
    n = DRAWS_A_STEP[arch]
    for (sa, bits_a), (sb, bits_b) in zip(ma[:n], mb[:n]):
        assert sa != sb and bits_a != bits_b


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_resumed_run_equals_the_uninterrupted_one(tmp_path, monkeypatch,
                                                  arch):
    _, full, full_masks = _run(tmp_path, monkeypatch, arch, "full")
    step = Trainer._step

    def interrupt_at_5(self, images, labels, gstep):
        if gstep == 5:
            raise KeyboardInterrupt
        return step(self, images, labels, gstep)

    monkeypatch.setattr(Trainer, "_step", interrupt_at_5)
    with pytest.raises(KeyboardInterrupt):
        _run(tmp_path, monkeypatch, arch, "cut")
    monkeypatch.setattr(Trainer, "_step", step)
    path = str(tmp_path / "cut-ck" / f"{arch}-checkpoint.pt")
    assert ckpt.read_checkpoint_meta(path)["step"] == 5
    tr, resumed, masks = _run(tmp_path, monkeypatch, arch, "resumed",
                              resume=path)
    assert tr.state.step == STEPS
    assert resumed == full[5:]
    assert masks == full_masks[5 * DRAWS_A_STEP[arch]:]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_accumulation_microbatches_draw_different_masks(tmp_path,
                                                        monkeypatch, arch):
    _, la, ma = _run(tmp_path, monkeypatch, arch, "a", grad_accum_steps=2)
    _, lb, mb = _run(tmp_path, monkeypatch, arch, "b", grad_accum_steps=2)
    n = DRAWS_A_STEP[arch]
    assert la == lb and ma == mb and len(ma) == STEPS * 2 * n
    for s in range(STEPS):
        first, second = ma[2 * n * s:2 * n * s + n], ma[2 * n * s + n:
                                                       2 * n * (s + 1)]
        for (s0, bits0), (s1, bits1) in zip(first, second):
            assert s0 != s1 and bits0 != bits1


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_windowed_dispatch_draws_the_per_batch_masks(tmp_path, monkeypatch,
                                                     arch):
    host, _, host_masks = _run(tmp_path, monkeypatch, arch, "host",
                               data_placement="host")
    win, _, win_masks = _run(tmp_path, monkeypatch, arch, "win",
                             steps_per_dispatch=4, data_placement="device")
    assert not host.device_data and win.device_data
    assert len(host_masks) == STEPS * DRAWS_A_STEP[arch]
    assert win_masks == host_masks


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dropout_ranks"))
    jobs = [{"kind": "dropout", "name": arch,
             "cfg": {**TINY, **ARCHS[arch], "data": "no-data",
                     "mesh_shape": [2]}}
            for arch in sorted(ARCHS)]
    return run_group(2, {"jobs": jobs}, out)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_data_ranks_draw_different_masks(two_ranks, arch):
    r0, r1 = (r[arch] for r in two_ranks)
    assert r0["world"] == r1["world"] == 2
    assert r0["step"] == r1["step"] == STEPS
    n = DRAWS_A_STEP[arch]
    assert len(r0["masks"]) == len(r1["masks"]) == STEPS * n
    for (s0, h0), (s1, h1) in zip(r0["masks"], r1["masks"]):
        assert s0 != s1 and h0 != h1
    # each step's draws: a function of (seed, step, rank) alone
    assert [s for s, _ in r0["masks"][::n]] != \
        [s for s, _ in r1["masks"][::n]]


def _model(arch, seed=0):
    shape = (28, 28, 1) if arch == "lenet" else (32, 32, 3)
    return create_model(arch, num_classes=10, dtype=torch.float32,
                        image_shape=shape, device="cpu", seed=seed), shape


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_a_model_outside_a_trainer_draws_from_its_own_seed(arch):
    (m1, shape), (m2, _) = _model(arch), _model(arch)
    x = torch.rand(4, *shape, generator=torch.Generator().manual_seed(3))
    m1.train()
    m2.train()
    a1, a2, b1 = m1(x), m1(x), m2(x)
    assert torch.equal(a1, b1)              # same seed, same first draw
    assert not torch.equal(a1, a2)          # the generator advances
    # eval draws nothing: the generator's state stays where it was
    m1.eval()
    state = m1.dropout_gen.get_state()
    y0, y1 = m1(x), m1(x)
    assert torch.equal(y0, y1)
    assert torch.equal(m1.dropout_gen.get_state(), state)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dropout_from_hands_the_step_generator_and_restores(arch):
    m, shape = _model(arch)
    m.train()
    own = m.dropout_gen
    x = torch.rand(4, *shape, generator=torch.Generator().manual_seed(4))
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(fold_seed(0, 7, 0))
        with dropout_from(m, gen):
            assert m.dropout_gen is gen
            outs.append(m(x))
        assert m.dropout_gen is own
    assert torch.equal(outs[0], outs[1])
    own_state = own.get_state()
    with dropout_from(m, None):            # None: the model's own
        m(x)
    assert not torch.equal(own.get_state(), own_state)


def test_fold_seed_separates_steps_microbatches_and_ranks():
    seeds = {fold_seed(s, step, rank) for s in range(3) for step in range(64)
             for rank in range(4)}
    assert len(seeds) == 3 * 64 * 4
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert fold_seed(0, 1, 2) == fold_seed(0, 1, 2) != fold_seed(0, 2, 1)
