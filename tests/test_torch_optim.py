"""The optax-protocol optimizers under ``health="skip"``, port against
reference, on CPU: three steps whose middle step's gradient holds a NaN,
each through the engines' own update funnel (the reference's
``engine.steps._apply_update`` and the port's ``apply_update``). The
skipped step must leave the params and the optimizer's schedule count
where they were, so the third step reads the same learning rate (and,
for AdamW, the same bias corrections) in both. Params agree within
1e-6 * (1 + |ref|), the counts exactly. ``update`` writes the state it
is given in place."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.engine.state import TrainState as JaxTrainState  # noqa: E402
from tpu_dist.engine.steps import _apply_update as jax_apply  # noqa: E402
from tpu_dist.ops import optim as jopt  # noqa: E402
from tpu_dist_torch.engine.state import TrainState  # noqa: E402
from tpu_dist_torch.engine.steps import apply_update  # noqa: E402
from tpu_dist_torch.ops import optim as topt  # noqa: E402

torch.set_num_threads(1)

SHAPES = {"w": (7, 33), "b": (33,)}


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_skipped_step_leaves_params_and_count_as_reference(kind):
    # the lr drops 10x at count 2: a count that advanced on the skipped
    # step would make the third step read the dropped lr
    kw = dict(momentum=0.9, weight_decay=1e-4, kind=kind, b2=0.999)
    ref = jopt.make_optimizer(0.1, schedule=jopt.step_decay_schedule(
        0.1, steps_per_epoch=1, step_epochs=2), **kw)
    port = topt.make_optimizer(0.1, schedule=topt.step_decay_schedule(
        0.1, steps_per_epoch=1, step_epochs=2), **kw)
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    names = list(SHAPES)
    jstate = JaxTrainState.create({k: jnp.asarray(v) for k, v in init.items()},
                                  {}, ref)
    params = [torch.from_numpy(init[k].copy()) for k in names]
    tstate = TrainState(step=0, params=params, opt_state=port.init(params))
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) * 0.5
             for k, s in SHAPES.items()}
        if step == 1:
            g["w"][2, 3] = np.nan
        jstate, jm = jax_apply(ref, jstate, {k: jnp.asarray(v)
                                             for k, v in g.items()},
                               {}, {}, health="skip")
        tm = apply_update(port, tstate, [torch.from_numpy(g[k])
                                         for k in names], {}, health="skip")
        assert float(tm["nonfinite_count"]) == float(jm["nonfinite_count"])
    counts = [int(v) for p, v in jax.tree_util.tree_leaves_with_path(
        jstate.opt_state) if jax.tree_util.keystr(p).endswith("count")]
    assert counts and set(counts) == {2}
    assert int(tstate.opt_state.count) == 2 and tstate.step == 3
    for i, k in enumerate(names):
        want = np.asarray(jstate.params[k])
        got = tstate.params[i].numpy()
        assert np.all(np.abs(got - want) <= 1e-6 * (1 + np.abs(want))), k


def test_schedules_take_a_device_count_without_a_host_value():
    """The schedules evaluate on a 0-d tensor count and return a 0-d
    tensor (no host read), matching their value at the same host int."""
    for sched in (topt.step_decay_schedule(0.1, 3, 2),
                  topt.lm_lr_schedule(0.1, "cosine", warmup_steps=2,
                                      total_steps=9)):
        for step in range(12):
            t = sched(torch.tensor(step, dtype=torch.int32))
            assert torch.is_tensor(t) and t.dim() == 0
            assert t.dtype == torch.float32
            assert float(t) == pytest.approx(sched(step), rel=1e-7)


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_update_writes_the_state_in_place(kind):
    """``update`` hands back the state it was given, its count and every
    moment in their own storage: no second state is allocated."""
    port = topt.make_optimizer(0.1, kind=kind, weight_decay=1e-4)
    params = [torch.ones(SHAPES[k]) for k in SHAPES]
    state = port.init(params)
    ptrs = [t.data_ptr() for t in (state.count, *state.mu, *state.nu)]
    for n in range(1, 3):
        _, new = port.update([torch.full_like(p, 0.5) for p in params],
                             state, params)
        assert new is state and int(state.count) == n
    assert [t.data_ptr() for t in (new.count, *new.mu, *new.nu)] == ptrs
    assert all(float(m.abs().sum()) > 0 for m in new.mu)
