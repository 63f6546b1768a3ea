"""The optimizer update with its health probes, for the port
(``tpu_dist/engine/steps.py:105-166 _apply_update``).

Every train step funnels its gradients through :func:`apply_update`, so the
probes (``grad_norm`` / ``nonfinite_count`` / ``update_norm``) join each
step's metric sums and ride the loop's one fetch per print window.
``health='skip'`` gates the step on the probes on the device: a non-finite
gradient or update leaves the parameters and optimizer state as they were
(restored from copies taken before the in-place update) while the step
counter still advances. The optax-protocol optimizers keep their schedule
count on the host, so under ``skip`` that count advances with the step
counter (the reference also reverts it); the fused optimizer reads the
step counter itself, as the reference's does. The image-trainer steps and
the fp16 loss scale are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from tpu_dist_torch.engine.state import TrainState
from tpu_dist_torch.obs.health import probe_update_metrics, probes_ok


@torch.no_grad()
def apply_update(tx, state: TrainState, grads: List[torch.Tensor],
                 metrics: Dict[str, torch.Tensor],
                 health: str = "record") -> Dict[str, torch.Tensor]:
    """Apply one optimizer step to ``state`` in place (``tx`` is a
    :class:`~tpu_dist_torch.ops.pallas_adamw.FusedAdamW` or an
    :class:`~tpu_dist_torch.ops.optim.Optimizer`); returns ``metrics`` with
    the probes added. No host sync."""
    params = state.params
    old = [p.detach().clone() for p in params]
    old_opt = ([t.clone() for t in state.opt_tensors()]
               if health == "skip" else None)
    if hasattr(tx, "apply"):      # fused kernel: params and moments in place
        state.opt_state = tx.apply(params, grads, state.opt_state, state.step)
    else:                          # optax protocol: updates, then p + u
        updates, state.opt_state = tx.update(grads, state.opt_state, params)
        for p, u in zip(params, updates):
            p.copy_((p.float() + u).to(p.dtype))
    probes = probe_update_metrics(grads, old, params)
    if health == "skip":
        ok = probes_ok(probes)
        for t, o in zip([*params, *state.opt_tensors()], [*old, *old_opt]):
            t.copy_(torch.where(ok, t, o))
    state.step += 1
    return {**metrics, **probes}
