"""Language-model train/eval steps for the port
(``tpu_dist/engine/lm_steps.py``): the data-parallel step on one device.

* :func:`make_lm_batches` shifts (B, L+1) host rows into inputs and
  targets before anything reaches the device;
* :func:`lm_loss_and_metrics` is the reference's objective (``:65-84``):
  per-token ``logsumexp - target logit`` in fp32, summed under a mask, the
  mean taken over ``count``;
* :func:`lm_train_step` is the dp step (``:150-190``): forward, the mean
  loss's gradient w.r.t. every parameter, then ``engine.steps.apply_update``;
* :func:`lm_eval_metrics` is the forward-only eval (``:271``), exact under
  sampler padding through the per-row ``valid`` mask.

Metric values stay 0-d tensors on the device; the loop fetches them once
per print window. The chunked head (``loss_chunk``), gradient accumulation
and the sharded steps are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tpu_dist_torch.engine.state import TrainState
from tpu_dist_torch.engine.steps import apply_update

LM_METRIC_KEYS = ("loss_sum", "correct1", "count")


def zeros_lm_metrics(device) -> Dict[str, torch.Tensor]:
    """Additive identity for :func:`lm_loss_and_metrics` sums."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in LM_METRIC_KEYS}


def make_lm_batches(tokens: np.ndarray):
    """Host side: (B, L+1) token rows -> (inputs (B, L), targets (B, L))."""
    return tokens[:, :-1], tokens[:, 1:]


def lm_loss_and_metrics(logits, targets, mask):
    """(loss_sum, metric sums) of next-token cross entropy. ``logits``
    (B, L, V), ``targets`` (B, L) int, ``mask`` (B, L) fp32. nll =
    logsumexp - target logit in fp32; ``correct1`` counts argmax hits
    (first maximal index on ties, as ``jnp.argmax``)."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    tgt = logits32.gather(-1, targets.long()[..., None])[..., 0]
    loss_sum = ((lse - tgt) * mask).sum()
    correct = (logits.argmax(dim=-1) == targets).float()
    return loss_sum, {"loss_sum": loss_sum.detach(),
                      "correct1": (correct * mask).sum(),
                      "count": mask.sum()}


def lm_train_step(model, tx, state: TrainState, inputs, targets,
                  health: str = "record") -> Dict[str, torch.Tensor]:
    """One optimizer step on device-resident (B, L) ``inputs``/``targets``:
    the mean CE over the batch, its gradient, the update. Returns the
    step's metric sums (with the health probes)."""
    logits = model(inputs)
    mask = torch.ones(targets.shape, dtype=torch.float32,
                      device=targets.device)
    loss_sum, metrics = lm_loss_and_metrics(logits, targets, mask)
    mean = loss_sum / torch.clamp(metrics["count"], min=1.0)
    grads = torch.autograd.grad(mean, state.params)
    del logits, loss_sum, mean
    return apply_update(tx, state, list(grads), metrics, health)


@torch.inference_mode()
def lm_eval_metrics(model, inputs, targets, valid) -> Dict[str, torch.Tensor]:
    """Forward-only metric sums; ``valid`` (B,) 0/1 masks sampler
    wrap-padding rows out of every sum."""
    mask = valid.float()[:, None].expand(targets.shape)
    _, metrics = lm_loss_and_metrics(model(inputs), targets, mask)
    return metrics
