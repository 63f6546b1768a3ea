"""Language-model train/eval steps for the port
(``tpu_dist/engine/lm_steps.py``): the data-parallel step on one device.

* :func:`make_lm_batches` shifts (B, L+1) host rows into inputs and
  targets before anything reaches the device; :func:`shift_rows` does the
  same on the device for the windowed path's gathered rows;
* :func:`lm_loss_and_metrics` is the reference's objective (``:65-84``):
  per-token ``logsumexp - target logit`` in fp32, summed under a mask, the
  mean taken over ``count``; :func:`lm_objective` picks it or, with
  ``loss_chunk > 0``, the chunked head (``ops.fused_xent``; the model
  returns its post-LayerNorm features and the (B, L, V) logits never
  exist), as ``_lm_objective_metrics`` (``:137-148``) does;
* :func:`lm_train_step` is the dp step (``:150-190``): forward, the mean
  loss's gradient w.r.t. every parameter, then ``engine.steps.apply_update``;
  with ``accum > 1`` the gradients of equal microbatches are averaged
  before the one update (``make_lm_grad_accum_train_step``, ``:373-395``);
* :func:`lm_eval_metrics` is the forward-only eval (``:271-285``), exact
  under sampler padding through the per-row ``valid`` mask.

Metric values stay 0-d tensors on the device; the loop fetches them once
per print window. The sharded steps are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tpu_dist_torch.engine.state import TrainState
from tpu_dist_torch.engine.steps import accumulate, apply_update
from tpu_dist_torch.ops.fused_xent import chunked_softmax_xent

LM_METRIC_KEYS = ("loss_sum", "correct1", "count")


def zeros_lm_metrics(device) -> Dict[str, torch.Tensor]:
    """Additive identity for :func:`lm_loss_and_metrics` sums."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in LM_METRIC_KEYS}


def make_lm_batches(tokens: np.ndarray):
    """Host side: (B, L+1) token rows -> (inputs (B, L), targets (B, L))."""
    return tokens[:, :-1], tokens[:, 1:]


def shift_rows(rows: torch.Tensor):
    """Device side: (B, L+1) token rows -> int64 (inputs, targets)."""
    rows = rows.long()
    return rows[:, :-1], rows[:, 1:]


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


def lm_objective(model, inputs, targets, mask, loss_chunk: int = 0):
    """(loss_sum, metric sums) of the model on (B, L) ``inputs``: through
    the full logits, or with ``loss_chunk > 0`` through the chunked head
    on the model's features (its lm_head kernel straight from the model,
    so the kernel's gradient flows through the chunked backward)."""
    if not loss_chunk:
        return lm_loss_and_metrics(model(inputs), targets, mask)
    feats = model(inputs, return_features=True)
    loss_sum, correct = chunked_softmax_xent(
        feats, model.lm_head.kernel, targets, mask, loss_chunk, model.dtype)
    return loss_sum, {"loss_sum": loss_sum.detach(), "correct1": correct,
                      "count": mask.sum()}


def lm_train_step(model, tx, state: TrainState, inputs, targets,
                  health: str = "record", loss_chunk: int = 0,
                  accum: int = 1) -> Dict[str, torch.Tensor]:
    """One optimizer step on device-resident (B, L) ``inputs``/``targets``:
    the mean CE over the batch (over each of ``accum`` microbatches), its
    gradient, the update. Returns the step's metric sums (with the health
    probes)."""

    def micro(inp, tgt):
        mask = torch.ones(tgt.shape, dtype=torch.float32, device=tgt.device)
        loss_sum, metrics = lm_objective(model, inp, tgt, mask, loss_chunk)
        mean = loss_sum / torch.clamp(metrics["count"], min=1.0)
        return list(torch.autograd.grad(mean, state.params)), metrics

    if accum > 1:
        grads, metrics = accumulate(micro, accum, inputs, targets)
    else:
        grads, metrics = micro(inputs, targets)
    return apply_update(tx, state, grads, metrics, health)


@torch.inference_mode()
def lm_eval_metrics(model, inputs, targets, valid,
                    loss_chunk: int = 0) -> Dict[str, torch.Tensor]:
    """Forward-only metric sums; ``valid`` (B,) 0/1 masks sampler
    wrap-padding rows out of every sum."""
    mask = valid.float()[:, None].expand(targets.shape)
    _, metrics = lm_objective(model, inputs, targets, mask, loss_chunk)
    return metrics
