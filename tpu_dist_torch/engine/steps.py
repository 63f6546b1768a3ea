"""Train/eval steps for the port (``tpu_dist/engine/steps.py``): the loss
and metric helpers (``:59-83``), the optimizer update with its health
probes (``:105-166 _apply_update``) and the image engine's train and eval
steps (``:86-102``, ``:169-185``), data-parallel on one device.

Every train step funnels its gradients through :func:`apply_update`, so the
probes (``grad_norm`` / ``nonfinite_count`` / ``update_norm``) join each
step's metric sums and ride the loop's one fetch per print window.
``health='skip'`` gates the step on the probes on the device: a non-finite
gradient or update leaves the parameters, the whole optimizer state (the
optax-style count included) and the BatchNorm running stats as they were
(restored from copies taken before the in-place update), while the step
counter still advances. The fused optimizers read that step counter, as
the reference's do.

Metrics stay 0-d tensors on the device (sums, so padded eval batches
divide exactly); the loop fetches them once per print window. The
reference packs uint8 rows into int32 words for the TPU's 32-bit gathers
(``pack_images_for_device``, ``:188-202``); the port gathers the uint8
rows directly. The fp16 loss scale is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from tpu_dist_torch.engine.state import TrainState
from tpu_dist_torch.obs.health import probe_update_metrics, probes_ok

IMAGE_METRIC_KEYS = ("loss_sum", "correct1", "correct5", "count")


def cross_entropy_sum(logits, labels, weights=None) -> torch.Tensor:
    """Summed (not averaged) NLL of the fp32 log_softmax; optional
    per-sample weights (the eval padding mask)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if weights is not None:
        nll = nll * weights
    return nll.sum()


def _metric_sums(logits, labels, loss_sum, weights=None):
    """Metric sums; ``weights`` (0/1 per sample) excludes sampler padding.
    top-1 takes the first maximal index on ties (``jnp.argmax``); top-5
    is top-``min(5, classes)``."""
    labels = labels.long()
    w = (torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
         if weights is None else weights)
    top1 = (logits.argmax(dim=-1) == labels).float()
    k = min(5, logits.shape[-1])
    topk = logits.topk(k, dim=-1).indices
    top5 = (topk == labels[:, None]).any(dim=-1).float()
    return {"loss_sum": loss_sum, "correct1": (top1 * w).sum(),
            "correct5": (top5 * w).sum(), "count": w.sum()}


def zeros_image_metrics(device) -> Dict[str, torch.Tensor]:
    """Additive identity for :func:`_metric_sums`."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in IMAGE_METRIC_KEYS}


@torch.no_grad()
def apply_update(tx, state: TrainState, grads: List[torch.Tensor],
                 metrics: Dict[str, torch.Tensor], health: str = "record",
                 old_stats: Optional[List[torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Apply one optimizer step to ``state`` in place (``tx`` is a fused
    optimizer with ``apply`` -- ``FusedSGD``, ``FusedAdamW`` -- or an
    optax-protocol :class:`~tpu_dist_torch.ops.optim.Optimizer`); returns
    ``metrics`` with the probes added. ``old_stats`` are the BN running
    stats from before this step's forward (the caller copies them under
    ``health='skip'``). No host sync."""
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
        stats = state.batch_stats if old_stats is not None else []
        for t, o in zip([*params, *state.opt_tensors(), *stats],
                        [*old, *old_opt, *(old_stats or [])]):
            t.copy_(torch.where(ok, t, o))
    state.step += 1
    return {**metrics, **probes}


def image_train_step(model, tx, state: TrainState, images_u8, labels,
                     transform, health: str = "record",
                     gen: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
    """One optimizer step on device-resident uint8 (B, H, W, C) images and
    int labels (``model`` in train mode): normalize (and augment with
    ``gen``), forward, the mean cross entropy's gradient, the update.
    Returns the step's metric sums with the health probes."""
    old_stats = ([b.clone() for b in state.batch_stats]
                 if health == "skip" else None)
    logits = model(transform(images_u8, gen))
    loss_sum = cross_entropy_sum(logits, labels)
    metrics = _metric_sums(logits.detach(), labels, loss_sum.detach())
    grads = torch.autograd.grad(loss_sum / labels.shape[0], state.params)
    del logits, loss_sum
    return apply_update(tx, state, list(grads), metrics, health, old_stats)


@torch.inference_mode()
def image_eval_metrics(model, transform, images_u8, labels,
                       valid) -> Dict[str, torch.Tensor]:
    """Forward-only metric sums (``model`` in eval mode: BN reads its
    running stats); ``valid`` (B,) 0/1 masks sampler wrap-padding rows out
    of every sum."""
    logits = model(transform(images_u8))
    loss_sum = cross_entropy_sum(logits, labels, valid)
    return _metric_sums(logits, labels, loss_sum, valid)
