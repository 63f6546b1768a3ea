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

With a loss scale on the state (``TrainState.loss_scale``) the loss is
scaled before the backward and the grads unscaled in :func:`apply_update`
(``:111-150``): a step whose grads are not all finite keeps the old
params and optimizer state (``torch.where`` against the device-side flag,
from copies taken before the in-place update), halves the scale, and
reports zero probes, so a routine overflow is never a health trip.

Gradient accumulation (``accum > 1``, the reference's
``make_grad_accum_train_step``, ``:299-318``) splits the batch into equal
microbatches, averages their gradients in fp32 and makes one optimizer
call per step; the metric sums add up over the microbatches and the BN
running stats advance once per microbatch.

Metrics stay 0-d tensors on the device (sums, so padded eval batches
divide exactly); the loop fetches them once per print window. The
reference packs uint8 rows into int32 words for the TPU's 32-bit gathers
(``pack_images_for_device``, ``:188-202``); the port gathers the uint8
rows directly.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from tpu_dist_torch.engine.state import TrainState
from tpu_dist_torch.obs.health import probe_update_metrics, probes_ok
from tpu_dist_torch.ops.precision import scale_loss, unscale_and_update

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
    ``metrics`` with the probes added. ``grads`` are scaled by the state's
    loss scale where it has one. ``old_stats`` are the BN running stats
    from before this step's forward (the caller copies them under
    ``health='skip'``). No host sync."""
    params = state.params
    old = [p.detach().clone() for p in params]
    scaled = state.loss_scale is not None
    grads, state.loss_scale, finite = unscale_and_update(grads,
                                                         state.loss_scale)
    old_opt = ([t.clone() for t in state.opt_tensors()]
               if health == "skip" or scaled else None)
    if hasattr(tx, "apply"):      # fused kernel: params and moments in place
        state.opt_state = tx.apply(params, grads, state.opt_state, state.step)
    else:                          # optax protocol: updates, then p + u
        updates, state.opt_state = tx.update(grads, state.opt_state, params)
        for p, u in zip(params, updates):
            p.copy_((p.float() + u).to(p.dtype))
    if scaled:   # an overflow step keeps the old params and optimizer state
        for t, o in zip([*params, *state.opt_tensors()], [*old, *old_opt]):
            t.copy_(torch.where(finite, t, o))
    probes = probe_update_metrics(grads, old, params)
    if scaled:   # a routine overflow reports clean zeros
        probes = {k: torch.where(finite, v, torch.zeros_like(v))
                  for k, v in probes.items()}
    if health == "skip":
        ok = probes_ok(probes)
        stats = state.batch_stats if old_stats is not None else []
        for t, o in zip([*params, *state.opt_tensors(), *stats],
                        [*old, *old_opt, *(old_stats or [])]):
            t.copy_(torch.where(ok, t, o))
    state.step += 1
    return {**metrics, **probes}


def accumulate(micro_fn, k: int, *batch):
    """Gradient accumulation over ``k`` equal microbatches of ``batch``
    (tensors split along dim 0): ``micro_fn(*micro)`` gives one
    microbatch's (grads, metric sums). Returns (the mean of the grads,
    in fp32, and the summed metrics)."""
    acc, sums = None, None
    for micro in zip(*(t.split(t.shape[0] // k) for t in batch)):
        grads, metrics = micro_fn(*micro)
        if acc is None:
            acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                   for g in grads]
            sums = metrics
        else:
            sums = {n: sums[n] + metrics[n] for n in sums}
        for a, g in zip(acc, grads):
            a.add_(g / k)
    return acc, sums


def image_train_step(model, tx, state: TrainState, images_u8, labels,
                     transform, health: str = "record",
                     gen: Optional[torch.Generator] = None,
                     accum: int = 1) -> Dict[str, torch.Tensor]:
    """One optimizer step on device-resident uint8 (B, H, W, C) images and
    int labels (``model`` in train mode): normalize (and augment with
    ``gen``), forward, the (scaled) mean cross entropy's gradient over
    ``accum`` microbatches, the update. Returns the step's metric sums with
    the health probes."""
    old_stats = ([b.clone() for b in state.batch_stats]
                 if health == "skip" else None)

    def micro(imgs, lbls):
        logits = model(transform(imgs, gen))
        loss_sum = cross_entropy_sum(logits, lbls)
        metrics = _metric_sums(logits.detach(), lbls, loss_sum.detach())
        loss = scale_loss(loss_sum / lbls.shape[0], state.loss_scale)
        return list(torch.autograd.grad(loss, state.params)), metrics

    if accum > 1:
        grads, metrics = accumulate(micro, accum, images_u8, labels)
    else:
        grads, metrics = micro(images_u8, labels)
    return apply_update(tx, state, grads, metrics, health, old_stats)


@torch.inference_mode()
def image_eval_metrics(model, transform, images_u8, labels,
                       valid) -> Dict[str, torch.Tensor]:
    """Forward-only metric sums (``model`` in eval mode: BN reads its
    running stats); ``valid`` (B,) 0/1 masks sampler wrap-padding rows out
    of every sum."""
    logits = model(transform(images_u8))
    loss_sum = cross_entropy_sum(logits, labels, valid)
    return _metric_sums(logits, labels, loss_sum, valid)
