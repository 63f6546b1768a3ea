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

Dropout draws as the reference's keys do (``:174``, ``plan/compile.py
:260-266``): the step's generator (``dropout_gen``, made by the trainer
from the seed, the global step and the data rank) goes to the model for
the forward (:func:`dropout_from`), and under accumulation microbatch
``i`` draws from :func:`fold_generator` of it and ``i``. The same seed and
step give the same masks, a resumed run draws what the uninterrupted one
drew, and ranks and microbatches differ.

Metrics stay 0-d tensors on the device (sums, so padded eval batches
divide exactly); the loop fetches them once per print window. The
reference packs uint8 rows into int32 words for the TPU's 32-bit gathers
(``pack_images_for_device``, ``:188-202``); the port gathers the uint8
rows directly.

Data parallelism (:class:`DataParallel`) runs one process per device; a
step's gradients are synced before :func:`apply_update`, so the loss-scale
flag, the ``health="skip"`` gate and the optimizers' clip slot read the
same values on every rank and the ranks stay in lockstep. The ``jit``
variant (the reference's GSPMD step over the global batch) averages the
gradients over the group, and its BatchNorm layers take their statistics
over the group's batch (``models.resnet.BatchNorm.process_group``). The
``shard_map`` variant is the reference's explicit-collective step
(``plan/compile.py:289-350 _image_explicit_train``), in its order:
predivide, compress, the sum (monolithic or in buckets), decompress,
postdivide, or the Adasum operator in place of all of that; then the
per-rank BatchNorm running stats are averaged. Both sum the metric sums
over the group.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from tpu_dist_torch.engine.state import TrainState
from tpu_dist_torch.obs.health import probe_update_metrics, probes_ok
from tpu_dist_torch.ops.precision import scale_loss, unscale_and_update
from tpu_dist_torch.parallel.collectives import (adasum_reduce, all_reduce_,
                                                 compress_grads)
from tpu_dist_torch.parallel.overlap import bucketed_grad_sync

IMAGE_METRIC_KEYS = ("loss_sum", "correct1", "correct5", "count")

_U64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
    return x ^ (x >> 31)


def fold_seed(*xs: int) -> int:
    """One 63-bit generator seed from integers, each folded in turn
    (splitmix64), the port's ``jax.random.fold_in``: distinct tuples give
    unrelated seeds."""
    h = 0
    for x in xs:
        h = _splitmix64(h ^ _splitmix64(int(x) & _U64))
    return h >> 1


def fold_generator(gen: torch.Generator, i: int) -> torch.Generator:
    """A new generator on ``gen``'s device seeded from ``gen``'s seed and
    ``i`` (the microbatch's ``fold_in``); ``gen`` itself is not drawn
    from."""
    return torch.Generator(device=gen.device).manual_seed(
        fold_seed(gen.initial_seed(), i))


@contextlib.contextmanager
def dropout_from(model, gen: Optional[torch.Generator]):
    """Inside the block ``model`` draws its dropout (and stochastic
    depth) from ``gen``; afterwards from its own generator again. A model
    that draws nothing (no ``dropout_gen``), or ``gen`` None, is left as
    it is."""
    own = getattr(model, "dropout_gen", None)
    if own is None or gen is None:
        yield
        return
    model.dropout_gen = gen
    try:
        yield
    finally:
        model.dropout_gen = own


@dataclass(frozen=True)
class DataParallel:
    """How a step syncs over the process group (``group`` None: one
    process, and the collectives are no-ops while the arithmetic of the
    variant still runs). ``bucket_mb`` 0 syncs in one collective per
    dtype."""
    group: Optional[Any] = None
    size: int = 1
    variant: str = "jit"
    compression: str = "none"
    predivide: float = 1.0
    adasum: bool = False
    bucket_mb: float = 0.0

    def mean(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients averaged over the group: ``rs_ag`` buckets of
        ``bucket_mb`` or one ``all_reduce`` per dtype."""
        if self.bucket_mb > 0:
            return bucketed_grad_sync(grads, self.bucket_mb, mean=True,
                                      group=self.group)
        if self.group is None:
            return grads
        return bucketed_grad_sync(grads, math.inf, mean=True, impl="psum",
                                  group=self.group)

    def grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The step's gradients synced by the variant's rule."""
        if self.variant == "jit":
            return self.mean(grads)
        if self.adasum:
            return adasum_reduce(grads, self.group)
        n = self.size
        pre = self.predivide if self.predivide != 1.0 else n
        down, up = compress_grads([g / pre for g in grads], self.compression)
        if self.bucket_mb > 0:
            down = bucketed_grad_sync(down, self.bucket_mb, mean=False,
                                      group=self.group)
        elif self.group is not None:
            down = bucketed_grad_sync(down, math.inf, mean=False,
                                      impl="psum", group=self.group)
        grads = up(down)
        if self.predivide != 1.0:
            grads = [g * (self.predivide / n) for g in grads]
        return grads

    def stats(self, stats: List[torch.Tensor]) -> None:
        """``shard_map``: the per-rank BatchNorm running stats averaged
        over the group, in place (``jit`` took them over the group's batch
        already)."""
        if self.variant == "shard_map" and self.group is not None and stats:
            for s, m in zip(stats, bucketed_grad_sync(
                    stats, math.inf, mean=True, impl="psum",
                    group=self.group)):
                s.copy_(m)

    def metrics(self, metrics: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """The metric sums summed over the group, in one all-reduce."""
        if self.group is None:
            return metrics
        keys = list(metrics)
        flat = torch.stack([metrics[k].float() for k in keys])
        all_reduce_(flat, self.group)
        return dict(zip(keys, flat.unbind()))


ONE_PROCESS = DataParallel()


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
                 old_stats: Optional[List[torch.Tensor]] = None,
                 sq_norm=None, probe_sync=None) -> Dict[str, torch.Tensor]:
    """Apply one optimizer step to ``state`` in place (``tx`` is a fused
    optimizer with ``apply`` -- ``FusedSGD``, ``FusedAdamW`` -- or an
    optax-protocol :class:`~tpu_dist_torch.ops.optim.Optimizer`); returns
    ``metrics`` with the probes added. ``grads`` are scaled by the state's
    loss scale where it has one. ``old_stats`` are the BN running stats
    from before this step's forward (the caller copies them under
    ``health='skip'``). ``sq_norm`` (a list of leaves -> their global sum
    of squares) gives the probes' norms over sharded leaves;
    ``probe_sync`` (probes -> probes) makes them one value on every rank
    where the grads are not fully synced (the pipeline's stage-local
    blocks). No host sync."""
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
    probes = probe_update_metrics(grads, old, params, sq_norm)
    if scaled:   # a routine overflow reports clean zeros
        probes = {k: torch.where(finite, v, torch.zeros_like(v))
                  for k, v in probes.items()}
    if probe_sync is not None:
        probes = probe_sync(probes)
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
                     accum: int = 1, dp: DataParallel = ONE_PROCESS,
                     dropout_gen: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
    """One optimizer step on device-resident uint8 (B, H, W, C) images and
    int labels (``model`` in train mode): normalize (and augment with
    ``gen``), forward (dropout drawn from ``dropout_gen``, microbatch ``i``
    from its fold with ``i``; None: the model's own generator), the
    (scaled) mean cross entropy's gradient over ``accum`` microbatches,
    the sync over ``dp``'s group, the update. Returns the step's metric
    sums (over the group) with the health probes."""
    old_stats = ([b.clone() for b in state.batch_stats]
                 if health == "skip" else None)
    drops = iter([fold_generator(dropout_gen, i) for i in range(accum)]
                 if accum > 1 and dropout_gen is not None
                 else [dropout_gen] * accum)

    def micro(imgs, lbls):
        with dropout_from(model, next(drops)):
            logits = model(transform(imgs, gen))
        loss_sum = cross_entropy_sum(logits, lbls)
        metrics = _metric_sums(logits.detach(), lbls, loss_sum.detach())
        loss = scale_loss(loss_sum / lbls.shape[0], state.loss_scale)
        return list(torch.autograd.grad(loss, state.params)), metrics

    if accum > 1:
        grads, metrics = accumulate(micro, accum, images_u8, labels)
    else:
        grads, metrics = micro(images_u8, labels)
    grads = dp.grads(grads)
    dp.stats(state.batch_stats)
    return apply_update(tx, state, grads, dp.metrics(metrics), health,
                        old_stats)


@torch.inference_mode()
def image_eval_metrics(model, transform, images_u8, labels,
                       valid) -> Dict[str, torch.Tensor]:
    """Forward-only metric sums (``model`` in eval mode: BN reads its
    running stats); ``valid`` (B,) 0/1 masks sampler wrap-padding rows out
    of every sum."""
    logits = model(transform(images_u8))
    loss_sum = cross_entropy_sum(logits, labels, valid)
    return _metric_sums(logits, labels, loss_sum, valid)
