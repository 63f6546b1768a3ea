"""Language-model train/eval steps for the port
(``tpu_dist/engine/lm_steps.py``): one step body for every parallel mode.

* :func:`make_lm_batches` shifts (B, L+1) host rows into inputs and
  targets before anything reaches the device or is sharded (``:28-37``: a
  sequence shard's targets then hold the next shard's first token, so no
  boundary needs a mask); :func:`shift_rows` does the same on the device
  for the windowed path's gathered rows;
* :func:`lm_loss_and_metrics` is the reference's objective (``:65-84``):
  per-token ``logsumexp - target logit`` in fp32, summed under a mask, the
  mean taken over ``count``; :func:`lm_objective` picks it, the
  vocab-sharded cross entropy of tensor parallelism
  (``parallel.tp.vocab_parallel_xent``) or, with ``loss_chunk > 0``, the
  chunked head (``ops.fused_xent``), as ``_lm_objective_metrics``
  (``:137-148``) does, and returns the MoE router sums beside them
  (``_apply_collect_aux``, ``:87``);
* :func:`lm_train_step` is the step (``:150-335``): per microbatch the
  local mean CE plus ``aux_weight`` times the router aux, its gradient
  w.r.t. every leaf of the state, then the mode's sync and
  ``engine.steps.apply_update``. :class:`ModelParallel` says how a mode
  runs it: ``dp`` (the data-parallel mean, one collective per dtype or
  ``grad_bucket_mb`` buckets, as ``_lm_explicit_dp_step_fn``,
  ``:195-217``), ``fsdp`` (the leaves gathered before use,
  ``parallel.fsdp``), ``tp``/``ep`` (the model's own collectives; the
  mean over ``data``), ``tp-ring`` (``_lm_tp_ring_step_fn``, ``:222``:
  the targets cut to this rank's sequence chunk, the mean over ``model``
  then ``data``) and ``sp-ring`` (``_lm_sp_step_fn``, ``:288``: the
  inputs and targets cut to this rank's chunk, as ``_sp_window_slices``
  (``:335``) cuts them on the device, positions offset per chunk, the
  mean over ``seq`` then ``data``; MoE groups are chunk-local). Under
  accumulation (``accum > 1``) the microbatches' gradients average before
  the one update (``make_lm_grad_accum_train_step``, ``:373-395``). The
  AdamW clip and the health probes read the global norm: shards' squares
  summed over their axes, replicated leaves once (:func:`sharded_sq_norm`);
* :func:`lm_eval_metrics` is the forward-only eval (``:271-285``), exact
  under sampler padding through the per-row ``valid`` mask, in every mode.

Metric values stay 0-d tensors on the device; the loop fetches them once
per print window, summed over the axes that hold different tokens.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_dist_torch.engine.state import TrainState
from tpu_dist_torch.engine.steps import (ONE_PROCESS, DataParallel,
                                         accumulate, apply_update)
from tpu_dist_torch.ops.fused_xent import chunked_softmax_xent
from tpu_dist_torch.parallel.collectives import psum
from tpu_dist_torch.parallel.overlap import bucketed_grad_sync

LM_METRIC_KEYS = ("loss_sum", "correct1", "count")
# the MoE router's combine-mass diagnostic (RMass = sum / n) and its aux
# loss (summed over the metric axes), train only
ROUTER_KEYS = ("router_mass_sum", "router_mass_n", "router_aux")


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


@dataclass
class ModelParallel:
    """How :func:`lm_train_step` and :func:`lm_eval_metrics` run one mode
    (module docstring). ``specs`` holds each state leaf's spec (None for a
    replicated run); ``grad_mean_axes`` the axes the gradients average
    over, in order; ``metric_axes`` those the metric sums add over;
    ``vocab`` the model axis of a vocab-sharded head; ``seq`` the axis
    whose chunk a rank's inputs and targets are (sp); ``ring`` the axis
    whose chunk its targets are (tp-ring); ``fsdp_names`` the state
    leaves' param names under fsdp."""
    mode: str = "dp"
    mesh: Any = None
    specs: Optional[List[Tuple]] = None
    grad_mean_axes: Tuple[str, ...] = ("data",)
    metric_axes: Tuple[str, ...] = ("data",)
    vocab: Any = None
    seq: Any = None
    ring: Any = None
    fsdp_names: Optional[List[str]] = None
    aux_weight: float = 0.0
    moe: bool = False
    dp: DataParallel = field(default_factory=lambda: ONE_PROCESS)

    def group(self, axis: str):
        return None if self.mesh is None else self.mesh.group(axis)

    def params_ctx(self, model, state: TrainState):
        """The model on the step's params: under fsdp each leaf gathered
        from the state's shards (autograd reduce-scatters its gradient)."""
        if self.fsdp_names is None:
            return nullcontext(model)
        from tpu_dist_torch.parallel.fsdp import gathered, swapped_params

        full = [gathered(p, s, self.mesh)
                for p, s in zip(state.params, self.specs)]
        return swapped_params(model, self.fsdp_names, full)

    def local(self, inputs, targets, mask):
        """This rank's (inputs, targets, mask, position offset)."""
        ax = self.seq or self.ring
        if ax is None or ax.size == 1:
            return inputs, targets, mask, 0
        n = targets.shape[1] // ax.size
        cut = lambda t: t.narrow(1, ax.index * n, n)    # noqa: E731
        if self.seq is not None:
            return cut(inputs), cut(targets), cut(mask), ax.index * n
        return inputs, cut(targets), cut(mask), 0

    def sync_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.fsdp_names is not None:
            from tpu_dist_torch.parallel.fsdp import sync_grads

            return sync_grads(grads, self.specs, self.mesh)
        if self.mode.startswith("dp"):
            return self.dp.grads(grads)
        for axis in self.grad_mean_axes:
            g = self.group(axis)
            if g is not None:
                grads = bucketed_grad_sync(grads, math.inf, mean=True,
                                           impl="psum", group=g)
        return grads

    def sync_metrics(self, metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        keys = list(metrics)
        flat = torch.stack([metrics[k].float() for k in keys])
        for axis in self.metric_axes:
            g = self.group(axis)
            if g is not None:
                flat = psum(flat, g)
        return dict(zip(keys, flat.unbind()))

    def sq_norm(self, tensors) -> torch.Tensor:
        return sharded_sq_norm(tensors, self.specs, self.mesh)


DP = ModelParallel()


def sharded_sq_norm(tensors, specs, mesh) -> torch.Tensor:
    """The global sum of squares of a list of leaves laid out by
    ``specs``: each sharded leaf's local squares summed over the axes it
    is sharded on, each replicated leaf counted once."""
    dev = tensors[0].device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
    for t, spec in zip(tensors, specs or [()] * len(tensors)):
        sq = t.float().square().sum()
        axes = tuple(a for a in spec if a)
        if not axes:
            total = total + sq
        else:
            by_axes[axes] = by_axes.get(axes, 0.0) + sq
    for axes in sorted(by_axes):
        part = by_axes[axes]
        for a in axes:
            part = psum(part, mesh.group(a))
        total = total + part
    return total


def lm_objective(model, inputs, targets, mask, loss_chunk: int = 0,
                 par: ModelParallel = DP):
    """(loss_sum, metric sums, router sums) of the model on (B, L)
    ``inputs``: through the full logits (vocab-sharded under ``par.vocab``)
    or, with ``loss_chunk > 0``, through the chunked head on the model's
    features (its lm_head kernel straight from the model, gathered from
    the vocab shards under tensor parallelism, so the kernel's gradient
    flows through the chunked backward). The router sums are zeros for a
    dense model."""
    inputs, targets, mask, pos = par.local(inputs, targets, mask)
    if loss_chunk:
        feats, aux = model(inputs, pos_offset=pos, return_features=True,
                           return_aux=True)
        w = model.lm_head.kernel
        if par.vocab is not None:
            from tpu_dist_torch.parallel.tp import gathered_head_kernel

            w = gathered_head_kernel(w, par.vocab)
        loss_sum, correct = chunked_softmax_xent(feats, w, targets, mask,
                                                 loss_chunk, model.dtype)
    else:
        logits, aux = model(inputs, pos_offset=pos, return_aux=True)
        if par.vocab is not None:
            from tpu_dist_torch.parallel.tp import vocab_parallel_xent

            loss_sum, correct = vocab_parallel_xent(logits, targets, mask,
                                                    par.vocab)
        else:
            loss_sum, m = lm_loss_and_metrics(logits, targets, mask)
            correct = m["correct1"]
    return loss_sum, {"loss_sum": loss_sum.detach(), "correct1": correct,
                      "count": mask.sum()}, aux


def lm_train_step(model, tx, state: TrainState, inputs, targets,
                  health: str = "record", loss_chunk: int = 0,
                  accum: int = 1, dp: DataParallel = ONE_PROCESS,
                  par: Optional[ModelParallel] = None
                  ) -> Dict[str, torch.Tensor]:
    """One optimizer step on device-resident (B, L) ``inputs``/``targets``
    (this rank's rows): the local mean CE (plus ``par.aux_weight`` times
    the MoE aux) over each of ``accum`` microbatches, its gradient synced
    by the mode (``par``; default: the data-parallel mean over ``dp``'s
    group), the update. Returns the step's metric sums over the mode's
    metric axes (with the health probes)."""
    par = par or ModelParallel(dp=dp)

    def micro(inp, tgt):
        mask = torch.ones(tgt.shape, dtype=torch.float32, device=tgt.device)
        with par.params_ctx(model, state):
            loss_sum, metrics, aux = lm_objective(model, inp, tgt, mask,
                                                  loss_chunk, par)
            mean = loss_sum / torch.clamp(metrics["count"], min=1.0)
            if par.moe:
                mean = mean + par.aux_weight * aux["aux"]
                metrics["router_mass_sum"] = aux["mass_sum"].detach()
                metrics["router_mass_n"] = aux["mass_n"]
                metrics["router_aux"] = aux["aux"].detach()
            grads = list(torch.autograd.grad(mean, state.params))
        return grads, metrics

    if accum > 1:
        grads, metrics = accumulate(micro, accum, inputs, targets)
    else:
        grads, metrics = micro(inputs, targets)
    metrics = (par.dp.metrics(metrics) if par.mode.startswith("dp")
               else par.sync_metrics(metrics))
    return apply_update(tx, state, par.sync_grads(grads), metrics, health,
                        sq_norm=par.sq_norm if par.specs else None)


@torch.inference_mode()
def lm_eval_metrics(model, inputs, targets, valid, loss_chunk: int = 0,
                    par: ModelParallel = DP,
                    state: Optional[TrainState] = None
                    ) -> Dict[str, torch.Tensor]:
    """Forward-only metric sums of this rank's tokens (summed over the
    mode's axes by the caller); ``valid`` (B,) 0/1 masks sampler
    wrap-padding rows out of every sum."""
    mask = valid.float()[:, None].expand(targets.shape)
    with par.params_ctx(model, state):
        _, metrics, _ = lm_objective(model, inputs, targets, mask,
                                     loss_chunk, par)
    return metrics
