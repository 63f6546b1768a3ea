"""Pipeline parallelism over a ``stage`` mesh axis for the port
(``tpu_dist/parallel/pp.py``): GPipe and 1F1B.

The reference runs one ``shard_map`` program per device: the blocks are
stage-stacked (``stack_pipeline_params``), microbatches flow through a
``lax.scan`` over lockstep ticks, and activations hop stage to stage by
``lax.ppermute``. The port runs one process per device, so each rank holds
its stage's ``num_layers / S`` consecutive blocks as the ``nn.Module`` s of
its model (:func:`lay_out_stage_`: the rest are dropped), and the schedule
is an explicit Python loop over the same ticks:

* **GPipe** (``Pipeline._gpipe``; ``make_lm_pp_train_step``,
  ``_pp_gpipe_step_builder`` and ``_pp_forward_builder``, ``:298-502``):
  M + S - 1 forward ticks, in which stage s runs microbatch t - s and keeps its
  autograd graph (activation memory grows with M), the head and loss on
  the last stage over the whole local batch, then M + S - 1 backward ticks
  in the mirror order, each stage differentiating its microbatch's forward
  with the cotangent that arrived (``torch.autograd.grad``) and sending the
  input's gradient upstream.
* **1F1B** (``Pipeline._1f1b``; ``make_lm_pp_1f1b_train_step`` and
  ``_pp_1f1b_step_builder``, ``:504-806``): M + 2(S - 1) ticks, each one
  forward (microbatch t - s, no graph kept; only the
  stage's input is stashed, at most 2(S - 1) + 1 of them, so activation
  memory does not grow with M) and one backward (microbatch t - (2(S - 1) -
  s)), which recomputes the stage forward from the stashed input under
  autograd and differentiates it with the received ``dy`` (the last stage:
  its head's loss, normalized by the local shard's size so the M losses
  sum to the local mean). The recompute doubles the stage's forward
  kernels.

:meth:`Pipeline.train_step` is the step of both schedules and
:meth:`Pipeline.eval_metrics` the forward-only eval
(``make_lm_pp_eval_step``, ``:898``); the reference's windowed makers
(``make_lm_pp_indexed_multi_train_step`` and ``_indexed_eval_step``,
``:809,861``) are ``LMTrainer.window_step`` and ``validate`` over the
device-resident rows, which call these. The stage-stacked trees
(``stack_pipeline_params``, ``:65,86``) are ``interop.pp_stage_tree``
and its inverses; a pp checkpoint stacks each block leaf over the stages
(:func:`gather_stage_leaf`).

What the reference's ``lax.cond`` s gate, the port skips, and its
collectives stay outside that gating: every rank joins every hop of every
tick (a bubble tick sends zeros), so the collective order is the same on
all ranks. Stage 0 alone embeds, stage S - 1 alone runs ``ln_f``, the
head and the loss, and a bubble tick runs no block (``Pipeline.work``
counts each). The hops ride :func:`~tpu_dist_torch.parallel.collectives
.ppermute` (a ring shift whose wrap-around is ignored), so over gloo with
CUDA tensors they stage through the host (``P2P_HOST_STAGED``), the one
point-to-point route gloo takes on one card.

Gradients: block leaves stay stage-local; the replicated embedding, final
norm and head have exact-zero gradients off their owning stage, and are
summed over ``stage`` so every stage's replica takes the same update; then
everything is averaged over ``data``. ``grad_clip`` clips by the
cross-stage global norm (:func:`_clip_pp_grads`: the blocks' squares
summed over ``stage`` plus the replicated leaves' once), and the optimizer
runs with its own clip off. MoE blocks add their router aux with the
coefficient ``aux_weight / M`` per microbatch (GPipe's objective; 1F1B
differentiates each stage's ``(y, aux)`` with cotangents ``(dy,
aux_weight / M)``, ``:562-597``); the balance loss keeps its data-axis
sums (``models.moe``).

pp x tp (``data=N,stage=S,model=K``, ``:50,113``): each stage's blocks
take the Megatron layout over the stage's own ``model`` group
(``parallel.tp`` rules, or ``parallel.ep``'s for MoE blocks); the
embedding and head stay whole on every rank, as the reference's
``pp_tp_placement_specs`` leaves them. Every rank of a tp group sits in
one stage and runs the same ticks, so the block compute is gated there
too (the reference runs it ungated under tp, ``gate_blocks``, because its
tp collectives would sit inside the ``cond``; the numbers are the same).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from tpu_dist_torch.engine.lm_steps import (LM_METRIC_KEYS,
                                            lm_loss_and_metrics,
                                            sharded_sq_norm)
from tpu_dist_torch.engine.steps import apply_update
from tpu_dist_torch.ops.fused_xent import chunked_softmax_xent
from tpu_dist_torch.parallel.collectives import ppermute, psum
from tpu_dist_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, STAGE_AXIS,
                                          Mesh)
from tpu_dist_torch.parallel.overlap import bucketed_grad_sync

SCHEDULES = ("gpipe", "1f1b")


# ---- layouts ---------------------------------------------------------------

def stage_blocks(num_layers: int, num_stages: int, stage: int
                 ) -> Tuple[int, int]:
    """(first block, blocks per stage) of ``stage``."""
    if num_layers % num_stages:
        raise ValueError(f"{num_layers} blocks not divisible by "
                         f"{num_stages} stages")
    per = num_layers // num_stages
    return stage * per, per


def block_param_specs(named_shapes, moe: bool, tp: bool) -> Dict[str, Tuple]:
    """Each leaf's spec under pp (x tp): the blocks' Megatron specs over
    ``model`` (``parallel.tp``'s rules; ``parallel.ep``'s for MoE blocks)
    where the mesh has a model axis, every other leaf replicated."""
    named_shapes = list(named_shapes)
    specs = {n: (None,) * len(s) for n, s in named_shapes}
    if not tp:
        return specs
    if moe:
        from tpu_dist_torch.parallel.ep import ep_param_specs
        from tpu_dist_torch.parallel.mesh import EXPERT_AXIS

        rules = ep_param_specs(named_shapes, EXPERT_AXIS, MODEL_AXIS)
    else:
        from tpu_dist_torch.parallel.tp import lm_param_specs

        rules = lm_param_specs(named_shapes)
    for n, _ in named_shapes:
        if n.startswith("blocks."):
            specs[n] = rules[n]
    return specs


def lay_out_stage_(model, mesh: Mesh):
    """Keep this rank's stage's blocks of ``model`` (a whole LM) and, with
    a model axis, shard them Megatron-style over it (``shard_state_pp``,
    ``:150``). Returns (the stage's (name, whole shape) pairs, their
    specs)."""
    from tpu_dist_torch.parallel.tp import shard_params_

    st, tp = mesh.axis(STAGE_AXIS), mesh.axis(MODEL_AXIS)
    lo, per = stage_blocks(len(model.blocks), st.size, st.index)
    model.blocks = torch.nn.ModuleList(list(model.blocks)[lo:lo + per])
    model.num_layers = per
    named = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    moe = getattr(model, "num_experts", 0) > 0
    if tp.size > 1:
        if model.num_heads % tp.size:
            raise ValueError(f"pp x tp shards heads: num_heads "
                             f"{model.num_heads} must divide by the model "
                             f"axis ({tp.size})")
        specs = block_param_specs(named, moe, True)
        shard_params_(model, specs, mesh)
        for blk in model.blocks:
            blk.tp = tp
            if moe:
                blk.moe.tp = tp
    else:
        specs = block_param_specs(named, moe, False)
    return named, specs


def gather_stage_leaf(t: torch.Tensor, name: str, spec, mesh: Mesh,
                      fused: int = 1) -> torch.Tensor:
    """A pp leaf whole for a checkpoint: a block leaf gathered over
    ``model`` under its spec, then stacked over ``stage`` (S, ...), the
    reference's stage-stacked layout; a replicated leaf as it is."""
    from tpu_dist_torch.parallel.collectives import all_gather
    from tpu_dist_torch.parallel.mesh import gather_leaf

    if not name.startswith("blocks."):
        return t
    whole = gather_leaf(t, spec, mesh, fused)
    return all_gather(whole.contiguous(), mesh.group(STAGE_AXIS))


def slice_stage_leaf(t: torch.Tensor, name: str, spec, mesh: Mesh,
                     fused: int = 1) -> torch.Tensor:
    """Inverse of :func:`gather_stage_leaf` on this rank."""
    from tpu_dist_torch.parallel.mesh import shard_leaf

    if not name.startswith("blocks."):
        return t
    return shard_leaf(t[mesh.coord(STAGE_AXIS)], spec, mesh, fused)


# ---- the stage's pieces ---------------------------------------------------

def _embed(model, ids):
    """Token plus position embeddings of (mb, L) ``ids`` (stage 0)."""
    ar = torch.arange(ids.shape[1], device=ids.device)
    return (model._embed(model.tok_emb, ids.long())
            + model._embed(model.pos_emb, ar)[None])


def _head_logits(model, x):
    """The last stage's lm_head product under the model's quant mode
    (``:213``: through ``ops.quant.quant_matmul``, so int8 reaches the
    head)."""
    return model.lm_head(x).float()


def _head_loss(model, y, targets, mask, loss_chunk: int):
    """(loss_sum, metric sums) of the last stage: ``ln_f``, the head and
    the cross entropy, or the chunked head (``ops.fused_xent``)."""
    x = model.ln_f(y)
    if loss_chunk:
        loss_sum, correct = chunked_softmax_xent(
            x, model.lm_head.kernel, targets, mask, loss_chunk, model.dtype)
        return loss_sum, {"loss_sum": loss_sum.detach(), "correct1": correct,
                          "count": mask.sum()}
    return lm_loss_and_metrics(_head_logits(model, x), targets, mask)


def _stage_apply(model, x):
    """The stage's blocks on ``x`` (``_stage_apply_builder`` /
    ``_stage_apply_aux_builder``, ``:225,250``): (y, router sums; zeros for
    a dense model), each block under ``torch.utils.checkpoint`` with
    ``remat`` when autograd records."""
    remat = model.remat and torch.is_grad_enabled()
    extras = []
    for blk in model.blocks:
        x, extra = (checkpoint(blk, x, use_reentrant=False) if remat
                    else blk(x))
        extras.append(extra)
    return x, model.collect_aux(extras, x)


def _clip_pp_grads(grads: List[torch.Tensor], is_block: List[bool],
                   specs, mesh: Mesh, grad_clip: float) -> torch.Tensor:
    """Scale ``grads`` in place to the cross-stage global norm ``grad_clip``
    (``:194``, optax's ``clip_by_global_norm``): the block leaves' squares
    (their model shards summed over ``model``) summed over ``stage``, plus
    the replicated leaves' squares once. Returns the norm."""
    blk = [i for i, b in enumerate(is_block) if b]
    eh = [i for i, b in enumerate(is_block) if not b]
    dev = grads[0].device
    block_sq = (sharded_sq_norm([grads[i] for i in blk],
                                [specs[i] for i in blk], mesh)
                if blk else torch.zeros((), device=dev))
    eh_sq = sum((grads[i].float().square().sum() for i in eh),
                torch.zeros((), device=dev))
    norm = torch.sqrt(psum(block_sq, mesh.group(STAGE_AXIS)) + eh_sq)
    scale = torch.where(norm > grad_clip,
                        grad_clip / torch.clamp(norm, min=1e-30),
                        torch.ones_like(norm))
    for g in grads:
        g.mul_(scale)
    return norm


class Pipeline:
    """One rank's pipeline: its stage model, the mesh, the schedule and
    the step's knobs. ``work`` counts what the rank ran (``embed``,
    ``head``, ``stage_fwd``: block forwards, recomputes included, and
    ``ticks``), and ``stash_peak`` the most stage inputs 1F1B held at
    once, for the structural checks."""

    def __init__(self, model, mesh: Mesh, num_microbatches: int,
                 schedule: str = "gpipe", aux_weight: float = 0.01,
                 loss_chunk: int = 0, grad_clip: float = 0.0,
                 specs=None, param_names=()):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown pp schedule {schedule!r} (gpipe|1f1b)")
        if num_microbatches < 1:
            raise ValueError("pp_microbatches must be >= 1")
        self.model, self.mesh = model, mesh
        self.m, self.schedule = num_microbatches, schedule
        self.stage = mesh.axis(STAGE_AXIS)
        self.s, self.S = self.stage.index, self.stage.size
        self.first, self.last = self.s == 0, self.s == self.S - 1
        self.moe = getattr(model, "num_experts", 0) > 0
        self.aux_weight, self.loss_chunk = aux_weight, loss_chunk
        self.grad_clip = grad_clip
        self.names = list(param_names)
        self.is_block = [n.startswith("blocks.") for n in self.names]
        self.specs = specs or [()] * len(self.names)
        self.work = {"embed": 0, "head": 0, "stage_fwd": 0, "ticks": 0}
        self.stash_peak = 0

    # ---- pieces ----
    def _hop(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """Every rank, every tick: ``x`` one stage on (``shift`` +1) or
        back (-1); what wraps around the ring is ignored."""
        with torch.no_grad():
            return ppermute(x.contiguous(), shift, self.stage.group)

    def _forward(self, ids, x_in):
        """The stage forward of one microbatch: embed on stage 0, else
        ``x_in``, then the blocks. (y, router sums)."""
        if self.first:
            self.work["embed"] += 1
            x_in = _embed(self.model, ids)
        self.work["stage_fwd"] += 1
        return _stage_apply(self.model, x_in)

    def _inputs(self, params, x_in):
        """What a stage backward differentiates: the params it uses and the
        received activation (not on stage 0, which embeds)."""
        return list(params) + ([] if self.first else [x_in])

    def _accumulate(self, acc, grads, n):
        for i, g in enumerate(grads[:n]):
            if g is not None:
                acc[i].add_(g.float())

    def _zeros_act(self, mb, seq, like_dtype, device):
        return torch.zeros((mb, seq, self.model.d_model), dtype=like_dtype,
                           device=device)

    def _aux_ct(self, device):
        return torch.full((), self.aux_weight / self.m, device=device)

    def _split(self, inputs):
        b = inputs.shape[0]
        if b % self.m:
            raise ValueError(f"local batch {b} not divisible by {self.m} "
                             f"microbatches")
        return list(inputs.split(b // self.m))

    # ---- schedules ----
    def _gpipe(self, params, inputs, targets):
        model, dev = self.model, inputs.device
        ids, m_count = self._split(inputs), self.m
        mb, seq = ids[0].shape
        dtype = model.dtype
        n = len(params)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for p in params]
        saved: Dict[int, tuple] = {}
        zeros = self._zeros_act(mb, seq, dtype, dev)
        recv = zeros
        router = torch.zeros(3, device=dev)
        for t in range(m_count + self.S - 1):
            self.work["ticks"] += 1
            mi = t - self.s
            send = zeros
            if 0 <= mi < m_count:
                x_in = None if self.first else \
                    recv.detach().requires_grad_()
                y, aux = self._forward(ids[mi], x_in)
                saved[mi] = (x_in, y, aux)
                send = y.detach()
                router += torch.stack([aux["aux"].detach(),
                                       aux["mass_sum"].detach(),
                                       aux["mass_n"]])
            recv = self._hop(send, 1)
        metrics = {k: torch.zeros((), device=dev) for k in LM_METRIC_KEYS}
        dys = [None] * m_count
        if self.last:
            self.work["head"] += 1
            ycat = torch.cat([saved[i][1].detach() for i in range(m_count)]
                             ).requires_grad_()
            mask = torch.ones(targets.shape, dtype=torch.float32, device=dev)
            loss_sum, metrics = _head_loss(model, ycat, targets, mask,
                                           self.loss_chunk)
            mean = loss_sum / float(targets.numel())
            g = torch.autograd.grad(mean, params + [ycat], allow_unused=True)
            self._accumulate(acc, g, n)
            dys = list(g[n].to(dtype).split(mb))
        recv = zeros
        aux_ct = self._aux_ct(dev)
        for u in range(m_count + self.S - 1):
            self.work["ticks"] += 1
            mi = m_count - 1 - u + (self.S - 1 - self.s)
            send = zeros
            if 0 <= mi < m_count:
                x_in, y, aux = saved.pop(mi)
                dy = dys[mi] if self.last else recv
                outs, cts = [y], [dy]
                if self.moe:
                    outs.append(aux["aux"])
                    cts.append(aux_ct)
                g = torch.autograd.grad(outs, self._inputs(params, x_in),
                                        cts, allow_unused=True)
                self._accumulate(acc, g, n)
                if not self.first:
                    send = g[n].detach()
            recv = self._hop(send, -1)
        return acc, metrics, router

    def _1f1b(self, params, inputs, targets):
        model, dev = self.model, inputs.device
        ids, tgts, m_count = (self._split(inputs), self._split(targets),
                              self.m)
        mb, seq = ids[0].shape
        dtype, n, S, s = model.dtype, len(params), self.S, self.s
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for p in params]
        zeros = self._zeros_act(mb, seq, dtype, dev)
        stash: Dict[int, Optional[torch.Tensor]] = {}
        metrics = {k: torch.zeros((), device=dev) for k in LM_METRIC_KEYS}
        router = torch.zeros(3, device=dev)
        fwd_recv = bwd_recv = zeros
        aux_ct = self._aux_ct(dev)
        norm = float(inputs.numel())        # the local shard's tokens
        for t in range(m_count + 2 * (S - 1)):
            self.work["ticks"] += 1
            # forward half: microbatch t - s, no graph; stash its input
            mf = t - s
            fwd_send = zeros
            if 0 <= mf < m_count:
                x_in = None if self.first else fwd_recv
                with torch.no_grad():
                    y, aux = self._forward(ids[mf], x_in)
                stash[mf] = x_in
                self.stash_peak = max(self.stash_peak, len(stash))
                fwd_send = y
                router += torch.stack([aux["aux"], aux["mass_sum"],
                                       aux["mass_n"]])
            # backward half: microbatch t - (2(S-1) - s), recomputed
            mb_i = t - (2 * (S - 1) - s)
            bwd_send = zeros
            if 0 <= mb_i < m_count:
                x_b = stash.pop(mb_i)
                x_b = None if x_b is None else x_b.detach().requires_grad_()
                y, aux = self._forward(ids[mb_i], x_b)
                wrt = self._inputs(params, x_b)
                if self.last:
                    self.work["head"] += 1
                    mask = torch.ones(tgts[mb_i].shape, dtype=torch.float32,
                                      device=dev)
                    loss_sum, m = _head_loss(model, y, tgts[mb_i], mask,
                                             self.loss_chunk)
                    obj = loss_sum / norm
                    if self.moe:
                        obj = obj + aux_ct * aux["aux"]
                    g = torch.autograd.grad(obj, wrt, allow_unused=True)
                    metrics = {k: metrics[k] + m[k] for k in metrics}
                else:
                    outs, cts = [y], [bwd_recv]
                    if self.moe:
                        outs.append(aux["aux"])
                        cts.append(aux_ct)
                    g = torch.autograd.grad(outs, wrt, cts,
                                            allow_unused=True)
                self._accumulate(acc, g, n)
                if not self.first:
                    bwd_send = g[n].detach().to(dtype)
            fwd_recv = self._hop(fwd_send, 1)
            bwd_recv = self._hop(bwd_send, -1)
        return acc, metrics, router

    # ---- the step ----
    def train_step(self, state, inputs, targets, tx, health: str = "record",
                   dp=None) -> Dict[str, torch.Tensor]:
        """One optimizer step on this rank's (B, L) rows (every rank of a
        data coordinate holds the same rows; stage 0 reads the inputs, the
        last stage the targets). Returns the metric sums over ``stage`` and
        ``data``, with the health probes."""
        params = list(state.params)
        run = self._1f1b if self.schedule == "1f1b" else self._gpipe
        grads, metrics, router = run(params, inputs, targets)
        # the replicated leaves: exact zeros off their owning stage, summed
        eh = [i for i, b in enumerate(self.is_block) if not b]
        summed = bucketed_grad_sync([grads[i] for i in eh], math.inf,
                                    mean=False, impl="psum",
                                    group=self.stage.group)
        for i, g in zip(eh, summed):
            grads[i] = g
        data = self.mesh.group(DATA_AXIS)
        if data is not None:
            grads = bucketed_grad_sync(grads, math.inf, mean=True,
                                       impl="psum", group=data)
        if self.grad_clip > 0:
            _clip_pp_grads(grads, self.is_block, self.specs, self.mesh,
                           self.grad_clip)
        if self.moe:
            metrics["router_aux"] = router[0] / self.m
            metrics["router_mass_sum"] = router[1]
            metrics["router_mass_n"] = router[2]
        metrics = self.sync_metrics(metrics)
        return apply_update(tx, state, grads, metrics, health,
                            probe_sync=self._probe_sync)

    def _probe_sync(self, probes):
        """The health probes summed over ``stage`` (``:489-492``), so they,
        and a skip gate, are the same on every rank."""
        keys = list(probes)
        flat = psum(torch.stack([probes[k].float() for k in keys]),
                    self.stage.group)
        return dict(zip(keys, flat.unbind()))

    def sync_metrics(self, metrics):
        keys = list(metrics)
        flat = torch.stack([metrics[k].float() for k in keys])
        for axis in (STAGE_AXIS, DATA_AXIS):
            flat = psum(flat, self.mesh.group(axis))
        return dict(zip(keys, flat.unbind()))

    @torch.no_grad()
    def eval_metrics(self, inputs, targets, valid) -> Dict[str, torch.Tensor]:
        """Forward-only metric sums of this rank's rows through the
        pipeline (``make_lm_pp_eval_step``, ``:898``): nonzero on the last
        stage only, for the caller to sum over ``stage`` and ``data``;
        ``valid`` (B,) masks sampler wrap-padding rows. The last stage runs
        the head a microbatch at a time, so no (B, L, V) logits exist."""
        model, dev = self.model, inputs.device
        ids, tgts = self._split(inputs), self._split(targets)
        masks = self._split(valid.float()[:, None].expand(targets.shape))
        mb, seq = ids[0].shape
        zeros = self._zeros_act(mb, seq, model.dtype, dev)
        sums = {k: torch.zeros((), device=dev) for k in LM_METRIC_KEYS}
        recv = zeros
        for t in range(self.m + self.S - 1):
            mi = t - self.s
            send = zeros
            if 0 <= mi < self.m:
                send, _ = self._forward(ids[mi], None if self.first
                                        else recv)
                if self.last:
                    self.work["head"] += 1
                    _, m = _head_loss(model, send, tgts[mi], masks[mi],
                                      self.loss_chunk)
                    sums = {k: sums[k] + m[k] for k in sums}
            recv = self._hop(send, 1)
        return sums
