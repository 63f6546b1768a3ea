"""LMTrainer for the port (``tpu_dist/engine/lm_loop.py``): the LM family's
training loop over the processes of a ``torch.distributed`` group, one
device each (a reference mesh of N devices is N processes).

Mode selection is by mesh axes, as in the reference (``:86-130``) and
script 8, with the same ``mode`` strings:

  data=N                      dp (``dp-moe`` with ``num_experts``)
  data=N  + fsdp=True         fsdp: params and optimizer state sharded
                              over data (``parallel.fsdp``)
  data=N,model=M              tp: Megatron shards (``parallel.tp``), or
                              tp-ring with ``tp_impl="ring"``
                              (``parallel.overlap``)
  data=N,seq=M                sp-ring: ring attention over sequence
                              chunks (``parallel.ring_attention``)
  data=N,expert=M             ep-moe (``parallel.ep``, ``models.moe``);
                              ep-moe+tp with a model axis as well
  data=N,stage=S              pp-gpipe | pp-1f1b (``pp_schedule``): each
                              rank holds its stage's blocks
                              (``parallel.pp``); pp-gpipe+tp | pp-1f1b+tp
                              with a model axis as well

``_validate_mode`` is the reference's (``:406-470``) word for word. Every
rank of one ``data`` coordinate reads the same rows (the sampler runs over
the data axis), each mode's step is ``engine.lm_steps.lm_train_step``
under its ``ModelParallel`` (pp: ``parallel.pp.Pipeline.train_step``),
and checkpoints are layout-free: a sharded mode gathers whole leaves for
rank 0 to write and slices them again on resume, so a checkpoint of one
mode resumes under another. A pp checkpoint is the exception, as in the
reference: its block leaves are stacked over the stages (S, ...), it
resumes under the same ``pp_stages`` only (``HARD_GEOMETRY``), and it is
refused as a warm-start donor.

What follows the reference (line numbers are ``lm_loop.py``'s):

* ``__init__`` (``:55-400``): the corpus (``data.tokens``), the model
  (``_build_model :469-505``, ``attn`` full | blockwise | flash), the
  ``pretrained`` warm start (``:133-165``: the leaves of a port ``.pt`` or
  a reference ``.msgpack`` checkpoint whose name and shape match, over a
  fresh optimizer at step 0; a pipeline-stacked donor is refused), the LR
  schedule and the optimizer (``sgd`` | ``adamw`` | ``fused_adamw``, the
  last through the AdamW kernel with its clip slot), gradient accumulation
  (``grad_accum_steps``, ``:216-234``, with the reference's exclusions),
  the K-steps-per-dispatch window over device-resident rows
  (``steps_per_dispatch``, ``data_placement``, ``:209-303``: ``auto``
  puts the (N, L+1) row matrices on the device when they fit and K > 1),
  the run geometry stamped into checkpoints and ``--resume`` with the
  geometry checks and the step-exact mid-epoch skip (``:305-349``);
* ``train_epoch`` (``:737``) on the host data path: ``DistributedSampler``
  rows (the reference's order, step for step), one step per batch, and
  one fetch of the metric sums per print window (``_drain``), which feeds
  the ``MeterBank`` line, the ledger's ``step`` events and the health
  sentry; ``_train_epoch_windowed`` (``:872``): per step a (B, L+1) row
  gather by a device index window, shifted on the device, K steps
  enqueued back to back (:meth:`LMTrainer.window_step`), one ``step``
  record per window. The math is that of K single steps;
* ``validate`` (``:1038``): exact under sampler padding; ``fit``
  (``:1123``) with ``max_steps``, a checkpoint at each epoch end
  (``:1228-1238``; async, keep-K) and a mid-epoch checkpoint on
  ``KeyboardInterrupt`` (``:1164-1182``); ledger ``run_start`` / ``step``
  / ``eval`` / ``epoch`` / ``ckpt`` / ``run_end`` events through the
  port's ``obs.RunObs`` (attempt lineage with ``job_id`` and ``attempt``,
  the watchdog beaten at each drain and paused around validation and
  checkpoints, the goodput sink, the supervisor's heartbeat file);
* the restart layer (``:352-366, 780-788, 901-910, 983-1033``): once an
  iteration, in the per-batch and the windowed loop, the step fault sites
  (``obs.faults``: ``nan_batch`` poisons the first fp32 master in place,
  ``preempt_deadline`` requests a snapshot); a SIGTERM (the crash guard's
  flag) or that request makes the loop drain its in-flight steps at the
  next step boundary, wait for the async writer, write a mid-epoch
  checkpoint stamped ``preempt``, emit ``ckpt`` and ``scale
  action=preempt_snapshot``, end the run ``status=preempted`` and exit
  ``PREEMPT_SNAPSHOT_RC`` (75). Over several ranks the decision is one
  max-reduce of the flag at the drain boundaries, so every rank snapshots
  the same step. ``TPU_DIST_PEER_RESUME=1`` in a dp-pure mode adopts rank
  0's live state (``checkpoint.peer_restore_state``) with a ``scale
  action=peer_restore`` event.
* the observers (``:678-681, 774-833, 1144-1160``): each dispatch and
  each drain's fetch timed by ``RunObs.tracer`` (``dispatch``,
  ``device``; ``torch.profiler`` ranges and ``ProfilerStep#`` marks while
  a ``profile_dir`` session runs around the fit), the skew monitor fed
  each step record of a drain on every rank, the telemetry sampler
  around the fit, and the run's first dispatch of ``train_step`` or
  ``window_step`` followed by its ``compile`` and ``cost_model`` events
  (``obs.attr``). The step fault sites fire before the step's data wait
  is read, so an injected ``hang`` counts in that rank's ``data_s``.

Over several data ranks each trains on ``batch_size // data`` rows
(the sampler's batch-blocked layout: the rows the reference gives that
shard), the gradients are averaged over the group before the update (one
collective per dtype, or ``grad_bucket_mb`` buckets, whose sync is timed
once alone for the step records' ``comm_s``), the metric sums are summed
over it, and logs, the ledger, the CSV and checkpoint writes are rank
0's.

``loss_chunk > 0`` trains and evaluates through the chunked head
(``ops.fused_xent``). It runs on CUDA unless ``device="cpu"`` is asked
for, and takes an optional flax-layout initial param tree
(``init_params``) so a run can start from the reference trainer's
initial weights. ``max_restarts`` takes effect in the entry point
(``scripts.lm_longcontext`` through ``parallel.supervisor.run_supervised``),
as in the reference.

The step plan (``:56-61``): ``plan`` (a ``tools/tune.py`` plan file, or
``"auto"``) is resolved first thing (``plan.compile.resolve_config_plan``),
before anything reads a plan-owned knob, so the model is built with the
plan's ``quant`` and the plan's kernel switches are set; the result rides
``run_start`` and one ``plan`` event (``obs.RunObs``). Every step, window
and eval comes from ``plan.compile.compile_plan`` over this mode's
bindings (:meth:`LMTrainer._step_plan`).

The program audit (``analysis.proglint``, the ``audit`` knob): armed from
``cfg.audit`` once the ledger is up (``plan.compile.set_audit``), it
records the run's first dispatch of ``train_step``/``window_step`` under
the first-dispatch probe (warm: out of every rate) and emits one ``audit``
event for it, with the config's ``precision``; every dispatch's input
signature is noted for the recompile sentry, which is read at each drain.
``fit`` disarms it on every exit: a later engine in the process does not
emit into this run's ledger.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from tpu_dist_torch.configs import LMConfig
from tpu_dist_torch.data.sampler import DistributedSampler
from tpu_dist_torch.data.tokens import load_token_dataset
from tpu_dist_torch.device import peak_flops
from tpu_dist_torch.engine import checkpoint as ckpt
from tpu_dist_torch.engine.lm_steps import (LM_METRIC_KEYS, ROUTER_KEYS,
                                            ModelParallel, make_lm_batches,
                                            shift_rows, zeros_lm_metrics)
from tpu_dist_torch.engine.state import TrainState
from tpu_dist_torch.engine.steps import DataParallel
from tpu_dist_torch.obs import RunObs, env_int
from tpu_dist_torch.obs.health import PROBE_KEYS, validate_health
from tpu_dist_torch.ops.optim import lm_lr_schedule, make_optimizer
from tpu_dist_torch.ops.pallas_adamw import FusedAdamW
from tpu_dist_torch.ops.precision import make_policy
from tpu_dist_torch.ops.quant import fused_quant_active, validate_quant
from tpu_dist_torch.parallel.collectives import P2P_HOST_STAGED
from tpu_dist_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                          MODEL_AXIS, SEQ_AXIS, STAGE_AXIS,
                                          gather_leaf, make_mesh, shard_leaf)
from tpu_dist_torch.parallel.overlap import (bucketed_grad_sync,
                                             validate_tp_impl)
from tpu_dist_torch.parallel.supervisor import PREEMPT_SNAPSHOT_RC
from tpu_dist_torch.plan.compile import (Bindings, audit_recorder,
                                         check_audit_sentry, compile_plan,
                                         current_switches, finish_audit,
                                         note_audit_dispatch,
                                         resolve_config_plan, set_audit,
                                         validate_audit)
from tpu_dist_torch.plan.ir import Plan
from tpu_dist_torch.utils.meters import MeterBank
from tpu_dist_torch.utils.mfu import lm_flops_per_token, moe_lm_flops_per_token

# knob -> its off value, for a knob the port does not honour (anything
# else raises NotImplementedError naming the knob): none is left
UNPORTED: Dict[str, tuple] = {}
ATTNS = ("full", "blockwise", "flash")
# run-meta keys a resume must match before any state loads, and those a
# mid-epoch resume must match as well
HARD_GEOMETRY = ("vocab_size", "num_layers", "d_model", "num_heads",
                 "seq_len", "num_experts", "pp_stages")
SOFT_GEOMETRY = ("steps_per_epoch", "batch_size", "dataset_len")


def refuse_unported(cfg: LMConfig) -> None:
    for knob, off in UNPORTED.items():
        val = getattr(cfg, knob)
        if val not in off:
            raise NotImplementedError(
                f"LMConfig.{knob}={val!r} is not ported (supported: "
                f"{' | '.join(repr(o) for o in off)})")


class LMTrainer:
    """The LM trainer, one device per process, in every mode of the
    reference's (module docstring has the tour)."""

    def __init__(self, cfg: LMConfig, *, device=None,
                 init_params: Optional[dict] = None):
        # the step plan rewrites the plan-owned knobs and sets the kernel
        # switches before anything below reads them
        cfg, self._plan_info = resolve_config_plan(cfg, device)
        refuse_unported(cfg)
        validate_audit(cfg.audit, cfg.profile_dir)
        if cfg.resume and not os.path.exists(cfg.resume):
            raise FileNotFoundError(
                f"--resume checkpoint not found: {cfg.resume}")
        if cfg.pretrained and not os.path.exists(cfg.pretrained):
            raise FileNotFoundError(
                f"--pretrained checkpoint not found: {cfg.pretrained}")
        if cfg.optimizer not in ("sgd", "adamw", "fused_adamw"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r} "
                             "(sgd|adamw|fused_adamw)")
        if cfg.attn not in ATTNS:
            raise ValueError(f"unknown attn {cfg.attn!r} "
                             f"({'|'.join(ATTNS)})")
        validate_health(cfg.health)
        validate_quant(cfg.quant)
        self.k = cfg.steps_per_dispatch
        if self.k < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if cfg.data_placement not in ("auto", "host", "device"):
            raise ValueError(f"unknown data_placement {cfg.data_placement!r}")
        self.accum = cfg.grad_accum_steps
        if self.accum < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        if self.accum > 1:
            if self.k > 1:
                raise ValueError("grad_accum_steps and steps_per_dispatch "
                                 "> 1 are mutually exclusive")
            if cfg.data_placement == "device":
                raise ValueError("grad_accum_steps > 1 requires "
                                 "data_placement='host'/'auto' (the indexed "
                                 "window step has no microbatch loop)")
        axes = dict(zip(cfg.mesh_axes or (), cfg.mesh_shape or ()))
        if axes.get(STAGE_AXIS, 1) > 1 and cfg.fsdp:
            # before the mesh: the reference's check (:416)
            raise ValueError("a 'stage' mesh axis does not compose with "
                             "fsdp (blocks already shard over 'stage')")
        self.mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axes, device=device)
        self.cfg = cfg
        self.device = self.mesh.device
        self.rank, self.world = self.mesh.rank, self.mesh.size
        self.is_main = self.mesh.is_main

        # ---- mode (:86-130) ----
        shape = self.mesh.shape
        self.use_sp = shape.get(SEQ_AXIS, 1) > 1
        self.use_tp = shape.get(MODEL_AXIS, 1) > 1
        self.use_ep = shape.get(EXPERT_AXIS, 1) > 1
        self.use_pp = shape.get(STAGE_AXIS, 1) > 1
        validate_tp_impl(cfg.tp_impl)
        self.use_ring = self.use_tp and cfg.tp_impl == "ring"
        self.use_bucket = cfg.grad_bucket_mb > 0
        self._validate_mode()
        self.use_fsdp = cfg.fsdp and not (self.use_sp or self.use_tp
                                          or self.use_ep or self.use_pp)
        self.mode = (f"pp-{cfg.pp_schedule}"
                     + ("+tp" if self.use_tp else "") if self.use_pp else
                     "sp-ring" if self.use_sp else
                     ("ep-moe" + ("+tp" if self.use_tp else ""))
                     if self.use_ep else
                     ("tp-ring" if self.use_ring else "tp") if self.use_tp
                     else "fsdp" if self.use_fsdp else
                     ("dp-moe" if cfg.num_experts else "dp")
                     + ("-bucketed" if self.use_bucket else ""))

        # ---- batch geometry: the data axis splits the batch ----
        d_size = shape.get(DATA_AXIS, 1)
        self.data_size, self.data_rank = d_size, self.mesh.coord(DATA_AXIS)
        if cfg.batch_size % d_size:
            raise ValueError(
                f"global batch {cfg.batch_size} (sequences) must divide by "
                f"the data axis ({d_size})")
        if self.use_sp and cfg.seq_len % shape[SEQ_AXIS]:
            raise ValueError(f"seq_len {cfg.seq_len} not divisible by the "
                             f"seq axis ({shape[SEQ_AXIS]})")
        if self.use_pp and (cfg.batch_size // d_size) % cfg.pp_microbatches:
            raise ValueError(
                f"per-data-shard batch {cfg.batch_size // d_size} not "
                f"divisible by {cfg.pp_microbatches} microbatches")
        if self.accum > 1:
            if self.use_sp or self.use_pp:
                raise ValueError("grad_accum_steps > 1 supports the jit "
                                 "modes (dp/fsdp/tp/ep); pp already "
                                 "microbatches via --pp-microbatches")
            if cfg.batch_size % (self.accum * d_size):
                raise ValueError(
                    f"global batch {cfg.batch_size} not divisible by "
                    f"grad_accum_steps x data axis ({self.accum} x {d_size})")
        self.dp = DataParallel(self.mesh.group(DATA_AXIS), d_size,
                               bucket_mb=cfg.grad_bucket_mb)
        self.policy = make_policy(cfg.precision)
        # whether the int8 matmuls ride the fused kernel (csrc/fused_quant.cu;
        # on the CPU its plain version runs): the step records' ``fused``
        # flag, as in the reference
        self._fused_quant = (cfg.quant == "int8" and fused_quant_active()
                             and self.device.type == "cuda")

        # ---- corpus ----
        seed = cfg.seed if cfg.seed is not None else 0
        self.train_ds, self.val_ds = load_token_dataset(
            cfg.data, cfg.seq_len, cfg.vocab_size, val_frac=cfg.val_frac,
            synth_tokens=cfg.synth_tokens, seed=seed, val_data=cfg.val_data)
        self.vocab_size = self.train_ds.vocab_size
        self.local_batch = cfg.batch_size // d_size

        # ---- model: whole, then laid out for the mode ----
        self.model = self._build_model(seed if init_params is None else None)
        if init_params is not None:
            from tpu_dist_torch.interop import load_flax_params
            load_flax_params(self.model, init_params)
        if cfg.pretrained:
            self._warm_start(cfg.pretrained)
        self._shapes = [(n, tuple(p.shape))
                        for n, p in self.model.named_parameters()]
        self._model_shapes = self._shapes     # the whole model's, for FLOPs
        if cfg.num_experts and not self.use_sp:
            self.model.set_data(self.mesh.axis(DATA_AXIS))
        specs, leaves = self._lay_out()
        self.model.requires_grad_(True)
        self.steps_per_epoch = max(
            1, -(-len(self.train_ds) // cfg.batch_size))
        total_steps = (cfg.lr_decay_steps or cfg.max_steps
                       or cfg.epochs * self.steps_per_epoch)
        self.lr_schedule = lm_lr_schedule(
            cfg.lr, cfg.lr_schedule, warmup_steps=cfg.warmup_steps,
            total_steps=total_steps, steps_per_epoch=self.steps_per_epoch,
            step_epochs=cfg.lr_step_epochs, min_frac=cfg.lr_min_frac)
        # pp clips inside its step by the cross-stage global norm
        # (parallel.pp._clip_pp_grads), so its optimizer's clip is off
        # (:174-201)
        clip = 0.0 if self.use_pp else cfg.grad_clip
        if cfg.optimizer == "fused_adamw":
            self.tx = FusedAdamW(self.lr_schedule, b1=cfg.adam_b1,
                                 b2=cfg.adam_b2, eps=cfg.adam_eps,
                                 weight_decay=cfg.weight_decay,
                                 clip_norm=clip)
        else:
            self.tx = make_optimizer(cfg.lr, cfg.momentum, cfg.weight_decay,
                                     schedule=self.lr_schedule,
                                     kind=cfg.optimizer, b1=cfg.adam_b1,
                                     b2=cfg.adam_b2, eps=cfg.adam_eps,
                                     grad_clip=clip)
        if leaves is None:
            self.state = TrainState.create(self.model, self.tx)
        else:
            names, params = leaves
            self.state = TrainState(step=0, params=params,
                                    opt_state=self.tx.init(params),
                                    param_names=names)
        self.specs = None if specs is None else [
            specs.get(n, (None,) * len(s)) for n, s in self._shapes]
        self.par = self._parallel_plan(leaves)
        # ranks whose router aux the metric sums add up (pp: each stage's
        # own blocks' aux, so only the data axis repeats it)
        self._aux_ranks = 1
        for a in self.par.metric_axes:
            if not (self.use_pp and a == STAGE_AXIS):
                self._aux_ranks *= shape.get(a, 1)
        self.pipe = None
        if self.use_pp:
            self.pipe = self._pipeline()
        elif self._sharded():
            self.tx.sq_norm = self.par.sq_norm

        # ---- windows over device-resident rows (:209-303) ----
        rows_bytes = ((len(self.train_ds) + len(self.val_ds))
                      * (cfg.seq_len + 1) * 4)
        fits = rows_bytes <= int(os.environ.get("TPU_DIST_DEVICE_DATA_MAX",
                                                str(1 << 30)))
        self.device_data = (cfg.data_placement == "device"
                            or (cfg.data_placement == "auto" and fits
                                and self.k > 1))
        self._train_rows_dev = self._val_rows_dev = None
        if self.device_data:
            self._train_rows_dev = torch.from_numpy(
                self.train_ds.rows_array()).to(self.device)
            self._val_rows_dev = torch.from_numpy(
                self.val_ds.rows_array()).to(self.device)
        elif self.k > 1:
            raise ValueError(
                "steps_per_dispatch > 1 needs the device-resident row path "
                "(corpus too large for TPU_DIST_DEVICE_DATA_MAX, or "
                "data_placement='host')")

        # ---- geometry meta / resume (:305-349) ----
        self._run_meta = {
            "vocab_size": self.vocab_size, "num_layers": cfg.num_layers,
            "d_model": cfg.d_model, "num_heads": cfg.num_heads,
            "seq_len": cfg.seq_len, "num_experts": cfg.num_experts,
            "pp_stages": shape[STAGE_AXIS] if self.use_pp else 0,
            "steps_per_epoch": self.steps_per_epoch,
            "batch_size": cfg.batch_size, "dataset_len": len(self.train_ds),
            "mode": self.mode}
        self.start_epoch = 0
        self._skip_batches = 0
        self.best_ppl = float("inf")
        if cfg.resume:
            self._resume(cfg.resume)
        # checkpoint-less dp-pure recovery (:352-366): on a supervisor's
        # mesh re-expansion (TPU_DIST_PEER_RESUME) adopt rank 0's live
        # replicated state; sharded modes take the disk path above
        self._dp_pure = not (self.use_sp or self.use_tp or self.use_ep
                             or self.use_pp or cfg.fsdp)
        self._peer_restored = False
        if os.environ.get("TPU_DIST_PEER_RESUME") == "1" and self._dp_pure:
            _, self._peer_restored = ckpt.peer_restore_state(self.state)
            if self._peer_restored:
                step_done = self.state.step
                self.start_epoch = step_done // self.steps_per_epoch
                self._skip_batches = step_done % self.steps_per_epoch
                self.log(f"=> peer-restored state from rank 0 at step "
                         f"{step_done} (no disk round-trip); resuming "
                         f"epoch {self.start_epoch}")
        self._epoch_in_progress = self.start_epoch
        self.last_tok_s = 0.0
        self._warmed = False
        self._flops_per_step = None
        # every step, window and eval from the plan lowering
        self.compiled = compile_plan(self._step_plan(), Bindings(
            mesh=self.mesh, model=self.model, tx=self.tx, par=self.par,
            pipe=self.pipe, dp=self.dp))
        # the run's ledger (attempt lineage), health sentry, watchdog,
        # goodput sink, faults, heartbeat and preemption (obs.RunObs)
        self.obs = RunObs("lm", cfg, process_index=self.rank, unit="tok/s",
                          device=self.device, plan_info=self._plan_info)
        self.ledger, self.health = self.obs.ledger, self.obs.health
        # the program audit (analysis.proglint), armed for this run's
        # programs before their first dispatch
        set_audit(cfg.audit, self.ledger)
        self._comm_probe_s = (self._measure_comm_probe()
                              if cfg.grad_bucket_mb > 0 else None)

    # ------------------------------------------------------------------
    def _validate_mode(self):
        """The reference's mode checks (``:406-470``), word for word; its
        stage+fsdp check runs before the mesh (``__init__``) and its
        schedule check in ``parallel.pp.Pipeline``."""
        cfg = self.cfg
        multi = [a for a in ("seq", "model", "expert", "stage")
                 if a in self.mesh.axis_names and self.mesh.shape[a] > 1]
        if len(multi) > 1 and set(multi) not in ({"stage", "model"},
                                                 {"expert", "model"}):
            raise ValueError(
                f"unsupported model-parallel axis combination {multi} "
                "(one axis at a time, stage+model for pp x tp, or "
                "expert+model for MoE x tp)")
        if self.use_ep and not cfg.num_experts:
            raise ValueError("an 'expert' mesh axis requires num_experts > 0")
        if self.use_tp and cfg.num_experts and not (self.use_ep
                                                    or self.use_pp):
            raise ValueError("MoE + pure tensor parallelism not supported: "
                             "use data=N,expert=M[,model=K] or "
                             "data=N,stage=S,model=K")
        if cfg.fsdp and (self.use_sp or self.use_tp or self.use_ep):
            self.log("warning: fsdp applies to the pure data-parallel "
                     "layout; ignored with a seq/model/expert mesh axis")
        if self.use_ring:
            tp = self.mesh.shape["model"]
            if self.use_ep or self.use_pp:
                raise ValueError("tp_impl='ring' drives the pure "
                                 "data x model layout; pp/ep compositions "
                                 "ride the GSPMD impl")
            if cfg.seq_len % tp:
                raise ValueError(f"tp_impl='ring' seq-shards the residual: "
                                 f"seq_len {cfg.seq_len} must divide by the "
                                 f"model axis ({tp})")
            if cfg.num_heads % tp:
                raise ValueError(f"tp_impl='ring' shards heads: num_heads "
                                 f"{cfg.num_heads} must divide by the model "
                                 f"axis ({tp})")
            if cfg.grad_accum_steps > 1:
                raise ValueError("tp_impl='ring' does not compose with "
                                 "grad_accum_steps > 1 yet (the accum step "
                                 "is GSPMD-partitioned)")
        if self.use_bucket:
            if (self.use_tp or self.use_sp or self.use_ep or self.use_pp
                    or cfg.fsdp):
                raise ValueError(
                    "grad_bucket_mb > 0 decomposes the pure-dp gradient "
                    "allreduce (replicated params); fsdp/tp/sp/pp/ep keep "
                    "their GSPMD-scheduled sync")
            if cfg.grad_accum_steps > 1:
                raise ValueError("grad_bucket_mb does not compose with "
                                 "grad_accum_steps > 1 yet")

    def _lay_out(self):
        """Lay the whole model out for the mode (``_place``, ``:590-616``):
        (specs by param name or None, (names, shard leaves) under fsdp or
        None). Under pp the model keeps its stage's blocks only, and
        ``_shapes`` becomes the stage's leaves."""
        if self.use_pp:
            from tpu_dist_torch.parallel.pp import lay_out_stage_
            self._shapes, specs = lay_out_stage_(self.model, self.mesh)
            return specs, None
        if self.use_ep:
            from tpu_dist_torch.parallel.ep import shard_moe_
            return shard_moe_(self.model, self.mesh), None
        if self.use_ring:
            from tpu_dist_torch.parallel.overlap import ring_lm_
            ring_lm_(self.model, self.mesh.axis(MODEL_AXIS))
            return None, None
        if self.use_tp:
            from tpu_dist_torch.parallel.tp import shard_lm_
            return shard_lm_(self.model, self.mesh), None
        if self.use_fsdp:
            from tpu_dist_torch.parallel.fsdp import fsdp_specs, shard_leaves
            specs = fsdp_specs(self._shapes, self.data_size)
            return specs, shard_leaves(self.model, specs, self.mesh)
        return None, None

    def _parallel_plan(self, leaves) -> ModelParallel:
        """The mode's ``lm_steps.ModelParallel``."""
        cfg = self.cfg
        kw = dict(mode=self.mode, mesh=self.mesh, specs=self.specs,
                  aux_weight=cfg.moe_aux_weight, moe=bool(cfg.num_experts),
                  dp=self.dp)
        if self.use_pp:
            kw.update(metric_axes=(STAGE_AXIS, DATA_AXIS))
        elif self.use_sp:
            kw.update(seq=self.mesh.axis(SEQ_AXIS),
                      grad_mean_axes=(SEQ_AXIS, DATA_AXIS),
                      metric_axes=(SEQ_AXIS, DATA_AXIS))
        elif self.use_ring:
            kw.update(ring=self.mesh.axis(MODEL_AXIS),
                      grad_mean_axes=(MODEL_AXIS, DATA_AXIS),
                      metric_axes=(MODEL_AXIS, DATA_AXIS))
        elif self.use_tp:
            kw.update(vocab=self.mesh.axis(MODEL_AXIS))
        if leaves is not None:
            kw.update(fsdp_names=leaves[0])
        return ModelParallel(**kw)

    def _pipeline(self):
        """The pp step's ``parallel.pp.Pipeline`` on this rank's stage."""
        from tpu_dist_torch.parallel.pp import Pipeline

        cfg = self.cfg
        return Pipeline(self.model, self.mesh, cfg.pp_microbatches,
                        cfg.pp_schedule, aux_weight=cfg.moe_aux_weight,
                        loss_chunk=cfg.loss_chunk, grad_clip=cfg.grad_clip,
                        specs=self.specs or [(None,) * len(s)
                                             for _, s in self._shapes],
                        param_names=[n for n, _ in self._shapes])

    def _donate(self) -> bool:
        """The resolved plan's ``donate`` (True without a plan)."""
        return self._plan_info["plan"].donate if self._plan_info else True

    def _step_plan(self) -> Plan:
        """The plan this run's steps lower from: the mode's layout and
        sync, the config's step knobs and the kernel switches as they
        stand (a resolved plan set both)."""
        cfg = self.cfg
        explicit = self.use_sp or self.use_ring or self.use_bucket
        return Plan(engine="lm",
                    layout=("sp" if self.use_sp else
                            "tp" if self.use_tp else "dp"),
                    sync="explicit" if explicit else "gspmd",
                    quant=cfg.quant,
                    tp_impl="ring" if self.use_ring else "gspmd",
                    grad_bucket_mb=float(cfg.grad_bucket_mb),
                    window="indexed" if self.device_data else "none",
                    steps_per_dispatch=self.k, grad_accum_steps=self.accum,
                    loss_chunk=cfg.loss_chunk, health=cfg.health,
                    aux_weight=cfg.moe_aux_weight, donate=self._donate(),
                    **current_switches())

    def _sharded(self) -> bool:
        return self.specs is not None and any(any(s) for s in self.specs)

    def _fused(self, i: int) -> int:
        from tpu_dist_torch.parallel.tp import fused_of
        return fused_of(self._shapes[i][0]) if not self.use_fsdp else 1

    def _gather_leaf(self, i: int, t: torch.Tensor) -> torch.Tensor:
        if self.use_pp:
            from tpu_dist_torch.parallel.pp import gather_stage_leaf
            return gather_stage_leaf(t, self._shapes[i][0],
                                     self.pipe.specs[i], self.mesh,
                                     self._fused(i))
        return gather_leaf(t, self.specs[i], self.mesh, self._fused(i))

    def _slice_leaf(self, i: int, t: torch.Tensor) -> torch.Tensor:
        if self.use_pp:
            from tpu_dist_torch.parallel.pp import slice_stage_leaf
            return slice_stage_leaf(t, self._shapes[i][0],
                                    self.pipe.specs[i], self.mesh,
                                    self._fused(i))
        return shard_leaf(t, self.specs[i], self.mesh, self._fused(i))

    def _layout_gather(self) -> bool:
        """Whether checkpoints gather the leaves (and resumes slice them)."""
        return self.use_pp or self._sharded()

    def whole_model(self):
        """This rank's model with whole params on one device, for decode
        after a sharded run (every rank must call it: the leaves are
        gathered); the trained model itself in a replicated mode."""
        if not self._layout_gather() and not (self.use_ring or self.use_sp):
            return self.model
        model = self._build_model(None, whole=True)
        if self.use_pp:
            return self._whole_from_stages(model)
        with torch.no_grad():
            for i, ((name, _), p) in enumerate(zip(self._shapes,
                                                   self.state.params)):
                full = self._gather_leaf(i, p.detach()) if self.specs \
                    else p.detach()
                model.get_parameter(name).copy_(full)
        return model

    @torch.no_grad()
    def _whole_from_stages(self, model):
        """``model`` (whole, fresh) filled from every stage's leaves."""
        s_size = self.mesh.shape[STAGE_AXIS]
        per = self.cfg.num_layers // s_size
        for i, ((name, _), p) in enumerate(zip(self._shapes,
                                               self.state.params)):
            full = self._gather_leaf(i, p.detach())
            if not name.startswith("blocks."):
                model.get_parameter(name).copy_(full)
                continue
            _, j, rest = name.split(".", 2)
            for s in range(s_size):
                model.get_parameter(f"blocks.{s * per + int(j)}.{rest}"
                                    ).copy_(full[s])
        return model

    def _measure_comm_probe(self) -> float:
        """Seconds of one bucketed gradient sync alone at this run's bucket
        geometry (zeros in the params' shapes), after one warm sync: the
        unoverlapped comm time the step records carry as ``comm_s``
        (``:620-641``)."""
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=self.device)
                 for p in self.state.params]

        def sync():
            out = bucketed_grad_sync(zeros, self.cfg.grad_bucket_mb,
                                     group=self.mesh.group(DATA_AXIS))
            out[-1].sum().item()     # the device's work done, on every rank

        sync()
        t0 = time.time()
        sync()
        return time.time() - t0

    def _warm_start(self, path: str) -> None:
        """Graft a checkpoint's params (the port's ``.pt`` or the
        reference's ``.msgpack``) onto the fresh whole model where name and
        shape match (``:133-165``); a pipeline-stacked donor is refused."""
        params, _, meta = ckpt.load_warmstart(path, self.model)
        if meta.get("pp_stages"):
            raise ValueError(
                f"--pretrained {path} was saved by a pipeline-parallel run "
                f"({meta['pp_stages']} stages): its blocks are stage-stacked "
                "and would not graft onto a fresh model. Unstack it first "
                "(parallel.pp.unstack_pipeline_params) and re-save, or "
                "warm-start from a non-pp checkpoint.")
        n_p, skipped = ckpt.graft_params(self.model.named_parameters(),
                                         params)
        if n_p == 0:
            raise ValueError(
                f"--pretrained {path} (arch {meta.get('arch', '?')!r}) "
                "shares no tensors with this model -- wrong checkpoint?")
        self.log(f"=> warm-started {n_p} param tensors from {path}"
                 + (f"; fresh init kept for {skipped}" if skipped else ""))

    def _resume(self, path: str) -> None:
        """``--resume``: the hard geometry keys are checked on the header
        before any state loads; the soft ones only bind a mid-epoch
        checkpoint, whose step count gives the epoch and the batches to
        skip."""
        def detail(bad):
            return ", ".join(f"{k}: checkpoint {a} vs run {b}"
                             for k, (a, b) in bad.items())

        pre = ckpt.read_checkpoint_meta(path)
        bad = {k: (pre[k], self._run_meta[k]) for k in HARD_GEOMETRY
               if k in pre and pre[k] != self._run_meta[k]}
        if bad:
            raise ValueError("--resume checkpoint has different model "
                             f"geometry: {detail(bad)}")
        _, meta = ckpt.load_checkpoint(
            path, self.state,
            reslice=self._slice_leaf if self._layout_gather() else None)
        self.start_epoch = meta.get("epoch", 0)
        self.best_ppl = meta.get("best_ppl", float("inf"))
        if meta.get("mid_epoch"):
            soft = {k: (meta[k], self._run_meta[k]) for k in SOFT_GEOMETRY
                    if k in meta and meta[k] != self._run_meta[k]}
            if soft:
                raise ValueError("mid-epoch resume requires the checkpoint's "
                                 f"data/batch geometry ({detail(soft)})")
            self.start_epoch = self.state.step // self.steps_per_epoch
            self._skip_batches = self.state.step % self.steps_per_epoch
            if self._skip_batches:
                self.log(f"=> mid-epoch checkpoint: resuming epoch "
                         f"{self.start_epoch}, skipping "
                         f"{self._skip_batches} already-applied batches")
        self.log(f"=> resumed from {path} (epoch {self.start_epoch})")

    # ------------------------------------------------------------------
    def _build_model(self, seed, whole: bool = False):
        """The whole model (``:469-505``); under sp its attention is the
        ring over ``seq`` unless ``whole`` (a one-device copy)."""
        from tpu_dist_torch.models.transformer import (TransformerLM,
                                                       full_attention)
        from tpu_dist_torch.ops.flash_attention import (
            blockwise_attention_fn, flash_attention_fn)

        cfg = self.cfg
        if cfg.attn == "flash":
            attn_fn = flash_attention_fn(block_k=cfg.attn_block)
        elif cfg.attn == "blockwise":
            attn_fn = blockwise_attention_fn(cfg.attn_block)
        else:
            attn_fn = full_attention
        if self.use_sp and not whole:
            from tpu_dist_torch.parallel.ring_attention import \
                ring_attention_fn
            if cfg.attn != "full":
                self.log(f"warning: a 'seq' mesh axis uses ring attention; "
                         f"attn={cfg.attn} ignored")
            attn_fn = ring_attention_fn(self.mesh.axis(SEQ_AXIS))
        kw = dict(vocab_size=self.vocab_size, num_layers=cfg.num_layers,
                  d_model=cfg.d_model, num_heads=cfg.num_heads,
                  max_len=cfg.seq_len, dtype=self.policy.compute_dtype,
                  param_dtype=self.policy.param_dtype, attn_fn=attn_fn,
                  quant=cfg.quant, remat=cfg.remat, device=self.device,
                  seed=seed)
        if cfg.num_experts:
            from tpu_dist_torch.models.moe import MoETransformerLM
            return MoETransformerLM(
                num_experts=cfg.num_experts, router_top_k=cfg.router_top_k,
                group_size=cfg.moe_group_size,
                capacity_factor=cfg.moe_capacity_factor, **kw)
        return TransformerLM(**kw)

    def log(self, *a, **kw):
        if self.is_main:
            print(*a, **kw, flush=True)

    def _epoch_indices(self, ds, train: bool, epoch: int):
        """(idx (nb, B), valid (nb, B)): the reference's batch-blocked
        sampler layout, this rank's data shard's rows."""
        sampler = DistributedSampler(
            len(ds), num_replicas=self.data_size, rank=self.data_rank,
            shuffle=train,
            seed=(self.cfg.seed or 0) + (17 if not train else 0),
            batch_size=self.local_batch)
        sampler.set_epoch(epoch)
        idx, valid = sampler.indices_with_valid()
        nb = sampler.num_samples // self.local_batch
        n = nb * self.local_batch
        shape = (nb, self.local_batch)
        return (np.asarray(idx[:n], np.int32).reshape(shape),
                np.asarray(valid[:n], np.float32).reshape(shape))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """One host batch to the device: a pinned, non-blocking copy on
        CUDA, so the upload never syncs the host with the device."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _batch(self, ds, idx):
        inputs, targets = make_lm_batches(ds.get_rows(idx))
        return self._to_device(inputs).long(), self._to_device(targets).long()

    def _step(self, inputs, targets) -> Dict[str, torch.Tensor]:
        self.state, m = self.compiled.advance(self.compiled.step, self.state,
                                              inputs, targets)
        return m

    def _step_flops(self) -> float:
        if self._flops_per_step is None:
            cfg = self.cfg
            if cfg.num_experts:
                per_token = moe_lm_flops_per_token(
                    self._model_shapes, cfg.num_layers, cfg.seq_len,
                    cfg.d_model,
                    cfg.num_experts, cfg.router_top_k,
                    total_tokens=cfg.batch_size * cfg.seq_len,
                    group_size=cfg.moe_group_size,
                    capacity_factor=cfg.moe_capacity_factor)
            else:
                per_token = lm_flops_per_token(
                    self._model_shapes, cfg.num_layers, cfg.seq_len,
                    cfg.d_model)
            self._flops_per_step = per_token * cfg.batch_size * cfg.seq_len
        return self._flops_per_step

    def _mfu(self, tok_per_s: float):
        """(tflops, mfu) from the analytical model FLOPs; mfu None where
        the card's peak is not in the table (the CPU included)."""
        tokens = self.cfg.batch_size * self.cfg.seq_len
        tflops = tok_per_s * self._step_flops() / tokens / 1e12
        peak = peak_flops(self.device, self.policy.compute_dtype)
        return tflops, (tflops * 1e12 / (peak * self.world) if peak else None)

    def _memory(self) -> dict:
        if self.device.type != "cuda":
            return {"hbm_bytes_in_use": None, "hbm_peak_bytes": None}
        return {"hbm_bytes_in_use": torch.cuda.memory_allocated(self.device),
                "hbm_peak_bytes":
                    torch.cuda.max_memory_allocated(self.device)}

    def _drain(self, pending, meters) -> None:
        """One fetch of every pending step's metric sums (the loop's sync
        point), then one ledger ``step`` record per step, with the fetch's
        device-block time shared out across the window, and the health
        sentry's look at each."""
        keys = LM_METRIC_KEYS + PROBE_KEYS \
            + (ROUTER_KEYS if self.cfg.num_experts else ())
        tr = self.obs.tracer
        with tr.span("device"):
            rows = torch.stack([torch.stack([m[k] for k in keys])
                                for m, _ in pending]).tolist()
        device_s = tr.pop().get("device", 0.0)
        total_steps = sum(info["n_steps"] for _, info in pending) or 1
        mem = self._memory()
        for row, (_, info) in zip(rows, pending):
            m = dict(zip(keys, row))
            cnt = m["count"]
            loss = m["loss_sum"] / cnt
            if math.isfinite(loss) or self.health.policy != "skip":
                meters.update("Loss", loss, int(cnt))
                meters.update("Acc", m["correct1"] / cnt, int(cnt))
            n = info["n_steps"]
            share = device_s * n / total_steps
            wall = info["data_s"] + info["dispatch_s"] + share
            tok_s = info["n_items"] / max(wall, 1e-9)
            _, mfu = self._mfu(tok_s)
            gn, un = m["grad_norm"] / n, m["update_norm"] / n
            extra = {}
            if m.get("router_mass_n"):
                # mean combine mass a token (1 = no capacity drop) and the
                # router aux loss a step (summed over the metric axes)
                extra["router_mass"] = m["router_mass_sum"] / \
                    m["router_mass_n"]
                extra["router_aux"] = m["router_aux"] / (n * self._aux_ranks)
                meters.update("RMass", extra["router_mass"],
                              int(m["router_mass_n"]))
            if self.use_ring or self.use_sp or self.use_pp:
                extra["p2p_host_staged"] = P2P_HOST_STAGED["calls"]
            self.ledger.emit(
                "step", step=info["step"], loss=loss, throughput=tok_s,
                unit="tok/s", data_s=info["data_s"],
                dispatch_s=info["dispatch_s"], device_s=share,
                comm_s=(self._comm_probe_s * n if self._comm_probe_s
                        else None),
                mfu=mfu, steps_in_dispatch=n, warm=info["warm"],
                fused=self._fused_quant, grad_norm=gn,
                nonfinite_count=m["nonfinite_count"], update_norm=un,
                **extra, **mem)
            self.obs.record_skew(info["step"], wall, info["data_s"], n)
            self.health.observe(info["step"], loss,
                                nonfinite=m["nonfinite_count"],
                                grad_norm=gn, update_norm=un, n_steps=n)
        pending.clear()
        self.obs.heartbeat()   # device progress proven at this fetch
        check_audit_sentry()   # PL005: host-side counts, no sync

    # ------------------------------------------------------------------
    def _meters(self, epoch: int) -> MeterBank:
        cols = [("Time", "6.3f"), ("Data", "6.3f"), ("Loss", ".4e"),
                ("Acc", "6.3f")]
        if self.cfg.num_experts:
            cols.append(("RMass", "6.3f"))
        return MeterBank(self.steps_per_epoch, cols,
                         prefix=f"Epoch: [{epoch}]")

    def _warm_up(self, metrics, t_epoch: float, n: int):
        """The run's first step or window carries the kernel builds and the
        allocator's warm-up: one deliberate sync, so they stay out of
        tok/s; returns (warm seconds, warm batches) of this epoch."""
        if self._warmed:
            return 0.0, 0
        metrics["count"].item()
        self._warmed = True
        return time.time() - t_epoch, n

    def _epoch_result(self, meters, batches, warm) -> Dict[str, float]:
        snap = meters.snapshot()
        return {"loss": snap["Loss"]["avg"], "acc": snap["Acc"]["avg"],
                "batches": batches, "warmup_secs": warm[0],
                "warmup_batches": warm[1]}

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        if self.device_data:
            return self._train_epoch_windowed(epoch)
        cfg = self.cfg
        idx, _ = self._epoch_indices(self.train_ds, True, epoch)
        nb = len(idx)
        meters = self._meters(epoch)
        skip, self._skip_batches = self._skip_batches, 0
        self.model.train()
        self.obs.resume()      # the watchdog watches from epoch entry
        pending = []
        warm = (0.0, 0)
        i = skip - 1
        tokens_per_batch = cfg.batch_size * cfg.seq_len
        t_epoch = end = time.time()
        for i in range(skip, nb):
            inputs, targets = self._batch(self.train_ds, idx[i])
            gstep = epoch * self.steps_per_epoch + i
            self.obs.fire_step_faults(gstep, self.state.params)
            data_s = time.time() - end
            meters.update("Data", data_s)
            self._preempt_check(pending, meters)
            was_cold = not self._warmed
            metrics, dispatch_s, warmed = self._dispatch(
                gstep, "train_step", lambda: self._step(inputs, targets),
                t_epoch, 1, (inputs, targets))
            warm = warmed or warm
            pending.append((metrics, {
                "step": gstep, "n_steps": 1, "n_items": tokens_per_batch,
                "data_s": data_s, "dispatch_s": dispatch_s,
                "warm": was_cold}))
            boundary = i % cfg.print_freq == 0 or i == nb - 1
            if boundary:
                self._drain(pending, meters)
            meters.update("Time", time.time() - end)
            if boundary and self.is_main:
                meters.display(i)
            end = time.time()
            if self._step_cap_hit(epoch, i + 1):
                break
        if pending:  # a max_steps break can land between print boundaries
            self._drain(pending, meters)
        self.obs.pause()       # validation and checkpoints follow
        return self._epoch_result(meters, i + 1 - skip, warm)

    def _device_windows(self, epoch: int, skip: int):
        """(n, idx (n, B) on the device) windows over the epoch's batches
        after ``skip``, clipped to what is left of ``max_steps`` (a window
        never overshoots it): one upload of the epoch's index array."""
        batches, _ = self._epoch_indices(self.train_ds, True, epoch)
        batches = batches[skip:]
        if self.cfg.max_steps:
            remaining = self.cfg.max_steps - (
                epoch * self.steps_per_epoch + skip)
            batches = batches[:max(remaining, 0)]
        idx = self._to_device(batches)
        return [(min(self.k, len(idx) - i), idx[i:i + self.k])
                for i in range(0, len(idx), self.k)]

    def window_step(self, idx_window) -> Dict[str, torch.Tensor]:
        """K optimizer steps back to back, no host sync: step j gathers its
        (B, L+1) rows from the resident matrix by ``idx_window[j]`` and
        shifts them on the device. Returns the metric sums over the K
        steps (the plan's indexed window)."""
        self.state, m = self.compiled.advance(
            self.compiled.train_step, self.state, self._train_rows_dev,
            idx_window)
        return m

    def _train_epoch_windowed(self, epoch: int) -> Dict[str, float]:
        """K-steps-per-dispatch epoch over device-resident rows (``:872``):
        the same math as the per-batch loop, one host round trip per print
        window."""
        cfg = self.cfg
        nb = self.steps_per_epoch
        meters = self._meters(epoch)
        skip, self._skip_batches = self._skip_batches, 0
        self.model.train()
        self.obs.resume()      # the watchdog watches from epoch entry
        pending = []
        done, last_print = skip, skip - 1
        warm = (0.0, 0)
        tokens_per_batch = cfg.batch_size * cfg.seq_len
        t_epoch = end = time.time()
        for n, idx_window in self._device_windows(epoch, skip):
            gstep = epoch * self.steps_per_epoch + done
            self.obs.fire_step_faults(gstep, self.state.params)
            data_s = time.time() - end
            meters.update("Data", data_s / n, n)
            self._preempt_check(pending, meters)
            was_cold = not self._warmed
            sums, dispatch_s, warmed = self._dispatch(
                gstep, "window_step", lambda: self.window_step(idx_window),
                t_epoch, n, (idx_window,))
            warm = warmed or warm
            done += n
            pending.append((sums, {
                "step": epoch * self.steps_per_epoch + done - 1,
                "n_steps": n, "n_items": n * tokens_per_batch,
                "data_s": data_s, "dispatch_s": dispatch_s,
                "warm": was_cold}))
            boundary = (done - 1) - last_print >= cfg.print_freq or done == nb
            if boundary:
                self._drain(pending, meters)
                last_print = done - 1
            meters.update("Time", (time.time() - end) / n, n)
            if boundary and self.is_main:
                meters.display(done - 1)
            end = time.time()
            if self._step_cap_hit(epoch, done):
                break
        if pending:  # a max_steps break can land between print boundaries
            self._drain(pending, meters)
        self.obs.pause()       # validation and checkpoints follow
        return self._epoch_result(meters, done - skip, warm)

    def _step_cap_hit(self, epoch: int, batches_done: int) -> bool:
        cap = self.cfg.max_steps
        return bool(cap) and epoch * self.steps_per_epoch + batches_done >= cap

    def _dispatch(self, gstep: int, program: str, fn, t_epoch: float,
                  n: int, args=()):
        """One dispatch of ``program`` (``fn()``, ``n`` steps, over the
        tensors ``args``) through ``RunObs.dispatch``; the run's first also
        gets the warm-up sync, the ``compile`` and ``cost_model`` events
        and, with the audit armed, its recording and ``audit`` event.
        Returns (metric sums, dispatch seconds, (warm seconds, warm
        batches) of the first dispatch or None)."""
        first = not self._warmed
        rec = audit_recorder(program, self.state) if first else None
        note_audit_dispatch(program, *args)
        metrics, dispatch_s, probe = self.obs.dispatch(gstep, fn, first,
                                                       audit=rec)
        if not first:
            return metrics, dispatch_s, None
        warm = self._warm_up(metrics, t_epoch, n)
        self.obs.emit_compile(program, warm[0], probe,
                              n * self._step_flops() / self.world,
                              self.policy.compute_dtype)
        finish_audit(program, rec, precision=self.cfg.precision,
                     donate=self.compiled.plan.donate, device=self.device)
        return metrics, dispatch_s, warm

    # ------------------------------------------------------------------
    def _preempt_check(self, pending=None, meters=None) -> None:
        """Once a loop iteration, before its dispatch and after the step
        fault sites (``RunObs.fire_step_faults``, which fire before the
        step's data wait is read, so an injected ``hang`` counts in this
        rank's ``data_s``, as a stalled loader would): the preemption
        decision (``RunObs.preempt_agreed``), which snapshots and
        exits."""
        if self.obs.preempt_agreed(self.world, self.device, pending):
            self._preempt_snapshot(pending, meters)   # raises SystemExit

    def _preempt_snapshot(self, pending=None, meters=None) -> None:
        """The coordinated snapshot (``:983-1033``): drain the in-flight
        steps, wait for the async writer, write a mid-epoch checkpoint
        stamped ``preempt`` (rank 0 writes, every rank meets at the
        save's barrier), emit ``ckpt`` and ``scale
        action=preempt_snapshot``, end the run ``status=preempted`` and
        exit :data:`PREEMPT_SNAPSHOT_RC`: the supervisor classes the
        attempt ``preemption_snapshotted`` and the restart resumes this
        step."""
        cfg = self.cfg
        if pending:
            self._drain(pending, meters)
        self.obs.pause()       # the snapshot write is not a stall
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ckpt.wait_for_async_save(cfg.checkpoint_dir or None)
        step_done = self.state.step
        if cfg.checkpoint_dir:
            t_ck = time.time()
            self._save(self._epoch_in_progress, False, mid_epoch=True,
                       preempt=True)
            self.ledger.emit("ckpt", epoch=self._epoch_in_progress,
                             path=cfg.checkpoint_dir, is_best=False,
                             seconds=round(time.time() - t_ck, 6),
                             preempt=True)
        self.ledger.emit("scale", action="preempt_snapshot",
                         processes=self.world,
                         epoch=env_int("TPU_DIST_MESH_EPOCH"),
                         step=step_done)
        self.log(f"preempted ({self.obs.preempt_source}, deadline "
                 f"{self.obs.preempt_deadline_s:g}s): snapshot at step "
                 f"{step_done} -- exiting for supervised resume")
        self.obs.run_end(status="preempted", steps=step_done,
                         snapshot_step=step_done, best_ppl=self.best_ppl)
        raise SystemExit(PREEMPT_SNAPSHOT_RC)

    # ------------------------------------------------------------------
    def validate(self, epoch: int = 0):
        """Exact held-out metrics: (loss, ppl, acc). Sampler wrap-padding
        rows are masked; sums divide by the true token count."""
        t0 = time.time()
        idx, valid = self._epoch_indices(self.val_ds, False, epoch)
        self.model.eval()
        sums = zeros_lm_metrics(self.device)
        if self._val_rows_dev is not None:
            idx_d, valid_d = self._to_device(idx), self._to_device(valid)
            batches = (shift_rows(self._val_rows_dev.index_select(0, idx_d[i]))
                       + (valid_d[i],) for i in range(len(idx)))
        else:
            batches = (self._batch(self.val_ds, idx[i])
                       + (self._to_device(valid[i]),) for i in range(len(idx)))
        for inputs, targets, v in batches:
            m = self.compiled.eval_step(self.state, inputs, targets, v)
            for k in sums:
                sums[k] = sums[k] + m[k]
        sums = {k: float(v) for k, v in self.par.sync_metrics(sums).items()}
        n = max(sums["count"], 1.0)
        loss = sums["loss_sum"] / n
        ppl = float(np.exp(min(loss, 30.0)))
        acc = sums["correct1"] / n
        self.ledger.emit("eval", epoch=epoch, loss=loss, ppl=ppl, acc=acc,
                         count=int(sums["count"]),
                         seconds=round(time.time() - t0, 6))
        self.log(f" * val_loss {loss:.4f} ppl {ppl:.2f} acc {acc:.3f}")
        return loss, ppl, acc

    # ------------------------------------------------------------------
    def _run_start(self) -> None:
        dev = (torch.cuda.get_device_name(self.device)
               if self.device.type == "cuda" else "cpu")
        # SIGTERM becomes a snapshot request the loop drains at its next
        # step boundary (the coordinated-preemption contract)
        self.obs.enable_preempt_snapshot()
        self.obs.run_start(mesh=dict(self.mesh.shape), devices=[dev],
                           process_count=self.world, mode=self.mode,
                           device=str(self.device))
        if self._peer_restored:
            self.ledger.emit("scale", action="peer_restore",
                             processes=self.world,
                             epoch=env_int("TPU_DIST_MESH_EPOCH"),
                             step=self.state.step)
        if self.use_ring or self.use_sp or self.use_pp:
            from tpu_dist_torch.parallel.collectives import p2p_route

            axis = (STAGE_AXIS if self.use_pp else
                    SEQ_AXIS if self.use_sp else MODEL_AXIS)
            self.log(f"ppermute route over {axis!r}: "
                     f"{p2p_route(self.mesh.group(axis), self.device)}")

    def _save(self, epoch: int, is_best: bool, mid_epoch: bool = False,
              async_write: bool = False, preempt: bool = False) -> str:
        """An ``lm`` checkpoint with the run's geometry and ``best_ppl``
        in its meta (keep-K retention)."""
        meta = {"best_ppl": self.best_ppl, **self._run_meta}
        if mid_epoch:
            meta["mid_epoch"] = True
        if preempt:
            meta["preempt"] = True
        return ckpt.save_checkpoint(
            self.cfg.checkpoint_dir, self.state, epoch, 0.0, "lm", is_best,
            extra_meta=meta, async_write=async_write,
            keep=self.cfg.keep_checkpoints, mesh=self.mesh,
            gather=self._gather_leaf if self._layout_gather() else None)

    def fit(self) -> float:
        """Train ``epochs`` (or ``max_steps``), validating after each
        epoch; returns the best validation perplexity. ``run_end`` carries
        ``status`` ok, interrupted, crashed (with the traceback) or, from
        the preemption snapshot, preempted."""
        self._run_start()
        try:
            with self.obs.observing():
                if self.cfg.evaluate:
                    self.best_ppl = self.validate(0)[1]
                else:
                    self._fit_epochs()
        except KeyboardInterrupt:
            self.obs.pause()   # a slow interrupt save is not a stall
            if self.cfg.checkpoint_dir:
                self._save(self._epoch_in_progress, False, mid_epoch=True)
                self.log(f"interrupted -- checkpoint saved at epoch "
                         f"{self._epoch_in_progress}; resume with --resume")
            else:
                self.log("interrupted -- no checkpoint_dir, nothing saved")
            raise
        finally:
            try:
                ckpt.wait_for_async_save()   # never exit mid-write
            finally:
                set_audit("none")   # the audit was this run's: disarm it
                self.obs.run_end(steps=self.state.step,
                                 best_ppl=self.best_ppl)
        return self.best_ppl

    def _fit_epochs(self) -> None:
        cfg = self.cfg
        for epoch in range(self.start_epoch, cfg.epochs):
            self._epoch_in_progress = epoch
            # a SIGTERM that landed during the previous eval or checkpoint
            if self.obs.preempt_agreed(self.world, self.device):
                self._preempt_snapshot()
            t0 = time.time()
            train = self.train_epoch(epoch)
            train_secs = time.time() - t0
            loss, ppl, acc = self.validate(epoch)
            epoch_secs = time.time() - t0
            # throughput leaves out the run's first step (kernel builds
            # and allocator warm-up ride on it)
            timed = train["batches"] - train["warmup_batches"]
            tokens = cfg.batch_size * cfg.seq_len
            tok_s = (timed * tokens / max(train_secs - train["warmup_secs"],
                                          1e-9) if timed > 0 else
                     train["batches"] * tokens / max(train_secs, 1e-9))
            self.last_tok_s = tok_s
            tflops, mfu = self._mfu(tok_s)
            is_best = ppl < self.best_ppl
            self.best_ppl = min(ppl, self.best_ppl)
            self.ledger.emit(
                "epoch", epoch=epoch, start_ts=t0, seconds=epoch_secs,
                throughput=tok_s, unit="tok/s", loss=train["loss"], ppl=ppl,
                mfu=mfu, tflops=tflops,
                hbm_bytes=self._memory()["hbm_peak_bytes"],
                batches=train["batches"])
            if cfg.checkpoint_dir:
                t_ck = time.time()
                self._save(epoch + 1, is_best, async_write=True)
                self.ledger.emit("ckpt", epoch=epoch + 1,
                                 path=cfg.checkpoint_dir, is_best=is_best,
                                 seconds=round(time.time() - t_ck, 6))
            lr_now = self.lr_schedule(max(self.state.step - 1, 0))
            self.log(
                f"Epoch {epoch} [{self.mode}]: "
                f"train_loss={train['loss']:.4f} val_ppl={ppl:.2f} "
                f"best={self.best_ppl:.2f} lr={lr_now:.3g} "
                f"({epoch_secs:.1f}s, train {tok_s:,.0f} tok/s, "
                f"{tflops:.1f} TF/s"
                + (f", MFU {mfu * 100:.1f}%" if mfu else "") + ")")
            if self._step_cap_hit(epoch, self.steps_per_epoch):
                self.log(f"max_steps={cfg.max_steps} reached")
                return
