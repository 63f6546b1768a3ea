"""The image ``Trainer`` for the port (``tpu_dist/engine/loop.py``):
data-parallel over the processes of a ``torch.distributed`` group, one
device each (a reference ``data=N`` mesh is N processes here).

What follows the reference (line numbers are ``loop.py``'s):

* ``__init__`` (``:54-448``): config validation, the datasets
  (``data.datasets``: arrays, or the ImageNet ``data.imagefolder`` tree;
  the synthetic fallback when the files are absent), the model
  (``models.registry``, every image arch, with the ResNet knobs ``norm``,
  ``norm_dtype`` and ``stem``, and ``quant`` for the ``vit_*`` archs
  alone, ``:109-124``), the ``pretrained`` warm start
  (``:174-190``: the leaves of a port ``.pt`` or a reference
  ``.msgpack`` checkpoint whose name and shape match, params and BN
  stats, over a fresh optimizer at step 0), the
  step-decay schedule, the optimizer (``sgd`` | ``adamw`` | ``fused_sgd``,
  the last through the hand-written SGD kernel), the fp16 ``loss_scale``
  (``:204-206``), gradient accumulation (``grad_accum_steps``,
  ``:218-245``: one optimizer call per step over equal microbatches, with
  the reference's exclusions), the K-steps-per-dispatch window and the
  data placement
  (``:266-336``: ``auto`` puts the uint8 train and val sets on the device
  when they fit and K > 1), the run geometry stamped into checkpoints, and
  ``--resume`` with step-exact mid-epoch resume (``:356-409``);
* ``train_epoch`` (``:581``): the host-fed per-batch path (a producer
  thread assembles batches, side-stream uploads through
  ``data.loader.prefetch_to_device``) with one fetch of the metric sums
  per print window (``_drain``), which feeds the meters, the ledger's
  ``step`` events and the health sentry;
* ``_train_epoch_windowed`` (``:739``): K steps enqueued back to back with
  no host sync, their metric sums added up on the device, one ``step``
  record per window and one ``_drain`` per print window. On the device
  path each step gathers its uint8 rows from the resident dataset by the
  sampler's index window. The math is that of K single steps;
* ``validate`` (``:849``): exact under sampler padding, each rank
  evaluating its shard, the sums all-reduced and fetched once;
* ``fit`` / ``_fit_epochs`` (``:892-1008``): an ``epoch`` ledger event with
  img/s, an async checkpoint per epoch, ``model_best`` on improvement, and
  a mid-epoch checkpoint on ``KeyboardInterrupt``; the events go through
  ``obs.RunObs`` (attempt lineage with ``job_id`` and ``attempt``, the
  watchdog, the goodput sink, the supervisor's heartbeat file);
* the restart layer (``:411-425, 519-576, 618-626, 783-792``), as in the
  LMTrainer: the step fault sites once an iteration (``nan_batch``,
  ``preempt_deadline``), the coordinated preemption snapshot (exit 75)
  agreed over the group at the drain boundaries, and
  ``TPU_DIST_PEER_RESUME`` in a dp-pure run.
* the observers (``:481-484, 610-666``), as in the LMTrainer: the
  tracer's ``dispatch`` and ``device`` spans, the skew monitor fed each
  step record on every rank, the telemetry sampler and the
  ``profile_dir`` session around the fit, and the ``compile`` and
  ``cost_model`` events of the first dispatch.

The first step (or window) of a run carries cuDNN's autotuning
(``cudnn.benchmark`` is on for CUDA) and the allocator's warm-up: the loop
syncs once after it and leaves it out of the epoch's img/s. MFU is
analytic: 3 x the forward FLOPs of the convs and dense layers per image
over the card's dense peak (``device.PEAK_FLOPS``).

Over several processes (``parallel.launch.initialize`` first; the mesh is
``parallel.mesh.make_mesh(mesh_shape, mesh_axes)``) each rank trains on
``batch_size // world`` rows: the sampler's batch-blocked layout gives
rank r the rows the reference gives it, the LR is ``scaled_lr(world)``
under ``lr_scale_by_world``, the augmentation and dropout generators fold
the rank into their seeds, and the step syncs by ``variant`` (``engine.steps
.DataParallel``: ``jit`` with BatchNorm statistics over the group's batch,
or ``shard_map`` with ``grad_compression``, ``gradient_predivide_factor``,
``adasum`` and ``grad_bucket_mb``). The windowed device-data path keeps
the whole set resident on each rank's device and gathers the rank's rows.
Logs, the ledger, the CSV and checkpoint writes are rank 0's; every rank
resumes from the same checkpoint.

A ``data=N,model=M`` mesh (``tpu_dist/engine/loop.py:125-170,
246-264``). Every rank of one ``data`` coordinate reads the same rows and
draws the same masks (the batch, the sampler and the augmentation and
dropout generators go by the data coordinate), the params stay whole and
identical on every rank, and the gradients are averaged over the data
axis. Under
``tp_impl="ring"`` (the reference's checks: a ``vit_*`` arch, a ``model``
axis of 2 or more, heads divisible by it) the model's blocks run the
``ring_ar`` flavour over the model axis (``models.vit``); the reference
requires ``variant="shard_map"`` there because its ring collectives are
explicit, and the port's trainer runs explicit collectives in both
variants, so either is taken. Under ``tp_impl="gspmd"`` it is the
reference's jit step (``engine/steps.py:220-227``): the batch sharded over
``data``, the params replicated, for every arch; the gradient mean runs
over every rank (the model axis's ranks hold equal gradients, so it is
the data axis's mean), so the replicas stay bit-equal whatever order each
rank's kernels summed in.

The step plan (``:55-59``): ``plan`` (a ``tools/tune.py`` plan file, or
``"auto"``) is resolved first thing (``plan.compile.resolve_config_plan``),
so the variant, the sync knobs and the kernel switches are the plan's
before the model is built; the result rides ``run_start`` and one ``plan``
event. Every step, window and eval comes from ``plan.compile
.compile_plan`` (:meth:`Trainer._step_plan`). The program audit (the
``audit`` knob, ``analysis.proglint``) records the run's first dispatch of
``train_step``/``window_step`` and reads the recompile sentry at each
drain, as in the LMTrainer; ``fit`` disarms it on every exit.

It runs on CUDA unless ``device="cpu"`` is asked for, and takes an
optional flax-layout ``init_params``/``init_batch_stats`` pair so a run can
start from the reference trainer's initial weights.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from tpu_dist_torch.configs import TrainConfig
from tpu_dist_torch.data.datasets import load_dataset
from tpu_dist_torch.data.loader import DataLoader, prefetch_to_device
from tpu_dist_torch.data.pipeline import make_transform
from tpu_dist_torch.data.sampler import DistributedSampler
from tpu_dist_torch.device import peak_flops
from tpu_dist_torch.engine import checkpoint as ckpt
from tpu_dist_torch.engine.state import TrainState
from tpu_dist_torch.engine.steps import (IMAGE_METRIC_KEYS, DataParallel,
                                         fold_seed, zeros_image_metrics)
from tpu_dist_torch.models.registry import create_model, model_kind
from tpu_dist_torch.models.resnet import set_batchnorm_group
from tpu_dist_torch.obs import RunObs, env_int
from tpu_dist_torch.obs.health import PROBE_KEYS, validate_health
from tpu_dist_torch.ops.optim import make_optimizer, step_decay_schedule
from tpu_dist_torch.ops.pallas_sgd import FusedSGD
from tpu_dist_torch.ops.precision import LossScaleState, make_policy
from tpu_dist_torch.ops.quant import fused_quant_active, validate_quant
from tpu_dist_torch.parallel.collectives import all_reduce_
from tpu_dist_torch.parallel.launch import say
from tpu_dist_torch.parallel.mesh import make_mesh
from tpu_dist_torch.parallel.overlap import validate_tp_impl
from tpu_dist_torch.parallel.supervisor import PREEMPT_SNAPSHOT_RC
from tpu_dist_torch.plan.compile import (Bindings, audit_recorder,
                                         check_audit_sentry, compile_plan,
                                         current_switches, finish_audit,
                                         note_audit_dispatch,
                                         resolve_config_plan, set_audit,
                                         validate_audit)
from tpu_dist_torch.plan.ir import Plan
from tpu_dist_torch.utils.meters import MeterBank
from tpu_dist_torch.utils.mfu import image_forward_flops

# knob -> its accepted values, for a knob the port does not honour
# (anything else raises NotImplementedError naming the knob): none is left
UNPORTED: Dict[str, tuple] = {}
# the mesh axes the Trainer takes
MESH_AXES = (("data",), ("data", "model"))


def refuse_unported(cfg: TrainConfig) -> None:
    for knob, accepted in UNPORTED.items():
        val = getattr(cfg, knob)
        if val not in accepted:
            raise NotImplementedError(
                f"TrainConfig.{knob}={val!r} is not ported (supported: "
                f"{' | '.join(repr(a) for a in accepted)})")


class Trainer:
    """The dp image trainer, one device per process (module docstring has
    the tour)."""

    def __init__(self, cfg: TrainConfig, *, device=None,
                 init_params: Optional[dict] = None,
                 init_batch_stats: Optional[dict] = None):
        # the step plan rewrites the plan-owned knobs (the variant too) and
        # sets the kernel switches before anything below reads them
        cfg, self._plan_info = resolve_config_plan(cfg, device)
        refuse_unported(cfg)
        validate_audit(cfg.audit, cfg.profile_dir)
        if cfg.resume and not os.path.exists(cfg.resume):
            raise FileNotFoundError(f"--resume checkpoint not found: {cfg.resume}")
        if cfg.pretrained and not os.path.exists(cfg.pretrained):
            raise FileNotFoundError(
                f"--pretrained checkpoint not found: {cfg.pretrained}")
        if cfg.optimizer not in ("sgd", "fused_sgd", "adamw"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r} "
                             "(sgd|fused_sgd|adamw)")
        if model_kind(cfg.arch) != "image":
            raise ValueError(
                f"--arch {cfg.arch} is a language model; this trainer drives "
                "image classifiers -- use tpu_dist_torch.scripts.lm_longcontext")
        if cfg.variant not in ("jit", "shard_map"):
            raise ValueError(f"unknown variant {cfg.variant!r} (jit|shard_map)")
        validate_health(cfg.health)
        validate_tp_impl(cfg.tp_impl)
        if tuple(cfg.mesh_axes) not in MESH_AXES:
            raise ValueError(
                f"TrainConfig.mesh_axes={tuple(cfg.mesh_axes)!r}: the image "
                f"Trainer takes {' | '.join(repr(a) for a in MESH_AXES)}")
        if cfg.tp_impl == "ring" and not cfg.arch.startswith("vit"):
            # the reference's checks (:125-170)
            raise ValueError(
                f"--tp-impl ring applies to the transformer-family image "
                f"archs (vit_*); arch {cfg.arch!r} has no column/row-"
                "parallel projections")
        self.mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axes, device=device)
        world = self.mesh.size
        # a ring run's model axis shares the rows of its data coordinate
        self.data_size = self.mesh.shape.get("data", 1)
        self.data_rank = self.mesh.coord("data")
        self.tp = self.mesh.axis("model")
        if cfg.tp_impl == "ring" and self.tp.size < 2:
            raise ValueError("--tp-impl ring needs a 'model' mesh axis "
                             "of size >= 2 (e.g. --mesh-shape=-1,2 "
                             "--mesh-axes=data,model)")
        if cfg.batch_size % self.data_size:
            raise ValueError(
                f"global batch {cfg.batch_size} not divisible by the data "
                f"axis {self.data_size} ({world} processes x 1 local "
                "device)")
        if cfg.grad_compression not in ("none", "bf16"):
            raise ValueError(
                f"unknown grad compression {cfg.grad_compression!r}")
        if cfg.grad_bucket_mb > 0 and cfg.variant != "shard_map":
            raise ValueError("--grad-bucket-mb decomposes the explicit "
                             "gradient allreduce; it requires "
                             "variant='shard_map' (the jit flavor's sync "
                             "is one collective)")
        self.accum = cfg.grad_accum_steps
        if self.accum < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        if self.accum > 1 and cfg.variant != "jit":
            raise ValueError("grad_accum_steps > 1 requires variant='jit'")
        if cfg.adasum and cfg.variant != "shard_map":
            raise ValueError("adasum requires variant='shard_map'")
        if cfg.adasum and cfg.grad_compression != "none":
            raise ValueError("adasum replaces the compressed-mean allreduce; "
                             "use grad_compression='none' with it")
        self.k = cfg.steps_per_dispatch
        if self.accum > 1 and self.k > 1:
            raise ValueError("grad_accum_steps and steps_per_dispatch > 1 "
                             "are mutually exclusive")
        if self.accum > 1 and cfg.batch_size % (self.accum * self.data_size):
            raise ValueError(
                f"global batch {cfg.batch_size} not divisible by "
                f"grad_accum_steps x device count ({self.accum} x "
                f"{self.data_size})")
        if self.k < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if self.k > 1 and cfg.variant != "jit":
            raise ValueError("steps_per_dispatch > 1 requires variant='jit'")
        if cfg.data_placement not in ("auto", "host", "device"):
            raise ValueError(f"unknown data_placement {cfg.data_placement!r}")
        if self.accum > 1 and cfg.data_placement == "device":
            raise ValueError("grad_accum_steps > 1 requires "
                             "data_placement='host' or 'auto'")
        if cfg.data_placement == "device" and cfg.variant != "jit":
            raise ValueError("data_placement='device' requires variant='jit'")
        model_kw = {}
        if cfg.norm:
            model_kw["norm"] = cfg.norm
        if cfg.norm_dtype:
            if cfg.norm_dtype not in ("bf16", "fp32"):
                raise ValueError(f"--norm-dtype {cfg.norm_dtype!r} (bf16|fp32)")
            if cfg.norm_dtype == "bf16":
                model_kw["norm_dtype"] = torch.bfloat16
        if cfg.stem:
            model_kw["stem"] = cfg.stem
        if model_kw and not cfg.arch.startswith(("resnet", "resnext",
                                                 "wide_resnet")):
            raise ValueError(
                f"--norm/--norm-dtype/--stem are ResNet-family knobs; "
                f"arch {cfg.arch!r} does not take them")
        if cfg.quant and cfg.quant != "none":
            validate_quant(cfg.quant)
            if not cfg.arch.startswith("vit"):
                # the reference's rule (:114-124): int8 matmuls live in the
                # transformer families; a conv stack has no quantized path
                raise ValueError(
                    f"--quant {cfg.quant} applies to the transformer-family "
                    f"image archs (vit_*); arch {cfg.arch!r} does not take it")
            model_kw["quant"] = cfg.quant
        if cfg.tp_impl == "ring":
            model_kw["tp_impl"] = "ring"
        self.cfg = cfg
        self.device = self.mesh.device
        self.rank, self.world = self.mesh.rank, world
        self.is_main = self.mesh.is_main
        # a model axis under gspmd replicates the params: the gradient mean
        # runs over every rank (the model axis's ranks hold equal
        # gradients, so it is the data axis's mean), which keeps the
        # replicas bit-equal whatever each rank's kernels summed in
        grad_group = self.mesh.group()
        if self.tp.size > 1 and cfg.tp_impl == "gspmd":
            import torch.distributed as dist

            grad_group = dist.group.WORLD
        self.dp = DataParallel(
            grad_group, self.data_size, cfg.variant, cfg.grad_compression,
            cfg.gradient_predivide_factor, cfg.adasum, cfg.grad_bucket_mb)
        if self.device.type == "cuda":
            torch.backends.cudnn.benchmark = True
        self.policy = make_policy(cfg.precision)
        self.seed = cfg.seed if cfg.seed is not None else 0

        # ---- data ----
        self.train_ds, self.val_ds = load_dataset(
            cfg.dataset, cfg.data, cfg.synth_train_size, cfg.synth_val_size,
            seed=cfg.seed if cfg.seed is not None else 1234)
        self.num_classes = self.train_ds.num_classes
        self.local_batch = cfg.batch_size // self.data_size

        # ---- model, schedule, optimizer ----
        self.model = create_model(
            cfg.arch, num_classes=self.num_classes,
            dtype=self.policy.compute_dtype,
            image_shape=self.train_ds.image_shape, device=self.device,
            seed=self.seed if init_params is None else None, **model_kw)
        if init_params is not None:
            from tpu_dist_torch.interop import load_flax_image_params
            load_flax_image_params(self.model, init_params, init_batch_stats)
        if cfg.tp_impl == "ring":
            # the params stay whole; each block slices its shard at use
            self.model.set_tp(self.tp)
        self.policy.cast_params_for_storage(self.model)
        if cfg.pretrained:
            self._warm_start(cfg.pretrained)
        self.model.requires_grad_(True)
        if cfg.variant == "jit" and self.data_size > 1:  # one step, the group
            set_batchnorm_group(self.model, self.mesh.group())
        # ceil: the sampler pads to full batches
        self.steps_per_epoch = max(1, -(-len(self.train_ds) // cfg.batch_size))
        self.schedule = step_decay_schedule(cfg.scaled_lr(world),
                                            self.steps_per_epoch,
                                            cfg.lr_step_epochs)
        if cfg.optimizer == "fused_sgd":
            self.tx = FusedSGD(self.schedule, cfg.momentum, cfg.weight_decay)
        else:
            self.tx = make_optimizer(
                cfg.lr, cfg.momentum, cfg.weight_decay, self.steps_per_epoch,
                cfg.lr_step_epochs, schedule=self.schedule,
                kind=cfg.optimizer, b1=cfg.adam_b1, b2=cfg.adam_b2,
                eps=cfg.adam_eps)
        self.state = TrainState.create(
            self.model, self.tx,
            LossScaleState.create(cfg.loss_scale, self.device)
            if cfg.loss_scale else None)
        self.augment = self.train_ds.name.startswith(("imagenet",
                                                      "synth-imagenet"))
        cdt = self.policy.compute_dtype
        self.transform = make_transform(self.train_ds.mean, self.train_ds.std,
                                        augment=self.augment, dtype=cdt,
                                        device=self.device)
        self.eval_transform = make_transform(self.val_ds.mean,
                                             self.val_ds.std, dtype=cdt,
                                             device=self.device)

        # ---- data placement (:274-336) ----
        in_memory = isinstance(getattr(self.train_ds, "images", None),
                               np.ndarray)
        if cfg.data_placement == "device" and not in_memory:
            raise ValueError("data_placement='device' needs an in-memory "
                             "(ArrayDataset) training set")
        val_rides = (in_memory and isinstance(
            getattr(self.val_ds, "images", None), np.ndarray)
            and self.val_ds.image_shape == self.train_ds.image_shape)
        data_bytes = (self.train_ds.images.nbytes
                      + (self.val_ds.images.nbytes if val_rides else 0)
                      ) if in_memory else 0
        fits = in_memory and data_bytes <= int(os.environ.get(
            "TPU_DIST_DEVICE_DATA_MAX", str(1 << 30)))
        self.device_data = (cfg.data_placement == "device"
                            or (cfg.data_placement == "auto" and fits
                                and self.k > 1))
        self._train_data_dev = self._val_data_dev = None
        if self.device_data:
            self._train_data_dev = self._resident(self.train_ds)
            if val_rides:
                self._val_data_dev = self._resident(self.val_ds)

        # whether the int8 matmuls (vit_* under quant="int8") ride
        # csrc/fused_quant.cu (on the CPU its plain version runs): the step
        # records' ``fused`` flag (:444-448,511; the LMTrainer's twin)
        self._fused_quant = (cfg.quant == "int8" and fused_quant_active()
                             and self.device.type == "cuda")
        self.best_acc1 = 0.0
        self.last_img_s = 0.0
        self.start_epoch = cfg.start_epoch
        self._skip_batches = 0
        self._warmed = False
        self._flops_per_image = None
        self._run_meta = {"steps_per_epoch": self.steps_per_epoch,
                          "batch_size": cfg.batch_size,
                          "dataset_len": len(self.train_ds),
                          "arch": cfg.arch, "dataset": self.train_ds.name,
                          "num_classes": self.num_classes,
                          "image_shape": list(self.train_ds.image_shape)}
        if cfg.resume:
            self._resume(cfg.resume)
        # checkpoint-less dp-pure recovery (:411-425): on a supervisor's
        # mesh re-expansion (TPU_DIST_PEER_RESUME) adopt rank 0's live
        # replicated state
        self._dp_pure = all(n == 1 for a, n in self.mesh.shape.items()
                            if a != "data")
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
        # every step, window and eval from the plan lowering
        self.compiled = compile_plan(self._step_plan(), Bindings(
            mesh=self.mesh, model=self.model, tx=self.tx, dp=self.dp,
            transform=self.transform, eval_transform=self.eval_transform,
            gen=self._gen, dropout_gen=self._dropout_gen))
        # the run's ledger (attempt lineage), health sentry, watchdog,
        # goodput sink, faults, heartbeat and preemption (obs.RunObs)
        self.obs = RunObs("image", cfg, process_index=self.rank,
                          unit="img/s", device=self.device,
                          plan_info=self._plan_info)
        self.ledger, self.health = self.obs.ledger, self.obs.health
        set_audit(cfg.audit, self.ledger)     # analysis.proglint

    # ------------------------------------------------------------------
    def _resident(self, ds):
        """(uint8 images, int64 labels) of ``ds`` on the device."""
        return (torch.from_numpy(ds.images).to(self.device),
                torch.from_numpy(ds.labels.astype(np.int64)).to(self.device))

    def _warm_start(self, path: str) -> None:
        """Graft a checkpoint's params and BN stats (the port's ``.pt`` or
        the reference's ``.msgpack``) onto the fresh model where name and
        shape match (``:174-190``)."""
        params, stats, meta = ckpt.load_warmstart(path, self.model)
        n_p, skipped = ckpt.graft_params(self.model.named_parameters(),
                                         params)
        n_s, _ = ckpt.graft_params(self.model.named_buffers(), stats)
        if n_p == 0:
            raise ValueError(
                f"--pretrained {path} (arch {meta.get('arch', '?')!r}) "
                f"shares no tensors with {self.cfg.arch!r} -- wrong "
                "checkpoint?")
        self.log(f"=> warm-started {n_p} param tensors (+{n_s} BN stats) "
                 f"from {path}"
                 + (f"; fresh init kept for {skipped}" if skipped else ""))

    def _resume(self, path: str) -> None:
        """``--resume`` (``:356-409``): geometry checks on the header, the
        state restored in place, and the step-exact skip of a mid-epoch
        checkpoint."""
        hard_keys = ("arch", "num_classes", "image_shape")

        def mismatch(meta):
            return {k: (meta[k], v) for k, v in self._run_meta.items()
                    if k in meta and meta[k] != v}

        def detail(mm):
            return ", ".join(f"{k}: checkpoint {a} vs run {b}"
                             for k, (a, b) in mm.items())

        hard = {k: v for k, v in mismatch(ckpt.read_checkpoint_meta(path))
                .items() if k in hard_keys}
        if hard:
            raise ValueError("--resume checkpoint is from a different model "
                             f"geometry ({detail(hard)})")
        _, meta = ckpt.load_checkpoint(path, self.state)
        self.start_epoch = meta.get("epoch", 0)
        self.best_acc1 = meta.get("best_acc1", 0.0)
        self.log(f"=> resumed from {path} (epoch {self.start_epoch})")
        mm = mismatch(meta)
        if mm:
            if meta.get("mid_epoch"):
                raise ValueError("mid-epoch resume requires the checkpoint's "
                                 f"data/batch geometry ({detail(mm)})")
            self.log(f"warning: resume with changed geometry ({detail(mm)}); "
                     "the LR schedule will not line up with the original run")
        if meta.get("mid_epoch"):
            self.start_epoch = self.state.step // self.steps_per_epoch
            self._skip_batches = self.state.step % self.steps_per_epoch
            if self._skip_batches:
                self.log(f"=> mid-epoch checkpoint: resuming epoch "
                         f"{self.start_epoch}, skipping {self._skip_batches} "
                         "already-applied batches")

    def log(self, line: str) -> None:
        if self.is_main:
            say(line)

    def _sampler(self, ds, train: bool, epoch: int) -> DistributedSampler:
        sampler = DistributedSampler(
            len(ds), num_replicas=self.data_size, rank=self.data_rank,
            shuffle=train,
            seed=(self.cfg.seed or 0) + (17 if not train else 0),
            batch_size=self.local_batch)
        sampler.set_epoch(epoch)
        return sampler

    def _loader(self, ds, train: bool, epoch: int) -> DataLoader:
        return DataLoader(ds, self._sampler(ds, train, epoch),
                          self.local_batch, workers=self.cfg.workers,
                          emit_valid=not train)

    def _epoch_indices(self, ds, train: bool, epoch: int):
        """(idx (nb, B) int64, valid (nb, B) fp32): the sampler's
        batch-blocked layout, shared by the windowed path and the eval."""
        sampler = self._sampler(ds, train, epoch)
        idx, valid = sampler.indices_with_valid()
        nb = sampler.num_samples // self.local_batch
        n = nb * self.local_batch
        shape = (nb, self.local_batch)
        return (np.asarray(idx[:n], np.int64).reshape(shape),
                np.asarray(valid[:n], np.float32).reshape(shape))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array to the device: a pinned, non-blocking copy on
        CUDA, so the upload never syncs the host with the device."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _gen(self, gstep: int) -> Optional[torch.Generator]:
        """The augmentation generator of global step ``gstep`` on this
        rank (None without augmentation): a function of the seed, the step
        and the rank, so a resumed run draws the same and ranks differ."""
        if not self.augment:
            return None
        return torch.Generator().manual_seed(
            (self.seed * 1_000_003 + gstep) * self.data_size
            + self.data_rank)

    def _dropout_gen(self, gstep: int) -> Optional[torch.Generator]:
        """The dropout generator of global step ``gstep`` on this rank, on
        the model's device (None for a model that draws nothing): a
        function of the seed, the step and the data rank, as the reference
        folds the step into its dropout key (``tpu_dist/engine/steps.py
        :174``); the step folds the microbatch in under accumulation."""
        if getattr(self.model, "dropout_gen", None) is None:
            return None
        return torch.Generator(device=self.device).manual_seed(
            fold_seed(self.seed, gstep, self.data_rank))

    def _donate(self) -> bool:
        """The resolved plan's ``donate`` (True without a plan)."""
        return self._plan_info["plan"].donate if self._plan_info else True

    def _step_plan(self) -> Plan:
        """The plan this run's steps lower from: the mesh's layout, the
        variant's sync (the ring's collectives are explicit in either), the
        config's step knobs and the kernel switches as they stand."""
        cfg = self.cfg
        explicit = cfg.variant == "shard_map" or cfg.tp_impl == "ring"
        return Plan(engine="image",
                    layout="tp" if self.tp.size > 1 else "dp",
                    sync="explicit" if explicit else "gspmd",
                    quant=cfg.quant or "none", tp_impl=cfg.tp_impl,
                    grad_bucket_mb=float(cfg.grad_bucket_mb),
                    grad_compression=cfg.grad_compression,
                    predivide_factor=float(cfg.gradient_predivide_factor),
                    adasum=bool(cfg.adasum),
                    window=("indexed" if self.device_data else
                            "stacked" if self.k > 1 else "none"),
                    steps_per_dispatch=self.k, grad_accum_steps=self.accum,
                    health=cfg.health, donate=self._donate(),
                    **current_switches())

    def _step(self, images, labels, gstep: int) -> Dict[str, torch.Tensor]:
        self.state, m = self.compiled.advance(self.compiled.step, self.state,
                                              images, labels, gstep)
        return m

    def _flops(self) -> float:
        if self._flops_per_image is None:
            self._flops_per_image = 3.0 * image_forward_flops(
                self.model, self.train_ds.image_shape)
        return self._flops_per_image

    def _mfu(self, img_per_s: float):
        """(tflops, analytic mfu); mfu None off the cards the peak table
        holds (the CPU included)."""
        tflops = img_per_s * self._flops() / 1e12
        peak = peak_flops(self.device, self.policy.compute_dtype)
        return tflops, (tflops * 1e12 / (peak * self.world) if peak else None)

    def _memory(self) -> dict:
        if self.device.type != "cuda":
            return {"hbm_bytes_in_use": None, "hbm_peak_bytes": None}
        return {"hbm_bytes_in_use": torch.cuda.memory_allocated(self.device),
                "hbm_peak_bytes":
                    torch.cuda.max_memory_allocated(self.device)}

    def _drain(self, pending, meters) -> None:
        """One fetch of every pending record's metric sums (the loop's sync
        point), then one ledger ``step`` record each, with the fetch's
        device-block time shared out by steps, and the health sentry's look
        at each. Under ``skip`` a non-finite record stays out of the
        meters (its update was already undone on the device)."""
        keys = IMAGE_METRIC_KEYS + PROBE_KEYS
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
            acc1 = m["correct1"] / cnt
            if math.isfinite(loss) or self.health.policy != "skip":
                meters.update("Loss", loss, int(cnt))
                meters.update("Acc@1", acc1, int(cnt))
                meters.update("Acc@5", m["correct5"] / cnt, int(cnt))
            n = info["n_steps"]
            share = device_s * n / total_steps
            wall = info["data_s"] + info["dispatch_s"] + share
            img_s = info["n_items"] / max(wall, 1e-9)
            gn, un = m["grad_norm"] / n, m["update_norm"] / n
            self.ledger.emit(
                "step", step=info["step"], loss=loss, throughput=img_s,
                unit="img/s", data_s=info["data_s"],
                dispatch_s=info["dispatch_s"], device_s=share, comm_s=None,
                mfu=self._mfu(img_s)[1], steps_in_dispatch=n,
                warm=info["warm"], fused=self._fused_quant, acc1=acc1,
                grad_norm=gn,
                nonfinite_count=m["nonfinite_count"], update_norm=un, **mem)
            self.obs.record_skew(info["step"], wall, info["data_s"], n)
            self.health.observe(info["step"], loss,
                                nonfinite=m["nonfinite_count"],
                                grad_norm=gn, update_norm=un, n_steps=n)
        pending.clear()
        self.obs.heartbeat()   # device progress proven at this fetch
        check_audit_sentry()   # PL005: host-side counts, no sync

    def _meters(self, epoch: int) -> MeterBank:
        return MeterBank(self.steps_per_epoch,
                         [("Time", "6.3f"), ("Data", "6.3f"),
                          ("Loss", ".4e"), ("Acc@1", "6.3f"),
                          ("Acc@5", "6.3f")], prefix=f"Epoch: [{epoch}]")

    def _warm_up(self, metrics, t_epoch: float, n: int):
        """The run's first step or window: one deliberate sync, so its
        cuDNN autotuning and allocations stay out of img/s; returns
        (warm seconds, warm batches) of this epoch."""
        if self._warmed:
            return 0.0, 0
        metrics["count"].item()
        self._warmed = True
        return time.time() - t_epoch, n

    def _epoch_result(self, meters, batches, warm) -> Dict[str, float]:
        snap = meters.snapshot()
        return {"loss": snap["Loss"]["avg"], "top1": snap["Acc@1"]["avg"],
                "top5": snap["Acc@5"]["avg"], "batches": batches,
                "warmup_secs": warm[0], "warmup_batches": warm[1]}

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        if self.k > 1 or self.device_data:
            return self._train_epoch_windowed(epoch)
        cfg = self.cfg
        meters = self._meters(epoch)
        nb = self.steps_per_epoch
        skip, self._skip_batches = self._skip_batches, 0
        self.model.train()
        self.obs.resume()      # the watchdog watches from epoch entry
        pending = []
        warm = (0.0, 0)
        t_epoch = end = time.time()
        it = prefetch_to_device(iter(self._loader(self.train_ds, True, epoch)),
                                self.device)
        for i, (images, labels) in enumerate(it):
            if i < skip:       # step-exact resume of a mid-epoch checkpoint
                end = time.time()
                continue
            gstep = epoch * self.steps_per_epoch + i
            self.obs.fire_step_faults(gstep, self.state.params)
            data_s = time.time() - end
            meters.update("Data", data_s)
            self._preempt_check(pending, meters)
            was_cold = not self._warmed
            metrics, dispatch_s, warmed = self._dispatch(
                gstep, "train_step",
                lambda: self._step(images, labels, gstep), t_epoch, 1,
                (images, labels))
            warm = warmed or warm
            pending.append((metrics, {
                "step": gstep, "n_steps": 1, "n_items": cfg.batch_size,
                "data_s": data_s, "dispatch_s": dispatch_s,
                "warm": was_cold}))
            boundary = i % cfg.print_freq == 0 or i == nb - 1
            if boundary:
                self._drain(pending, meters)
            meters.update("Time", time.time() - end)
            if boundary and self.is_main:
                meters.display(i, printer=say)
            end = time.time()
        self.obs.pause()       # validation and checkpoints follow
        return self._epoch_result(meters, nb - skip, warm)

    def _device_windows(self, epoch: int, skip: int):
        """(n, idx (n, B) on the device) windows over the epoch's batches
        after ``skip``: one upload of the epoch's index array."""
        batches, _ = self._epoch_indices(self.train_ds, True, epoch)
        idx = self._to_device(batches[skip:])
        return [(min(self.k, len(idx) - i), idx[i:i + self.k])
                for i in range(0, len(idx), self.k)]

    def _host_windows(self, epoch: int, skip: int):
        """(n, (images (n, B, ...), labels (n, B)) on the device) windows
        assembled by the loader's thread and uploaded on a side stream."""
        def stacked():
            it = iter(self._loader(self.train_ds, True, epoch))
            for _ in range(skip):
                next(it)
            while True:
                stack = [b for _, b in zip(range(self.k), it)]
                if not stack:
                    return
                yield (np.stack([b[0] for b in stack]),
                       np.stack([b[1] for b in stack]))

        for imgs, lbls in prefetch_to_device(stacked(), self.device):
            yield len(imgs), (imgs, lbls)

    def _train_epoch_windowed(self, epoch: int) -> Dict[str, float]:
        """K-steps-per-dispatch epoch (``:739``): the same math as the
        per-batch loop, one host round trip per print window."""
        cfg = self.cfg
        nb = self.steps_per_epoch
        meters = self._meters(epoch)
        skip, self._skip_batches = self._skip_batches, 0
        self.model.train()
        self.obs.resume()      # the watchdog watches from epoch entry
        if self.device_data:
            images_all, labels_all = self._train_data_dev
            windows = self._device_windows(epoch, skip)
        else:
            windows = self._host_windows(epoch, skip)
        pending = []
        done, last_print = skip, skip - 1
        warm = (0.0, 0)
        t_epoch = end = time.time()
        for n, payload in windows:
            gstep = epoch * self.steps_per_epoch + done
            self.obs.fire_step_faults(gstep, self.state.params)
            data_s = time.time() - end
            meters.update("Data", data_s / n, n)
            self._preempt_check(pending, meters)
            was_cold = not self._warmed

            def window(payload=payload, gstep=gstep):
                args = ((images_all, labels_all, payload) if self.device_data
                        else (payload[0], payload[1]))    # indexed | stacked
                self.state, m = self.compiled.advance(
                    self.compiled.train_step, self.state, *args, gstep)
                return m

            sums, dispatch_s, warmed = self._dispatch(
                gstep, "window_step", window, t_epoch, n, (payload,))
            warm = warmed or warm
            done += n
            pending.append((sums, {
                "step": epoch * self.steps_per_epoch + done - 1,
                "n_steps": n, "n_items": n * cfg.batch_size,
                "data_s": data_s, "dispatch_s": dispatch_s,
                "warm": was_cold}))
            boundary = (done - 1) - last_print >= cfg.print_freq or done == nb
            if boundary:
                self._drain(pending, meters)
                last_print = done - 1
            meters.update("Time", (time.time() - end) / n, n)
            if boundary and self.is_main:
                meters.display(done - 1, printer=say)
            end = time.time()
        self.obs.pause()       # validation and checkpoints follow
        return self._epoch_result(meters, nb - skip, warm)

    def _dispatch(self, gstep: int, program: str, fn, t_epoch: float,
                  n: int, args=()):
        """One dispatch of ``program`` (``fn()``, ``n`` steps, over the
        tensors ``args``) through ``RunObs.dispatch``; the run's first also
        gets the warm-up sync, the ``compile`` and ``cost_model`` events
        and the audit's recording and ``audit`` event (the LMTrainer's
        twin). Returns (metric sums, dispatch seconds, (warm seconds, warm
        batches) of the first dispatch or None)."""
        first = not self._warmed
        rec = audit_recorder(program, self.state) if first else None
        note_audit_dispatch(program, *args)
        metrics, dispatch_s, probe = self.obs.dispatch(gstep, fn, first,
                                                       audit=rec)
        if not first:
            return metrics, dispatch_s, None
        warm = self._warm_up(metrics, t_epoch, n)
        self.obs.emit_compile(
            program, warm[0], probe,
            n * self._flops() * self.cfg.batch_size / self.data_size,
            self.policy.compute_dtype)
        finish_audit(program, rec, precision=self.cfg.precision,
                     donate=self.compiled.plan.donate, device=self.device)
        return metrics, dispatch_s, warm

    # ------------------------------------------------------------------
    def _preempt_check(self, pending=None, meters=None) -> None:
        """Once a loop iteration, before its dispatch and after the step
        fault sites (fired before the step's data wait is read, so an
        injected ``hang`` counts in this rank's ``data_s``): the
        preemption decision (``RunObs.preempt_agreed``), which snapshots
        and exits."""
        if self.obs.preempt_agreed(self.world, self.device, pending):
            self._preempt_snapshot(pending, meters)   # raises SystemExit

    def _preempt_snapshot(self, pending=None, meters=None) -> None:
        """The coordinated snapshot (``:533-576``): drain, wait for the
        async writer, a mid-epoch checkpoint stamped ``preempt``, the
        ``ckpt`` and ``scale action=preempt_snapshot`` events, ``run_end
        status=preempted`` and exit :data:`PREEMPT_SNAPSHOT_RC`."""
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
            ckpt.save_checkpoint(
                cfg.checkpoint_dir, self.state, self._epoch_in_progress,
                self.best_acc1, cfg.arch, is_best=False,
                extra_meta={"mid_epoch": True, "preempt": True,
                            **self._run_meta},
                keep=cfg.keep_checkpoints, mesh=self.mesh)
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
                         snapshot_step=step_done, best_acc1=self.best_acc1)
        raise SystemExit(PREEMPT_SNAPSHOT_RC)

    def validate(self, epoch: int = 0) -> float:
        """Exact eval (``:849``): metric sums over the val set with the
        sampler's wrap-padding masked, divided by the true count; one fetch
        at the end. With the val set on the device each batch is a row
        gather."""
        t0 = time.time()
        self.model.eval()
        sums = zeros_image_metrics(self.device)
        if self._val_data_dev is not None:
            images_all, labels_all = self._val_data_dev
            idx, valid = self._epoch_indices(self.val_ds, False, epoch)
            idx, valid = self._to_device(idx), self._to_device(valid)
            batches = ((images_all.index_select(0, idx[i]),
                        labels_all.index_select(0, idx[i]), valid[i])
                       for i in range(len(idx)))
        else:
            batches = prefetch_to_device(
                iter(self._loader(self.val_ds, False, epoch)), self.device)
        for images, labels, v in batches:
            m = self.compiled.eval_step(images, labels, v)
            sums = {k: sums[k] + m[k] for k in sums}
        flat = torch.stack([sums[k] for k in IMAGE_METRIC_KEYS])
        all_reduce_(flat, self.mesh.group())
        sums = dict(zip(IMAGE_METRIC_KEYS, flat.tolist()))
        n = max(sums["count"], 1.0)
        acc1, acc5 = sums["correct1"] / n, sums["correct5"] / n
        self.ledger.emit("eval", epoch=epoch, loss=sums["loss_sum"] / n,
                         acc1=acc1, acc5=acc5, count=int(sums["count"]),
                         seconds=round(time.time() - t0, 6))
        self.log(f" * Acc@1 {acc1 * 100:.3f} Acc@5 {acc5 * 100:.3f} "
                 f"Loss {sums['loss_sum'] / n:.4f}")
        return acc1

    # ------------------------------------------------------------------
    def _run_start(self) -> None:
        cfg = self.cfg
        dev = (torch.cuda.get_device_name(self.device)
               if self.device.type == "cuda" else "cpu")
        # SIGTERM becomes a snapshot request the loop drains at its next
        # step boundary (the coordinated-preemption contract)
        self.obs.enable_preempt_snapshot()
        self.obs.run_start(mesh=dict(self.mesh.shape), devices=[dev],
                           process_count=self.world,
                           mode="tp-ring" if cfg.tp_impl == "ring" else "dp",
                           device=str(self.device))
        if self._peer_restored:
            self.ledger.emit("scale", action="peer_restore",
                             processes=self.world,
                             epoch=env_int("TPU_DIST_MESH_EPOCH"),
                             step=self.state.step)
        self._flops()   # its forward stays out of the first epoch's time

    def fit(self) -> float:
        """Train from ``start_epoch`` to ``epochs``, validating and
        checkpointing after each; returns the best validation acc@1. An
        interrupt leaves a mid-epoch checkpoint to ``--resume`` from."""
        cfg = self.cfg
        self._run_start()
        try:
            with self.obs.observing():
                if cfg.evaluate:
                    self.best_acc1 = self.validate()
                else:
                    self._fit_epochs()
        except KeyboardInterrupt:
            self.obs.pause()   # a slow interrupt save is not a stall
            if cfg.checkpoint_dir:
                ckpt.save_checkpoint(
                    cfg.checkpoint_dir, self.state, self._epoch_in_progress,
                    self.best_acc1, cfg.arch, is_best=False,
                    extra_meta={"mid_epoch": True, **self._run_meta},
                    keep=cfg.keep_checkpoints, mesh=self.mesh)
                self.log(f"interrupted -- checkpoint saved at epoch "
                         f"{self._epoch_in_progress}; resume with --resume")
            raise
        finally:
            try:
                ckpt.wait_for_async_save()   # never exit mid-write
            finally:
                set_audit("none")   # the audit was this run's: disarm it
                self.obs.run_end(steps=self.state.step,
                                 best_acc1=self.best_acc1)
        return self.best_acc1

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
            acc1 = self.validate(epoch)
            epoch_secs = time.time() - t0
            timed = train["batches"] - train["warmup_batches"]
            img_s = (timed * cfg.batch_size
                     / max(train_secs - train["warmup_secs"], 1e-9)
                     if timed > 0 else
                     train["batches"] * cfg.batch_size / max(train_secs, 1e-9))
            self.last_img_s = img_s
            tflops, mfu = self._mfu(img_s)
            is_best = acc1 > self.best_acc1
            self.best_acc1 = max(acc1, self.best_acc1)
            self.ledger.emit(
                "epoch", epoch=epoch, start_ts=t0, seconds=epoch_secs,
                throughput=img_s, unit="img/s", loss=train["loss"],
                acc1=acc1, mfu=mfu, tflops=tflops,
                hbm_bytes=self._memory()["hbm_peak_bytes"],
                batches=train["batches"])
            if cfg.checkpoint_dir:
                t_ck = time.time()
                ckpt.save_checkpoint(cfg.checkpoint_dir, self.state,
                                     epoch + 1, self.best_acc1, cfg.arch,
                                     is_best, extra_meta=self._run_meta,
                                     async_write=True,
                                     keep=cfg.keep_checkpoints,
                                     mesh=self.mesh)
                self.ledger.emit("ckpt", epoch=epoch + 1,
                                 path=cfg.checkpoint_dir, is_best=is_best,
                                 seconds=round(time.time() - t_ck, 6))
            self.log(f"Epoch {epoch}: train_loss={train['loss']:.4f} "
                     f"val_acc1={acc1 * 100:.3f} "
                     f"best={self.best_acc1 * 100:.3f} ({epoch_secs:.1f}s, "
                     f"train {img_s:,.0f} img/s, {tflops:.1f} TF/s analytic"
                     + (f", MFU {mfu * 100:.1f}% analytic" if mfu else "")
                     + ")")
