"""The image ``Trainer`` for the port (``tpu_dist/engine/loop.py``):
data-parallel on one device.

What follows the reference (line numbers are ``loop.py``'s):

* ``__init__`` (``:54-448``): config validation, the datasets
  (``data.datasets``; the synthetic fallback when the files are absent),
  the model (``models.registry``, with the ResNet knobs ``norm``,
  ``norm_dtype`` and ``stem``), the ``pretrained`` warm start
  (``:174-190``: the leaves of a port checkpoint whose name and shape
  match, params and BN stats, over a fresh optimizer at step 0), the
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
* ``validate`` (``:849``): exact under sampler padding, sums fetched once;
* ``fit`` / ``_fit_epochs`` (``:892-1008``): an ``epoch`` ledger event with
  img/s, an async checkpoint per epoch, ``model_best`` on improvement, and
  a mid-epoch checkpoint on ``KeyboardInterrupt``.

The first step (or window) of a run carries cuDNN's autotuning
(``cudnn.benchmark`` is on for CUDA) and the allocator's warm-up: the loop
syncs once after it and leaves it out of the epoch's img/s. MFU is
analytic: 3 x the forward FLOPs of the convs and dense layers per image
over the card's dense peak (``device.PEAK_FLOPS``).

It runs on CUDA unless ``device="cpu"`` is asked for, and takes an
optional flax-layout ``init_params``/``init_batch_stats`` pair so a run can
start from the reference trainer's initial weights. Knobs not ported yet
raise ``NotImplementedError`` naming the knob (:data:`UNPORTED`).
"""

from __future__ import annotations

import dataclasses
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
from tpu_dist_torch.device import peak_flops, resolve_device
from tpu_dist_torch.engine import checkpoint as ckpt
from tpu_dist_torch.engine.state import TrainState
from tpu_dist_torch.engine.steps import (IMAGE_METRIC_KEYS,
                                         image_eval_metrics,
                                         image_train_step,
                                         zeros_image_metrics)
from tpu_dist_torch.models.registry import create_model, model_kind
from tpu_dist_torch.obs.health import (PROBE_KEYS, HealthSentry,
                                       validate_health)
from tpu_dist_torch.obs.ledger import EpochCsvSink, Ledger
from tpu_dist_torch.ops.optim import make_optimizer, step_decay_schedule
from tpu_dist_torch.ops.pallas_sgd import FusedSGD
from tpu_dist_torch.ops.precision import LossScaleState, make_policy
from tpu_dist_torch.utils.meters import MeterBank

# knob -> its accepted values. Anything else raises NotImplementedError
# naming the knob: each waits for a later slice of the port.
UNPORTED = {
    "variant": ("jit",), "mesh_shape": (None, (1,)),
    "mesh_axes": (("data",),), "grad_compression": ("none",),
    "adasum": (False,), "gradient_predivide_factor": (1.0,),
    "grad_bucket_mb": (0.0,), "tp_impl": ("gspmd",), "quant": ("none",),
    "plan": ("", "none"), "audit": ("none",), "faults": ("",),
    "max_restarts": (0,), "metrics_port": (0,), "profile_dir": ("",),
    "telemetry_csv": ("",), "skew_every": (0,),
    "slo_steps_per_min": (0.0,), "slo_throughput": (0.0,),
    "flightrec_dir": ("",), "job_id": ("",), "attempt": (0,),
}
# observers the reference turns on by default; named once in the start log
UNPORTED_OBSERVERS = ("watchdog_factor", "goodput_every_s")


def refuse_unported(cfg: TrainConfig) -> None:
    for knob, accepted in UNPORTED.items():
        val = getattr(cfg, knob)
        if knob in ("mesh_shape", "mesh_axes") and val is not None:
            val = tuple(val)
        if val not in accepted:
            raise NotImplementedError(
                f"TrainConfig.{knob}={val!r} is not ported yet: the port's "
                f"Trainer runs data=1 dp on one device (supported: "
                f"{' | '.join(repr(a) for a in accepted)})")


def image_forward_flops(model, image_shape) -> float:
    """Forward FLOPs per image of the convs and dense layers (2 x MACs),
    from one eval-mode forward of a single zero image."""
    from tpu_dist_torch.models.resnet import Conv
    from tpu_dist_torch.ops.quant import QuantDense

    total = [0.0]

    def conv_hook(mod, _inp, out):
        total[0] += 2.0 * out[0].numel() * mod.weight[0].numel()

    def dense_hook(mod, _inp, out):
        total[0] += 2.0 * mod.in_features * mod.features

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, Conv)
                                     else dense_hook)
             for m in model.modules() if isinstance(m, (Conv, QuantDense))]
    was_training, tuned = model.training, torch.backends.cudnn.benchmark
    model.eval()
    # no cuDNN autotuning for this one-off batch-1 forward
    torch.backends.cudnn.benchmark = False
    try:
        with torch.inference_mode():
            dev = next(model.parameters()).device
            model(torch.zeros((1, *image_shape), device=dev))
    finally:
        torch.backends.cudnn.benchmark = tuned
        model.train(was_training)
        for h in hooks:
            h.remove()
    return total[0]


class Trainer:
    """The dp image trainer on one device (module docstring has the
    tour)."""

    def __init__(self, cfg: TrainConfig, *, device=None,
                 init_params: Optional[dict] = None,
                 init_batch_stats: Optional[dict] = None):
        refuse_unported(cfg)
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
        validate_health(cfg.health)
        self.k = cfg.steps_per_dispatch
        if self.k < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if cfg.data_placement not in ("auto", "host", "device"):
            raise ValueError(f"unknown data_placement {cfg.data_placement!r}")
        self.accum = cfg.grad_accum_steps
        if self.accum < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        if self.accum > 1 and self.k > 1:
            raise ValueError("grad_accum_steps and steps_per_dispatch > 1 "
                             "are mutually exclusive")
        if self.accum > 1 and cfg.batch_size % self.accum:
            raise ValueError(
                f"global batch {cfg.batch_size} not divisible by "
                f"grad_accum_steps x device count ({self.accum} x 1)")
        if self.accum > 1 and cfg.data_placement == "device":
            raise ValueError("grad_accum_steps > 1 requires "
                             "data_placement='host' or 'auto'")
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
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.benchmark = True
        self.policy = make_policy(cfg.precision)
        self.seed = cfg.seed if cfg.seed is not None else 0

        # ---- data ----
        self.train_ds, self.val_ds = load_dataset(
            cfg.dataset, cfg.data, cfg.synth_train_size, cfg.synth_val_size,
            seed=cfg.seed if cfg.seed is not None else 1234)
        self.num_classes = self.train_ds.num_classes
        self.local_batch = cfg.batch_size

        # ---- model, schedule, optimizer ----
        self.model = create_model(
            cfg.arch, num_classes=self.num_classes,
            dtype=self.policy.compute_dtype,
            image_shape=self.train_ds.image_shape, device=self.device,
            seed=self.seed if init_params is None else None, **model_kw)
        if init_params is not None:
            from tpu_dist_torch.interop import load_flax_image_params
            load_flax_image_params(self.model, init_params, init_batch_stats)
        self.policy.cast_params_for_storage(self.model)
        if cfg.pretrained:
            self._warm_start(cfg.pretrained)
        self.model.requires_grad_(True)
        # ceil: the sampler pads to full batches
        self.steps_per_epoch = max(1, -(-len(self.train_ds) // cfg.batch_size))
        self.schedule = step_decay_schedule(cfg.scaled_lr(1),
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
        val_rides = self.val_ds.image_shape == self.train_ds.image_shape
        data_bytes = (self.train_ds.images.nbytes
                      + (self.val_ds.images.nbytes if val_rides else 0))
        fits = data_bytes <= int(os.environ.get("TPU_DIST_DEVICE_DATA_MAX",
                                                str(1 << 30)))
        self.device_data = (cfg.data_placement == "device"
                            or (cfg.data_placement == "auto" and fits
                                and self.k > 1))
        self._train_data_dev = self._val_data_dev = None
        if self.device_data:
            self._train_data_dev = self._resident(self.train_ds)
            if val_rides:
                self._val_data_dev = self._resident(self.val_ds)

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
        self._epoch_in_progress = self.start_epoch
        self.ledger = Ledger(cfg.ledger_path or None)
        if cfg.log_csv:
            self.ledger.add_sink(EpochCsvSink(cfg.log_csv))
        self.health = HealthSentry(cfg.health, cfg.health_spike_z,
                                   ledger=self.ledger)

    # ------------------------------------------------------------------
    def _resident(self, ds):
        """(uint8 images, int64 labels) of ``ds`` on the device."""
        return (torch.from_numpy(ds.images).to(self.device),
                torch.from_numpy(ds.labels.astype(np.int64)).to(self.device))

    def _warm_start(self, path: str) -> None:
        """Graft a port checkpoint's params and BN stats onto the fresh
        model where name and shape match (``:174-190``)."""
        params, stats, meta = ckpt.load_warmstart(path)
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

    def log(self, *a, **kw):
        print(*a, **kw, flush=True)

    def _sampler(self, ds, train: bool, epoch: int) -> DistributedSampler:
        sampler = DistributedSampler(
            len(ds), num_replicas=1, rank=0, shuffle=train,
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
        """The augmentation generator of global step ``gstep`` (None
        without augmentation): a function of the seed and the step, so a
        resumed run draws the same."""
        if not self.augment:
            return None
        return torch.Generator().manual_seed(self.seed * 1_000_003 + gstep)

    def _step(self, images, labels, gstep: int) -> Dict[str, torch.Tensor]:
        return image_train_step(self.model, self.tx, self.state, images,
                                labels, self.transform, self.cfg.health,
                                self._gen(gstep), self.accum)

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
        return tflops, (tflops * 1e12 / peak if peak else None)

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
        t0 = time.time()
        rows = torch.stack([torch.stack([m[k] for k in keys])
                            for m, _ in pending]).tolist()
        device_s = time.time() - t0
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
                warm=info["warm"], acc1=acc1, grad_norm=gn,
                nonfinite_count=m["nonfinite_count"], update_norm=un, **mem)
            self.health.observe(info["step"], loss,
                                nonfinite=m["nonfinite_count"],
                                grad_norm=gn, update_norm=un, n_steps=n)
        pending.clear()

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
        pending = []
        warm = (0.0, 0)
        t_epoch = end = time.time()
        it = prefetch_to_device(iter(self._loader(self.train_ds, True, epoch)),
                                self.device)
        for i, (images, labels) in enumerate(it):
            if i < skip:       # step-exact resume of a mid-epoch checkpoint
                end = time.time()
                continue
            data_s = time.time() - end
            meters.update("Data", data_s)
            gstep = epoch * self.steps_per_epoch + i
            was_cold = not self._warmed
            t0 = time.time()
            metrics = self._step(images, labels, gstep)
            dispatch_s = time.time() - t0
            if was_cold:
                warm = self._warm_up(metrics, t_epoch, 1)
            pending.append((metrics, {
                "step": gstep, "n_steps": 1, "n_items": cfg.batch_size,
                "data_s": data_s, "dispatch_s": dispatch_s,
                "warm": was_cold}))
            boundary = i % cfg.print_freq == 0 or i == nb - 1
            if boundary:
                self._drain(pending, meters)
            meters.update("Time", time.time() - end)
            if boundary:
                meters.display(i)
            end = time.time()
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
            data_s = time.time() - end
            meters.update("Data", data_s / n, n)
            was_cold = not self._warmed
            t0 = time.time()
            sums = None
            for j in range(n):
                if self.device_data:
                    images = images_all.index_select(0, payload[j])
                    labels = labels_all.index_select(0, payload[j])
                else:
                    images, labels = payload[0][j], payload[1][j]
                m = self._step(images, labels,
                               epoch * self.steps_per_epoch + done + j)
                sums = m if sums is None else {k: sums[k] + m[k] for k in m}
            dispatch_s = time.time() - t0
            if was_cold:
                warm = self._warm_up(sums, t_epoch, n)
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
            if boundary:
                meters.display(done - 1)
            end = time.time()
        return self._epoch_result(meters, nb - skip, warm)

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
            m = image_eval_metrics(self.model, self.eval_transform, images,
                                   labels, v)
            sums = {k: sums[k] + m[k] for k in sums}
        sums = dict(zip(IMAGE_METRIC_KEYS, torch.stack(
            [sums[k] for k in IMAGE_METRIC_KEYS]).tolist()))
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
        self.ledger.emit("run_start", kind="image",
                         config=dataclasses.asdict(cfg), mesh={"data": 1},
                         devices=[dev], process_count=1, mode="dp",
                         device=str(self.device))
        self._flops()   # its forward stays out of the first epoch's time
        off = [f"{k}={getattr(cfg, k)}" for k in UNPORTED_OBSERVERS
               if getattr(cfg, k)]
        self.log("note: observers not ported yet, off in this run: "
                 + ", ".join(off + ["preemption snapshot (SIGTERM)"]))

    def fit(self) -> float:
        """Train from ``start_epoch`` to ``epochs``, validating and
        checkpointing after each; returns the best validation acc@1. An
        interrupt leaves a mid-epoch checkpoint to ``--resume`` from."""
        cfg = self.cfg
        t_run = time.time()
        self._run_start()
        status = "crashed"
        try:
            if cfg.evaluate:
                self.best_acc1 = self.validate()
            else:
                self._fit_epochs()
            status = "ok"
        except KeyboardInterrupt:
            status = "interrupted"
            if cfg.checkpoint_dir:
                ckpt.save_checkpoint(
                    cfg.checkpoint_dir, self.state, self._epoch_in_progress,
                    self.best_acc1, cfg.arch, is_best=False,
                    extra_meta={"mid_epoch": True, **self._run_meta},
                    keep=cfg.keep_checkpoints)
                self.log(f"interrupted -- checkpoint saved at epoch "
                         f"{self._epoch_in_progress}; resume with --resume")
            raise
        finally:
            ckpt.wait_for_async_save()   # never exit with a write in flight
            self.ledger.emit("run_end", steps=self.state.step,
                             seconds=round(time.time() - t_run, 6),
                             status=status, best_acc1=self.best_acc1)
            self.ledger.close()
        return self.best_acc1

    def _fit_epochs(self) -> None:
        cfg = self.cfg
        for epoch in range(self.start_epoch, cfg.epochs):
            self._epoch_in_progress = epoch
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
                                     keep=cfg.keep_checkpoints)
                self.ledger.emit("ckpt", epoch=epoch + 1,
                                 path=cfg.checkpoint_dir, is_best=is_best,
                                 seconds=round(time.time() - t_ck, 6))
            self.log(f"Epoch {epoch}: train_loss={train['loss']:.4f} "
                     f"val_acc1={acc1 * 100:.3f} "
                     f"best={self.best_acc1 * 100:.3f} ({epoch_secs:.1f}s, "
                     f"train {img_s:,.0f} img/s, {tflops:.1f} TF/s analytic"
                     + (f", MFU {mfu * 100:.1f}% analytic" if mfu else "")
                     + ")")
