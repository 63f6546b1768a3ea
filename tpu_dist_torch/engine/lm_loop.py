"""LMTrainer for the port (``tpu_dist/engine/lm_loop.py``): the LM family's
training loop, data-parallel on one device.

What follows the reference (line numbers are ``lm_loop.py``'s):

* ``__init__`` (``:55-400``): the corpus (``data.tokens``), the model
  (``_build_model :469-505``, ``attn`` full | blockwise | flash), the
  ``pretrained`` warm start (``:133-165``: the leaves of a port checkpoint
  whose name and shape match, over a fresh optimizer at step 0), the LR
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
  port's ``obs/ledger.py``.

``loss_chunk > 0`` trains and evaluates through the chunked head
(``ops.fused_xent``). It runs on CUDA unless ``device="cpu"`` is asked
for, and takes an optional flax-layout initial param tree
(``init_params``) so a run can start from the reference trainer's
initial weights. Knobs not ported yet raise ``NotImplementedError``
naming the knob (:data:`UNPORTED`); the preemption snapshot on SIGTERM is
one of the observers left out.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from tpu_dist_torch.configs import LMConfig
from tpu_dist_torch.data.sampler import DistributedSampler
from tpu_dist_torch.data.tokens import load_token_dataset
from tpu_dist_torch.device import peak_flops, resolve_device
from tpu_dist_torch.engine import checkpoint as ckpt
from tpu_dist_torch.engine.lm_steps import (LM_METRIC_KEYS, lm_eval_metrics,
                                            lm_train_step, make_lm_batches,
                                            shift_rows, zeros_lm_metrics)
from tpu_dist_torch.engine.state import TrainState
from tpu_dist_torch.obs.health import (PROBE_KEYS, HealthSentry,
                                       validate_health)
from tpu_dist_torch.obs.ledger import EpochCsvSink, Ledger
from tpu_dist_torch.ops.optim import lm_lr_schedule, make_optimizer
from tpu_dist_torch.ops.pallas_adamw import FusedAdamW
from tpu_dist_torch.ops.precision import make_policy
from tpu_dist_torch.ops.quant import validate_quant
from tpu_dist_torch.utils.meters import MeterBank

# knob -> its off value. Anything else raises NotImplementedError naming
# the knob: each waits for a later slice of the port.
UNPORTED = {
    "mesh_shape": (None, (1,)), "mesh_axes": (("data",),),
    "fsdp": (False,), "num_experts": (0,), "grad_bucket_mb": (0.0,),
    "plan": ("", "none"), "audit": ("none",), "faults": ("",),
    "max_restarts": (0,), "metrics_port": (0,), "profile_dir": ("",),
    "telemetry_csv": ("",), "skew_every": (0,),
    "slo_steps_per_min": (0.0,), "slo_throughput": (0.0,),
}
# observers the reference turns on by default; named once in the start log
UNPORTED_OBSERVERS = ("watchdog_factor", "goodput_every_s")
ATTNS = ("full", "blockwise", "flash")
# run-meta keys a resume must match before any state loads, and those a
# mid-epoch resume must match as well
HARD_GEOMETRY = ("vocab_size", "num_layers", "d_model", "num_heads",
                 "seq_len", "num_experts", "pp_stages")
SOFT_GEOMETRY = ("steps_per_epoch", "batch_size", "dataset_len")


def refuse_unported(cfg: LMConfig) -> None:
    for knob, off in UNPORTED.items():
        val = getattr(cfg, knob)
        if knob == "mesh_shape" and val is not None:
            val = tuple(val)
        if knob == "mesh_axes":
            val = tuple(val)
        if val not in off:
            raise NotImplementedError(
                f"LMConfig.{knob}={val!r} is not ported yet: the port's "
                f"LMTrainer runs data=1 dp on one device (supported: "
                f"{' | '.join(repr(o) for o in off)})")


def lm_flops_per_token(model, num_layers: int, seq_len: int,
                       d_model: int) -> float:
    """Model FLOPs per trained token (the reference's ``utils/mfu.py``
    accounting): 6 * non-embedding params + 6 * layers * L * d."""
    n = sum(p.numel() for name, p in model.named_parameters()
            if not name.startswith(("tok_emb", "pos_emb")))
    return 6.0 * n + 6.0 * num_layers * seq_len * d_model


class LMTrainer:
    """The dp LM trainer on one device (module docstring has the tour)."""

    def __init__(self, cfg: LMConfig, *, device=None,
                 init_params: Optional[dict] = None):
        refuse_unported(cfg)
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
            if cfg.batch_size % self.accum:
                raise ValueError(
                    f"global batch {cfg.batch_size} not divisible by "
                    f"grad_accum_steps x data axis ({self.accum} x 1)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = make_policy(cfg.precision)
        self.mode = "dp"
        # whether the int8 matmuls ride the fused kernel (csrc/fused_quant.cu;
        # on the CPU its plain version runs): the step records' ``fused``
        # flag, as in the reference
        self._fused_quant = cfg.quant == "int8" and self.device.type == "cuda"

        # ---- corpus ----
        seed = cfg.seed if cfg.seed is not None else 0
        self.train_ds, self.val_ds = load_token_dataset(
            cfg.data, cfg.seq_len, cfg.vocab_size, val_frac=cfg.val_frac,
            synth_tokens=cfg.synth_tokens, seed=seed, val_data=cfg.val_data)
        self.vocab_size = self.train_ds.vocab_size
        self.local_batch = cfg.batch_size

        # ---- model ----
        self.model = self._build_model(seed if init_params is None else None)
        if init_params is not None:
            from tpu_dist_torch.interop import load_flax_params
            load_flax_params(self.model, init_params)
        if cfg.pretrained:
            self._warm_start(cfg.pretrained)
        self.model.requires_grad_(True)
        self.steps_per_epoch = max(
            1, -(-len(self.train_ds) // cfg.batch_size))
        total_steps = (cfg.lr_decay_steps or cfg.max_steps
                       or cfg.epochs * self.steps_per_epoch)
        self.lr_schedule = lm_lr_schedule(
            cfg.lr, cfg.lr_schedule, warmup_steps=cfg.warmup_steps,
            total_steps=total_steps, steps_per_epoch=self.steps_per_epoch,
            step_epochs=cfg.lr_step_epochs, min_frac=cfg.lr_min_frac)
        if cfg.optimizer == "fused_adamw":
            self.tx = FusedAdamW(self.lr_schedule, b1=cfg.adam_b1,
                                 b2=cfg.adam_b2, eps=cfg.adam_eps,
                                 weight_decay=cfg.weight_decay,
                                 clip_norm=cfg.grad_clip)
        else:
            self.tx = make_optimizer(cfg.lr, cfg.momentum, cfg.weight_decay,
                                     schedule=self.lr_schedule,
                                     kind=cfg.optimizer, b1=cfg.adam_b1,
                                     b2=cfg.adam_b2, eps=cfg.adam_eps,
                                     grad_clip=cfg.grad_clip)
        self.state = TrainState.create(self.model, self.tx)

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
            "pp_stages": 0, "steps_per_epoch": self.steps_per_epoch,
            "batch_size": cfg.batch_size, "dataset_len": len(self.train_ds),
            "mode": self.mode}
        self.start_epoch = 0
        self._skip_batches = 0
        self.best_ppl = float("inf")
        if cfg.resume:
            self._resume(cfg.resume)
        self._epoch_in_progress = self.start_epoch
        self.last_tok_s = 0.0
        self._warmed = False
        self._flops_per_step = None
        self.ledger = Ledger(cfg.ledger_path or None)
        if cfg.log_csv:
            self.ledger.add_sink(EpochCsvSink(cfg.log_csv))
        self.health = HealthSentry(cfg.health, cfg.health_spike_z,
                                   ledger=self.ledger)

    def _warm_start(self, path: str) -> None:
        """Graft a port checkpoint's params onto the fresh model where name
        and shape match (``:133-165``)."""
        params, _, meta = ckpt.load_warmstart(path)
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
        _, meta = ckpt.load_checkpoint(path, self.state)
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
    def _build_model(self, seed):
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
        return TransformerLM(
            vocab_size=self.vocab_size, num_layers=cfg.num_layers,
            d_model=cfg.d_model, num_heads=cfg.num_heads,
            max_len=cfg.seq_len, dtype=self.policy.compute_dtype,
            param_dtype=self.policy.param_dtype, attn_fn=attn_fn,
            quant=cfg.quant, remat=cfg.remat, device=self.device, seed=seed)

    def log(self, *a, **kw):
        print(*a, **kw, flush=True)

    def _epoch_indices(self, ds, train: bool, epoch: int):
        """(idx (nb, B), valid (nb, B)): the reference's batch-blocked
        sampler layout."""
        sampler = DistributedSampler(
            len(ds), num_replicas=1, rank=0, shuffle=train,
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
        cfg = self.cfg
        return lm_train_step(self.model, self.tx, self.state, inputs,
                             targets, cfg.health, cfg.loss_chunk, self.accum)

    def _step_flops(self) -> float:
        if self._flops_per_step is None:
            cfg = self.cfg
            self._flops_per_step = lm_flops_per_token(
                self.model, cfg.num_layers, cfg.seq_len, cfg.d_model) \
                * cfg.batch_size * cfg.seq_len
        return self._flops_per_step

    def _mfu(self, tok_per_s: float):
        """(tflops, mfu) from the analytical model FLOPs; mfu None where
        the card's peak is not in the table (the CPU included)."""
        tokens = self.cfg.batch_size * self.cfg.seq_len
        tflops = tok_per_s * self._step_flops() / tokens / 1e12
        peak = peak_flops(self.device, self.policy.compute_dtype)
        return tflops, (tflops * 1e12 / peak if peak else None)

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
        keys = LM_METRIC_KEYS + PROBE_KEYS
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
            if math.isfinite(loss) or self.health.policy != "skip":
                meters.update("Loss", loss, int(cnt))
                meters.update("Acc", m["correct1"] / cnt, int(cnt))
            n = info["n_steps"]
            share = device_s * n / total_steps
            wall = info["data_s"] + info["dispatch_s"] + share
            tok_s = info["n_items"] / max(wall, 1e-9)
            _, mfu = self._mfu(tok_s)
            gn, un = m["grad_norm"] / n, m["update_norm"] / n
            self.ledger.emit(
                "step", step=info["step"], loss=loss, throughput=tok_s,
                unit="tok/s", data_s=info["data_s"],
                dispatch_s=info["dispatch_s"], device_s=share, comm_s=None,
                mfu=mfu, steps_in_dispatch=n, warm=info["warm"],
                fused=self._fused_quant, grad_norm=gn,
                nonfinite_count=m["nonfinite_count"], update_norm=un, **mem)
            self.health.observe(info["step"], loss,
                                nonfinite=m["nonfinite_count"],
                                grad_norm=gn, update_norm=un, n_steps=n)
        pending.clear()

    # ------------------------------------------------------------------
    def _meters(self, epoch: int) -> MeterBank:
        return MeterBank(self.steps_per_epoch,
                         [("Time", "6.3f"), ("Data", "6.3f"),
                          ("Loss", ".4e"), ("Acc", "6.3f")],
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
        pending = []
        warm = (0.0, 0)
        i = skip - 1
        tokens_per_batch = cfg.batch_size * cfg.seq_len
        t_epoch = end = time.time()
        for i in range(skip, nb):
            inputs, targets = self._batch(self.train_ds, idx[i])
            data_s = time.time() - end
            meters.update("Data", data_s)
            gstep = epoch * self.steps_per_epoch + i
            was_cold = not self._warmed
            t0 = time.time()
            metrics = self._step(inputs, targets)
            dispatch_s = time.time() - t0
            if was_cold:
                warm = self._warm_up(metrics, t_epoch, 1)
            pending.append((metrics, {
                "step": gstep, "n_steps": 1, "n_items": tokens_per_batch,
                "data_s": data_s, "dispatch_s": dispatch_s,
                "warm": was_cold}))
            boundary = i % cfg.print_freq == 0 or i == nb - 1
            if boundary:
                self._drain(pending, meters)
            meters.update("Time", time.time() - end)
            if boundary:
                meters.display(i)
            end = time.time()
            if self._step_cap_hit(epoch, i + 1):
                break
        if pending:  # a max_steps break can land between print boundaries
            self._drain(pending, meters)
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
        steps."""
        sums = None
        for j in range(len(idx_window)):
            inputs, targets = shift_rows(
                self._train_rows_dev.index_select(0, idx_window[j]))
            m = self._step(inputs, targets)
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        return sums

    def _train_epoch_windowed(self, epoch: int) -> Dict[str, float]:
        """K-steps-per-dispatch epoch over device-resident rows (``:872``):
        the same math as the per-batch loop, one host round trip per print
        window."""
        cfg = self.cfg
        nb = self.steps_per_epoch
        meters = self._meters(epoch)
        skip, self._skip_batches = self._skip_batches, 0
        self.model.train()
        pending = []
        done, last_print = skip, skip - 1
        warm = (0.0, 0)
        tokens_per_batch = cfg.batch_size * cfg.seq_len
        t_epoch = end = time.time()
        for n, idx_window in self._device_windows(epoch, skip):
            data_s = time.time() - end
            meters.update("Data", data_s / n, n)
            was_cold = not self._warmed
            t0 = time.time()
            sums = self.window_step(idx_window)
            dispatch_s = time.time() - t0
            if was_cold:
                warm = self._warm_up(sums, t_epoch, n)
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
            if boundary:
                meters.display(done - 1)
            end = time.time()
            if self._step_cap_hit(epoch, done):
                break
        if pending:  # a max_steps break can land between print boundaries
            self._drain(pending, meters)
        return self._epoch_result(meters, done - skip, warm)

    def _step_cap_hit(self, epoch: int, batches_done: int) -> bool:
        cap = self.cfg.max_steps
        return bool(cap) and epoch * self.steps_per_epoch + batches_done >= cap

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
            m = lm_eval_metrics(self.model, inputs, targets, v,
                                self.cfg.loss_chunk)
            for k in sums:
                sums[k] = sums[k] + m[k]
        sums = dict(zip(LM_METRIC_KEYS, torch.stack(
            [sums[k] for k in LM_METRIC_KEYS]).tolist()))
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
        cfg = self.cfg
        dev = (torch.cuda.get_device_name(self.device)
               if self.device.type == "cuda" else "cpu")
        self.ledger.emit("run_start", kind="lm",
                         config=dataclasses.asdict(cfg), mesh={"data": 1},
                         devices=[dev], process_count=1, mode=self.mode,
                         device=str(self.device))
        off = [f"{k}={getattr(cfg, k)}" for k in UNPORTED_OBSERVERS
               if getattr(cfg, k)]
        self.log("note: observers not ported yet, off in this run: "
                 + ", ".join(off + ["preemption snapshot (SIGTERM)"]))

    def _save(self, epoch: int, is_best: bool, mid_epoch: bool = False,
              async_write: bool = False) -> str:
        """An ``lm`` checkpoint with the run's geometry and ``best_ppl``
        in its meta (keep-K retention)."""
        meta = {"best_ppl": self.best_ppl, **self._run_meta}
        if mid_epoch:
            meta["mid_epoch"] = True
        return ckpt.save_checkpoint(
            self.cfg.checkpoint_dir, self.state, epoch, 0.0, "lm", is_best,
            extra_meta=meta, async_write=async_write,
            keep=self.cfg.keep_checkpoints)

    def fit(self) -> float:
        """Train ``epochs`` (or ``max_steps``), validating after each
        epoch; returns the best validation perplexity."""
        t_run = time.time()
        self._run_start()
        status = "crashed"
        try:
            if self.cfg.evaluate:
                self.best_ppl = self.validate(0)[1]
            else:
                self._fit_epochs()
            status = "ok"
        except KeyboardInterrupt:
            status = "interrupted"
            if self.cfg.checkpoint_dir:
                self._save(self._epoch_in_progress, False, mid_epoch=True)
                self.log(f"interrupted -- checkpoint saved at epoch "
                         f"{self._epoch_in_progress}; resume with --resume")
            else:
                self.log("interrupted -- no checkpoint_dir, nothing saved")
            raise
        finally:
            ckpt.wait_for_async_save()   # never exit with a write in flight
            self.ledger.emit("run_end", steps=self.state.step,
                             seconds=round(time.time() - t_run, 6),
                             status=status, best_ppl=self.best_ppl)
            self.ledger.close()
        return self.best_ppl

    def _fit_epochs(self) -> None:
        cfg = self.cfg
        for epoch in range(self.start_epoch, cfg.epochs):
            self._epoch_in_progress = epoch
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
