"""LMTrainer for the port (``tpu_dist/engine/lm_loop.py``): the LM family's
training loop, data-parallel on one device.

What follows the reference (line numbers are ``lm_loop.py``'s):

* ``__init__`` (``:55-206``): the corpus (``data.tokens``), the model
  (``_build_model :469-505``, ``attn`` full | flash), the LR schedule and
  the optimizer (``sgd`` | ``adamw`` | ``fused_adamw``, the last through
  the AdamW kernel with its clip slot), the dp step (``:581-588``);
* ``train_epoch`` (``:737``) on the host data path: ``DistributedSampler``
  rows (the reference's order, step for step), one step per batch, and
  one fetch of the metric sums per print window (``_drain``), which feeds
  the ``MeterBank`` line, the ledger's ``step`` events and the health
  sentry;
* ``validate`` (``:1038``): exact under sampler padding; ``fit``
  (``:1123``) with ``max_steps``; ledger ``run_start`` / ``step`` /
  ``eval`` / ``epoch`` / ``run_end`` events through the port's
  ``obs/ledger.py``.

It runs on CUDA unless ``device="cpu"`` is asked for, and takes an
optional flax-layout initial param tree (``init_params``) so a run can
start from the reference trainer's initial weights. Knobs not ported yet
raise ``NotImplementedError`` naming the knob (:data:`UNPORTED`).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from tpu_dist_torch.configs import LMConfig
from tpu_dist_torch.data.sampler import DistributedSampler
from tpu_dist_torch.data.tokens import load_token_dataset
from tpu_dist_torch.device import peak_flops, resolve_device
from tpu_dist_torch.engine.lm_steps import (LM_METRIC_KEYS, lm_eval_metrics,
                                            lm_train_step, make_lm_batches,
                                            zeros_lm_metrics)
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
    "loss_chunk": (0,), "grad_accum_steps": (1,),
    "steps_per_dispatch": (1,), "data_placement": ("auto", "host"),
    "checkpoint_dir": ("",), "resume": ("",), "pretrained": ("",),
    "attn": ("full", "flash"),
    "plan": ("", "none"), "audit": ("none",), "faults": ("",),
    "max_restarts": (0,), "metrics_port": (0,), "profile_dir": ("",),
    "telemetry_csv": ("",), "skew_every": (0,),
    "slo_steps_per_min": (0.0,), "slo_throughput": (0.0,),
}
# observers the reference turns on by default; named once in the start log
UNPORTED_OBSERVERS = ("watchdog_factor", "goodput_every_s")

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
        if cfg.optimizer not in ("sgd", "adamw", "fused_adamw"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r} "
                             "(sgd|adamw|fused_adamw)")
        validate_health(cfg.health)
        validate_quant(cfg.quant)
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

        self.best_ppl = float("inf")
        self.last_tok_s = 0.0
        self._warmed = False
        self._flops_per_step = None
        self.ledger = Ledger(cfg.ledger_path or None)
        if cfg.log_csv:
            self.ledger.add_sink(EpochCsvSink(cfg.log_csv))
        self.health = HealthSentry(cfg.health, cfg.health_spike_z,
                                   ledger=self.ledger)

    # ------------------------------------------------------------------
    def _build_model(self, seed):
        from tpu_dist_torch.models.transformer import (TransformerLM,
                                                       full_attention)
        from tpu_dist_torch.ops.flash_attention import flash_attention_fn

        cfg = self.cfg
        attn_fn = (flash_attention_fn(block_k=cfg.attn_block)
                   if cfg.attn == "flash" else full_attention)
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
        mem = self._memory()
        for row, (_, info) in zip(rows, pending):
            m = dict(zip(keys, row))
            cnt = m["count"]
            loss = m["loss_sum"] / cnt
            if math.isfinite(loss) or self.health.policy != "skip":
                meters.update("Loss", loss, int(cnt))
                meters.update("Acc", m["correct1"] / cnt, int(cnt))
            share = device_s / len(pending)
            wall = info["data_s"] + info["dispatch_s"] + share
            tok_s = info["n_items"] / max(wall, 1e-9)
            _, mfu = self._mfu(tok_s)
            self.ledger.emit(
                "step", step=info["step"], loss=loss, throughput=tok_s,
                unit="tok/s", data_s=info["data_s"],
                dispatch_s=info["dispatch_s"], device_s=share, comm_s=None,
                mfu=mfu, steps_in_dispatch=1, warm=info["warm"],
                fused=self._fused_quant,
                grad_norm=m["grad_norm"],
                nonfinite_count=m["nonfinite_count"],
                update_norm=m["update_norm"], **mem)
            self.health.observe(info["step"], loss,
                                nonfinite=m["nonfinite_count"],
                                grad_norm=m["grad_norm"],
                                update_norm=m["update_norm"])
        pending.clear()

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        idx, _ = self._epoch_indices(self.train_ds, True, epoch)
        nb = len(idx)
        meters = MeterBank(nb, [("Time", "6.3f"), ("Data", "6.3f"),
                                ("Loss", ".4e"), ("Acc", "6.3f")],
                           prefix=f"Epoch: [{epoch}]")
        self.model.train()
        pending = []
        warm_secs, warm_batches = 0.0, 0
        i = -1
        tokens_per_batch = cfg.batch_size * cfg.seq_len
        end = time.time()
        for i in range(nb):
            inputs, targets = self._batch(self.train_ds, idx[i])
            data_s = time.time() - end
            meters.update("Data", data_s)
            gstep = epoch * self.steps_per_epoch + i
            was_cold = not self._warmed
            t0 = time.time()
            metrics = lm_train_step(self.model, self.tx, self.state, inputs,
                                    targets, cfg.health)
            dispatch_s = time.time() - t0
            if not self._warmed:
                # the first step carries the kernel builds and the
                # allocator's warm-up: one deliberate sync so warm_secs
                # keeps them out of tok/s
                metrics["count"].item()
                self._warmed = True
                warm_secs, warm_batches = time.time() - end, 1
            pending.append((metrics, {
                "step": gstep, "n_items": tokens_per_batch,
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
        snap = meters.snapshot()
        return {"loss": snap["Loss"]["avg"], "acc": snap["Acc"]["avg"],
                "batches": i + 1, "warmup_secs": warm_secs,
                "warmup_batches": warm_batches}

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
        for i in range(len(idx)):
            inputs, targets = self._batch(self.val_ds, idx[i])
            m = lm_eval_metrics(self.model, inputs, targets,
                                self._to_device(valid[i]))
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
        if off:
            self.log("note: observers not ported yet, off in this run: "
                     + ", ".join(off))

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
            raise
        finally:
            self.ledger.emit("run_end", steps=self.state.step,
                             seconds=round(time.time() - t_run, 6),
                             status=status, best_ppl=self.best_ppl)
            self.ledger.close()
        return self.best_ppl

    def _fit_epochs(self) -> None:
        cfg = self.cfg
        for epoch in range(cfg.epochs):
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
            self.best_ppl = min(ppl, self.best_ppl)
            self.ledger.emit(
                "epoch", epoch=epoch, start_ts=t0, seconds=epoch_secs,
                throughput=tok_s, unit="tok/s", loss=train["loss"], ppl=ppl,
                mfu=mfu, tflops=tflops,
                hbm_bytes=self._memory()["hbm_peak_bytes"],
                batches=train["batches"])
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
