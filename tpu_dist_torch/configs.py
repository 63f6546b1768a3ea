"""LM configuration for the port (``tpu_dist/configs.py``: ``LMConfig``
``:224-394`` and ``add_args`` ``:398``), copied so the port's entry points
take the reference's flags. The field list, defaults and comments are the
reference's; knobs the port does not implement yet are refused by
``tpu_dist_torch.engine.lm_loop.LMTrainer``, which names each one.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass
class LMConfig:
    """Knobs of the LM half of the framework (no reference analog — the
    reference is image-only; SURVEY.md §2c). Mirrors TrainConfig's shape so
    scripts build their parsers the same way (add_args works on both)."""

    # -- corpus (tpu_dist.data.tokens)
    data: str = ""                 # token file (.bin uint16 / .npy); empty
                                   # or missing -> synthetic affine corpus
    val_data: str = ""             # separate val token file (else tail split)
    val_frac: float = 0.05         # held-out tail fraction of the stream
    synth_tokens: int = 2_000_000  # synthetic corpus length
    vocab_size: int = 512
    seq_len: int = 512

    # -- model
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 8
    num_experts: int = 0           # MoE feed-forward with N experts (0=dense)
    router_top_k: int = 1          # 1 = Switch top-1, 2 = GShard top-2
    moe_group_size: int = 512      # router group tokens (GShard grouping;
                                   # under sp, groups are shard-local — a
                                   # size dividing the shard keeps routing
                                   # identical to the dp grouping)
    moe_aux_weight: float = 0.01   # weight of the router balance+z losses
                                   # in the objective (every MoE mode)
    moe_capacity_factor: float = 1.25  # per-expert queue = S/E * factor * k
                                   # (>= E/k makes dispatch drop-free —
                                   # models/moe.py capacity notes)
    attn: str = "full"             # full | blockwise | flash (Pallas FA2)
    attn_block: int = 1024         # KV block for blockwise/flash (clamped
                                   # to seq_len; 1024 measured ~20% faster
                                   # than 512 for flash fwd+bwd on v5e)
    remat: bool = False            # jax.checkpoint each block (HBM lever)
    loss_chunk: int = 0            # >0: chunked head+CE (ops.fused_xent) —
                                   # the (B,L,V) logits never materialize;
                                   # N rows of logits at a time, backward
                                   # recomputes (jit, sp, and gpipe-pp)
    precision: str = "fp32"        # fp32 | bf16
    quant: str = "none"            # none | int8 | int8_wo (ops.quant):
                                   # int8 dense/attention/expert matmuls
                                   # with STE training (int8) or weight-only
                                   # quantization (int8_wo — the
                                   # memory-bound-decode mode; with
                                   # loss_chunk > 0 the chunked head stays
                                   # in the compute dtype)

    # -- schedule
    epochs: int = 1
    max_steps: int = 0             # stop after N optimizer steps (0 = off;
                                   # smoke tests / fixed-step runs)
    batch_size: int = 16           # GLOBAL batch in sequences
    optimizer: str = "sgd"         # sgd | adamw (decoupled, b2=0.95 LM
                                   # convention — ops.optim.make_optimizer)
                                   # | fused_adamw (Pallas single-pass
                                   # kernel, ops.pallas_adamw; measured
                                   # SLOWER than adamw at 0.9B — BASELINE.md
                                   # round-5 — kept as the apex-FusedAdam
                                   # capability analog)
    lr: float = 3e-2
    momentum: float = 0.9
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0         # >0: clip raw grads by global norm
                                   # before the optimizer statistics
    lr_schedule: str = "constant"  # constant | cosine | step, each with
                                   # linear warmup (ops.optim.lm_lr_schedule;
                                   # resume-safe — the step count rides in
                                   # the checkpointed optimizer state)
    warmup_steps: int = 0          # linear warmup updates before the decay
    lr_decay_steps: int = 0        # cosine horizon in optimizer steps
                                   # (0 = max_steps if set, else
                                   # epochs * steps_per_epoch)
    lr_min_frac: float = 0.0       # cosine floor as a fraction of base lr
    lr_step_epochs: int = 30       # 'step' decay interval (reference C19)

    # -- distribution (mesh axes pick the parallelism: data / model / seq /
    #    expert / stage — see scripts/8)
    mesh_shape: Optional[Sequence[int]] = None
    mesh_axes: Sequence[str] = ("data",)
    tp_impl: str = "gspmd"         # gspmd (declarative Megatron specs,
                                   # parallel.tp) | ring (manual collective
                                   # matmul with comm/compute overlap,
                                   # parallel.overlap) — picks HOW a
                                   # 'model' mesh axis is implemented;
                                   # identical param trees/checkpoints,
                                   # fp losses allclose (tests)
    grad_bucket_mb: float = 0.0    # >0: dp grad sync as DDP-style bucket
                                   # reduce-scatter collectives of ~this
                                   # many MB (25 = DDP's default) instead
                                   # of one fused tree-wide allreduce
                                   # (engine.lm_steps explicit dp step)
    fsdp: bool = False             # ZeRO-3 param+opt sharding over 'data'
    pp_microbatches: int = 4       # pipeline microbatches (with a 'stage' axis)
    pp_schedule: str = "gpipe"     # gpipe (autodiff through the tick scan;
                                   # stashes O(M) microbatch activations) |
                                   # 1f1b (manual-vjp PipeDream-flush:
                                   # activation stash O(S), M-independent —
                                   # the large-M / long-context schedule)

    # -- dispatch/data path (same TPU levers as TrainConfig)
    steps_per_dispatch: int = 1
    data_placement: str = "auto"   # auto | host | device (HBM-resident rows)
    grad_accum_steps: int = 1      # microbatches per optimizer step (jit
                                   # modes; global token batches beyond HBM)

    # -- loop control
    print_freq: int = 10
    evaluate: bool = False
    seed: Optional[int] = 0
    resume: str = ""
    pretrained: str = ""           # warm-start params from a local ckpt
                                   # (fresh opt state; see TrainConfig)
    checkpoint_dir: str = ""
    log_csv: str = ""              # per-epoch CSV (ledger sink since round 6)
    profile_dir: str = ""          # jax.profiler trace dir if set (C22)
    telemetry_csv: str = ""        # 500ms device-HBM sampler (utils.telemetry;
                                   # .pN-suffixed per process on multi-host)
    ledger_path: str = ""          # JSONL run ledger (obs.ledger; non-main
                                   # processes write <path>.pN)
    watchdog_factor: float = 10.0  # hang watchdog: factor x trailing-median
                                   # step time (5s floor; 0 disables)
    skew_every: int = 0            # cross-host skew allgather every K steps
    health: str = "record"         # numerical-health policy (obs.health):
                                   # record | skip (zero a non-finite
                                   # update, advance data+RNG) | halt
    health_spike_z: float = 8.0    # loss-spike z-score threshold (0 = off)
    metrics_port: int = 0          # Prometheus scrape endpoint: process i
                                   # serves port+i (obs.metrics; 0 = off)
    flightrec_dir: str = ""        # flight-recorder bundle root
                                   # (obs.flightrec; "" derives from
                                   # ledger_path or a temp dir)
    flightrec_trace_steps: int = 3 # profiler window after a trigger, in
                                   # step records (0 = no trace)
    job_id: str = ""               # run lineage (obs.goodput): stable id
                                   # across restart attempts of one job
                                   # (default: ledger filename stem)
    attempt: int = 0               # restart ordinal: 0 = bare ledger_path,
                                   # N>0 writes <path>.aN, -1 = auto
    goodput_every_s: float = 60.0  # periodic 'goodput' event cadence
                                   # (0 = only the final one at run_end)
    slo_steps_per_min: float = 0.0 # progress-SLO floor on EMA optimizer
                                   # steps/min (0 = off; breach emits
                                   # 'slo' -> flight-recorder bundle)
    slo_throughput: float = 0.0    # progress-SLO floor on EMA tok/s
                                   # (0 = off)
    faults: str = ""               # fault-injection spec (obs.faults;
                                   # TPU_DIST_FAULTS env also honored)
    keep_checkpoints: int = 3      # keep-last-K retention + newest-valid
                                   # pointer (corrupt newest falls back)
    max_restarts: int = 0          # >0: in-process supervised restarts
                                   # (parallel.supervisor.run_supervised)
    restart_backoff_s: float = 1.0 # restart backoff base (doubles, cap 60s)
    crash_loop_k: int = 3          # crash-loop cutoff: K consecutive
                                   # pre-first-step deaths stop the loop
    plan: str = ""                 # step plan (tpu_dist.plan): "" | "none"
                                   # = hand-set knobs; "auto" = analytic
                                   # tuner search for this device kind; a
                                   # path = a tools/tune.py plan JSON —
                                   # plan-owned knobs (quant/tp_impl/
                                   # grad_bucket_mb/steps_per_dispatch/
                                   # loss_chunk/health/precision/blocks)
                                   # override before steps build; the
                                   # hash lands in run_start + a 'plan'
                                   # ledger event
    audit: str = "none"            # program audit (analysis.proglint):
                                   # none | record (compile-time pass +
                                   # drain-boundary recompile sentry,
                                   # 'audit' ledger events) | halt
                                   # (record + raise on unwaivered)


def add_args(parser: argparse.ArgumentParser, defaults) -> None:
    """Register every config field as a --flag (reference C1 parity).
    Works for TrainConfig and LMConfig alike (fields come from the
    defaults instance's own dataclass)."""
    for f in dataclasses.fields(type(defaults)):
        name = "--" + f.name.replace("_", "-")
        default = getattr(defaults, f.name)
        if f.type == "bool" or isinstance(default, bool):
            # BooleanOptionalAction: --flag / --no-flag, so variant defaults
            # of True (e.g. 5.2's lr_scale_by_world) stay overridable
            parser.add_argument(name, action=argparse.BooleanOptionalAction,
                                default=default)
        elif f.name == "mesh_shape":
            # "" -> None (auto: all devices on the data axis) — the
            # supervisor's degraded relaunch uses --mesh-shape "" to reset
            # an explicit layout after mesh shrink
            parser.add_argument(
                name,
                type=lambda s: tuple(int(x) for x in s.split(",")) if s
                else None,
                default=default)
        elif f.name == "mesh_axes":
            parser.add_argument(name, type=lambda s: tuple(s.split(",")), default=default)
        else:
            typ = type(default) if default is not None else str
            if f.name in ("seed", "loss_scale"):
                typ = float if f.name == "loss_scale" else int
            parser.add_argument(name, type=typ, default=default)
