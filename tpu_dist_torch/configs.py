"""Configuration for the port (``tpu_dist/configs.py``: ``TrainConfig``
``:20-221``, ``LMConfig`` ``:224-394``, ``add_args`` ``:398`` and
``parse_config`` ``:428``), copied so the port's entry points take the
reference's flags. The field lists, defaults and comments are the
reference's; knobs the port does not implement yet are refused by the
trainers (``tpu_dist_torch.engine.loop.Trainer`` and
``tpu_dist_torch.engine.lm_loop.LMTrainer``), which name each one.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass
class TrainConfig:
    """All knobs of the reference scripts, plus TPU-native ones.

    Reference flag provenance is noted per field; TPU-only fields are marked.
    """

    # -- data (reference 1.dataparallel.py:27-31)
    data: str = "data"                 # dataset root dir
    dataset: str = "cifar10"           # cifar10 | mnist | imagenet | synthetic
    workers: int = 4                   # loader worker threads (host-side)

    # -- model (reference 1.dataparallel.py:32-38)
    arch: str = "resnet18"
    pretrained: str = ""               # reference: bool (download torchvision
    # weights). Zero egress makes that a PATH: warm-start params/BN stats
    # from a local checkpoint (this repo's own model_best format), fresh
    # optimizer state — shape-mismatched leaves (a different-class head)
    # keep their init, the fine-tune contract. "" = train from scratch.
    norm: str = ""                     # ResNet-only: bn (default) | gn
    norm_dtype: str = ""               # ResNet-only: "" (fp32 norm outputs,
                                       # torch-AMP parity) | bf16 (MLPerf-TPU
                                       # practice: bf16 normalized activations,
                                       # fp32 statistics — models/resnet.py)
    stem: str = ""                     # ResNet-only: imagenet | cifar | s2d
                                       # (space-to-depth, models/resnet.py)

    # -- schedule (reference 1.dataparallel.py:39-56)
    epochs: int = 10
    start_epoch: int = 0
    batch_size: int = 3200             # GLOBAL batch (divided per process/device)
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr_step_epochs: int = 30           # x0.1 every N epochs (1.dataparallel.py:332-336)
    lr_scale_by_world: bool = False    # horovod-style lr x world_size (5.2...py:159-171)
    optimizer: str = "sgd"             # sgd | adamw | fused_sgd (Pallas kernel,
                                       # apex fused-optimizer analog)
    adam_b1: float = 0.9               # adamw betas/eps; b2 defaults to the
    adam_b2: float = 0.999             # image convention here (the LM config
    adam_eps: float = 1e-8             # defaults to the LM one, 0.95)

    # -- loop control (reference 1.dataparallel.py:57-70)
    print_freq: int = 10
    evaluate: bool = False
    seed: Optional[int] = None
    resume: str = ""                   # TPU build adds REAL resume (reference has none,
                                       # SURVEY.md §5 checkpoint)
    checkpoint_dir: str = "checkpoints"

    # -- precision (reference variant 4 apex AMP -> XLA bf16; SURVEY.md §2b apex row)
    precision: str = "fp32"            # fp32 | bf16 | bf16_params
    quant: str = "none"                # none | int8 | int8_wo (ops.quant):
                                       # int8 quantized matmuls in the
                                       # transformer-family archs (vit_*) —
                                       # the rung above bf16 on the ladder;
                                       # composes with precision=bf16
    loss_scale: Optional[float] = None # only meaningful if emulating fp16 semantics
    grad_compression: str = "none"     # none | bf16  (hvd.Compression.fp16-equiv,
                                       # reference 5.horovod_distributed.py:123-125)

    # -- comm/compute overlap (parallel.overlap; no reference analog beyond
    #    DDP's own bucket overlap, which grad_bucket_mb reproduces)
    tp_impl: str = "gspmd"             # gspmd | ring: ring = manual
                                       # collective-matmul TP for the
                                       # transformer-family archs (vit_*)
                                       # under variant='shard_map' with a
                                       # 'model' mesh axis
    grad_bucket_mb: float = 0.0        # >0: explicit grad sync in DDP-style
                                       # size-targeted bucket collectives
                                       # (~25 is DDP's default) instead of
                                       # one fused allreduce; requires
                                       # variant='shard_map'

    # -- distribution (reference C5/C6/C25 + TPU mesh)
    variant: str = "jit"               # engine flavor tag for logging only
    mesh_shape: Optional[Sequence[int]] = None  # e.g. (8,) dp; (4,2) dp x model
    mesh_axes: Sequence[str] = ("data",)
    gradient_predivide_factor: float = 1.0      # reference 5.2...py:185
    adasum: bool = False                        # reference 5.2...py:184: REAL
                                                # Adasum recursive-halving
                                                # reduction (collectives.
                                                # adasum_reduce) in the
                                                # shard_map engine

    # -- dispatch/data-path tuning (TPU-only; no reference analog — its
    #    per-batch host loop was the bottleneck the prefetcher fought, C13)
    steps_per_dispatch: int = 1        # K optimizer steps per XLA dispatch
                                       # (lax.scan window; amortizes controller
                                       # latency — requires variant 'jit')
    grad_accum_steps: int = 1          # microbatches per optimizer step: the
                                       # global batch is split into N
                                       # sequential microbatches whose grads
                                       # average into ONE update (for global
                                       # batches beyond device memory)
    data_placement: str = "auto"       # host | device | auto: 'device' keeps
                                       # the whole uint8 dataset in HBM and
                                       # sends only index windows per step
                                       # (auto: device when in-memory and
                                       # steps_per_dispatch > 1)

    # -- observability (reference C21/C22 + the round-6 obs subsystem)
    log_csv: str = ""                  # per-epoch [start, seconds] CSV if set
                                       # (rendered as a ledger sink since
                                       # round 6 — same values, one source)
    profile_dir: str = ""              # torch.profiler trace dir if set
    telemetry_csv: str = ""            # 500ms device-HBM/host-RSS sampler CSV
                                       # (utils.telemetry — the reference's
                                       # nvidia-smi statistics.sh analog;
                                       # every process writes its own
                                       # .pN-suffixed file on multi-host)
    ledger_path: str = ""              # append-only JSONL run ledger
                                       # (obs.ledger: run_start/step/epoch/
                                       # eval/ckpt/... typed events; non-main
                                       # processes write <path>.pN)
    watchdog_factor: float = 10.0      # hang watchdog (obs.watchdog): dump
                                       # stacks+HBM when no step completes in
                                       # factor x trailing-median step time
                                       # (5s floor; 0 disables)
    skew_every: int = 0                # cross-host step-time skew allgather
                                       # every K steps (obs.skew; 0 = off)
    health: str = "record"             # numerical-health policy (obs.health):
                                       # record (probes + ledger events only)
                                       # | skip (zero a non-finite update,
                                       # advance data+RNG — multi-host
                                       # lockstep preserved) | halt (raise)
    health_spike_z: float = 8.0        # loss-spike z-score threshold of the
                                       # host-side EMA detector (0 disables)
    metrics_port: int = 0              # Prometheus scrape endpoint
                                       # (obs.metrics): process i serves
                                       # http://host:(port+i)/metrics; 0=off
    flightrec_dir: str = ""            # flight-recorder bundle root
                                       # (obs.flightrec); "" derives
                                       # <ledger_path>.flightrec (or a temp
                                       # dir) at first trigger
    flightrec_trace_steps: int = 3     # torch.profiler window: step records
                                       # captured after a trigger (0 = no
                                       # trace in the bundle)
    job_id: str = ""                   # run lineage (obs.goodput): stable
                                       # id shared by every restart attempt
                                       # of one logical job (default: the
                                       # ledger filename stem)
    attempt: int = 0                   # restart ordinal: 0 = first attempt
                                       # (bare ledger_path), N>0 writes
                                       # <path>.aN, -1 = auto (next free
                                       # index from the files on disk)
    goodput_every_s: float = 60.0      # periodic 'goodput' ledger-event
                                       # cadence in run seconds (0 = only
                                       # the final one at run_end)
    slo_steps_per_min: float = 0.0     # progress-SLO floor on EMA
                                       # optimizer steps/min (0 = off);
                                       # a breach emits an 'slo' event,
                                       # which auto-triggers the flight
                                       # recorder via the ledger sink
    slo_throughput: float = 0.0        # progress-SLO floor on EMA items/s
                                       # (img/s here, tok/s in LMConfig;
                                       # 0 = off)

    # -- self-healing (round 10: parallel.supervisor + obs.faults)
    faults: str = ""                   # deterministic fault-injection spec
                                       # (obs.faults grammar, e.g.
                                       # "hard_exit@step=10,attempt=0";
                                       # TPU_DIST_FAULTS env also honored)
    keep_checkpoints: int = 3          # retain the last K checkpoints as
                                       # step-stamped hard links + a
                                       # newest-valid pointer; a corrupt
                                       # newest falls back at load (0 =
                                       # newest only, pre-round-10)
    max_restarts: int = 0              # >0: wrap fit() in the in-process
                                       # supervised-restart loop
                                       # (parallel.supervisor.
                                       # run_supervised); halts/crashes
                                       # resume from the newest valid
                                       # checkpoint with attempt lineage
    restart_backoff_s: float = 1.0     # restart backoff base (doubles per
                                       # restart, capped at 60s)
    crash_loop_k: int = 3              # stop restarting after K
                                       # consecutive pre-first-step deaths

    # -- step plan (tpu_dist.plan): "" | "none" = hand-set knobs; "auto"
    #    = the tuner's analytic search for this device kind (pruned to
    #    what this config can run); a path = a tools/tune.py plan JSON
    #    (best-plan-per-device-kind). The plan-owned knobs (quant,
    #    tp_impl, grad_bucket_mb, steps_per_dispatch, health, precision,
    #    variant, Pallas block sizes) are overridden before the engine
    #    builds steps; run_start + a 'plan' ledger event record the hash
    plan: str = ""
    # -- program audit (analysis.proglint via plan.compile):
    #    none = off; record = audit the step program's first dispatch +
    #    the drain-boundary recompile sentry, emitting 'audit' ledger
    #    events; halt = record, then raise AuditError on any unwaivered
    #    finding
    audit: str = "none"

    # -- synthetic-data knobs (TPU-only: zero-egress envs can't download datasets)
    synth_train_size: int = 50000
    synth_val_size: int = 10000

    def scaled_lr(self, world_size: int) -> float:
        """Horovod lr scaling rule (reference 5.2.horovod_pytorch_mnist.py:159-171)."""
        return self.lr * world_size if self.lr_scale_by_world else self.lr


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
    profile_dir: str = ""          # torch.profiler trace dir if set (C22)
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
                                   # none | record (first-dispatch pass +
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


def parse_config(argv: Optional[Sequence[str]] = None,
                 defaults: Optional[TrainConfig] = None,
                 description: str = "tpu_dist training"):
    """Parse argv into a config of the same dataclass as ``defaults``."""
    defaults = defaults if defaults is not None else TrainConfig()
    cls = type(defaults)
    parser = argparse.ArgumentParser(description=description)
    add_args(parser, defaults)
    ns = parser.parse_args(argv)
    return cls(**{f.name: getattr(ns, f.name)
                  for f in dataclasses.fields(cls)})
