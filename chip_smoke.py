#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (tpu_dist_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU (the
kernels are built for sm_90a with the CUDA toolkit's nvcc). Every phase
raises on failure; the script prints no result and exits non-zero without
CUDA or without the repository beside it. Where a phase starts
independent rank groups, supervised runs, benches or fleets (phases 10,
12-15 and 18), they run side by side, so the step times, rates and walls
they print share the card and the host. Phases:

1. device: name and power limit (nvidia-smi), TF32 off for matmul/cuDNN;
2. build every CUDA kernel of the port from ``tpu_dist_torch/csrc``, all
   nvcc processes started together;
3. each kernel against its plain PyTorch version on the card, at the
   shapes its main path gives it, with the error, the kernel's time (CUDA
   events, median of 20, each queued behind a device sleep so that the
   host's dispatch stays out of it), the plain version's time, a one-call
   PyTorch yardstick (``scaled_dot_product_attention`` and its backward,
   ``torch._fused_adamw_``, ``torch._fused_sgd_``; timed here and used
   nowhere in the port) and the least time the card could take. The sgd
   kernel is held across ResNet-50's 161 leaves as one multi-leaf call,
   with the clip slot at 1 and at 0.3, and with a bf16 p (within one bf16
   ulp of max(|plain|, |p|, lr |m'|): see BF16_ULP), and timed as that
   step (graph replay and eager) and at the largest leaf; the adamw
   kernel likewise across the LM's 85 leaves (a bf16 p within one bf16
   ulp of max(|plain|, |p|, lr |upd|)) and at the lm_head leaf. The paged
   decode is held over gathered K/V and through a shuffled block table
   (bit-equal), on arenas with NaN scales wherever no row may read, and
   with a row of length 0 (exact zeros). The flash
   forward is held at two serving prefills (B1 L1024 and L2048 H8 D128)
   and at the training shape (B8 L2048, with its times), the flash
   forward, the int8-K/V flash forward and the backward pair at a ragged
   shape (B1 L1000 H8 D64, q_offset 24) and at one with dead rows (B1
   Lq130 Lk200 H8 D128, kv_offset 40; exact zeros, and dead keys too for
   the backward), and their records carry ptxas's spill stores and
   registers per kernel instance (a line of its own gives them for adamw,
   sgd, fused_quant and paged_decode). The fused int8 matmul is held
   bit-equal at every dense shape of a decode tick and a prefill (no one
   PyTorch call computes it: ``library_ms`` is null, and ``yardstick_ms``
   times the bf16 ``torch.matmul`` of the unquantized operands), the
   int8-K/V flash forward at L=2048 (library: SDPA on the dequantized K/V).
   Rows 1-5 again at head dims 16 and 32 (their own instances), 48 (the
   64 instance with the true head dim at run time) at 8 heads, 256 at 4
   and 512 (the wide path) at 2 (P3_HEAD_DIMS), each timed beside SDPA
   and its bound: the flash
   forward and the int8-K/V forward at B1 L2048, the backward pair at B8
   L2048, each also with dead rows (Lq130 Lk200, kv_offset 40), the paged
   decode at B8 Lk2048 gathered and through a shuffled block table
   (bit-equal), a row of length 0 exact zeros (``check_head_dims``). Then
   the general instances at head dims 8, 24, 33, 100, 136, 200 and 256,
   and the wide path at 257, 320, 512 and 1024 (P3_SWEEP_DIMS) in fp32
   and bf16, all five kernels at a small shape
   with dead rows, dead keys and a length-0 paged row (exact zeros),
   every output between sentinel elements (untouched), once on the
   allocator's tensors and once on views a few elements into their
   buffers (bit-equal; ``check_head_dim_sweep``);
4. small-input checks: a tiny fp32 model served on the card (kernels) and
   on the CPU (plain versions) gives the same greedy tokens, also with
   ``quant="int8"``, and with ``spec_k=3`` on the card against the same
   engine without speculation on the CPU; a tiny fp32 LM trainer, a tiny
   fp32 int8 LM trainer and a tiny fp32 image trainer (``fused_sgd``) each
   take 5 steps on both with the same losses;
5. serving main path: ``ServeEngine`` at the full width of the LM the repo
   benches (V=32000, 8 layers, d_model 1024, 8 heads, bf16, random
   weights from a seed), flash prefill and int8 paged decode, serving 16
   requests; the launch counts show both forward kernels ran;
6. training main path: ``LMTrainer`` at the same full width (L=2048, batch
   8, bf16 compute over fp32 masters, flash attention, ``fused_adamw``
   with grad_clip 1.0) for 20 steps: finite, falling losses, and per step
   one ``flash_bwd_dq`` and one ``flash_bwd_dkv`` launch per layer and one
   ``adamw`` call (one launch over all 85 leaves);
7. image main path: ``python -m tpu_dist_torch.scripts.image_train`` at the
   repo's headline image geometry (``BENCH_GEOMETRY``: ResNet-50 on
   CIFAR-10, 23.5M params in 161 leaves, batch 1024, bf16 convs over fp32
   masters, bf16 norm outputs, s2d stem, ``fused_sgd``, 16 steps a window
   over the device-resident uint8 set), one epoch of 32 steps: train img/s
   with window 1 left out, finite and falling window losses, validation
   acc@1, an analytic MFU, one ``sgd`` launch per step, and a
   checkpoint that reloads;
8. quantized and speculative serving at full width: phase 5's model and
   requests, (a) with ``quant="int8"`` (every dense layer through the
   fused int8 kernel: 33 wrapper calls per tick or prefill), (b) with
   ``spec_k=4`` self-speculation; all requests complete, and (b) emits more
   than one token per slot-tick.

9. the one-device training knobs at full width: (a) phase 6's LM with
   the chunked head (``loss_chunk=1024``), 4-step windows over
   device-resident rows: run A trains 12 steps, run B (the one with a
   checkpoint directory) is interrupted after 2 windows and leaves a
   mid-epoch checkpoint, run C resumes from it, skips 8 batches and must
   match A's steps 9-12 (loss within LOSS_TOL; whether bit-equal is
   reported), with
   one ``adamw`` launch per step, one flash backward pair per layer per
   step and a peak memory below phase 6's; (b) ``grad_accum_steps=2``
   for 4 steps: one ``adamw`` launch per step, 2 flash backward pairs per
   layer per step, step 0 within BF16_TOL of phase 6's step 0; (c)
   ``attn="blockwise"`` for 4 steps: no flash kernel launches, step 0
   within BF16_TOL of phase 6's; the chunked head's time against the
   unchunked head at the training shape; (d) ResNet-50 at
   ``BENCH_GEOMETRY`` with ``grad_accum_steps=2`` and a 2^15 loss scale
   for 8 steps (one ``sgd`` launch per step), then a ``Trainer`` warm
   started from phase 7's ``model_best`` validates within one image of
   phase 7's acc@1, and a 100-class model grafts every leaf but the
   classifier's two; (e) the decode bench's one-shot mode at the
   reference's defaults (96 of its 384 steps: P9E_STEPS) with the flash
   kernel in the full recompute.
10. multi-process data parallelism, each rank a subprocess of this script
   (``--dp-worker SPEC``) joining through ``parallel.launch.initialize``:
   (a) one rank over nccl: phase 7's run under ``variant="jit"`` (window
   losses within BF16_TOL of phase 7's; whether bit-equal is reported;
   one ``sgd`` launch a step), then script 5's settings (``shard_map``,
   bf16 compression, 25 MB buckets) for 8 host-fed steps, with img/s
   beside phase 7's; (b) two ranks sharing the card over gloo with CUDA
   tensors: a probe of the collectives (point to point is refused by the
   port there, as gloo aborts on it) and a 25 MB bucket's sync time,
   ResNet-50 2 x 512 under script 5's settings for 4 steps and phase 6's
   LM 2 x 4 with 25 MB buckets for 4 steps (step 0 within BF16_TOL of
   phase 6's; per rank one flash backward pair per layer and one
   ``adamw`` launch a step); (c) phase 4's tiny trainers on those two
   ranks against two gloo ranks on the CPU (``jit``, ``shard_map`` with
   bf16 and predivide 2, Adasum, the LM with buckets), and the 2-rank
   ``jit`` run against the 1-rank one. One card: no scaling is measured.
11. the image side on one card: (a) script 6
   (``scripts.distributed_slurm``) at its defaults (ResNet-50, synthetic
   ImageNet 224 x 224 x 3 with 1000 classes, fp32, plain sgd, ``jit``)
   cut to batch 256 and 2048 + 512 images (SCRIPT6_CUTS), cuDNN's
   autotuning off (the time limit): img/s with window 1 left out, step
   ms, peak memory, acc@1, no kernel launched;
   (b) ViT-B/16 with ``quant="int8"`` and ``fused_sgd`` (VIT_INT8): 48
   ``fused_quant`` calls a step (and a validation batch), one ``sgd``
   launch a step, ``fused`` true in every step record; ``fused_quant``
   bit-equal at its training shapes and an M tail (VIT_QUANT_SHAPES),
   timed against bf16 ``torch.matmul`` and its bound; (c) one arch per
   family of the zoo's 29 at 1000 classes in a process of its own beside
   (a), (b) and (d) (its seconds are cuDNN's first build of each conv
   shape, on the host) (ZOO_SWEEP, 12 archs: the
   published parameter counts; one bf16 ``fused_sgd`` step at batch 8,
   224 px, 299 for inception_v3, with a finite loss and one ``sgd``
   launch), then, in that process after the sweep, the same archs on the
   card against the CPU in fp32 (ZOO_FAMILIES: the eval loss, and the
   train-mode loss where no dropout draws, within LOSS_TOL (1 + |loss|);
   int8 within twice the CPU's own spread under one-ulp input moves plus
   INT8_LOSS_TOL (1 + |loss|): ``zoo_agreement``); (d) where the port's native library found
   libjpeg, ``tools/data_rate.py`` over an 8-class tree of 500 x 375
   JPEGs (with 11a's img/s as the rate to keep up with) and script 6 for
   2 steps of 64 over it, every JPEG through the native decoder; where it
   did not, the PIL route, or with no PIL the refusal naming both.
12. the LM's model-parallel axes, ranks as in phase 10: (a) phase 6's LM
   at batch 4 on two ranks sharing the card over gloo with CUDA tensors,
   for 2 steps in each of ``data=2`` + fsdp, ``data=1,model=2`` (gspmd and
   ``tp_impl="ring"``) and ``data=1,seq=2``: the reference's mode strings,
   step 0 within BF16_TOL of a one-rank dp run at the same batch over nccl,
   falling finite losses, per rank one flash backward pair per layer a
   step (H/2 heads a launch under tp; none under sp, whose ring attention
   is plain torch) and one ``adamw`` launch a step, a peak below the dp
   run's for fsdp and tp, the step ms with the share of it in the
   collectives (gloo's, through the host), and the ring modes'
   host-staged ``ppermute`` calls; (b) the reference's on-chip MoE (8
   layers, d_model 512, 8 experts top-2, L1024, bf16, flash) as ``dp-moe``
   on one rank over nccl and ``data=1,expert=2`` on two gloo ranks (step 0
   within BF16_TOL), the router aux and the dropped share, ``quant="int8"``
   with every expert matmul through ``fused_quant``, and the decode
   bench's one-shot ``--num-experts 4`` (P9E_STEPS); (c) tiny fp32
   trainers in each
   mode, ep-moe included, on two card ranks against two CPU gloo ranks,
   and ``ep-moe+tp`` on 2 x 2 (four card ranks against four CPU ranks),
   losses within LOSS_TOL (1 + |loss|); (d) the reference's tiny msgpack
   checkpoint (``tests/fixtures/torch_tiny_lm.msgpack``) warm-started on
   the card and on the CPU, fp32 logits within LOSS_TOL (1 + |x|); (e)
   each kernel of the path against its plain version at the shapes the
   modes give it (flash at tp's 4 heads a rank and at the MoE LM's width,
   ``adamw`` over a rank's fsdp and tp leaves, ``fused_quant`` bit-equal
   at the expert products). (b)'s decode bench and (d) run in this
   process beside the rank groups. One card: no scaling is measured.
13. pipeline parallelism, sharded decode and ViT ring, ranks as in phase
   10 (gloo on the card; step 0 of each mode within BF16_TOL of a one-rank
   twin over nccl): (a) phase 6's LM on ``data=1,stage=2`` with 4
   microbatches of 2 under ``gpipe`` and ``1f1b``, 2 steps: per rank and
   train step 16 flash forwards (32 under 1F1B: the recompute), 16 dq, 16
   dkv and one ``adamw``, every tick's hop host-staged, and the peak per
   rank at M=4 and M=8 (batch 2M): 1F1B within 1.25x, GPipe rising; (b)
   ``data=1,stage=2,model=2`` on four ranks at batch 4, both schedules;
   (c) phase 12b's MoE LM under both schedules; (d) gspmd tp with
   ``quant="int8"`` at batch 4 (b-d one step each: P13_SHORT): the row
   products through fused_quant's
   scaled pair (``fused_quant_amax`` then ``fused_quant_scaled``, the
   maxima max-reduced between), the pair bit-equal to its plain version at
   the tp ranks' proj and mlp_out shapes and timed beside the one-call
   kernel; (e) tiny fp32 runs of every new mode, card ranks against CPU
   ranks, within LOSS_TOL (int8: INT8_LOSS_TOL) (1 + |loss|); (f) the
   decode bench's one-shot mode with ``--tp 2`` and ``--dp 2`` at phase
   5's model (64 tokens, one trial; the two side by side, beside the rank
   groups; (b)'s four ranks start once the one-rank twins have ended),
   and tiny fp32
   greedy tokens over
   tp=2 and dp=2 equal card vs CPU and to one device; (g) ViT-B/16 under
   ``tp_impl="ring"`` at batch 128 with and without int8; and the flash
   triple at a stage's microbatch and at 4 heads, ``adamw`` over a stage's
   leaves, against their plain versions, and the one-call ``fused_quant``
   bit-equal at (d)'s column and head products and (g)'s ring products
   (P13_FQ_SHAPES).

14. sp-sharded long-context serving: (a) in this process beside (b)'s
   and (c)'s rank groups, the decode bench's ``--long-context`` replay
   of ``tools/traces/longcontext_mix.json`` at phase 5's model (``--attn flash --kv-quant int8 --attn-read flash``,
   4 slots, pages of 64, chunks of 128, ``--long-monolithic``): every
   virtual-clock number equal to P14_LC_PINS (held against the reference
   on the CPU), every request served, one ``flash_fwd`` a layer per
   monolithic prefill and one ``paged_decode`` a layer per tick of the
   three replays, and the replays' wall seconds; (b) ``ServeEngine`` over
   an ``sp`` mesh of two ranks sharing the card (gloo) at phase 5's model
   with int8 pages read by the paged decode kernel (through its contiguous
   entry, on the view the byte sum assembles): an 8,000-token prompt past
   the sp threshold (a context beyond one rank's 6,144-token budget,
   prefilled over ring attention) beside a 200-token one (the monolithic
   flash prefill), and the same in fp32 at the same widths; against the
   same engine on one rank over nccl (its sp prefill over a one-rank axis:
   the same ring attention) and one rank's unsharded flash prefill: in
   fp32 each prefill's first-token logits within LOSS_TOL (1 + |x|) of the
   one-rank sp engine (held); in bf16 within P14_BF16_LOGIT_TOL (1 + |x|)
   with the same argmax and every greedy token equal (held; every GEMM of
   a 4,096-row shard rounds apart from the 8,192-row prefill's, past
   BF16_TOL), and a control with a known fault past that limit (held);
   sp prefills, host-staged hops, sum calls and bytes, collective seconds,
   ms per tick and the peak per rank; (c) a tiny fp32 sharded engine with
   sp prefill, fp32 and int8 pages, on two card ranks against two CPU
   ranks: equal greedy tokens; (d) the paged decode kernel's contiguous
   entry against its plain version at (b)'s summed view (B2 Lk8192 H8
   D128), timed.

15. restart and faults: (a) ``python -m tpu_dist_torch.supervise
   --ledger L --ckpt-dir CK --max-restarts 4 --backoff-s 0.5
   --stall-grace-s 5 -- python3 chip_smoke.py --p15-child OUT <flags>``,
   the child wrapping ``scripts.lm_longcontext.main`` (and writing its
   kernel counts at exit) at phase 6's model on a corpus of 4 steps an
   epoch, 12 steps, one drain a step, twice: uninterrupted, and with
   ``--faults hang@step=6,attempt=0;preempt_deadline@step=9,attempt=1;
   hard_exit@step=10,attempt=2``: four attempts classed stall,
   preemption_snapshotted, crash and clean (by the supervisor and by
   ``classify_attempt`` over each attempt ledger), resumed at steps 4, 9
   and 9, the supervisor's exit 0, the stitched losses of steps 0-11
   within LOSS_TOL (1 + |loss|) of the uninterrupted run's (whether
   bit-equal is reported), per step of each clean attempt 8
   ``flash_fwd``, 8 ``flash_bwd_dq``, 8 ``flash_bwd_dkv`` and 1
   ``adamw`` launch (validation's forwards apart), each attempt's
   seconds, the stall's detection (after the last beat) and kill (after
   the stall event) latencies, the snapshot's write seconds and both
   runs' walls; (b) ``run_supervised`` over the LMTrainer at (a)'s width
   in this process for 8 steps, ``health="halt"`` and
   ``nan_batch@step=6,attempt=0``: the halt restarts from the step-4
   checkpoint and steps 4-7 are within LOSS_TOL of (a)'s uninterrupted
   run; (c) ``scripts.image_train`` at
   BENCH_GEOMETRY cut to 4 steps an epoch, 2-step windows and 2 epochs
   (P15_IMAGE) with ``--max-restarts 1 --health halt --faults
   nan_batch@step=6,attempt=0``: health_halt then clean, one ``sgd``
   launch a step, a finite final loss; (d) phase 4's tiny fp32 LM: a
   preemption snapshot at step 5, then two gloo ranks sharing the card
   with ``TPU_DIST_PEER_RESUME=1``, rank 0 resuming the snapshot and rank
   1 with none (a fresh init at step 0): rank 1 adopts rank 0's params
   and step, and step 5's loss is equal on both ranks and within LOSS_TOL
   of one rank resumed from the snapshot; (e) the same LM with
   ``ckpt_enospc@nth=2``: the second epoch's write fails inside the
   container write, the run raises, and the newest valid checkpoint is
   the first epoch's, which reloads on the card. (b)-(e) run in this
   process once (a)'s uninterrupted run has ended, beside its faulted one.
16. the observers: (a) phase 6's LM for 8 steps (a drain a step) three
   times: with every observer on but the profiler (``metrics_port``,
   ``telemetry_csv``, ``skew_every=4``, the watchdog, the flight
   recorder's 3-step window, ``slo_steps_per_min`` above what the run
   reaches): scrapes from a thread show ``tpu_dist_steps_total`` rising
   and the MFU gauge one of the step records' ``mfu``, the CSV about a
   row per 0.5 s with ``bytes_in_use`` filled and at most
   ``bytes_limit`` (one ``hbm`` event a row), the ``slo`` breach one
   bundle whose manifest lists stacks, hbm, the allocator snapshot and
   the events tail with its window ``captured`` into a Chrome trace
   holding 24 ``flash_fwd``, 24 dq, 24 dkv and 3 ``adamw`` kernels (the
   window's 3 steps), one ``compile`` and one ``cost_model`` event with
   ``matmul`` the largest flop bucket, 2 ``skew`` events, and a
   ``metrics_snapshot`` before ``run_end``; with the observers off; and
   under ``profile_dir`` (the other observers on, the recorder's window
   ``skipped``): the whole fit's Chrome trace holds every kernel launch
   the run made (8 steps and validation's forwards) and 8
   ``ProfilerStep#`` marks. The hot steps' median ms of the three runs
   (the window's steps left out) is what the observers cost; (b)
   ``scripts.image_train`` at BENCH_GEOMETRY cut to 4 steps (P16_IMAGE)
   with ``--telemetry-csv``, ``--profile-dir`` and ``--skew-every 2``:
   a ``SIGUSR1`` once the ledger shows step 1 gives a ``diagnosis``
   with reason ``sigusr1``, and the trace one ``sgd`` kernel a step;
   (c) phase 4's tiny LM on three gloo ranks sharing the card with
   ``skew_every=2`` and ``metrics_port`` (with two ranks the
   reference's spike rule, spread >= 4 x p50, cannot hold: p50 of two is
   their mean), a 2 s ``hang`` on rank 1 at step 3: every rank emits the
   same ``skew`` stats with ``n_procs`` 3, the one spike names rank 1 and
   gives every rank a ``skew`` bundle, every rank's endpoint answers at
   ``metrics_port + rank``, and ``tpu_dist_torch/tools/trace_merge.py``
   merges the three ledgers into one trace of three process lanes.
17. the plan lowering: (a) ``python -m tpu_dist_torch.tools.tune`` twice
   for the card's device kind at phase 6's workload (P17_WORKLOAD):
   byte-identical plan files, the port's peaks for the card (989 TFLOP/s
   bf16, 3,350 GB/s, not nominal), the winning plan's knobs and hash; (b)
   phase 6's LM at full width driven by that plan file (``plan=``; the
   plan owns precision, quant, the sync and window knobs, and the kernel
   switches) for 8 steps: the plan's knobs in ``t.cfg`` and the switches,
   ``run_start`` with its hash and exactly one ``plan`` event after it,
   finite falling losses, per step one ``adamw`` and 8 flash backward
   pairs, and 33 ``fused_quant`` calls a forward where the plan picked
   int8; then the same 8 steps at other tiles (the defaults, or
   P17_OTHER_TILES where the plan's are the defaults): losses bit-equal
   step for step; (c) ``fused_quant`` at phase 6's int8 products
   (M = 16,384) and a decode tick's lm_head, for every instantiated tile
   at bk 0 and 512: bit-equal to the plain version and to the default
   tile, each timed (CUDA-event medians of 20 behind a device sleep), and
   a tile the plan IR refuses (bm 12) refused by the IR with its message
   (every tile it accepts runs: phase 23d); ``sgd`` over ResNet-50's 161 leaves and ``adamw`` over
   the LM's 85 at ``opt_block_rows`` 8, 512 and 1024: within FP32_TOL
   (1 + |plain|) of the plain version, bit-equal across the values, each
   timed; (d) the image ``Trainer`` with ``plan="auto"`` on ResNet-50 at
   BENCH_GEOMETRY cut to 4 steps (P17_IMAGE): source ``auto``, the hash
   in ``run_start``, one ``sgd`` launch a step; (e) the image ``Trainer``
   on a (1, 2) ``data`` x ``model`` mesh under ``tp_impl="gspmd"``: two
   gloo ranks sharing the card (started first, beside a-d), phase 4's
   tiny image model for 4 steps (P17_TINY_IMAGE), losses within
   LOSS_TOL (1 + |loss|) of one rank's dp run at the same batch and
   weights, and the two ranks' params
   bit-equal after the last step.
18. the fleet, two ``python -m tpu_dist_torch.sim.runner`` processes side
   by side, every worker (one supervised ``ServeEngine`` process a
   virtual host) on the card: (a) ``scripts/fleet_ci.json`` (seed 7, 3
   hosts, 200 ticks of 0.02 s, host 1 preempted at tick 56 and back at
   120 through the consensus path, a 1.5x slow host 2, the burst at tick
   80, both tenants, 2 slots, a queue of 64, a 0.15 s queue-wait floor)
   with phase 5's widths in fp32 (P18_CI_MODEL) and int8 pages of 16 read
   by the paged decode kernel (P18_CI_SERVE): the restart classes equal
   the schedule's prediction (histogram P18_CI_HISTOGRAM), host 0 shrinks
   to 2 processes and expands to 3, host 1 drains, the goodput sum-check
   within 0.02 of 1, both tenants served, every SLO breach resolves to an
   exemplar trace (``tpu_dist_torch.tools.request_report --json``), and
   every worker attempt's ``run_end`` counts ``paged_decode`` at least
   once per layer per decode tick; printed: the breaches, the fleet
   goodput ratio, TTFT p50/p99 by tenant, ticks a second by host, the
   restart gaps; (b) ``scripts/fleet_autoscale.json`` as checked in (the
   tiny model): the first decision ``up`` (2 -> 3), after the first step
   record of any host at the burst's window and within P18_UP_WINDOW
   ticks after the burst on the fleet clock (the slowest live host's
   tick), a ``down`` (3 -> 2) after it, every decision paired
   with one ``scale`` event, each ``applied`` plan hash the port tuner's
   best for the card's name at processes x worker_devices devices, with
   its ``plans/plan_epoch<N>.json``, no shed request lost and a request
   of the removed standby's completed on a survivor.
19. the program audit (``analysis.proglint``) and the convergence tools:
   (a) phase 6's LM for 4 steps with ``audit="record"``, then with
   ``audit="none"``: one ``audit`` event for ``train_step`` with no
   finding (PL003 clean: the masters and moments keep their storage), the
   losses of both runs within LOSS_TOL (1 + |loss|), phase 6's launches a
   step, the audited first step's seconds and the hot step ms of both;
   (b) phase 7's ResNet-50 for 2 steps (one window of 2) with
   ``audit="record"``: one clean event, one ``sgd`` launch a step; (c)
   phase 5's serving with the audit armed: every request served, no PL005,
   prefill signatures within the bucket ladder, ``paged_decode`` once a
   layer a decode tick; (d) under ``audit="halt"``, on the card and on the
   CPU alike: an fp32 matmul in a bf16 program raises PL004, an optimizer
   that rebinds a parameter PL003, a program allowed one input signature
   and dispatched with two PL005, and phase 4's small int8 LM in bf16 runs
   clean (its fused int8 products are kernel launches on the card and the
   kernel's plain version on the CPU, out of the program's compute both
   ways); (e) two gloo ranks sharing the card (started first, side by side
   with b-f): phase 10's tiny LM twin with the audit clean on both ranks,
   then same-shape all-reduces issued SUM then MAX on rank 0 and MAX then
   SUM on rank 1, over a group with a timeout, PL002 on both ranks; (f)
   ``tools.convergence`` (ResNet-50, batch 1024, synthetic 10,240/2,048,
   bf16, ``fused_sgd``) and ``tools.lm_convergence`` (2 layers, d_model
   128 in 4 heads of 32, V 512, batch 32, L 256, bf16, flash: the
   reference's geometry): steps and seconds to 90% top-1 and to ppl 4,
   beside the reference's 30 and 116;
20. dropout drawn from (seed, step, microbatch, rank): LeNet (synthetic
   MNIST) and SqueezeNet 1.1 (synthetic CIFAR-10, 32 px) through the image
   ``Trainer`` (P20_RUN: 8 steps of 256, bf16 over fp32 masters,
   ``fused_sgd``, a step a dispatch), cuDNN deterministic and untuned:
   two runs of one seed give bit-equal per-step losses, a run stopped at
   step P20_CUT and resumed from its checkpoint gives the uninterrupted
   run's losses from there bit-equal, and every run launches ``sgd`` once
   a step.
21. the reference's own small LM configurations through the kernels at
   head dims 16 and 32: (a) ``tiny_lm`` at its defaults (V 256, 2 layers,
   d_model 64 in 4 heads of 16), fp32, a flash prefill and int8 pages read
   by the paged decode kernel (P21_SERVE), six requests served on the card
   and on the CPU from the same weights: every greedy token equal, and on
   the card ``flash_fwd`` once a layer a prefill and ``paged_decode`` once
   a layer a tick; (b) ``LMTrainer`` at ``LMConfig``'s defaults (V 512, 4
   layers, d_model 256 in 8 heads of 32, L 512, batch 16, sgd) with
   ``attn="flash"``: the fp32 twin card against CPU for P21_STEPS steps,
   losses within LOSS_TOL (1 + |loss|), then bf16 on the card for
   P21_BF16_STEPS steps, finite and falling; each run launches
   ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``.
22. four heads of 256, every attention kernel on its 256 instance: (a)
   phase 6's LM with 4 heads instead of 8 (the same parameters; the
   reference's ``LMConfig(d_model=1024, num_heads=4)``) for P22_STEPS
   steps, finite losses whose last five's mean is below the first five's,
   8 ``flash_bwd_dq``, 8 ``flash_bwd_dkv`` and one ``adamw`` launch a
   step, with the step time and peak memory; (b) ``ServeEngine`` on that
   geometry (bf16, flash prefill, int8 paged decode) serving phase 5's 16
   requests, every one complete through ``flash_fwd`` and
   ``paged_decode``; (c) tiny fp32 LMs at head dims 24 and 256
   (P22_TWINS) served on the card and on the CPU with equal greedy
   tokens, and trained 5 steps on both within LOSS_TOL (1 + |loss|).
23. two heads of 512, every attention kernel on the wide path (head dims
   above 256: 128-column output chunks over the grid's z axis, the scores
   summed over d in slices streamed through shared memory), and
   ``fused_quant`` at tiles outside its compiled ones: (a) phase 6's LM
   with 2 heads (the reference's ``LMConfig(d_model=1024, num_heads=2)``,
   ``bench.py`` with ``BENCH_HEADS=2``) for P23_STEPS steps, as 22a, with
   its step time and peak memory beside phase 6's; (b) ``ServeEngine`` on
   that geometry serving phase 5's 16 requests, as 22b; (c) tiny fp32 LMs
   at head dims 320 and 1024 (P23_TWINS), as 22c; (d) ``fused_quant`` at
   the IR-legal tiles P23_TILES (the general instance: the tile a run-time
   parameter, walked in 64 x 128 sub-tiles) at phase 17c's prefill shapes
   and a ragged one (P23_QUANT_SHAPES): bit-equal to the default tile and
   to the plain version, each timed beside the default 128 x 128.

Each phase's seconds print as it ends ("phase N took"), the parts of
phases 9 and 11 and each rank group's jobs too, and all of them together
on a line before the total.

The line before the last is the card's name and power limit; the one
before it the ``{"kernels": [...]}`` record; the last line is
``{"ok": true, "device": {...}}``.
"""

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 SIMT,
# HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# kernel vs plain version, bf16 outputs: |err| <= BF16_TOL * (1 + |plain|)
# elementwise -- the flash forward kernel rounds p and the output to bf16
# where the plain version keeps fp32: a few bf16 ulps (2^-8 relative each).
# The backward kernels round p and ds at the same points as their plain
# version, so what is left is fp32 summation order before the bf16 outputs
# round: one ulp where a sum sits on a rounding boundary, within the same
# bound
BF16_TOL = 2e-2
# int8-K/V flash forward with a bf16 q vs plain: the kernel keeps p' = p vs
# at about 16 bits (a two-term bf16 split) where the plain version keeps
# fp32, so its fp32 output is within about 2^-17 max|v| of the plain one
# (at most 3e-5 for |v| <= 4) and the two bf16 roundings land at most one
# bf16 ulp (2^-7 relative) apart: |err| <= INT8KV_ULP * |plain| +
# INT8KV_ATOL elementwise
INT8KV_ULP = 2.0 ** -7
INT8KV_ATOL = 1e-4
# AdamW and SGD kernels vs plain, fp32 throughout: the kernels contract
# mul+add into fma where PyTorch rounds each, a few fp32 ulps (2^-23
# relative each)
FP32_TOL = 1e-6
# SGD kernel vs plain with a bf16 p: both form p' = p - lr m' in fp32 and
# round it to bf16 once, but the kernel contracts the update into an fma
# where PyTorch rounds lr m' first, so the two fp32 values of p' lie a few
# fp32 ulps (2^-23 relative) of the larger term, max(|p|, lr |m'|), apart.
# Where p' does not cancel, they round to the same or neighbouring bf16
# values: one bf16 ulp of |p'| (2^-7 |p'| at most). Where it cancels
# (|p'| far below |p|), those fp32 ulps can exceed a bf16 ulp of |p'|, and
# the bf16 values differ by about the fp32 gap: a bound relative to |p'|
# alone fails there, though the gap is far below 2^-7 max(|p|, lr |m'|).
# One bound covers both: BF16_ULP * max(|plain|, |p|, lr |m'|)
BF16_ULP = 2.0 ** -7
# tiny fp32 trainer, card vs CPU: per-step losses within LOSS_TOL * (1 +
# |loss|) -- matmul summation order differs (cuBLAS vs CPU), and Adam's
# normalized update turns small gradient differences into parameter
# differences over 5 steps
LOSS_TOL = 1e-4
# tiny fp32 int8 trainer (sgd), card vs CPU: the fp32 activations entering
# each quantized layer differ by summation order (cuBLAS and the card's
# attention against the CPU's); a difference that crosses an int8 rounding
# boundary flips that int8 value by one step (1/127 of its row's range),
# from step 0 on, so per-step losses are held within INT8_LOSS_TOL * (1 +
# |loss|) (on an H100: at most 2.0e-3 apart, against a bound near 5.5e-3)
INT8_LOSS_TOL = 1e-3
# the dense products of the serving LM at full width, (M, K, N): a decode
# tick's at 8 slots and a 1024-token prefill's; QUANT_SHAPES draw from the
# shared generator, QUANT_MORE_SHAPES from their own
QUANT_SHAPES = {"decode lm_head": (8, 1024, 32000),
                "decode qkv": (8, 1024, 3072),
                "decode mlp_out": (8, 4096, 1024),
                "prefill lm_head": (1024, 1024, 32000)}
QUANT_MORE_SHAPES = {"decode proj": (8, 1024, 1024),
                     "decode mlp_in": (8, 1024, 4096),
                     "prefill mlp_out": (1024, 4096, 1024)}
SPEC_K = 4
# the training main path (V=32000, 8 layers, d_model 1024, L=2048)
TRAIN_STEPS = 20
# the LM of phases 5, 6 and 8: parameter leaves and elements
LM_LEAVES = 85
LM_PARAMS = 168_372_224
# ResNet-50 (10 classes, s2d stem): parameter leaves and elements
RESNET50_LEAVES = 161
RESNET50_PARAMS = 23_531_402


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3, backlog=True):
    """Median of ``iters`` CUDA-event timings of ``fn`` (after warmup).
    With ``backlog`` each timing waits in the stream behind a device sleep
    twice as long as the host takes to enqueue ``fn``, so the events
    bracket device time alone; without it the host's dispatch gaps count
    too."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(2 * enqueue_s, 1e-4) * 2e9)     # SM clock about 2 GHz
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if backlog:
            torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bf16_err(torch, out, ref):
    """(max |out - ref|, every element within BF16_TOL * (1 + |ref|))."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= BF16_TOL * (1 + ref.float().abs())).all())
    return diff.max().item(), ok


def pctl(xs, q):
    xs = sorted(xs)
    return xs[min(int(round(q / 100.0 * (len(xs) - 1))), len(xs) - 1)]


def flash_bound(b, h, d, live, nbytes):
    """(bound_ms, bound_by) of an attention forward over ``live`` (q, k)
    pairs moving ``nbytes``: the larger of the bf16 tensor-core time and
    the HBM time."""
    flops = 4.0 * b * h * d * live
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def dead_rows_of(torch, lq, q_offset, kv_offset):
    """The causal rows that see no key (exact zeros in every output)."""
    return q_offset + torch.arange(lq, device="cuda") < kv_offset


def check_flash_shape(torch, gen, b, lq, lk, h, d, q_offset=0, kv_offset=0):
    """flash_fwd against flash_forward_plain at one bf16 causal shape: out
    within BF16_TOL, lse within 1e-3, and the rows that see no key exact
    zeros. Returns (record, (q, k, v))."""
    from tpu_dist_torch.ops import flash_attention as fa

    q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for n in (lq, lk, lk))
    mask = (True, q_offset, kv_offset)
    out, lse = fa.flash_forward_cuda(q, k, v, *mask)
    ref, ref_lse = fa.flash_forward_plain(q, k, v, *mask)
    torch.cuda.synchronize()
    shape = (f"B{b} Lq{lq} Lk{lk} H{h} D{d} bf16 causal q_offset "
             f"{q_offset} kv_offset {kv_offset}")
    err, ok = bf16_err(torch, out, ref)
    lse_err = (lse - ref_lse).abs().max().item()
    dead = dead_rows_of(torch, lq, q_offset, kv_offset)
    zeros = bool((out[:, dead] == 0).all())
    if not (ok and lse_err <= 1e-3 and zeros):
        raise AssertionError(f"flash_fwd at {shape}: max|out err| {err} "
                             f"(tol {BF16_TOL} (1 + |ref|)), max|lse err| "
                             f"{lse_err} (tol 1e-3), dead rows exact zeros: "
                             f"{zeros}")
    return {"shape": shape, "max_abs_err": err, "lse_max_abs_err": lse_err,
            "tolerance": f"{BF16_TOL} * (1 + |plain|), lse 1e-3",
            "dead_rows": int(dead.sum()), "dead_exact_zero": zeros}, (q, k, v)


def time_flash(torch, F, rec, q, k, v, plain_iters=20):
    """Adds the kernel's, the plain version's and SDPA's times at rec's
    causal shape (q_offset = kv_offset = 0), and the bound, to ``rec``."""
    from tpu_dist_torch.ops import flash_attention as fa

    b, lq, h, d = q.shape
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    rec["ms"] = time_ms(torch, lambda: fa.flash_forward_cuda(q, k, v, True))
    rec["plain_ms"] = time_ms(torch, lambda: fa.flash_forward_plain(
        q, k, v, True), iters=plain_iters)
    rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    rec["library"] = "scaled_dot_product_attention(is_causal=True)"
    nbytes = 4 * b * lq * h * d * 2 + b * h * lq * 4    # q, k, v, out + lse
    rec["bound_ms"], rec["bound_by"] = flash_bound(
        b, h, d, live_causal_pairs(lq, lq), nbytes)
    return rec


def check_flash(torch, F, L, gen):
    """flash_fwd at B1 L H8 D128 bf16 causal (a serving prefill), from the
    shared generator, with its times."""
    rec, qkv = check_flash_shape(torch, gen, 1, L, L, 8, 128)
    rec["shape"] = f"B1 L{L} H8 D128 bf16 causal"
    return time_flash(torch, F, rec, *qkv)


def check_flash_more(torch, F):
    """flash_fwd at the training shape (B8 L2048 H8 D128 bf16 causal) with
    its times, at a ragged shape (B1 L1000 H8 D64, q_offset 24) and at one
    with dead rows (B1 Lq130 Lk200 H8 D128, kv_offset 40), from a generator
    of their own: the later phases' inputs stay as they were."""
    own = torch.Generator(device="cuda").manual_seed(SEED + 2)
    train, qkv = check_flash_shape(torch, own, 8, 2048, 2048, 8, 128)
    train["shape"] = "B8 L2048 H8 D128 bf16 causal (training)"
    train = time_flash(torch, F, train, *qkv, plain_iters=5)
    del qkv
    return [train,
            check_flash_shape(torch, own, 1, 1000, 1000, 8, 64,
                              q_offset=24)[0],
            check_flash_shape(torch, own, 1, 130, 200, 8, 128,
                              kv_offset=40)[0]]


def paged_bound(b, h, d, lengths, page_size=None):
    """(bound_ms, bound_by) of the int8 paged decode over ``lengths``: each
    live key's K and V rows (D int8 a head) and two fp32 scales a head,
    q read and the output written (bf16), the lengths, and with a block
    table its live entries (int32), against 4 D FLOP a key and head."""
    live = int(lengths.sum().item())
    nbytes = live * h * (2 * d + 2 * 4) + 2 * b * h * d * 2 + b * 4
    if page_size:
        nbytes += 4 * int(((lengths + page_size - 1) // page_size).sum())
    flops = 4.0 * live * h * d
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_paged(torch, F, gen, d=128, h=8):
    """The paged decode kernel against its plain version at the serving
    width: over gathered K/V (B8 Lk2048 H8 D``d``, the reference's layout),
    and over the same keys scattered to 1,024 pages of 16 through a
    shuffled (8, 128) block table (bit-equal to the gathered result: the
    same keys in the same splits); on arenas whose scales are NaN wherever
    no row may read (bit-equal again: never read); and with one row of
    length 0 (exact zeros)."""
    from tpu_dist_torch.ops import flash_attention as fa
    from tpu_dist_torch.ops import paged_attention as pa

    b, lk = 8, 2048
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((b, lk, h, d), generator=gen, device="cuda")
            for _ in range(2))
    kq, ks, vq, vs = fa.quantize_kv(k, v)
    lengths = torch.randint(1, lk + 1, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
    out = pa.paged_decode_cuda(q, kq, ks, vq, vs, lengths)
    ref = pa.paged_decode_plain(q, kq, ks, vq, vs, lengths)
    torch.cuda.synchronize()
    err, ok = bf16_err(torch, out, ref)
    if not ok:
        raise AssertionError(f"paged_decode: max|err| {err} "
                             f"(tol {BF16_TOL} (1 + |ref|))")

    # the same keys in 1,024 pages of 16, the table a permutation drawn
    # from a generator of its own (the later phases' inputs stay as they
    # were), the trash page last
    ps, per_row = 16, lk // 16
    n_pages = b * per_row
    perm = torch.randperm(n_pages, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED + 1))
    bt = perm.view(b, per_row).to(torch.int32)

    def arena(t):
        a = t.new_zeros((n_pages + 1, ps) + tuple(t.shape[2:]))
        a[perm] = t.reshape((n_pages, ps) + tuple(t.shape[2:]))
        return a

    layer = pa.PagedLayer(arena(kq), arena(vq), arena(ks), arena(vs),
                          quant="int8", read="flash")
    out_bt = pa.paged_decode_blocks_cuda(q, layer, bt, lengths)
    ref_bt = pa.paged_decode_blocks_plain(q, layer, bt, lengths)
    torch.cuda.synchronize()
    err_bt, ok = bf16_err(torch, out_bt, ref_bt)
    if not ok:
        raise AssertionError(f"paged_decode (block table): max|err| "
                             f"{err_bt} (tol {BF16_TOL} (1 + |ref|))")
    if not torch.equal(out_bt, out):
        raise AssertionError("paged_decode: the block-table read differs "
                             "from the gathered read of the same keys")
    # NaN scales on every key no row may read: the trash page and, in
    # each row's pages, the positions at or past its length
    pos = torch.arange(lk, device="cuda")
    readable = arena((pos[None, :] < lengths[:, None].long())[..., None])
    nan = torch.where(readable, 0.0, float("nan"))
    poisoned = pa.PagedLayer(layer.k, layer.v, layer.k_scale + nan,
                             layer.v_scale + nan, quant="int8", read="flash")
    zeroed = pa.PagedLayer(layer.k, layer.v,
                           poisoned.k_scale.nan_to_num(0.0),
                           poisoned.v_scale.nan_to_num(0.0), quant="int8",
                           read="flash")
    out_nan = pa.paged_decode_blocks_cuda(q, poisoned, bt, lengths)
    ref_nan = pa.paged_decode_blocks_plain(q, zeroed, bt, lengths)
    len0 = lengths.clone()
    len0[0] = 0
    out0 = pa.paged_decode_blocks_cuda(q, poisoned, bt, len0)
    torch.cuda.synchronize()
    err_nan, ok = bf16_err(torch, out_nan, ref_nan)
    if not ok or not torch.equal(out_nan, out_bt):
        raise AssertionError(f"paged_decode read a NaN-scale key: max|err| "
                             f"{err_nan}")
    if not bool((out0[0] == 0).all()) or not torch.equal(out0[1:],
                                                         out_nan[1:]):
        raise AssertionError("paged_decode: length 0 is not exact zeros")

    kd = (kq.float() * ks[..., None]).to(torch.bfloat16).transpose(1, 2)
    vd = (vq.float() * vs[..., None]).to(torch.bfloat16).transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    qh = q.transpose(1, 2).contiguous()
    mask = (torch.arange(lk, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    ms = time_ms(torch, lambda: pa.paged_decode_cuda(q, kq, ks, vq, vs,
                                                     lengths))
    bt_ms = time_ms(torch, lambda: pa.paged_decode_blocks_cuda(
        q, layer, bt, lengths))
    plain_ms = time_ms(torch, lambda: pa.paged_decode_plain(q, kq, ks, vq,
                                                            vs, lengths))
    bt_plain_ms = time_ms(torch, lambda: pa.paged_decode_blocks_plain(
        q, layer, bt, lengths))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=mask))
    live = int(lengths.sum().item())                   # keys this data needs
    bound_ms, bound_by = paged_bound(b, h, d, lengths)
    bt_bound_ms, bt_bound_by = paged_bound(b, h, d, lengths, ps)
    lib = ("scaled_dot_product_attention on dequantized bf16 K/V with the "
           "length mask")
    return {"shape": f"B{b} Lk{lk} H{h} D{d} int8 K/V, bf16 q, "
                     f"{live} live keys (gathered)",
            "max_abs_err": err, "tolerance": f"{BF16_TOL} * (1 + |plain|)",
            "ms": ms, "ms_is": "one call: split and merge launches",
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "library": lib,
            "more_shapes": [{
                "shape": f"the same keys in {n_pages} pages of {ps} through "
                         f"a shuffled ({b}, {per_row}) block table",
                "max_abs_err": err_bt, "bit_equal_to_gathered": True,
                "ms": bt_ms, "plain_ms": bt_plain_ms,
                "plain_is": "gather_pages then paged_decode_plain",
                "bound_ms": bt_bound_ms, "bound_by": bt_bound_by,
                "library_ms": lib_ms, "library": lib}],
            "nan_scale_arenas": {"max_abs_err": err_nan,
                                 "bit_equal_to_clean": True},
            "length0_exact_zeros": True}


def live_causal_pairs(lq, lk):
    """(q, k) pairs a causal mask leaves live, row i seeing keys 0..i."""
    return sum(min(i + 1, lk) for i in range(lq))


def check_flash_bwd_shape(torch, gen, b, lq, lk, h, d, q_offset=0,
                          kv_offset=0):
    """The backward kernels against flash_backward_plain at one bf16 causal
    shape: {dq, dk, dv: max abs error} (each within BF16_TOL), and exact
    zeros for the rows that see no key and the keys that no row sees.
    Returns (errors, the tensors the timing reuses)."""
    from tpu_dist_torch.ops import flash_attention as fa

    q, k, v, g = (torch.randn((b, n, h, d), generator=gen, device="cuda")
                  .to(torch.bfloat16) for n in (lq, lk, lk, lq))
    mask = (True, q_offset, kv_offset)
    out, lse = fa.flash_forward_cuda(q, k, v, *mask)
    got = fa.flash_backward_cuda(q, k, v, out, lse, g, *mask)
    ref = fa.flash_backward_plain(q, k, v, out, lse, g, *mask)
    torch.cuda.synchronize()
    shape = (f"B{b} Lq{lq} Lk{lk} H{h} D{d} bf16 causal q_offset "
             f"{q_offset} kv_offset {kv_offset}")
    errs = {}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        errs[name], ok = bf16_err(torch, a, r)
        if not ok:
            raise AssertionError(f"flash backward {name} at {shape}: "
                                 f"max|err| {errs[name]} (tol {BF16_TOL} "
                                 f"(1 + |ref|))")
    dead_rows = dead_rows_of(torch, lq, q_offset, kv_offset)
    dead_keys = kv_offset + torch.arange(lk, device="cuda") > q_offset + lq - 1
    zeros = (bool((got[0][:, dead_rows] == 0).all())
             and all(bool((t[:, dead_keys] == 0).all()) for t in got[1:]))
    if not zeros:
        raise AssertionError(f"flash backward at {shape}: a row that sees no "
                             "key or a key that no row sees has a nonzero "
                             "gradient")
    rec = {"shape": shape, "max_abs_err": errs,
           "dead_rows": int(dead_rows.sum()), "dead_keys": int(dead_keys.sum()),
           "dead_exact_zero": zeros}
    return rec, (q, k, v, g, out, lse)


def kernel_label(fn):
    """``name<args>`` of a mangled kernel template instance, e.g.
    ``fq_decode_kernel<bf16, 1>`` or ``fq_gemm_kernel<bf16, 128, 128,
    false>``; the symbol itself where no
    ``<length><name>_kernel`` template is found."""
    label = None
    for m in re.finditer(r"(?=(\d+))", fn):     # every digit run's suffixes
        n, at = int(m.group(1)), m.start() + len(m.group(1))
        ident = fn[at:at + n]
        if (len(ident) == n and fn[at + n:at + n + 1] == "I"
                and re.fullmatch(r"[A-Za-z]\w*_kernel(?:_mma)?", ident)):
            label, rest = ident, fn[at + n + 1:]
    if label is None:
        return fn
    args = []
    while rest and rest[0] != "E":
        t = re.match(r"f|13__nv_bfloat16|Li(\d+)E|Lb([01])E", rest)
        if not t:
            return fn
        args.append(t.group(1) or ({"0": "false", "1": "true"}[t.group(2)]
                                   if t.group(2) else
                                   "float" if t.group() == "f" else "bf16"))
        rest = rest[t.end():]
    return f"{label}<{', '.join(args)}>"


def ptxas_report(kernels, name):
    """{"spill_stores": {kernel instance: bytes}, "registers": {kernel
    instance: count}} from ptxas -v's report in the build log of
    ``csrc/<name>.cu`` (None for each without a log)."""
    path = os.path.join(kernels.build_dir(), f"{name}.log")
    if not os.path.isfile(path):
        return {"spill_stores": None, "registers": None}
    spills, regs, label = {}, {}, None
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                label = kernel_label(m.group(1))
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and label:
                spills[label] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and label:
                regs[label] = int(m.group(1))
    return {"spill_stores": spills, "registers": regs}


def check_flash_bwd(torch, F, gen):
    """dq and dk/dv kernels against flash_backward_plain, B=8 H=8 L=2048
    D=128 bf16 causal: the training main path's shape; then a ragged shape
    (B1 L1000 H8 D64, q_offset 24) and one with dead rows and keys (B1 Lq130
    Lk200 H8 D128, kv_offset 40) in the same tolerance."""
    from tpu_dist_torch import kernels

    b, L, h, d = 8, 2048, 8, 128
    main, (q, k, v, g, out, lse) = check_flash_bwd_shape(torch, gen, b, L, L,
                                                         h, d)
    errs = main["max_abs_err"]
    # their own generator: the later phases' inputs stay as they were
    own = torch.Generator(device="cuda").manual_seed(SEED + 1)
    more = [check_flash_bwd_shape(torch, own, 1, 1000, 1000, 8, 64,
                                  q_offset=24)[0],
            check_flash_bwd_shape(torch, own, 1, 130, 200, 8, 128,
                                  kv_offset=40)[0]]
    recs = time_flash_bwd(torch, F, errs, q, k, v, g, out, lse)
    for name in recs:
        recs[name].update(more_shapes=more, **ptxas_report(kernels, name))
    return recs


def time_flash_bwd(torch, F, errs, q, k, v, g, out, lse):
    """{flash_bwd_dq, flash_bwd_dkv: record} at a causal shape (q_offset =
    kv_offset = 0): each kernel's time, the plain version's and SDPA's
    backward (both for dq, dk and dv together), the bound, and the errors
    ``errs`` the check found."""
    from tpu_dist_torch import kernels
    from tpu_dist_torch.ops import flash_attention as fa

    b, L, h, d = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    fn_dq = kernels.function("flash_bwd_dq", "tdt_flash_bwd_dq",
                             fa._BWD_DQ_ARGS)
    fn_dkv = kernels.function("flash_bwd_dkv", "tdt_flash_bwd_dkv",
                              fa._BWD_DKV_ARGS)
    delta = fa.bwd_delta(out, g)
    args = (q, k, v, g, lse, delta, True, 0, 0, stream)
    dq_ms = time_ms(torch, lambda: fa._launch_bwd_dq(fn_dq, *args))
    dkv_ms = time_ms(torch, lambda: fa._launch_bwd_dkv(fn_dkv, *args))
    plain_ms = time_ms(torch, lambda: fa.flash_backward_plain(
        q, k, v, out, lse, g, True), iters=5)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    gh = g.transpose(1, 2).contiguous()
    oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        oh, (qh, kh, vh), gh, retain_graph=True))
    live = live_causal_pairs(L, L) * b * h
    elt = b * L * h * d * 2                        # one bf16 (B, L, H, D)
    recs = {}
    for name, ms, products, tensors, errk in (
            ("flash_bwd_dq", dq_ms, 3, 5, ("dq",)),
            ("flash_bwd_dkv", dkv_ms, 4, 6, ("dk", "dv"))):
        flops = 2.0 * d * live * products
        nbytes = tensors * elt + 2 * b * h * L * 4   # + lse, delta
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        recs[name] = {
            "shape": f"B{b} L{L} H{h} D{d} bf16 causal",
            "max_abs_err": max(errs[e] for e in errk),
            "tolerance": f"{BF16_TOL} * (1 + |plain|)", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
            "note": "plain_ms and library_ms cover dq, dk and dv together",
            "library": "scaled_dot_product_attention(is_causal=True) "
                       "backward (autograd.grad)"}
    return recs


def adamw_case(torch, p, g, m, v, row):
    """One multi-leaf adamw call over every leaf against
    fused_adamw_plain on copies; returns the max |err|. fp32 values within
    FP32_TOL (1 + |plain|); a bf16 p within one bf16 ulp of the terms of
    p' = p - lr upd, max(|plain|, |p|, lr |upd|) (as the sgd case, with
    upd from the plain step's m' and v')."""
    from tpu_dist_torch.ops import pallas_adamw as pa

    got = [[t.clone() for t in ts] for ts in (p, m, v)]
    ref = [[t.clone() for t in ts] for ts in (p, m, v)]
    pa.fused_adamw_multi_cuda(*got[:1], g, *got[1:], row)
    for i in range(len(p)):
        pa.fused_adamw_plain(ref[0][i], g[i], ref[1][i], ref[2][i], row)
    torch.cuda.synchronize()
    lr, _, _, eps, wd, c1, c2, _ = row.tolist()
    err = 0.0
    for i in range(len(p)):
        for a, r in zip((got[0][i], got[1][i], got[2][i]),
                        (ref[0][i], ref[1][i], ref[2][i])):
            diff = (a.float() - r.float()).abs()
            err = max(err, diff.max().item())
            if a.dtype == torch.bfloat16:   # the terms of p' = p - lr upd
                pf = p[i].float()
                upd = ((ref[1][i] / c1) / (torch.sqrt(ref[2][i] / c2) + eps)
                       + wd * pf)
                bound = BF16_ULP * torch.maximum(torch.maximum(
                    r.float().abs(), pf.abs()), lr * upd.abs())
                tol = "one bf16 ulp of max(|plain|, |p|, lr |upd|)"
            else:
                bound = FP32_TOL * (1 + r.abs())
                tol = f"{FP32_TOL} * (1 + |plain|)"
            if not bool((diff <= bound).all()):
                raise AssertionError(f"adamw {tuple(a.shape)} {a.dtype}: "
                                     f"max|err| {diff.max().item()} (tol "
                                     f"{tol})")
    return err


def check_adamw(torch, gen):
    """The AdamW kernel against fused_adamw_plain across the 85 leaves of
    phase 6's LM as one step (one multi-leaf call, drawn from a generator
    of their own), with the clip slot and weight decay live, and with a
    bf16 p; timed as that step (graph replay and eager) and at the lm_head
    leaf (1024 x 32000 fp32) alone, whose draws come first from ``gen`` as
    before, so the later phases' inputs stay as they were."""
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.ops import pallas_adamw as pa

    shape = (1024, 32000)
    p1, g1, m1 = (torch.randn(shape, generator=gen, device="cuda")
                  for _ in range(3))
    v1 = torch.rand(shape, generator=gen, device="cuda")
    m1, v1 = m1 * 1e-3, v1 * 1e-6
    row = pa.scalar_row(1e-3, 0.9, 0.95, 1e-8, 0.1, 3,
                        torch.tensor(0.5, device="cuda"))
    leaf_err = adamw_case(torch, [p1], [g1], [m1], [v1], row)

    model = TransformerLM(vocab_size=32000, num_layers=8, d_model=1024,
                          num_heads=8, max_len=2048, device="cuda",
                          seed=SEED)
    shapes = [tuple(t.shape) for t in model.parameters()]
    del model
    n = sum(math.prod(s) for s in shapes)
    if len(shapes) != LM_LEAVES or n != LM_PARAMS:
        raise AssertionError(f"LM: {len(shapes)} leaves, {n} params")
    own = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rand = lambda s: torch.randn(s, generator=own, device="cuda")
    p = [rand(s) for s in shapes]
    g = [rand(s) for s in shapes]
    m = [rand(s) * 1e-3 for s in shapes]
    v = [torch.rand(s, generator=own, device="cuda") * 1e-6 for s in shapes]
    errs = {"step": adamw_case(torch, p, g, m, v, row),
            "step_bf16_p": adamw_case(
                torch, [t.to(torch.bfloat16) for t in p], g, m, v, row),
            "lm_head_leaf": leaf_err}

    def step_kernel():
        pa.fused_adamw_multi_cuda(p, g, m, v, row)

    def step_plain():
        for i in range(len(p)):
            pa.fused_adamw_plain(p[i], g[i], m[i], v[i], row)

    # the step's launch replayed from a CUDA graph: its device time without
    # the host's cost (the check pass, the table, the ctypes call), which
    # eager_ms keeps
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step_kernel()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        step_kernel()
    step_ms = time_ms(torch, graph.replay)
    eager_ms = time_ms(torch, step_kernel, backlog=False)
    step_plain_ms = time_ms(torch, step_plain, iters=5)
    leaf_ms = time_ms(torch, lambda: pa.fused_adamw_cuda(p1, g1, m1, v1,
                                                         row))
    leaf_plain_ms = time_ms(torch, lambda: pa.fused_adamw_plain(
        p1, g1, m1, v1, row))
    step_lib_ms = leaf_lib_ms = None
    if hasattr(torch, "_fused_adamw_"):
        kw = dict(lr=1e-3, beta1=0.9, beta2=0.95, weight_decay=0.1, eps=1e-8,
                  amsgrad=False, maximize=False)
        steps = [torch.tensor(3.0, device="cuda") for _ in p]
        step_lib_ms = time_ms(torch, lambda: torch._fused_adamw_(
            p, g, m, v, [], steps, **kw))
        leaf_lib_ms = time_ms(torch, lambda: torch._fused_adamw_(
            [p1], [g1], [m1], [v1], [], steps[:1], **kw))
    # read p, g, m, v and write p, m, v, fp32; 16 FLOP per element
    bound = lambda k: max(28.0 * k / PEAK_BYTES, 16.0 * k / PEAK_FP32_FLOPS)
    lib = "torch._fused_adamw_ (decoupled wd, no clip slot)"
    fp32 = f"{FP32_TOL} * (1 + |plain|)"
    return {
        "shape": f"one LM step: {len(shapes)} fp32 leaves, {n} elements, "
                 "one launch over all",
        "max_abs_err": max(errs["step"], errs["lm_head_leaf"]),
        "errors": errs, "tolerance": fp32, "ms": step_ms,
        "ms_is": "CUDA-graph replay of the step's launches",
        "eager_ms": eager_ms, "plain_ms": step_plain_ms,
        "bound_ms": bound(n) * 1e3, "bound_by": "bytes",
        "library_ms": step_lib_ms, "library": lib,
        "more_shapes": [{
            "shape": f"{shape[0]}x{shape[1]} fp32 (lm_head leaf)",
            "max_abs_err": leaf_err, "tolerance": fp32, "ms": leaf_ms,
            "plain_ms": leaf_plain_ms,
            "bound_ms": bound(math.prod(shape)) * 1e3, "bound_by": "bytes",
            "library_ms": leaf_lib_ms, "library": lib}]}


def sgd_case(torch, p, g, m, row, tol):
    """One multi-leaf sgd call over every leaf against fused_sgd_plain on
    copies; returns the max |err|. ``tol`` names the bound: fp32 values
    within FP32_TOL (1 + |plain|), a bf16 p within one bf16 ulp of
    max(|plain|, |p|, lr |m'|)."""
    from tpu_dist_torch.ops import pallas_sgd as ps

    got = ([t.clone() for t in p], [t.clone() for t in m])
    ref = ([t.clone() for t in p], [t.clone() for t in m])
    ps.fused_sgd_multi_cuda(got[0], g, got[1], row)
    for i in range(len(p)):
        ps.fused_sgd_plain(ref[0][i], g[i], ref[1][i], row)
    torch.cuda.synchronize()
    lr = float(row[0])
    err = 0.0
    for i in range(len(p)):
        for a, r in ((got[0][i], ref[0][i]), (got[1][i], ref[1][i])):
            diff = (a.float() - r.float()).abs()
            err = max(err, diff.max().item())
            if a.dtype == torch.bfloat16:   # the terms of p' = p - lr m'
                big = torch.maximum(torch.maximum(
                    r.float().abs(), p[i].float().abs()),
                    lr * ref[1][i].abs())
                bound = BF16_ULP * big
            else:
                bound = FP32_TOL * (1 + r.abs())
            if not bool((diff <= bound).all()):
                raise AssertionError(f"sgd {tuple(a.shape)} {a.dtype}: "
                                     f"max|err| {diff.max().item()} (tol "
                                     f"{tol})")
    return err


def check_sgd(torch, gen):
    """The SGD kernel against fused_sgd_plain across ResNet-50's 161
    leaves as one step (one multi-leaf call), with the clip slot at 1 and
    0.3, and with a bf16 p; timed as that step and at the largest leaf
    (3x3x512x512, 2,359,296 fp32) alone."""
    from tpu_dist_torch.models.registry import create_model
    from tpu_dist_torch.ops import pallas_sgd as ps

    model = create_model("resnet50", num_classes=10, stem="s2d",
                         device="cuda", seed=SEED)
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model
    n = sum(math.prod(s) for s in shapes)
    if len(shapes) != RESNET50_LEAVES or n != RESNET50_PARAMS:
        raise AssertionError(f"resnet50: {len(shapes)} leaves, {n} params")
    rand = lambda s: torch.randn(s, generator=gen, device="cuda")
    p = [rand(s) for s in shapes]
    g = [rand(s) for s in shapes]
    m = [rand(s) * 0.1 for s in shapes]
    big = max(range(len(shapes)), key=lambda i: math.prod(shapes[i]))
    one = torch.ones((), device="cuda")
    row = ps.scalar_row(0.1, 0.9, 1e-4, one)
    row_cs = ps.scalar_row(0.1, 0.9, 1e-4, torch.tensor(0.3, device="cuda"))
    fp32 = f"{FP32_TOL} * (1 + |plain|)"
    errs = {"step_cs1": sgd_case(torch, p, g, m, row, fp32),
            "step_cs0.3": sgd_case(torch, p, g, m, row_cs, fp32),
            "step_bf16_p_cs0.3": sgd_case(
                torch, [t.to(torch.bfloat16) for t in p], g, m, row_cs,
                "one bf16 ulp of max(|plain|, |p|, lr |m'|)")}

    def step_kernel():
        ps.fused_sgd_multi_cuda(p, g, m, row)

    def step_plain():
        for i in range(len(p)):
            ps.fused_sgd_plain(p[i], g[i], m[i], row)

    # the step's launch replayed from a CUDA graph: its device time without
    # the host's cost (the check pass, the table, the ctypes call), which
    # eager_ms keeps
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step_kernel()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        step_kernel()
    step_ms = time_ms(torch, graph.replay)
    eager_ms = time_ms(torch, step_kernel, backlog=False)
    step_plain_ms = time_ms(torch, step_plain, iters=5)
    pb, gb, mb = p[big], g[big], m[big]
    leaf_ms = time_ms(torch, lambda: ps.fused_sgd_cuda(pb, gb, mb, row))
    leaf_plain_ms = time_ms(torch, lambda: ps.fused_sgd_plain(pb, gb, mb,
                                                              row))
    step_lib_ms = leaf_lib_ms = None
    if hasattr(torch, "_fused_sgd_"):
        kw = dict(weight_decay=1e-4, momentum=0.9, lr=0.1, dampening=0.0,
                  nesterov=False, maximize=False, is_first_step=False)
        step_lib_ms = time_ms(torch, lambda: torch._fused_sgd_(p, g, m, **kw))
        leaf_lib_ms = time_ms(torch, lambda: torch._fused_sgd_(
            [pb], [gb], [mb], **kw))
    # read p, g, m and write p, m, fp32; 5 FLOP per element
    bound = lambda k: max(20.0 * k / PEAK_BYTES, 5.0 * k / PEAK_FP32_FLOPS)
    leaf_n = math.prod(shapes[big])
    lib = "torch._fused_sgd_ (weight decay, momentum; no clip slot)"
    return {
        "shape": f"one ResNet-50 step: {len(shapes)} fp32 leaves, {n} "
                 "elements, one launch over all",
        "max_abs_err": max(errs["step_cs1"], errs["step_cs0.3"]),
        "errors": errs, "tolerance": fp32, "ms": step_ms,
        "ms_is": "CUDA-graph replay of the step's launches",
        "eager_ms": eager_ms, "plain_ms": step_plain_ms,
        "bound_ms": bound(n) * 1e3, "bound_by": "bytes",
        "library_ms": step_lib_ms, "library": lib,
        "more_shapes": [{
            "shape": f"largest leaf {shapes[big]} fp32, {leaf_n} elements",
            "ms": leaf_ms, "plain_ms": leaf_plain_ms,
            "bound_ms": bound(leaf_n) * 1e3, "bound_by": "bytes",
            "library_ms": leaf_lib_ms, "library": lib}]}


def check_fused_quant(torch, gen):
    """The fused int8 matmul against fused_quant_matmul_plain at every
    dense shape of the serving path, bf16: bit-equal. QUANT_SHAPES are
    drawn from ``gen`` as before, QUANT_MORE_SHAPES from a generator of
    their own, so the later phases' inputs stay as they were."""
    from tpu_dist_torch.ops import pallas_quant as pq

    own = torch.Generator(device="cuda").manual_seed(SEED + 4)
    recs = {}
    for label, (m, k, n), draw in (
            [(lb, s, gen) for lb, s in QUANT_SHAPES.items()]
            + [(lb, s, own) for lb, s in QUANT_MORE_SHAPES.items()]):
        x = torch.randn((m, k), generator=draw, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((k, n), generator=draw, device="cuda")
             / math.sqrt(k)).to(torch.bfloat16)
        out = pq.fused_quant_cuda(x, w)
        ref = pq.fused_quant_matmul_plain(x, w)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"fused_quant {label} ({m}, {k}, {n}): "
                                 f"max|err| {err}, expected bit-equal")
        del ref
        ms = time_ms(torch, lambda: pq.fused_quant_cuda(x, w))
        plain_ms = time_ms(torch, lambda: pq.fused_quant_matmul_plain(x, w),
                           iters=5)
        lib_ms = time_ms(torch, lambda: torch.matmul(x, w))
        nbytes = 2 * (m * k + k * n + m * n)   # bf16 in once, out once
        ops = 2.0 * m * n * k
        t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
        recs[label] = {
            "shape": f"{label}: M{m} K{k} N{n} bf16", "max_abs_err": err,
            "tolerance": "bit-equal", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "yardstick_ms": lib_ms,
            "library": "none: no one PyTorch call computes this function; "
                       "yardstick_ms times the bf16 torch.matmul of the "
                       "unquantized operands"}
    return recs


def check_int8kv_shape(torch, gen, b, lq, lk, h, d, q_offset=0,
                       kv_offset=0):
    """flash_fwd_int8kv against int8kv_flash_plain at one causal shape,
    bf16 q: within INT8KV_ULP |plain| + INT8KV_ATOL, and the rows that see
    no key exact zeros. Returns (record, (q, kv))."""
    from tpu_dist_torch.ops import flash_attention as fa

    q = torch.randn((b, lq, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    kv = fa.quantize_kv(*(torch.randn((b, lk, h, d), generator=gen,
                                      device="cuda") for _ in range(2)))
    mask = (True, q_offset, kv_offset)
    out = fa.int8kv_flash_cuda(q, kv, *mask)
    ref = fa.int8kv_flash_plain(q, kv, *mask)
    torch.cuda.synchronize()
    shape = (f"B{b} Lq{lq} Lk{lk} H{h} D{d} bf16 q, int8 K/V, causal "
             f"q_offset {q_offset} kv_offset {kv_offset}")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= INT8KV_ULP * ref.float().abs() + INT8KV_ATOL).all())
    dead = dead_rows_of(torch, lq, q_offset, kv_offset)
    zeros = bool((out[:, dead] == 0).all())
    if not (ok and zeros):
        raise AssertionError(f"flash_fwd_int8kv at {shape}: max|err| {err} "
                             f"(tol {INT8KV_ULP} |ref| + {INT8KV_ATOL}), "
                             f"dead rows exact zeros: {zeros}")
    return {"shape": shape, "max_abs_err": err,
            "tolerance": f"{INT8KV_ULP} * |plain| + {INT8KV_ATOL}",
            "dead_rows": int(dead.sum()), "dead_exact_zero": zeros}, (q, kv)


def check_flash_int8kv(torch, F, gen):
    """The int8-K/V flash forward against int8kv_flash_plain at B=1 L=2048
    H=8 D=128, bf16 q, causal, from the shared generator, with its times;
    then a ragged shape (B1 L1000 H8 D64, q_offset 24) and one with dead
    rows (B1 Lq130 Lk200 H8 D128, kv_offset 40) from their own."""
    from tpu_dist_torch import kernels

    rec, (q, kv) = check_int8kv_shape(torch, gen, 1, 2048, 2048, 8, 128)
    time_int8kv(torch, F, rec, q, kv)
    own = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rec["more_shapes"] = [
        check_int8kv_shape(torch, own, 1, 1000, 1000, 8, 64, q_offset=24)[0],
        check_int8kv_shape(torch, own, 1, 130, 200, 8, 128, kv_offset=40)[0]]
    rec.update(ptxas_report(kernels, "flash_fwd_int8kv"))
    return rec


def time_int8kv(torch, F, rec, q, kv):
    """Adds the int8-K/V kernel's, the plain version's and SDPA's times at
    rec's causal shape, and the bound, to ``rec``."""
    from tpu_dist_torch.ops import flash_attention as fa

    b, L, h, d = q.shape
    rec["shape"] = f"B{b} L{L} H{h} D{d} bf16 q, int8 K/V, causal"
    kq, ks, vq, vs = kv
    kd, vd = ((t.float() * sc[..., None]).to(torch.bfloat16)
              .transpose(1, 2).contiguous() for t, sc in ((kq, ks), (vq, vs)))
    qh = q.transpose(1, 2).contiguous()
    rec["ms"] = time_ms(torch, lambda: fa.int8kv_flash_cuda(q, kv,
                                                            causal=True))
    rec["plain_ms"] = time_ms(torch, lambda: fa.int8kv_flash_plain(q, kv,
                                                                   True))
    rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kd, vd, is_causal=True))
    rec["library"] = ("scaled_dot_product_attention(is_causal=True) on the "
                      "dequantized bf16 K/V")
    # the reference's work (the kernel's hi/lo split does 1.5x of it); q
    # and out bf16, int8 K/V, their fp32 row scales
    nbytes = 2 * b * L * h * d * 2 + 2 * b * L * h * d + 2 * b * L * h * 4
    rec["bound_ms"], rec["bound_by"] = flash_bound(
        b, h, d, live_causal_pairs(L, L), nbytes)
    return rec


# phase 3's timed head dims, (d, heads): the instances at 16 and 32
# (tiny_lm, LMConfig) and 48 on the 64 instance with the true head dim at
# run time, at 8 heads; the 256 instance at phase 22's 4 heads; the wide
# path at phase 23's 2 heads of 512
P3_HEAD_DIMS = ((16, 8), (32, 8), (48, 8), (256, 4), (512, 2))
# kernel vs plain version, fp32 attention outputs: the SIMT instances'
# fp32 sums against PyTorch's, summation order alone
ATTN_FP32_TOL = 1e-5
# phase 3's sweep of the general instances: rows narrower than their
# instance (8 on 16, 24 on 32, 33 on 64, 100 on 128, 136 and 200 on 256),
# odd (33) and not a multiple of 8 (100), and the 256 instance itself,
# each in fp32 and bf16, once on the allocator's tensors and once on views
# P3_MISALIGN[d] elements into their buffers (outputs too): byte loads,
# 4- and 8-byte cp.async; and the wide path above 256: an odd d (257), a
# d not a multiple of 128 (320), 512 and 1024
P3_SWEEP_DIMS = (8, 24, 33, 100, 136, 200, 256, 257, 320, 512, 1024)
P3_SWEEP_SHAPE = (2, 130, 200, 4, 40)   # B, Lq, Lk, H, kv_offset
P3_MISALIGN = {8: 1, 24: 2, 33: 1, 100: 4, 136: 1, 200: 2, 256: 4, 257: 1,
               320: 4, 512: 2, 1024: 1}
GUARD = 256        # elements past (and P3_MISALIGN before) every output,
SENTINEL = -4096.0  # SENTINEL before a launch and after it


def check_head_dims(torch, F, dims=P3_HEAD_DIMS):
    """Rows 1-5 at each (head dim, heads) of ``dims``, from a generator
    of their own, against their plain versions (the tolerances of the D128
    checks; dead rows, dead keys and length-0 rows exact zeros), each timed
    with SDPA's time and the bound at the row's timed shape: the flash
    forward and the int8-K/V forward at B1 L2048 causal, the backward pair
    at B8 L2048 causal, each also at B1 Lq130 Lk200 with kv_offset 40; the
    paged decode as ``check_paged`` checks it at D128, gathered and through
    a shuffled block table (bit-equal) at B8 Lk2048. Returns {kernel:
    [record a head dim]}."""
    own = torch.Generator(device="cuda").manual_seed(SEED + 21)
    recs = {k: [] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                            "flash_fwd_int8kv", "paged_decode")}
    for d, h in dims:
        rec, qkv = check_flash_shape(torch, own, 1, 2048, 2048, h, d)
        rec = time_flash(torch, F, rec, *qkv)
        rec["shape"] = f"B1 L2048 H{h} D{d} bf16 causal"
        rec["dead_rows_shape"] = check_flash_shape(
            torch, own, 1, 130, 200, h, d, kv_offset=40)[0]
        recs["flash_fwd"].append(rec)
        del qkv
        main, (q, k, v, g, out, lse) = check_flash_bwd_shape(
            torch, own, 8, 2048, 2048, h, d)
        dead = check_flash_bwd_shape(torch, own, 1, 130, 200, h, d,
                                     kv_offset=40)[0]
        for name, r in time_flash_bwd(torch, F, main["max_abs_err"], q, k,
                                      v, g, out, lse).items():
            r["dead_rows_shape"] = dead
            recs[name].append(r)
        del q, k, v, g, out, lse
        rec, (q, kv) = check_int8kv_shape(torch, own, 1, 2048, 2048, h, d)
        recs["flash_fwd_int8kv"].append(time_int8kv(torch, F, rec, q, kv))
        rec["dead_rows_shape"] = check_int8kv_shape(
            torch, own, 1, 130, 200, h, d, kv_offset=40)[0]
        del q, kv
        recs["paged_decode"].append(check_paged(torch, F, own, d, h))
    return recs


def offset_view(torch, t, off):
    """``t``'s values in a contiguous view ``off`` elements into a fresh
    buffer on its device (0: ``t`` itself)."""
    if not off:
        return t
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


class SentinelOutputs:
    """While entered, ``torch.empty`` and ``torch.empty_like`` (the
    wrappers' output allocations) return NaN views ``off`` elements into a
    buffer whose other elements (``off`` before, GUARD after) hold
    SENTINEL; ``untouched()`` says whether every sentinel survived."""

    def __init__(self, torch, off):
        self.torch, self.off, self.made = torch, off, []

    def _empty(self, *shape, dtype=None, device=None, **_):
        torch = self.torch
        if len(shape) == 1 and not isinstance(shape[0], int):
            shape = tuple(shape[0])
        n = math.prod(shape)
        buf = torch.full((self.off + n + GUARD,), SENTINEL,
                         dtype=dtype or torch.float32, device=device)
        buf[self.off:self.off + n] = float("nan")
        self.made.append((buf, n))
        return buf[self.off:self.off + n].view(shape)

    def __enter__(self):
        torch = self.torch
        self.saved = (torch.empty, torch.empty_like)
        torch.empty = self._empty
        torch.empty_like = lambda t, dtype=None, **_: self._empty(
            t.shape, dtype=dtype or t.dtype, device=t.device)
        return self

    def __exit__(self, *exc):
        self.torch.empty, self.torch.empty_like = self.saved

    def untouched(self):
        o = self.off
        return all(bool((buf[:o] == SENTINEL).all())
                   and bool((buf[o + n:] == SENTINEL).all())
                   for buf, n in self.made)


def attention_entries(kernels):
    """The five attention kernels' C entries (built on first use)."""
    from tpu_dist_torch.ops import flash_attention as fa
    from tpu_dist_torch.ops import paged_attention as pa

    return {"flash": kernels.function("flash_fwd", "tdt_flash_fwd",
                                      fa._FLASH_ARGS),
            "dq": kernels.function("flash_bwd_dq", "tdt_flash_bwd_dq",
                                   fa._BWD_DQ_ARGS),
            "dkv": kernels.function("flash_bwd_dkv", "tdt_flash_bwd_dkv",
                                    fa._BWD_DKV_ARGS),
            "int8kv": kernels.function("flash_fwd_int8kv",
                                       "tdt_flash_fwd_int8kv",
                                       fa._INT8KV_ARGS),
            "paged": kernels.function("paged_decode", "tdt_paged_decode",
                                      pa._PAGED_ARGS)}


def five_at_head_dim(torch, kernels, d, dtype, off, device="cuda",
                     entries=None, shape=P3_SWEEP_SHAPE):
    """The five attention kernels at head dim ``d`` in ``dtype`` through
    their C entries, on the allocator's tensors and (``off`` > 0) again on
    views ``off`` elements into their buffers (inputs and outputs), every
    output between SENTINEL elements. ``shape`` is (B, Lq, Lk, H,
    kv_offset): flash forward, backward and int8-K/V forward causal with
    that kv_offset (at P3_SWEEP_SHAPE rows 0-39 see no key, keys 90-199 no
    row); the paged decode over gathered int8 K/V at B3 Lk H with lengths
    Lk, min(77, Lk - 3), 0. Each run against the plain versions (bf16:
    BF16_TOL, the int8-K/V forward INT8KV_ULP and INT8KV_ATOL, fp32:
    ATTN_FP32_TOL; lse ATTN_FP32_TOL), dead rows, dead keys and the
    length-0 row exact zeros, every sentinel untouched, and the two runs
    bit-equal. Returns (the record, {output name: the aligned run's
    tensor}). ``device="cpu"`` with ``entries`` (the C entries built by
    ``tools/cuda_emu.py``) rehearses it on the CPU."""
    from tpu_dist_torch.ops import flash_attention as fa
    from tpu_dist_torch.ops import paged_attention as pa

    fn = entries or attention_entries(kernels)
    gen = torch.Generator(device=device).manual_seed(SEED + 22 + d)
    rnd = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa
    b, lq, lk, h, kvo = shape
    q, k, v, g = (rnd(b, n, h, d).to(dtype) for n in (lq, lk, lk, lq))
    kv = fa.quantize_kv(rnd(b, lk, h, d), rnd(b, lk, h, d))
    pkv = fa.quantize_kv(rnd(3, lk, h, d), rnd(3, lk, h, d))
    qd = rnd(3, 1, h, d).to(dtype)
    lens = torch.tensor([lk, min(77, lk - 3), 0], dtype=torch.int32,
                        device=device)
    mask = (True, 0, kvo)
    ref = fa.flash_forward_plain(q, k, v, *mask)
    refs = {"flash_fwd": ref[0], "lse": ref[1],
            **dict(zip(("dq", "dk", "dv"),
                       fa.flash_backward_plain(q, k, v, *ref, g, *mask))),
            "flash_fwd_int8kv": fa.int8kv_flash_plain(q, kv, *mask),
            "paged_decode": pa.paged_decode_plain(qd, *pkv, lens)}
    stream = (torch.cuda.current_stream().cuda_stream if device == "cuda"
              else None)

    def run(o):
        mv = lambda t: offset_view(torch, t, o)  # noqa: E731
        qo, ko, vo, go, qdo = (mv(t) for t in (q, k, v, g, qd))
        kvm, pkvm = (tuple(mv(t) for t in pack) for pack in (kv, pkv))
        refm = tuple(mv(t) for t in ref)
        with SentinelOutputs(torch, o) as sent:
            out, lse = fa._launch(fn["flash"], qo, ko, vo, *mask, stream)
            grads = fa._launch_backward(fn["dq"], fn["dkv"], qo, ko, vo,
                                        *refm, go, *mask, stream)
            out8 = fa._launch_int8kv(fn["int8kv"], qo, kvm, *mask, stream)
            outp = pa._launch(fn["paged"], qdo, *pkvm, lens, stream)
        if device == "cuda":
            torch.cuda.synchronize()
        if len(sent.made) != 9 or not sent.untouched():
            raise AssertionError(f"D{d} {dtype} offset {o}: an output's "
                                 "sentinel changed (a store past its end)")
        return dict(zip(("flash_fwd", "lse", "dq", "dk", "dv",
                         "flash_fwd_int8kv", "paged_decode"),
                        (out, lse, *grads, out8, outp)))

    got = run(0)
    moved = run(off) if off else got
    errs = {}
    for name, r in refs.items():
        a = got[name]
        if not torch.equal(a, moved[name]):
            raise AssertionError(f"{name} at D{d} {dtype}: the view at "
                                 f"offset {off} is not bit-equal")
        diff = (a.float() - r.float()).abs()
        if name == "lse" or dtype == torch.float32:
            ok = bool((diff <= ATTN_FP32_TOL * (1 + r.float().abs())).all())
        elif name == "flash_fwd_int8kv":
            ok = bool((diff <= INT8KV_ULP * r.float().abs()
                       + INT8KV_ATOL).all())
        else:
            ok = bool((diff <= BF16_TOL * (1 + r.float().abs())).all())
        errs[name] = diff.max().item()
        if not ok:
            raise AssertionError(f"{name} at D{d} {dtype}: max|err| "
                                 f"{errs[name]}")
    zeros = (all(bool((got[n][:, :kvo] == 0).all())
                 for n in ("flash_fwd", "dq", "flash_fwd_int8kv"))
             and all(bool((got[n][:, lq - kvo:] == 0).all())
                     for n in ("dk", "dv"))
             and bool((got["paged_decode"][2] == 0).all()))
    if not zeros:
        raise AssertionError(f"D{d} {dtype}: a dead row, a dead key or the "
                             "length-0 row is not exact zeros")
    return {"max_abs_err": errs,
            "tolerance": ("fp32: " + f"{ATTN_FP32_TOL} * (1 + |plain|)"
                          if dtype == torch.float32 else
                          f"bf16: {BF16_TOL} * (1 + |plain|), int8-K/V "
                          f"{INT8KV_ULP} |plain| + {INT8KV_ATOL}")
            + f", lse {ATTN_FP32_TOL} * (1 + |plain|)",
            "misaligned_offset_elements": off, "bit_equal_misaligned": True,
            "sentinels_untouched": True, "dead_exact_zero": True}, got


def kernel_outputs(kname):
    """The outputs of a five_at_head_dim record that kernel ``kname``
    writes."""
    return {"flash_fwd": ("flash_fwd", "lse"), "flash_bwd_dq": ("dq",),
            "flash_bwd_dkv": ("dk", "dv")}.get(kname, (kname,))


def check_head_dim_sweep(torch, kernels):
    """five_at_head_dim at every head dim of P3_SWEEP_DIMS in fp32 and
    bf16: {"D<d>": {"fp32": record, "bf16": record}}."""
    return {f"D{d}": {name: five_at_head_dim(torch, kernels, d, dtype,
                                             P3_MISALIGN[d])[0]
                      for name, dtype in (("fp32", torch.float32),
                                          ("bf16", torch.bfloat16))}
            for d in P3_SWEEP_DIMS}


def run_trainer(cfg, device, init_params=None):
    """Fit ``cfg`` on ``device``; (trainer, per-step losses from its
    ledger)."""
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.jsonl")
        cfg = dataclasses.replace(cfg, ledger_path=path)
        tr = LMTrainer(cfg, device=device, init_params=init_params)
        tr.fit()
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    return tr, [r["loss"] for r in recs if r["event"] == "step"]


def small_int8_trainer_agreement(torch):
    """Tiny fp32 LMTrainer(quant="int8") with sgd: 5 steps on the card (the
    fused int8 kernel) and on the CPU (its plain version) from the same
    weights."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.interop import export_flax_params
    from tpu_dist_torch.models.transformer import TransformerLM

    cfg = LMConfig(batch_size=4, seq_len=96, d_model=128, num_layers=2,
                   num_heads=1, vocab_size=64, synth_tokens=4000, seed=SEED,
                   quant="int8", optimizer="sgd", lr=1e-2, max_steps=5,
                   print_freq=100)
    init = export_flax_params(TransformerLM(
        vocab_size=64, num_layers=2, d_model=128, num_heads=1, max_len=96,
        device="cpu", seed=SEED))
    _, cpu_losses = run_trainer(cfg, "cpu", init)
    _, gpu_losses = run_trainer(cfg, "cuda", init)
    if len(gpu_losses) != 5 or len(cpu_losses) != 5:
        raise AssertionError(f"int8 steps: card {len(gpu_losses)}, cpu "
                             f"{len(cpu_losses)}")
    for i, (a, r) in enumerate(zip(gpu_losses, cpu_losses)):
        if abs(a - r) > INT8_LOSS_TOL * (1 + abs(r)):
            raise AssertionError(f"int8 step {i}: card loss {a} != plain "
                                 f"{r} (tol {INT8_LOSS_TOL} (1 + |loss|))")
    return {"card": gpu_losses, "cpu": cpu_losses,
            "max_abs_diff": max(abs(a - r) for a, r in
                                zip(gpu_losses, cpu_losses))}


def small_trainer_agreement(torch, d_model=128, num_heads=1):
    """Tiny fp32 trainer, flash + fused_adamw with the clip slot: 5 steps
    on the card (kernels) and on the CPU (plain) from the same weights."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.interop import export_flax_params
    from tpu_dist_torch.models.transformer import TransformerLM

    cfg = LMConfig(batch_size=4, seq_len=96, d_model=d_model, num_layers=2,
                   num_heads=num_heads, vocab_size=64, synth_tokens=4000,
                   seed=SEED,
                   attn="flash", optimizer="fused_adamw", lr=3e-3,
                   grad_clip=0.5, weight_decay=0.1, max_steps=5,
                   print_freq=100)
    # one set of initial weights for both (the CPU and CUDA generators of
    # one seed give different numbers)
    init = export_flax_params(TransformerLM(
        vocab_size=64, num_layers=2, d_model=d_model, num_heads=num_heads,
        max_len=96, device="cpu", seed=SEED))
    _, cpu_losses = run_trainer(cfg, "cpu", init)
    _, gpu_losses = run_trainer(cfg, "cuda", init)
    if len(gpu_losses) != 5 or len(cpu_losses) != 5:
        raise AssertionError(f"steps: card {len(gpu_losses)}, cpu "
                             f"{len(cpu_losses)}")
    for i, (a, r) in enumerate(zip(gpu_losses, cpu_losses)):
        if abs(a - r) > LOSS_TOL * (1 + abs(r)):
            raise AssertionError(f"step {i}: card loss {a} != plain {r} "
                                 f"(tol {LOSS_TOL} (1 + |loss|))")
    return {"card": gpu_losses, "cpu": cpu_losses,
            "max_abs_diff": max(abs(a - r) for a, r in
                                zip(gpu_losses, cpu_losses))}


def full_lm_config(**kw):
    """The LM of phases 6 and 9 at full width: V=32000, 8 layers, d_model
    1024, 8 heads, L=2048, batch 8, bf16 over fp32 masters, flash
    attention, ``fused_adamw`` with grad_clip 1.0, the synthetic affine
    corpus; ``kw`` sets the knobs of each run."""
    from tpu_dist_torch.configs import LMConfig

    base = dict(vocab_size=32000, num_layers=8, d_model=1024, num_heads=8,
                seq_len=2048, batch_size=8, precision="bf16", attn="flash",
                optimizer="fused_adamw", lr=1e-3, weight_decay=0.1,
                grad_clip=1.0, synth_tokens=400_000, seed=SEED)
    return LMConfig(**{**base, **kw})


def training_path(torch, kernels, steps=TRAIN_STEPS, **kw):
    """The training main path at full width (module docstring, phase 6),
    ``steps`` steps with ``kw`` set on the config (phase 22a: 4 heads)."""
    layers = 8
    cfg = full_lm_config(max_steps=steps, print_freq=5, **kw)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    tr, losses = run_trainer(cfg, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    leaves = len(tr.state.params)
    n_eval = len(tr._epoch_indices(tr.val_ds, False, 0)[0])
    if len(losses) != steps or tr.state.step != steps:
        raise AssertionError(f"trained {tr.state.step} steps, "
                             f"{len(losses)} losses")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    first, last = (statistics.mean(losses[:5]), statistics.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"losses not falling: first 5 mean {first}, "
                             f"last 5 mean {last}: {losses}")
    want = {"flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps,
            "adamw": steps,              # one call over all leaves
            "flash_fwd": layers * (steps + n_eval)}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"expected {n}")
    params = sum(p.numel() for p in tr.state.params)
    # the epoch rate leaves out the first step (kernel builds and the
    # allocator's warm-up ride on it)
    tokens = cfg.batch_size * cfg.seq_len
    training = {
        "params": params, "leaves": leaves, "steps": steps,
        "heads": cfg.num_heads, "head_dim": cfg.d_model // cfg.num_heads,
        "losses": losses, "first5_mean": first, "last5_mean": last,
        "tokens_per_s": tr.last_tok_s,
        "step_ms": tokens / tr.last_tok_s * 1e3,
        "wall_s_incl_build_and_eval": wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "launches_per_step": {k: launches[k] / steps for k in (
            "flash_bwd_dq", "flash_bwd_dkv", "adamw")},
        "eval_batches": n_eval}
    return training, launches


def run_image_trainer(cfg, device, init=(None, None)):
    """Fit the image ``cfg`` on ``device`` (synthetic data, checkpoints in
    a temp dir); returns (trainer, per-record losses from its ledger)."""
    from tpu_dist_torch.engine.loop import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.jsonl")
        cfg = dataclasses.replace(
            cfg, ledger_path=path, log_csv="",
            checkpoint_dir=os.path.join(tmp, "ck"),
            data=os.path.join(tmp, "no-data"))
        tr = Trainer(cfg, device=device, init_params=init[0],
                     init_batch_stats=init[1])
        tr.fit()
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    return tr, [r["loss"] for r in recs if r["event"] == "step"]


def small_image_trainer_agreement(torch):
    """Tiny fp32 ResNet-18 with ``fused_sgd``: 5 steps on the card (the
    sgd kernel) and on the CPU (its plain version) from the same weights."""
    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.interop import export_flax_image_params
    from tpu_dist_torch.models.resnet import ResNet18

    cfg = TrainConfig(arch="resnet18", dataset="cifar10", batch_size=16,
                      epochs=1, synth_train_size=80, synth_val_size=32,
                      precision="fp32", optimizer="fused_sgd", seed=SEED,
                      print_freq=1, workers=1)
    init = export_flax_image_params(ResNet18(device="cpu", seed=SEED))
    _, cpu_losses = run_image_trainer(cfg, "cpu", init)
    _, gpu_losses = run_image_trainer(cfg, "cuda", init)
    if len(gpu_losses) != 5 or len(cpu_losses) != 5:
        raise AssertionError(f"image steps: card {len(gpu_losses)}, cpu "
                             f"{len(cpu_losses)}")
    for i, (a, r) in enumerate(zip(gpu_losses, cpu_losses)):
        if abs(a - r) > LOSS_TOL * (1 + abs(r)):
            raise AssertionError(f"image step {i}: card loss {a} != plain "
                                 f"{r} (tol {LOSS_TOL} (1 + |loss|))")
    return {"card": gpu_losses, "cpu": cpu_losses,
            "max_abs_diff": max(abs(a - r) for a, r in
                                zip(gpu_losses, cpu_losses))}


def image_path(torch, kernels, ck_dir):
    """The image main path at full width (module docstring, phase 7),
    through the entry script's ``main``; its checkpoints go to ``ck_dir``
    (phase 9 warm-starts from its ``model_best``)."""
    from tpu_dist_torch.engine import checkpoint as ckpt
    from tpu_dist_torch.scripts import image_train

    geom = image_train.BENCH_GEOMETRY
    with tempfile.TemporaryDirectory() as tmp:
        ledger = os.path.join(tmp, "run.jsonl")
        argv = [a for k, v in geom.items()
                for a in (f"--{k.replace('_', '-')}", str(v))]
        argv += ["--data", os.path.join(tmp, "no-data"), "--checkpoint-dir",
                 ck_dir, "--ledger-path", ledger,
                 "--log-csv", "", "--print-freq", "16"]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        tr = image_train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(ledger) as f:
            recs = [json.loads(line) for line in f]
        path = os.path.join(ck_dir, "resnet50-checkpoint.pt")
        meta = ckpt.read_checkpoint_meta(path)
        want = ckpt.host_state(tr.state)
        with torch.no_grad():
            for t in tr.state.params:
                t.zero_()
        ckpt.load_checkpoint(path, tr.state)
        got = ckpt.host_state(tr.state)
    steps = tr.cfg.synth_train_size // tr.cfg.batch_size
    leaves = len(tr.state.params)
    params = sum(p.numel() for p in tr.state.params)
    if (leaves, params) != (RESNET50_LEAVES, RESNET50_PARAMS):
        raise AssertionError(f"resnet50: {leaves} leaves, {params} params")
    if tr.state.step != steps or not tr.device_data or tr.k != 16:
        raise AssertionError(f"trained {tr.state.step} of {steps} steps, "
                             f"device data {tr.device_data}, K {tr.k}")
    windows = [r for r in recs if r["event"] == "step"]
    losses = [r["loss"] for r in windows]
    if len(losses) != steps // tr.k or not all(map(math.isfinite, losses)):
        raise AssertionError(f"window losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"losses not falling: {losses}")
    groups = len({p.dtype for p in tr.state.params})   # one call each
    if launches["sgd"] != groups * steps:
        raise AssertionError(f"sgd launched {launches['sgd']} times, "
                             f"expected {groups} dtype group(s) x {steps}")
    if meta.get("step") != steps or meta.get("arch") != "resnet50":
        raise AssertionError(f"checkpoint meta {meta}")
    for name in ("params", "batch_stats"):
        for a, b in zip(want[name], got[name]):
            if not torch.equal(a, b):
                raise AssertionError(f"checkpoint reload: {name} differ")
    for name, v in want["opt_state"].items():
        for a, b in zip(v, got["opt_state"][name]):
            if not torch.equal(a, b):
                raise AssertionError(f"checkpoint reload: {name} differ")
    epoch = next(r for r in recs if r["event"] == "epoch")
    img_s = tr.last_img_s
    image = {
        "config": geom, "params": params, "leaves": leaves, "steps": steps,
        "window_losses": losses, "train_img_per_s_window1_excluded": img_s,
        "step_ms": tr.cfg.batch_size / img_s * 1e3,
        "val_acc1": tr.best_acc1,
        "analytic_mfu": epoch["mfu"], "analytic_tflops": epoch["tflops"],
        "mfu_is": "3 x forward conv+dense FLOPs per image x img/s over "
                  "989 TFLOP/s bf16",
        "peak_mem_gb": peak_gb, "wall_s_incl_data_build_and_eval": wall,
        "launches": launches, "sgd_launches_per_step": launches["sgd"] / steps,
        "checkpoint": {"step": meta["step"], "reloaded_equal": True}}
    return image, launches


def small_input_agreement(torch, card_kw=None, cpu_kw=None, d_model=256,
                          num_heads=2):
    """Tiny fp32 model: kernels on the card == plain versions on the CPU,
    with ``card_kw`` / ``cpu_kw`` added to each side's ServeConfig."""
    import numpy as np

    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.models.transformer import tiny_lm
    from tpu_dist_torch.ops.flash_attention import flash_attention_fn

    geom = dict(vocab_size=64, num_layers=2, d_model=d_model,
                num_heads=num_heads, max_len=96,
                attn_fn=flash_attention_fn())
    cpu_lm = tiny_lm(device="cpu", seed=SEED, **geom)
    gpu_lm = tiny_lm(device="cuda", seed=None, **geom)
    gpu_lm.load_state_dict(cpu_lm.state_dict())
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32) for n in (5, 33, 64)]
    outs = (20, 12, 30)
    reqs = lambda: [DecodeRequest(i, p, n)
                    for i, (p, n) in enumerate(zip(prompts, outs))]
    base = dict(max_slots=2, page_size=16, num_pages=32, kv_quant="int8",
                attn_read="flash")
    got = {}
    for dev, lm, kw in (("cpu", cpu_lm, cpu_kw), ("cuda", gpu_lm, card_kw)):
        cfg = ServeConfig(**base, **(kw or {}))
        got[dev] = {c.rid: c.tokens for c in
                    ServeEngine(lm, cfg, device=dev).run(reqs())}
    for rid, toks in got["cpu"].items():
        if not np.array_equal(toks, got["cuda"][rid]):
            raise AssertionError(f"request {rid}: card tokens "
                                 f"{got['cuda'][rid].tolist()} != plain "
                                 f"{toks.tolist()}")
    return len(got["cpu"])


def serve_run(torch, kernels, model, cfg, prompts, outs):
    """Serve the requests through ``ServeEngine(model, cfg)`` on the card,
    after a warm-up engine on two of them (cuBLAS handles, allocator,
    builds); launch counts from the measured run alone. Returns (record,
    launches, engine)."""
    import numpy as np

    from tpu_dist_torch.engine.serve import DecodeRequest, ServeEngine

    n_req = len(prompts)
    reqs = lambda: [DecodeRequest(i, prompts[i], int(outs[i]))
                    for i in range(n_req)]
    ServeEngine(model, cfg).run(reqs()[:2])
    torch.cuda.synchronize()

    eng = ServeEngine(model, cfg)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    comps = eng.run(reqs())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    if len(comps) != n_req:
        raise AssertionError(f"served {len(comps)}/{n_req}")
    for c in comps:
        if c.n_generated != int(outs[c.rid]) or c.tokens.min() < 0 \
                or c.tokens.max() >= model.vocab_size:
            raise AssertionError(f"request {c.rid}: bad completion")
        np.testing.assert_array_equal(c.tokens[:c.prompt_len],
                                      prompts[c.rid])
    if eng.ticks <= 0:
        raise AssertionError("no decode tick ran")
    toks = sum(c.n_generated for c in comps)
    ttft = [c.ttft_s for c in comps]
    tpot = [(c.finish_ts - c.first_token_ts) / (c.n_generated - 1)
            for c in comps if c.n_generated > 1]
    record = {
        "requests": n_req, "completed": len(comps),
        "prompt_tokens": int(sum(p.size for p in prompts)),
        "generated_tokens": toks, "wall_s": wall,
        "tokens_per_s": toks / wall, "prefills": eng.prefills,
        "ticks": eng.ticks, "occupancy": eng.occupancy,
        "ttft_ms": {"p50": pctl(ttft, 50) * 1e3, "p99": pctl(ttft, 99) * 1e3},
        "tpot_ms": {"p50": pctl(tpot, 50) * 1e3, "p99": pctl(tpot, 99) * 1e3},
        "prefill_s": eng.prefill_s, "tick_s": eng.tick_s,
        "ms_per_tick": eng.tick_s / eng.ticks * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}
    return record, launches, eng


def main_path(torch, kernels, heads=8):
    """The serving main path at full width (module docstring, phase 5),
    with ``heads`` heads (phase 22b: 4). Returns (record, launches, model,
    prompts, outs): phase 8 serves the same model and requests."""
    import numpy as np

    from tpu_dist_torch.engine.serve import ServeConfig
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.ops.flash_attention import flash_attention_fn

    layers = 8
    model = TransformerLM(vocab_size=32000, num_layers=layers, d_model=1024,
                          num_heads=heads, max_len=2048,
                          dtype=torch.bfloat16, attn_fn=flash_attention_fn(),
                          device="cuda", seed=SEED)
    cfg = ServeConfig(max_slots=8, page_size=16, num_pages=1024,
                      kv_quant="int8", attn_read="flash")
    rng = np.random.default_rng(SEED)
    n_req = 16
    prompts = [rng.integers(0, 32000, (int(rng.integers(16, 1025)),))
               .astype(np.int32) for _ in range(n_req)]
    outs = rng.integers(32, 129, n_req)
    serving, launches, eng = serve_run(torch, kernels, model, cfg, prompts,
                                       outs)
    if launches["flash_fwd"] < eng.prefills * layers:
        raise AssertionError(f"flash_fwd launched {launches['flash_fwd']} "
                             f"times for {eng.prefills} prefills x {layers}")
    if launches["paged_decode"] < layers * eng.ticks:
        raise AssertionError(f"paged_decode launched "
                             f"{launches['paged_decode']} times for "
                             f"{eng.ticks} ticks x {layers}")
    with torch.inference_mode():
        logits = model(torch.as_tensor(prompts[0][None], device="cuda"))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits at full width")
    serving["params"] = sum(p.numel() for p in model.parameters())
    serving["head_dim"] = 1024 // heads
    return serving, launches, model, prompts, outs


def quant_spec_path(torch, kernels, model, prompts, outs):
    """Phase 8: phase 5's model and requests served (a) with quant="int8"
    and (b) with spec_k=SPEC_K self-speculation."""
    from tpu_dist_torch.engine.serve import ServeConfig

    layers = model.num_layers
    dense = 4 * layers + 1                 # qkv, proj, mlp_in, mlp_out; head
    base = dict(max_slots=8, page_size=16, num_pages=1024, kv_quant="int8",
                attn_read="flash")
    quant, q_launches, eng = serve_run(
        torch, kernels, model, ServeConfig(**base, quant="int8"), prompts,
        outs)
    want = dense * (eng.ticks + eng.prefills)
    if q_launches["fused_quant"] != want:
        raise AssertionError(f"fused_quant launched "
                             f"{q_launches['fused_quant']} times, expected "
                             f"{dense} x ({eng.ticks} ticks + "
                             f"{eng.prefills} prefills) = {want}")
    if q_launches["paged_decode"] < layers * eng.ticks:
        raise AssertionError(f"paged_decode launched "
                             f"{q_launches['paged_decode']} times for "
                             f"{eng.ticks} ticks x {layers}")
    if q_launches["flash_fwd"] < layers * eng.prefills:
        raise AssertionError(f"flash_fwd launched {q_launches['flash_fwd']} "
                             f"times for {eng.prefills} prefills x {layers}")
    quant["fused_quant_per_forward"] = dense
    spec, s_launches, eng = serve_run(
        torch, kernels, model, ServeConfig(**base, spec_k=SPEC_K), prompts,
        outs)
    apt = eng.accepted_per_tick
    if apt is None or not apt > 1.0:
        raise AssertionError(f"spec_k={SPEC_K}: accepted_per_tick {apt}")
    # the (k+1)-row verify reads through the exact path: no int8-page
    # flash decode under speculation, the prompt passes still on flash_fwd
    if s_launches["paged_decode"] != 0:
        raise AssertionError(f"spec_k={SPEC_K}: paged_decode launched "
                             f"{s_launches['paged_decode']} times, expected 0")
    if s_launches["flash_fwd"] < layers * eng.prefills:
        raise AssertionError(f"spec_k={SPEC_K}: flash_fwd launched "
                             f"{s_launches['flash_fwd']} times for "
                             f"{eng.prefills} prefills x {layers}")
    spec.update(spec_k=SPEC_K, accepted_per_tick=apt,
                spec_emitted=eng.spec_emitted,
                spec_slot_ticks=eng.spec_slot_ticks)
    return {"int8": quant, "spec": spec}, q_launches, s_launches


# ---- phase 9: the one-device training knobs --------------------------------

def ledger_steps(path):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["event"] == "step"]


def flat_params(torch, tr):
    return torch.cat([p.detach().float().flatten() for p in tr.state.params])


def free_device(torch):
    """Drop what earlier runs left (trainers hold reference cycles), so a
    run's peak memory counts its own tensors."""
    gc.collect()
    torch.cuda.empty_cache()


def lm_windows_resume(torch, kernels, base):
    """9a: 4-step windows over device-resident rows, the chunked head and a
    step-exact mid-epoch resume. Run A trains 12 steps; run B is cut by a
    KeyboardInterrupt after 2 windows and leaves a mid-epoch checkpoint;
    run C resumes from it to step 12. Only B has a checkpoint dir: A's and
    C's end-of-epoch checkpoints (2 GB each) would be read by nothing.
    ``base`` is phase 6's record."""
    from tpu_dist_torch.engine import checkpoint as ckpt
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    steps, k, layers = 12, 4, 8
    free_device(torch)
    with tempfile.TemporaryDirectory() as tmp:
        def cfg(name, **kw):
            return full_lm_config(
                loss_chunk=1024, steps_per_dispatch=k,
                data_placement="device", max_steps=steps, print_freq=k,
                checkpoint_dir=os.path.join(tmp, name) if name == "b" else "",
                ledger_path=os.path.join(tmp, name + ".jsonl"), **kw)

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        a = LMTrainer(cfg("a"), device="cuda")
        a.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_eval = len(a._epoch_indices(a.val_ds, False, 0)[0])
        a_params = flat_params(torch, a)
        a_tok_s = a.last_tok_s
        del a
        free_device(torch)
        b = LMTrainer(cfg("b"), device="cuda")
        real, calls = b.window_step, [0]

        def cut(idx_window):
            if calls[0] == 2:
                raise KeyboardInterrupt
            calls[0] += 1
            return real(idx_window)

        b.window_step = cut
        try:
            b.fit()
            raise AssertionError("run B was not interrupted")
        except KeyboardInterrupt:
            pass
        del b
        ck = os.path.join(tmp, "b", "lm-checkpoint.pt")
        meta = ckpt.read_checkpoint_meta(ck)
        c = LMTrainer(cfg("c", resume=ck), device="cuda")
        skipped = c._skip_batches
        c.fit()
        c_params = flat_params(torch, c)
        c_step = c.state.step
        del c
        rec_a = ledger_steps(os.path.join(tmp, "a.jsonl"))
        rec_c = ledger_steps(os.path.join(tmp, "c.jsonl"))
    if not (meta.get("mid_epoch") and meta.get("step") == 2 * k):
        raise AssertionError(f"run B's checkpoint meta {meta}")
    if skipped != 2 * k or c_step != steps:
        raise AssertionError(f"run C skipped {skipped} batches, ended at "
                             f"step {c_step}")
    losses_a = [r["loss"] for r in rec_a]
    if [r["steps_in_dispatch"] for r in rec_a] != [k] * (steps // k) or \
            not all(map(math.isfinite, losses_a)):
        raise AssertionError(f"run A windows {rec_a}")
    if len(rec_c) != 1 or rec_c[0]["step"] != rec_a[-1]["step"]:
        raise AssertionError(f"run C windows {rec_c}")
    la, lc = losses_a[-1], rec_c[0]["loss"]
    if abs(la - lc) > LOSS_TOL * (1 + abs(la)):
        raise AssertionError(f"steps 9-12: resumed loss {lc} != "
                             f"uninterrupted {la}")
    want = {"adamw": steps, "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps,
            "flash_fwd": layers * (steps + n_eval)}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"9a: {name} launched {launches[name]} "
                                 f"times, expected {n}")
    if not peak_gb < base["peak_mem_gb"]:
        raise AssertionError(f"chunked peak {peak_gb} GB not below phase "
                             f"6's {base['peak_mem_gb']} GB")
    return {
        "steps": steps, "steps_per_dispatch": k, "loss_chunk": 1024,
        "window_losses_a": losses_a, "resumed_window_loss_c": lc,
        "loss_tol": f"{LOSS_TOL} (1 + |loss|)", "skipped_batches": skipped,
        "resume_loss_bit_equal": la == lc,
        "resume_params_bit_equal": bool(torch.equal(a_params, c_params)),
        "resume_params_max_abs_diff": float(
            (a_params - c_params).abs().max()),
        "tokens_per_s": a_tok_s, "wall_s_run_a": wall,
        "peak_mem_gb": peak_gb, "phase6_peak_mem_gb": base["peak_mem_gb"],
        "launches": launches}, launches


def lm_knob_run(torch, kernels, base, **kw):
    """A 4-step full-width LM run with ``kw`` (9b, 9c): finite losses and
    step 0 within BF16_TOL of phase 6's step 0 (same seed, same batch).
    Returns (record, launches)."""
    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    tr, losses = run_trainer(full_lm_config(max_steps=4, print_freq=1, **kw),
                             "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    l0 = base["losses"][0]
    if len(losses) != 4 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{kw}: losses {losses}")
    if abs(losses[0] - l0) > BF16_TOL * (1 + abs(l0)):
        raise AssertionError(f"{kw}: step 0 loss {losses[0]} != phase 6's "
                             f"{l0} (tol {BF16_TOL} (1 + |loss|))")
    return {"knobs": kw, "losses": losses, "phase6_step0_loss": l0,
            "tokens_per_s": tr.last_tok_s, "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}, launches


def chunked_head_timing(torch):
    """The chunked head (forward and backward, chunk 1024) against the
    unchunked bf16 head and loss at the training shape, on the same
    inputs: the product route, the times, the extra memory of each, and
    the mean losses (the unchunked rounds its logits to bf16: within
    BF16_TOL)."""
    from tpu_dist_torch.engine.lm_steps import lm_loss_and_metrics
    from tpu_dist_torch.ops.f32_product import mm_route
    from tpu_dist_torch.ops.fused_xent import chunked_softmax_xent

    free_device(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, l, d, v = 8, 2048, 1024, 32000
    x = torch.randn(b, l, d, generator=gen, device="cuda").requires_grad_()
    w = (torch.randn(d, v, generator=gen, device="cuda") * 0.02
         ).requires_grad_()
    t = torch.randint(0, v, (b, l), generator=gen, device="cuda")
    m = torch.ones(b, l, device="cuda")
    out = {}

    def chunked():
        loss, _ = chunked_softmax_xent(x, w, t, m, 1024, torch.bfloat16)
        torch.autograd.grad(loss, (x, w))
        return loss

    def unchunked():
        logits = (x.bfloat16() @ w.bfloat16()).float()
        loss, _ = lm_loss_and_metrics(logits, t, m)
        torch.autograd.grad(loss, (x, w))
        return loss

    for name, fn in (("chunked", chunked), ("unchunked", unchunked)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = fn()
        torch.cuda.synchronize()
        out[name] = {"mean_loss": loss.item() / (b * l),
                     "extra_peak_gb": (torch.cuda.max_memory_allocated()
                                       - base) / 1e9,
                     "ms": time_ms(torch, fn, iters=5, warmup=1)}
    a, r = out["chunked"]["mean_loss"], out["unchunked"]["mean_loss"]
    if abs(a - r) > BF16_TOL * (1 + abs(r)):
        raise AssertionError(f"chunked mean loss {a} != unchunked {r}")
    return {"shape": {"B": b, "L": l, "D": d, "V": v, "chunk": 1024},
            "route": mm_route("cuda", torch.bfloat16),
            "ms_is": "forward + backward (dx, dw), CUDA events, median of 5",
            **out}


def image_knobs(torch, kernels, image, best):
    """9d: ResNet-50 at BENCH_GEOMETRY with 2-way accumulation and a 2^15
    loss scale for 8 steps, then warm starts from phase 7's model_best."""
    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine import checkpoint as ckpt
    from tpu_dist_torch.engine.loop import Trainer
    from tpu_dist_torch.models.registry import create_model
    from tpu_dist_torch.scripts import image_train

    geom = image_train.BENCH_GEOMETRY
    steps = 8
    free_device(torch)
    cfg = TrainConfig(**{**geom, "steps_per_dispatch": 1,
                         "grad_accum_steps": 2, "loss_scale": 2.0 ** 15,
                         "synth_train_size": steps * geom["batch_size"],
                         "print_freq": 1})
    kernels.reset_launches()
    t0 = time.perf_counter()
    tr, losses = run_image_trainer(cfg, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    scale = {"scale": float(tr.state.loss_scale.scale),
             "good_steps": int(tr.state.loss_scale.good_steps)}
    if tr.state.step != steps or len(losses) != steps or \
            not all(map(math.isfinite, losses)):
        raise AssertionError(f"9d: {tr.state.step} steps, losses {losses}")
    if launches["sgd"] != steps:
        raise AssertionError(f"9d: sgd launched {launches['sgd']} times, "
                             f"expected {steps}")
    accum = {"steps": steps, "grad_accum_steps": 2, "losses": losses,
             "loss_scale": scale, "img_per_s": tr.last_img_s,
             "wall_s": wall, "launches": launches}
    del tr
    with tempfile.TemporaryDirectory() as tmp:
        warm = Trainer(TrainConfig(**{
            **geom, "pretrained": best,
            "synth_train_size": geom["batch_size"], "checkpoint_dir": "",
            "log_csv": "", "data": os.path.join(tmp, "no-data")}),
            device="cuda")
        acc1 = warm.validate()
    n_val = geom["synth_val_size"]
    if abs(acc1 - image["val_acc1"]) * n_val > 0.5:
        raise AssertionError(f"warm-started val acc@1 {acc1} != phase 7's "
                             f"{image['val_acc1']} (one image: 1/{n_val})")
    m100 = create_model("resnet50", num_classes=100, dtype=torch.bfloat16,
                        device="cuda", seed=SEED, stem=geom["stem"],
                        norm_dtype=torch.bfloat16)
    params, _, _ = ckpt.load_warmstart(best)
    n100, skipped = ckpt.graft_params(m100.named_parameters(), params)
    if sorted(skipped) != ["fc.bias", "fc.kernel"] or \
            n100 != RESNET50_LEAVES - 2:
        raise AssertionError(f"100-class graft: {n100} leaves, skipped "
                             f"{skipped}")
    accum["warm_start"] = {"val_acc1": acc1,
                           "phase7_val_acc1": image["val_acc1"],
                           "images_apart": abs(acc1 - image["val_acc1"])
                           * n_val,
                           "classes100_grafted": n100,
                           "classes100_skipped": skipped}
    return accum, launches


# 9e's and 12b's decode depth: the bench's 384 steps cut to a quarter
P9E_STEPS = 96


def decode_bench_one_shot(torch, kernels):
    """9e: the decode bench's one-shot mode at the reference's defaults
    (batch 8, prompt 128) cut from 384 steps to P9E_STEPS, on the LM's
    width with the flash kernel in the full recompute."""
    import contextlib
    import io

    from tpu_dist_torch.tools import decode_bench

    argv = ["--batch", "8", "--prompt-len", "128", "--steps", str(P9E_STEPS),
            "--num-layers", "8", "--d-model", "1024", "--vocab-size",
            "32000", "--num-heads", "8", "--precision", "bf16", "--attn",
            "flash", "--trials", "1", "--requests", "3"]
    kernels.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        decode_bench.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    # the full recompute runs P9E_STEPS forwards per call (a warm call and
    # one trial); the cached decode attends exactly over its cache
    want = 2 * P9E_STEPS * 8
    if launches["flash_fwd"] != want:
        raise AssertionError(f"9e: flash_fwd launched "
                             f"{launches['flash_fwd']} times, expected "
                             f"{want}")
    if line["metric"] != "torch_lm_decode_tokens_per_sec" or \
            line["device"]["platform"] != "gpu" or \
            not line["kv_cache"] > 0 or not line["full_recompute"] > 0:
        raise AssertionError(f"9e: bench line {line}")
    return {"argv": " ".join(argv), "line": line, "wall_s": wall,
            "launches": launches}, launches


# ---- phase 10: multi-process data parallelism ------------------------------

DP_WORKER = "--dp-worker"
# bf16 gradient compression, card vs CPU: an fp32 summation-order
# difference that moves a gradient entry across a bf16 rounding boundary
# flips it by one bf16 ulp (2^-8 of its magnitude), and that update
# difference grows with every later step, by an amount that changes from
# run to run with cuDNN's algorithm choice (on an H100, step 4 was 2e-4
# apart in one call and 4.6e-3 in the next). Steps 0 and 1 (which see
# only step 0's update) are held within LOSS_TOL (1 + |loss|); the later
# steps' difference is reported
BF16_COMPRESS_HELD_STEPS = 2
# the tiny runs of phase 10c: phase 4's image and LM trainers, 2 x 8 and
# 2 x 2 rows
DP_TINY_IMAGE = dict(arch="resnet18", dataset="cifar10", batch_size=16,
                     epochs=1, synth_train_size=80, synth_val_size=32,
                     precision="fp32", optimizer="fused_sgd", seed=SEED,
                     print_freq=1, workers=1, log_csv="")
DP_TINY_LM = dict(batch_size=4, seq_len=96, d_model=128, num_layers=2,
                  num_heads=1, vocab_size=64, synth_tokens=4000, seed=SEED,
                  attn="flash", optimizer="fused_adamw", lr=3e-3,
                  grad_clip=0.5, weight_decay=0.1, max_steps=5,
                  print_freq=1, grad_bucket_mb=0.05)
DP_TINY_RUNS = {"jit": {},
                "shard_map_bf16_pre2": dict(variant="shard_map",
                                            grad_compression="bf16",
                                            gradient_predivide_factor=2.0),
                "adasum": dict(variant="shard_map", adasum=True)}


def dp_image_geometry(**kw):
    """Phase 7's BENCH_GEOMETRY with ``kw`` (a TrainConfig's kwargs)."""
    from tpu_dist_torch.scripts import image_train

    return {**image_train.BENCH_GEOMETRY, **kw}


def dp_job(torch, kernels, job, out, rank):
    """One job of a phase-10 rank (module docstring): a trainer fit with the
    kernel counts reset just before it, or a collective probe."""
    from tpu_dist_torch.parallel import collectives as C
    from tpu_dist_torch.parallel.mesh import make_mesh
    from tpu_dist_torch.parallel.overlap import (bucketed_grad_sync,
                                                 grad_buckets)

    kind, device = job["kind"], job["device"]
    if kind == "lm12":
        return mp_lm_job(torch, kernels, job, out, rank)
    if kind == "zoo11":
        sweep, sgd = zoo_sweep(torch, kernels, job["archs"], device=device)
        return {"sweep": sweep, "sgd": sgd}
    if kind == "zoo11_agree":     # its CPU side wants more than 2 threads
        torch.set_num_threads(4)
        return zoo_agreement(torch)
    if kind == "image13":
        return p13_image_job(torch, kernels, job, out, rank)
    if kind == "decode13":
        return p13_decode_job(torch, kernels, job, out, rank)
    if kind == "sp14":
        return p14_serve_job(torch, kernels, job, out, rank)
    if kind == "restart15":
        return p15_restart_job(torch, kernels, job, out, rank)
    if kind == "obs16":
        return p16_rank_job(torch, kernels, job, out, rank)
    if kind == "plan17":
        return p17_rank_job(torch, kernels, job, out, rank)
    if kind == "audit19":
        return p19_rank_job(torch, kernels, job, out, rank)
    if kind == "probe":
        mesh = make_mesh(device=device)
        res = {"backend": C.backend_of(mesh.group()), "world": mesh.size}
        x = torch.arange(8, dtype=torch.float32, device=mesh.device) + rank
        want = (torch.arange(8.0) * mesh.size
                + sum(range(mesh.size))).tolist()
        # (name, the collective, whether its result is the sum over ranks)
        for name, fn, is_sum in (
                ("all_reduce fp32", lambda: C.psum(x, mesh.group()), True),
                ("all_reduce bf16", lambda: C.psum(x.bfloat16(), mesh.group()),
                 True),
                ("reduce_scatter_tensor + all_gather_into_tensor fp32",
                 lambda: bucketed_grad_sync([x], mean=False,
                                            group=mesh.group())[0], True),
                ("reduce_scatter_tensor + all_gather_into_tensor bf16",
                 lambda: bucketed_grad_sync([x.bfloat16()], mean=False,
                                            group=mesh.group())[0], True),
                ("batch_isend_irecv (ring_allreduce)",
                 lambda: C.ring_allreduce(x, mesh.group()), True),
                ("batch_isend_irecv (adasum_reduce)",
                 lambda: C.adasum_reduce([x], mesh.group())[0], False)):
            try:
                got = fn().float().tolist()
            except NotImplementedError as e:
                res[name] = f"refused: {e}"
                continue
            if is_sum and got != want:
                raise AssertionError(f"{name}: {got} != {want}")
            res[name] = "ok"
        C.barrier(mesh.device, mesh.group())
        # one 25 MB bucket (fp32), synced alone: the comm_s of one bucket
        g = [torch.ones(6_250_000, device=mesh.device)]
        bucketed_grad_sync(g, group=mesh.group())
        C.barrier(mesh.device, mesh.group())
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            bucketed_grad_sync(g, group=mesh.group())[0].sum().item()
            times.append((time.perf_counter() - t0) * 1e3)
        res["bucket_25mb_sync_ms"] = statistics.median(times)
        return res
    if device != "cpu":
        free_device(torch)
        torch.cuda.reset_peak_memory_stats()
    cfg = dict(job["cfg"], ledger_path=os.path.join(out, f"{job['name']}"
                                                    f".r{rank}.jsonl"))
    init = None
    if job.get("init"):
        with open(job["init"], "rb") as f:
            init = torch.load(f, weights_only=False)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        if kind == "image":
            from tpu_dist_torch.configs import TrainConfig
            from tpu_dist_torch.engine.loop import Trainer

            cfg.setdefault("data", os.path.join(out, "no-data"))
            cfg.setdefault("log_csv", "")
            cfg.setdefault("checkpoint_dir",
                           os.path.join(out, f"ck-{job['name']}"))
            tr = Trainer(TrainConfig(**cfg), device=device,
                         init_params=init and init[0],
                         init_batch_stats=init and init[1])
        else:
            from tpu_dist_torch.configs import LMConfig
            from tpu_dist_torch.engine.lm_loop import LMTrainer

            tr = LMTrainer(LMConfig(**cfg), device=device, init_params=init)
        best = tr.fit()
    except NotImplementedError as e:
        if job.get("refusal") and job["refusal"] in str(e):
            return {"refused": str(e)}
        raise
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    res = {"best": best, "step": tr.state.step, "world": tr.world,
           "rank": tr.rank, "local_batch": tr.local_batch,
           "launches": launches, "wall_s": wall,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if device != "cpu" else None)}
    if rank == 0:
        steps = ledger_steps(cfg["ledger_path"])
        res["losses"] = [r["loss"] for r in steps]
        res["comm_s"] = [r["comm_s"] for r in steps]
    if kind == "image":
        res["img_per_s"] = tr.last_img_s
        payload = tr.state.params
        if tr.cfg.grad_compression == "bf16":
            payload = [p.to(torch.bfloat16) for p in payload]
        res["buckets_25mb"] = len(grad_buckets(payload, 25e6))
    else:
        res["tokens_per_s"] = tr.last_tok_s
        res["buckets"] = len(grad_buckets(tr.state.params,
                                          tr.cfg.grad_bucket_mb * 1e6))
    return res


def wait_groups(groups, timeouts):
    """Wait for :class:`DpGroup` s started together, in order, each with
    its own time limit; a failure kills the ones not yet waited for."""
    out = []
    try:
        for g, t in zip(groups, timeouts):
            out.append(g.wait(t))
    finally:
        for g in groups[len(out):]:
            g.kill()
    return out


def dp_worker(spec_path):
    """A phase-10 rank: join the group through ``launch.initialize``, run
    the spec's jobs in order, write ``rank<r>.json``."""
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from tpu_dist_torch import kernels
    from tpu_dist_torch.parallel import launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    with open(spec_path) as f:
        spec = json.load(f)
    info = launch.initialize(device=spec["device"], backend=spec["backend"])
    results, job_s = {}, {}
    for job in spec["jobs"]:
        t0 = time.perf_counter()
        results[job["name"]] = dp_job(torch, kernels,
                                      dict(job, device=spec["device"]),
                                      spec["out"], info.process_id)
        job_s[job["name"]] = round(time.perf_counter() - t0, 1)
    with open(os.path.join(spec["out"], f"seconds{info.process_id}.json"),
              "w") as f:
        json.dump(job_s, f)
    with open(os.path.join(spec["out"], f"rank{info.process_id}.json"),
              "w") as f:
        json.dump(results, f)
    # a barrier before leaving: a rank that destroys its gloo group while
    # a peer is still finishing can abort that peer at teardown
    launch.shutdown()
    return 0


class DpGroup:
    """``world`` phase-10 ranks of this script, started at once on a
    loopback store this process binds and holds
    (``parallel.launch.host_store``); :meth:`wait` joins them and returns
    each rank's results, and kills them all if one fails or the time runs
    out."""

    def __init__(self, name, world, device, backend, jobs, tmp):
        from tpu_dist_torch.parallel.launch import host_store

        self.name, self.world = name, world
        self.out = os.path.join(tmp, name)
        os.makedirs(self.out, exist_ok=True)
        spec = os.path.join(self.out, "spec.json")
        with open(spec, "w") as f:
            json.dump({"device": device, "backend": backend, "jobs": jobs,
                       "out": self.out}, f)
        self.store, coordinator = host_store("127.0.0.1:0", world)
        self.procs = []
        for r in range(world):
            env = dict(os.environ, TPU_DIST_COORDINATOR=coordinator,
                       TPU_DIST_NUM_PROCESSES=str(world),
                       TPU_DIST_PROCESS_ID=str(r), TPU_DIST_STORE_HELD="1")
            log = open(os.path.join(self.out, f"rank{r}.log"), "w")
            self.procs.append((log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), DP_WORKER, spec],
                env=env, stdout=log, stderr=subprocess.STDOUT)))

    def kill(self):
        for log, p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        self.store = None

    def wait(self, timeout_s):
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.poll() is None for _, p in self.procs):
                failed = [p for _, p in self.procs if p.poll() not in
                          (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            self.kill()
        bad = [(r, p.returncode) for r, (_, p) in enumerate(self.procs)
               if p.returncode != 0]
        if bad:
            tails = []
            for r, rc in bad:
                with open(os.path.join(self.out, f"rank{r}.log")) as f:
                    tails.append(f"rank {r} rc={rc}:\n{f.read()[-3000:]}")
            raise AssertionError(f"phase 10 {self.name}: "
                                 + "\n".join(tails))
        res = []
        for r in range(self.world):
            with open(os.path.join(self.out, f"rank{r}.json")) as f:
                res.append(json.load(f))
        with open(os.path.join(self.out, "seconds0.json")) as f:
            log(f"  {self.name}: rank 0's seconds a job {f.read()}")
        return res


def dp_close(tag, got, want, tol, steps=None):
    """Per-step losses of two runs within ``tol`` (1 + |loss|), the first
    ``steps`` of them (all by default); returns the largest difference."""
    if len(got) != len(want) or not got:
        raise AssertionError(f"{tag}: {len(got)} vs {len(want)} losses")
    for i, (a, r) in enumerate(zip(got, want)):
        if (steps is None or i < steps) and abs(a - r) > tol * (1 + abs(r)):
            raise AssertionError(f"{tag} step {i}: {a} vs {r} (tol {tol} "
                                 f"(1 + |loss|)): {got} vs {want}")
    return max(abs(a - r) for a, r in zip(got, want))


def dp_path(torch, kernels, training, image, tmp):
    """Phase 10 (module docstring). ``training`` and ``image`` are phases
    6 and 7's records. Returns (record, launches by run)."""
    from tpu_dist_torch.interop import (export_flax_image_params,
                                        export_flax_params)
    from tpu_dist_torch.models.resnet import ResNet18
    from tpu_dist_torch.models.transformer import TransformerLM

    free_device(torch)
    t0 = time.perf_counter()
    # one set of initial weights for the tiny runs on the card and the CPU
    inits = {}
    for name, tree in (
            ("image", (export_flax_image_params(
                ResNet18(device="cpu", seed=SEED)))),
            ("lm", export_flax_params(TransformerLM(
                vocab_size=64, num_layers=2, d_model=128, num_heads=1,
                max_len=96, device="cpu", seed=SEED)))):
        inits[name] = os.path.join(tmp, f"{name}_init.pt")
        torch.save(tree, inits[name])

    def tiny(name, kind, **kw):
        base = DP_TINY_IMAGE if kind == "image" else DP_TINY_LM
        return {"name": name, "kind": kind, "init": inits[kind],
                "cfg": {**base, **kw}}

    # adasum exchanges point to point, which gloo refuses on CUDA tensors
    tiny_2rank = [dict(tiny(n, "image", mesh_shape=[2], **kw),
                       refusal="gloo")
                  for n, kw in DP_TINY_RUNS.items()]
    tiny_2rank.append(tiny("lm_buckets", "lm", mesh_shape=[2]))
    steps7 = image["steps"]
    # (a) world 1 over nccl: phase 7's run with variant="jit", script 5's
    # settings for 8 steps, and the tiny jit run (the 2-rank runs' twin)
    a = DpGroup("a", 1, "cuda", "nccl", [
        {"name": "probe", "kind": "probe"},
        {"name": "image_jit", "kind": "image",
         "cfg": dp_image_geometry(variant="jit", mesh_shape=[1],
                                  print_freq=16)},
        {"name": "image_shard_map_bf16_buckets", "kind": "image",
         "cfg": dp_image_geometry(variant="shard_map",
                                  grad_compression="bf16",
                                  grad_bucket_mb=25.0, steps_per_dispatch=1,
                                  synth_train_size=8 * 1024,
                                  synth_val_size=2048, print_freq=4)},
        tiny("tiny_jit_world1", "image")], tmp)
    # (b) 2 ranks on the card over gloo, and (c) their CPU twins, beside
    # (a) (their img/s and tokens/s share the card)
    b = DpGroup("b", 2, "cuda", "gloo", [
        {"name": "probe", "kind": "probe"},
        {"name": "image", "kind": "image",
         "cfg": dp_image_geometry(variant="shard_map",
                                  grad_compression="bf16",
                                  grad_bucket_mb=25.0, steps_per_dispatch=1,
                                  mesh_shape=[2], synth_train_size=4 * 1024,
                                  synth_val_size=2048, print_freq=1)},
        {"name": "lm", "kind": "lm",
         "cfg": dict(dataclasses.asdict(full_lm_config(
             max_steps=4, print_freq=1, grad_bucket_mb=25.0)),
             mesh_shape=[2], mesh_axes=["data"])},
        *tiny_2rank], tmp)
    c = DpGroup("c", 2, "cpu", "gloo", [dict(j) for j in tiny_2rank], tmp)
    res_a, res_b, res_c = wait_groups([a, b, c], (300, 300, 120))
    res_a = res_a[0]
    wall = time.perf_counter() - t0

    # (a) checks
    jit = res_a["image_jit"]
    w7 = image["window_losses"]
    jit_diff = dp_close("10a jit windows vs phase 7", jit["losses"], w7,
                        BF16_TOL)
    if jit["launches"]["sgd"] != steps7 or jit["step"] != steps7:
        raise AssertionError(f"10a jit: {jit['step']} steps, "
                             f"{jit['launches']['sgd']} sgd launches")
    sm = res_a["image_shard_map_bf16_buckets"]
    if sm["launches"]["sgd"] != 8 or len(sm["losses"]) != 8 or \
            not all(map(math.isfinite, sm["losses"])):
        raise AssertionError(f"10a shard_map: {sm}")
    # (b) checks
    for r, res in enumerate(res_b):
        img, lm = res["image"], res["lm"]
        if img["launches"]["sgd"] != 4 or img["local_batch"] != 512:
            raise AssertionError(f"10b rank {r} image: {img}")
        want = {"flash_bwd_dq": 8 * 4, "flash_bwd_dkv": 8 * 4, "adamw": 4}
        if any(lm["launches"][k] != n for k, n in want.items()) or \
                lm["local_batch"] != 4:
            raise AssertionError(f"10b rank {r} lm: {lm['launches']}")
    img2, lm2 = res_b[0]["image"], res_b[0]["lm"]
    if len(img2["losses"]) != 4 or not all(map(math.isfinite,
                                               img2["losses"])):
        raise AssertionError(f"10b image losses {img2['losses']}")
    l0 = training["losses"][0]
    if len(lm2["losses"]) != 4 or not all(map(math.isfinite, lm2["losses"])) \
            or abs(lm2["losses"][0] - l0) > BF16_TOL * (1 + abs(l0)):
        raise AssertionError(f"10b lm losses {lm2['losses']} vs phase 6's "
                             f"step 0 {l0}")
    # (c) card against CPU, and the 2-rank jit against the 1-rank jit
    small = {}
    for name in (*DP_TINY_RUNS, "lm_buckets"):
        card, cpu = res_b[0][name], res_c[0][name]
        if name == "adasum":
            if "refused" not in card or "losses" not in cpu:
                raise AssertionError(f"10c adasum: card {card}, cpu {cpu}")
            small[name] = {"card": card["refused"], "cpu": cpu["losses"]}
            continue
        held = (BF16_COMPRESS_HELD_STEPS if name.startswith("shard_map_bf16")
                else None)
        diff = dp_close(f"10c {name}", card["losses"], cpu["losses"],
                        LOSS_TOL, steps=held)
        small[name] = {"card": card["losses"], "cpu": cpu["losses"],
                       "max_abs_diff": diff, "steps_held": held or "all"}
    one = res_a["tiny_jit_world1"]["losses"]
    small["jit_2rank_vs_1rank_card_max_abs_diff"] = dp_close(
        "10c jit 2 ranks vs 1", res_b[0]["jit"]["losses"], one, LOSS_TOL)
    record = {
        "a_world1_nccl": {
            "probe": res_a["probe"],
            "image_jit": {"window_losses": jit["losses"],
                          "phase7_window_losses": w7,
                          "bit_equal_phase7": jit["losses"] == w7,
                          "max_abs_diff": jit_diff,
                          "img_per_s": jit["img_per_s"],
                          "phase7_img_per_s":
                              image["train_img_per_s_window1_excluded"],
                          "sgd_launches": jit["launches"]["sgd"],
                          "buckets_25mb_fp32": jit["buckets_25mb"]},
            "image_shard_map_bf16_buckets": {
                "losses": sm["losses"], "img_per_s": sm["img_per_s"],
                "sgd_launches": sm["launches"]["sgd"],
                "buckets_25mb_bf16": sm["buckets_25mb"],
                "peak_mem_gb": sm["peak_mem_gb"]}},
        "b_2rank_gloo_cuda": {
            "probe": res_b[0]["probe"],
            "image": {"losses": img2["losses"], "img_per_s":
                      img2["img_per_s"], "step_ms": 1024 / img2["img_per_s"]
                      * 1e3, "sgd_launches_per_rank":
                      [r["image"]["launches"]["sgd"] for r in res_b],
                      "buckets_25mb_bf16": img2["buckets_25mb"],
                      "peak_mem_gb_per_rank":
                      [r["image"]["peak_mem_gb"] for r in res_b]},
            "lm": {"losses": lm2["losses"], "phase6_step0_loss": l0,
                   "tokens_per_s": lm2["tokens_per_s"],
                   "step_ms": 8 * 2048 / lm2["tokens_per_s"] * 1e3,
                   "comm_s_per_step": lm2["comm_s"],
                   "buckets": lm2["buckets"],
                   "launches_per_rank": [
                       {k: r["lm"]["launches"][k] for k in (
                           "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                           "adamw")} for r in res_b],
                   "peak_mem_gb_per_rank":
                       [r["lm"]["peak_mem_gb"] for r in res_b]}},
        "c_small_card_vs_cpu": small,
        "wall_s": wall}
    by_path = {"dp_image_jit_world1": jit["launches"],
               "dp_image_shard_map_world1": sm["launches"],
               "dp_image_2rank_rank0": img2["launches"],
               "dp_lm_2rank_rank0": lm2["launches"]}
    return record, by_path


# ---- phase 11: the image side on one card ----------------------------------

# script 6 (scripts/6.distributed_slurm.py) at its DEFAULTS, cut to one
# card: batch 3200 is job-wide and one card holds about 256 at fp32; one
# epoch of 8 steps; 512 validation images
SCRIPT6_CUTS = dict(batch_size=256, synth_train_size=2048,
                    synth_val_size=512, epochs=1)
# ViT-B/16 in int8 at full width on the synthetic ImageNet
VIT_INT8 = dict(arch="vit_base", dataset="imagenet", precision="bf16",
                quant="int8", optimizer="fused_sgd", batch_size=128,
                synth_train_size=1024, synth_val_size=256, epochs=1,
                seed=SEED, print_freq=16, workers=2)
# fused_quant at ViT-B/16 training shapes, (M, K, N): M = 128 images x 197
# tokens; an M that is no multiple of a tile (3 images) for the tail
VIT_QUANT_SHAPES = {"vit qkv (train)": (25216, 768, 2304),
                    "vit mlp_out (train)": (25216, 3072, 768),
                    "vit qkv (3 images)": (591, 768, 2304)}
# the 29 archs phase 11c builds at 1000 classes; torchvision's published
# counts where they exist (tests/test_models.py:112-135)
ZOO_PUBLISHED = {
    "densenet121": 7_978_856, "densenet161": 28_681_000,
    "densenet169": 14_149_480, "densenet201": 20_013_928,
    "squeezenet1_0": 1_248_424, "squeezenet1_1": 1_235_496,
    "shufflenet_v2_x0_5": 1_366_792, "shufflenet_v2_x1_0": 2_278_604,
    "shufflenet_v2_x1_5": 3_503_624, "shufflenet_v2_x2_0": 7_393_996,
    "mobilenet_v2": 3_504_872, "efficientnet_b0": 5_288_548,
    "googlenet": 6_624_904, "inception_v3": 23_834_568,
    "mnasnet0_5": 2_218_512, "mnasnet0_75": 3_170_208,
    "mnasnet1_0": 4_383_312, "mnasnet1_3": 6_282_256,
    "mobilenet_v3_large": 5_483_032, "mobilenet_v3_small": 2_542_856}
ZOO_ARCHS = sorted(ZOO_PUBLISHED) + [
    "vgg11", "vgg13", "vgg16", "vgg19", "alexnet", "vit_tiny", "vit_small",
    "vit_base", "vit_cifar"]
# one arch per family for the card-against-CPU check (phase 11c): name,
# input px, whether the train-mode forward has no dropout, extra kwargs
ZOO_FAMILIES = (("vgg11", 64, False, {}), ("densenet121", 64, True, {}),
                ("alexnet", 64, False, {}), ("squeezenet1_0", 64, False, {}),
                ("mobilenet_v2", 64, False, {}),
                ("shufflenet_v2_x0_5", 64, True, {}),
                # stochastic depth draws inside the trunk, ahead of the
                # running stats: off, as in the CPU tests
                ("efficientnet_b0", 64, False, {"sd_max": 0.0}),
                ("googlenet", 64, False, {}), ("inception_v3", 128, False, {}),
                ("mnasnet0_5", 64, False, {}),
                ("mobilenet_v3_small", 64, False, {}),
                ("vit_cifar", 32, True, {}),
                ("vit_cifar", 32, True, {"quant": "int8"}))
# the archs 11c's sweep steps at 1000 classes: one a family, the ones the
# card-against-CPU check picks
ZOO_SWEEP = sorted({name for name, *_ in ZOO_FAMILIES})
# 11d: the ImageFolder tree (8 classes x 16 JPEGs at 500 x 375) and the
# script-6 steps over it
FOLDER_IMAGES, FOLDER_CLASSES, FOLDER_BATCH = 128, 8, 64


def script6_path(torch, kernels, cuts=SCRIPT6_CUTS, device="cuda"):
    """11a: ``tpu_dist_torch.scripts.distributed_slurm.main`` at the
    reference script's DEFAULTS (resnet50, synthetic ImageNet, fp32,
    plain sgd, jit) with the cuts of SCRIPT6_CUTS, and without cuDNN's
    autotuning (the trainer turns it on for CUDA; off here to keep the
    script inside its time limit, so the convolutions run the algorithms
    cuDNN's heuristics pick)."""
    from tpu_dist_torch.engine import loop
    from tpu_dist_torch.scripts import distributed_slurm

    init = loop.Trainer.__init__

    def untuned(self, *a, **kw):
        init(self, *a, **kw)
        torch.backends.cudnn.benchmark = False

    with tempfile.TemporaryDirectory() as tmp:
        ledger = os.path.join(tmp, "run.jsonl")
        argv = [a for k, v in cuts.items()
                for a in (f"--{k.replace('_', '-')}", str(v))]
        argv += ["--device", device, "--data", os.path.join(tmp, "no-data"),
                 "--checkpoint-dir", os.path.join(tmp, "ck"),
                 "--ledger-path", ledger, "--log-csv", "",
                 "--print-freq", "8", "--workers", "4"]
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        loop.Trainer.__init__ = untuned
        try:
            tr = distributed_slurm.main(argv)
        finally:
            loop.Trainer.__init__ = init
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        recs = ledger_steps(ledger)
    cfg = tr.cfg
    steps = cfg.synth_train_size // cfg.batch_size
    if (cfg.arch, cfg.dataset, cfg.variant, cfg.precision, cfg.optimizer) \
            != ("resnet50", "imagenet", "jit", "fp32", "sgd"):
        raise AssertionError(f"script 6 config {cfg}")
    if tr.state.step != steps or tr.num_classes != 1000 or \
            tuple(tr.train_ds.image_shape) != (224, 224, 3):
        raise AssertionError(f"script 6: {tr.state.step} of {steps} steps, "
                             f"{tr.num_classes} classes, "
                             f"{tr.train_ds.image_shape}")
    losses = [r["loss"] for r in recs]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"script 6 losses {losses}")
    if any(launches.values()):
        raise AssertionError(f"script 6 (plain sgd) launched {launches}")
    return {"config": {**cuts, "arch": cfg.arch, "dataset": cfg.dataset,
                       "precision": cfg.precision,
                       "optimizer": cfg.optimizer, "variant": cfg.variant},
            "cuts": "batch 3200 -> 256 (one card), 2048 train / 512 val "
                    "synthetic images, 1 epoch (90), no cuDNN autotuning",
            "steps": steps, "losses": losses,
            "train_img_per_s_window1_excluded": tr.last_img_s,
            "step_ms": cfg.batch_size / tr.last_img_s * 1e3,
            "val_acc1": tr.best_acc1,
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if device == "cuda" else None),
            "wall_s_incl_data_build_and_eval": wall}, launches


def vit_int8_path(torch, kernels, cfg_kw=VIT_INT8, device="cuda"):
    """11b: ViT-B/16 trained in int8 on fused_quant.cu with fused_sgd:
    48 fused_quant calls a training step and as many a validation batch,
    one sgd launch a step, ``fused`` true in every step record."""
    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine.loop import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        ledger = os.path.join(tmp, "run.jsonl")
        cfg = TrainConfig(**cfg_kw, ledger_path=ledger, log_csv="",
                          checkpoint_dir=os.path.join(tmp, "ck"),
                          data=os.path.join(tmp, "no-data"))
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        tr = Trainer(cfg, device=device)
        tr.fit()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        recs = ledger_steps(ledger)
    steps = cfg.synth_train_size // cfg.batch_size
    evals = -(-cfg.synth_val_size // cfg.batch_size)
    params = sum(p.numel() for p in tr.state.params)
    blocks = len(tr.model.block_names)
    per_step = 4 * blocks     # qkv, proj, mlp_in, mlp_out of every block
    on_card = device == "cuda"
    # every training step, every validation batch and the trainer's one
    # one-image forward that counts FLOPs for its analytic MFU
    want_fq = per_step * (steps + evals + 1) if on_card else 0
    losses = [r["loss"] for r in recs]
    if tr.state.step != steps or len(losses) != steps or \
            not all(map(math.isfinite, losses)):
        raise AssertionError(f"vit int8: {tr.state.step} of {steps} steps, "
                             f"losses {losses}")
    if launches["fused_quant"] != want_fq or \
            launches["sgd"] != (steps if on_card else 0):
        raise AssertionError(f"vit int8 launches {launches}, expected "
                             f"fused_quant {want_fq}, sgd {steps}")
    if any(r.get("fused") is not on_card for r in recs):
        raise AssertionError("vit int8: a step record's fused flag is "
                             f"not {on_card}")
    return {"config": {k: v for k, v in cfg_kw.items()
                       if k not in ("print_freq", "workers")},
            "params": params, "blocks": blocks, "steps": steps,
            "losses": losses,
            "train_img_per_s_window1_excluded": tr.last_img_s,
            "step_ms": cfg.batch_size / tr.last_img_s * 1e3,
            "val_acc1": tr.best_acc1,
            "fused_quant_per_train_step": per_step,
            "fused_quant_is": "per step x (steps + eval batches + the "
                              "one-image FLOP-count forward)",
            "eval_batches": evals, "fused": on_card,
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if on_card else None),
            "wall_s_incl_data_build_and_eval": wall,
            "launches": launches}, launches


def check_fused_quant_training(torch, shapes=VIT_QUANT_SHAPES,
                               seed=SEED + 11):
    """fused_quant at ``shapes`` (ViT-B/16's training shapes and an M tail
    by default): bit-equal to its plain version, timed against bf16
    torch.matmul of the same operands and its bound."""
    from tpu_dist_torch.ops import pallas_quant as pq

    own = torch.Generator(device="cuda").manual_seed(seed)
    recs = {}
    for label, (m, k, n) in shapes.items():
        x = torch.randn((m, k), generator=own, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((k, n), generator=own, device="cuda")
             / math.sqrt(k)).to(torch.bfloat16)
        out = pq.fused_quant_cuda(x, w)
        ref = pq.fused_quant_matmul_plain(x, w)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"fused_quant {label} ({m}, {k}, {n}): "
                                 f"max|err| {err}, expected bit-equal")
        del ref, out
        ms = time_ms(torch, lambda: pq.fused_quant_cuda(x, w))
        plain_ms = time_ms(torch, lambda: pq.fused_quant_matmul_plain(x, w),
                           iters=5)
        yard_ms = time_ms(torch, lambda: torch.matmul(x, w))
        nbytes = 2 * (m * k + k * n + m * n)
        ops = 2.0 * m * n * k
        t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
        recs[label] = {
            "shape": f"{label}: M{m} K{k} N{n} bf16", "max_abs_err": err,
            "tolerance": "bit-equal", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "yardstick_ms": yard_ms}
    return recs


def zoo_sweep(torch, kernels, archs=ZOO_ARCHS, batch=8, device="cuda"):
    """11c: every new arch at 1000 classes on ``device``: its parameter
    count (the published one where there is one) and one bf16
    ``fused_sgd`` step at ``batch`` x 224 px (inception_v3: 299) with a
    finite loss and one sgd launch."""
    import numpy as np

    from tpu_dist_torch.data.datasets import IMAGENET_MEAN, IMAGENET_STD
    from tpu_dist_torch.data.pipeline import make_transform
    from tpu_dist_torch.engine.state import TrainState
    from tpu_dist_torch.engine.steps import image_train_step
    from tpu_dist_torch.models.registry import create_model
    from tpu_dist_torch.ops.optim import step_decay_schedule
    from tpu_dist_torch.ops.pallas_sgd import FusedSGD

    transform = make_transform(IMAGENET_MEAN, IMAGENET_STD,
                               dtype=torch.bfloat16, device=device)
    rng = np.random.default_rng(SEED)
    out, sgd_total = {}, 0
    # one step of each arch: no cuDNN autotuning of its conv shapes
    torch.backends.cudnn.benchmark = False
    for arch in archs:
        px = 299 if arch == "inception_v3" else 224
        t0 = time.perf_counter()
        model = create_model(arch, num_classes=1000, dtype=torch.bfloat16,
                             image_shape=(px, px, 3), device=device,
                             seed=SEED)
        n = sum(p.numel() for p in model.parameters())
        if arch in ZOO_PUBLISHED and n != ZOO_PUBLISHED[arch]:
            raise AssertionError(f"{arch}: {n} params, published "
                                 f"{ZOO_PUBLISHED[arch]}")
        model.requires_grad_(True)
        model.train()
        tx = FusedSGD(step_decay_schedule(0.01, 1), 0.9, 1e-4)
        state = TrainState.create(model, tx)
        images = torch.from_numpy(rng.integers(
            0, 255, (batch, px, px, 3), np.uint8)).to(device)
        labels = torch.from_numpy(rng.integers(0, 1000, batch)).to(device)
        kernels.reset_launches()
        m = image_train_step(model, tx, state, images, labels, transform)
        loss = (m["loss_sum"] / m["count"]).item()
        sgd = kernels.LAUNCHES["sgd"]
        if not math.isfinite(loss) or sgd != (1 if device == "cuda" else 0):
            raise AssertionError(f"{arch}: loss {loss}, sgd launches {sgd}")
        sgd_total += sgd
        out[arch] = {"params": n, "published": ZOO_PUBLISHED.get(arch),
                     "px": px, "loss": loss, "sgd": sgd,
                     "s": time.perf_counter() - t0}
        del model, state, tx
    return out, sgd_total


def zoo_agreement(torch, families=ZOO_FAMILIES, n=4):
    """11c: one arch per family, fp32, the same params on the card and on
    the CPU (plain versions): the mean cross entropy of a train-mode
    forward (where it has no dropout) and of the eval forward over the
    running stats that train forward left, within LOSS_TOL (1 + |loss|).
    int8 (``vit_cifar``, 8 blocks): a value that the card's and the CPU's
    fp32 sums put on two sides of an int8 rounding boundary moves by one
    quant step, and over 32 quantized products that moves the loss by
    more than INT8_LOSS_TOL (1 + |loss|) on the CPU alone (its loss with
    the input moved by one fp32 ulp, four draws). So int8 is held within
    twice that spread of the CPU's own plus INT8_LOSS_TOL (1 + |loss|)."""
    import numpy as np

    from tpu_dist_torch.engine.steps import cross_entropy_sum
    from tpu_dist_torch.models.registry import create_model

    def losses_of(model, x, y, dev):
        xs, ys = torch.from_numpy(x).to(dev), y.to(dev)
        with torch.no_grad():
            model.train()
            train = cross_entropy_sum(model(xs), ys).item() / n
            model.eval()
            ev = cross_entropy_sum(model(xs), ys).item() / n
        return train, ev

    out = {}
    for arch, px, dropout_free, kw in families:
        int8 = kw.get("quant") == "int8"
        tol = INT8_LOSS_TOL if int8 else LOSS_TOL
        rng = np.random.default_rng(SEED)
        x = rng.standard_normal((n, px, px, 3)).astype(np.float32)
        y = torch.from_numpy(rng.integers(0, 10, n))
        cpu = create_model(arch, num_classes=10, image_shape=(px, px, 3),
                           device="cpu", seed=SEED, **kw)
        card = create_model(arch, num_classes=10, image_shape=(px, px, 3),
                            device="cuda", seed=None, **kw)
        card.load_state_dict(cpu.state_dict())
        ct, ce = losses_of(cpu, x, y, "cpu")
        gt, ge = losses_of(card, x, y, "cuda")
        spread = 0.0
        if int8:          # the CPU's own spread under one-ulp input moves
            for k in range(4):
                ulp = np.random.default_rng(SEED + 1 + k).choice(
                    [-1.0, 1.0], x.shape).astype(np.float32) \
                    * np.abs(x) * 2.0 ** -23
                st, se = losses_of(cpu, x + ulp, y, "cpu")
                spread = max(spread, abs(st - ct), abs(se - ce))
        held = [("eval", ge, ce)] + ([("train", gt, ct)] if dropout_free
                                     else [])
        for what, got, want in held:
            if not abs(got - want) <= 2 * spread + tol * (1 + abs(want)):
                raise AssertionError(f"{arch} {kw} {what} loss: card {got} "
                                     f"!= cpu {want} (tol {tol}, cpu "
                                     f"spread {spread})")
        out[arch + "".join(f"+{k}={v}" for k, v in kw.items())] = {
            "px": px, "cpu": [ct, ce], "card": [gt, ge],
            "held": [w for w, _, _ in held], "tol": tol,
            **({"cpu_one_ulp_spread": spread} if int8 else {})}
    return out


def imagefolder_path(torch, kernels, device_rate, device="cuda"):
    """11d: where the native library found libjpeg, the data-rate tool
    over an 8-class tree of 500 x 375 JPEGs and 2 steps of script 6 over
    the same tree, every JPEG through the native decoder; where it did
    not, ``dataset="imagenet"`` over a JPEG tree takes the PIL route (PIL
    present) or raises naming both libraries."""
    from tpu_dist_torch import native
    from tpu_dist_torch.scripts import distributed_slurm
    from tpu_dist_torch.tools import data_rate

    probe = {"decode_available": native.decode_available(),
             "pil": importable("PIL")}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "tree")
        if not probe["decode_available"] and not probe["pil"]:
            for split in ("train", "val"):
                os.makedirs(os.path.join(root, split, "c0"))
                with open(os.path.join(root, split, "c0", "0.jpg"),
                          "wb") as f:
                    f.write(b"\xff\xd8 no decoder on this host")
            try:
                distributed_slurm.main(["--device", device, "--data", root,
                                        "--arch", "resnet18",
                                        "--batch-size", "1", "--log-csv", "",
                                        "--checkpoint-dir",
                                        os.path.join(tmp, "ck")])
            except RuntimeError as e:
                if "libjpeg" not in str(e) or "PIL" not in str(e):
                    raise
                return {**probe, "refused": str(e)[:200]}, {}
            raise AssertionError("an ImageFolder of JPEGs trained with no "
                                 "decoder on the host")
        rate = data_rate.main([
            "--device", device, "--root", root, "--classes",
            str(FOLDER_CLASSES), "--images", str(FOLDER_IMAGES),
            "--batch", str(FOLDER_BATCH), "--seconds", "2",
            "--device-rate", str(device_rate)])
        kernels.reset_launches()
        tr = distributed_slurm.main([
            "--device", device, "--data", f"{root}_500",
            "--batch-size", str(FOLDER_BATCH), "--epochs", "1",
            "--print-freq", "1", "--log-csv", "", "--workers", "4",
            "--checkpoint-dir", os.path.join(tmp, "ck")])
        launches = dict(kernels.LAUNCHES)
    steps = FOLDER_IMAGES // FOLDER_BATCH
    if tr.state.step != steps or tr.num_classes != FOLDER_CLASSES:
        raise AssertionError(f"11d: {tr.state.step} of {steps} steps, "
                             f"{tr.num_classes} classes")
    served = {"train": dict(tr.train_ds.routes),
              "val": dict(tr.val_ds.routes)}
    if probe["decode_available"]:
        if any(r["pil"] for r in served.values()) or \
                rate["routes"]["folder"]["pil"]:
            raise AssertionError(f"11d: a JPEG took the PIL route: {served}")
    elif any(r["native"] for r in served.values()):
        raise AssertionError(f"11d: native decode without libjpeg {served}")
    return {**probe, "data_rate": rate, "steps": steps,
            "routes": served, "val_acc1": tr.best_acc1,
            "train_img_per_s": tr.last_img_s}, launches


# ---- phase 12: the LM's model-parallel axes ---------------------------------

P12_STEPS = 2
# (a) phase 6's LM at batch 4 in each mode, two ranks sharing the card
P12_MODES = {
    "fsdp": dict(mesh_shape=[2], mesh_axes=["data"], fsdp=True),
    "tp": dict(mesh_shape=[1, 2], mesh_axes=["data", "model"]),
    "tp-ring": dict(mesh_shape=[1, 2], mesh_axes=["data", "model"],
                    tp_impl="ring"),
    "sp-ring": dict(mesh_shape=[1, 2], mesh_axes=["data", "seq"])}
# (b) the reference's on-chip MoE geometry (BASELINE.md:296): 8 layers,
# d_model 512, 8 experts, top-2, L1024, bf16, flash; V32000 as phase 6
P12_MOE = dict(vocab_size=32000, num_layers=8, d_model=512, num_heads=8,
               seq_len=1024, batch_size=8, num_experts=8, router_top_k=2,
               precision="bf16", attn="flash", optimizer="fused_adamw",
               lr=1e-3, weight_decay=0.1, grad_clip=1.0,
               synth_tokens=200_000, seed=SEED)
P12_EP = dict(mesh_shape=[1, 2], mesh_axes=["data", "expert"])
# (c) tiny fp32 trainers, card ranks against CPU ranks (phase 10c's LM with
# two heads, so the model axis splits them)
P12_TINY = dict(batch_size=4, seq_len=96, d_model=128, num_layers=2,
                num_heads=2, vocab_size=64, synth_tokens=4000, seed=SEED,
                attn="flash", optimizer="fused_adamw", lr=3e-3,
                grad_clip=0.5, weight_decay=0.1, max_steps=5, print_freq=1)
P12_TINY_MODES = {**P12_MODES,
                  "ep-moe": dict(P12_EP, num_experts=4, moe_group_size=96)}
P12_TINY_EPTP = dict(mesh_shape=[1, 2, 2],
                     mesh_axes=["data", "expert", "model"], num_experts=4,
                     moe_group_size=96)
FIXTURE = os.path.join("tests", "fixtures", "torch_tiny_lm.msgpack")


def mp_lm_job(torch, kernels, job, out, rank):
    """One phase-12 trainer fit on this rank (the kernel counts, the
    host-staged transfers and the collective seconds reset just before
    it): its losses, launches, peak memory, mode, step time and the share
    of it spent in the model-parallel collectives."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.parallel import collectives as C

    device = job["device"]
    if device != "cpu":
        free_device(torch)
        torch.cuda.reset_peak_memory_stats()
    ledger = os.path.join(out, f"{job['name']}.r{rank}.jsonl")
    init = None
    if job.get("init"):
        with open(job["init"], "rb") as f:
            init = torch.load(f, weights_only=False)
    tr = LMTrainer(LMConfig(**{**job["cfg"], "ledger_path": ledger}),
                   device=device, init_params=init)
    kernels.reset_launches()
    C.P2P_HOST_STAGED["calls"] = 0
    C.COMM_SECONDS["s"] = 0.0
    t0 = time.perf_counter()
    tr.fit()
    if device != "cpu":
        torch.cuda.synchronize()
    steps = ledger_steps(ledger) if tr.is_main else []   # rank 0 writes
    losses = [r["loss"] for r in steps]
    step_s = statistics.median([r["data_s"] + r["dispatch_s"]
                                + r["device_s"] for r in steps[1:]]
                               or [0.0])
    res = {"mode": tr.mode, "step": tr.state.step, "losses": losses,
           "launches": dict(kernels.LAUNCHES),
           "p2p_host_staged": C.P2P_HOST_STAGED["calls"],
           "p2p_route": (C.p2p_route(tr.mesh.group(
               "stage" if tr.use_pp else "seq" if tr.use_sp else "model"),
               tr.device) if tr.use_sp or tr.use_ring or tr.use_pp
                         else None),
           "comm_s": C.COMM_SECONDS["s"], "wall_s": time.perf_counter() - t0,
           "step_ms": step_s * 1e3, "local_batch": tr.local_batch,
           "eval_batches": len(tr._epoch_indices(tr.val_ds, False, 0)[0]),
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if device != "cpu" else None)}
    if tr.cfg.num_experts:
        res["router_mass"] = [r.get("router_mass") for r in steps]
        res["router_aux"] = [r.get("router_aux") for r in steps]
    if tr.pipe is not None:
        res["pp"] = {"work": dict(tr.pipe.work),
                     "stash_peak": tr.pipe.stash_peak}
    return res


def check_parallel_shapes(torch):
    """12e: each kernel of phase 12's path against its plain version at the
    shapes the modes give it (a generator of its own): the flash forward
    and backward at tp's heads a rank (B4 L2048 H4 D128) and at the MoE
    LM's (B8 L1024 H8 D64); ``adamw`` over a rank's leaves under fsdp
    (``data=2``) and under tp (``model=2``) of phase 6's LM, each as one
    multi-leaf call with the clip slot live; ``fused_quant`` bit-equal at
    12b's expert products (M = 16 groups x 160 slots, w_in and w_out)."""
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.ops import pallas_adamw as pa
    from tpu_dist_torch.ops import pallas_quant as pq
    from tpu_dist_torch.parallel.fsdp import fsdp_specs
    from tpu_dist_torch.parallel.tp import lm_param_specs

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    rec = {"flash": {}, "adamw": {}, "fused_quant": {}}
    for label, (b, lq, h, d) in (("tp heads a rank", (4, 2048, 4, 128)),
                                 ("moe lm", (8, 1024, 8, 64))):
        fwd, _ = check_flash_shape(torch, gen, b, lq, lq, h, d)
        bwd, _ = check_flash_bwd_shape(torch, gen, b, lq, lq, h, d)
        rec["flash"][label] = {"forward": fwd, "backward": bwd}
    model = TransformerLM(vocab_size=32000, num_layers=8, d_model=1024,
                          num_heads=8, max_len=2048, device="cpu", seed=None)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    del model
    row = pa.scalar_row(1e-3, 0.9, 0.95, 1e-8, 0.1, 3,
                        torch.tensor(0.5, device="cuda"))
    for label, specs in (("fsdp data=2", fsdp_specs(shapes, 2)),
                         ("tp model=2", lm_param_specs(shapes))):
        # a rank's shard of each leaf (each sharded dim halved)
        local = [tuple(d // 2 if a else d for d, a in zip(shape, specs[n]))
                 for n, shape in shapes]
        p, g, m = ([torch.randn(s, generator=gen, device="cuda")
                    for s in local] for _ in range(3))
        v = [torch.rand(s, generator=gen, device="cuda") * 1e-6
             for s in local]
        m = [t * 1e-3 for t in m]
        err = adamw_case(torch, p, g, m, v, row)
        rec["adamw"][label] = {"leaves": len(local), "elements": sum(
            math.prod(s) for s in local), "max_abs_err": err}
        del p, g, m, v
    cap = int(512 / P12_MOE["num_experts"] * P12_MOE.get(
        "moe_capacity_factor", 1.25) * P12_MOE["router_top_k"])
    rows = P12_MOE["batch_size"] * P12_MOE["seq_len"] // 512 * cap
    for label, (k, n) in (("expert w_in", (512, 2048)),
                          ("expert w_out", (2048, 512))):
        x = torch.randn((rows, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / math.sqrt(k)).to(torch.bfloat16)
        out, ref = pq.fused_quant_cuda(x, w), pq.fused_quant_matmul_plain(x, w)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"12e fused_quant {label}: not bit-equal")
        rec["fused_quant"][label] = {"shape": f"M{rows} K{k} N{n} bf16",
                                     "bit_equal": True}
    return rec


def p12_close(tag, got, want, tol, steps=None):
    return dp_close(f"12{tag}", got, want, tol, steps)


def warm_start_fixture(torch):
    """12d: the reference's tiny msgpack checkpoint (committed, rebuilt
    and held leaf by leaf in tests/test_torch_msgpack.py) warm-started on
    the card and on the CPU: fp32 logits within LOSS_TOL (1 + |x|)."""
    from tpu_dist_torch.engine import checkpoint as ckpt
    from tpu_dist_torch.models.transformer import tiny_lm

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, FIXTURE)
    with open(path, "rb") as f:
        raw = f.read()
    meta, _ = ckpt._split_container(raw, ckpt._REF_MAGIC)
    logits = {}
    for dev in ("cuda", "cpu"):
        m = tiny_lm(vocab_size=meta["vocab_size"],
                    num_layers=meta["num_layers"], d_model=meta["d_model"],
                    num_heads=meta["num_heads"], max_len=meta["seq_len"],
                    device=dev, seed=None)
        params, _, _ = ckpt.load_warmstart(path, m)
        n, skipped = ckpt.graft_params(m.named_parameters(), params)
        if skipped:
            raise AssertionError(f"12d: leaves not grafted: {skipped}")
        tokens = torch.arange(2 * meta["seq_len"]).reshape(2, -1) \
            % meta["vocab_size"]
        with torch.no_grad():
            logits[dev] = m(tokens.to(dev)).float().cpu()
    diff = (logits["cuda"] - logits["cpu"]).abs()
    bound = LOSS_TOL * (1 + logits["cpu"].abs())
    if not bool((diff <= bound).all()) or not torch.isfinite(
            logits["cuda"]).all():
        raise AssertionError(f"12d: card logits off the CPU's by "
                             f"{float(diff.max())}")
    return {"fixture": FIXTURE, "leaves": n, "max_abs_diff":
            float(diff.max()), "tolerance": f"{LOSS_TOL} (1 + |x|)",
            "meta": {k: meta[k] for k in ("vocab_size", "num_layers",
                                           "d_model", "num_heads",
                                           "seq_len")}}


def moe_decode_bench(torch, kernels):
    """12b: the decode bench's one-shot mode with ``--num-experts 4`` at
    its geometry (8L/d1024/V32k, batch 8, prompt 128; BASELINE.md:644-651)
    cut from 384 steps to P9E_STEPS, one trial."""
    import contextlib
    import io

    from tpu_dist_torch.tools import decode_bench

    argv = ["--num-experts", "4", "--trials", "1", "--requests", "2",
            "--steps", str(P9E_STEPS)]
    kernels.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        decode_bench.main(argv)
    torch.cuda.synchronize()
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if line["num_experts"] != 4 or not line["kv_cache"] > 0 or \
            line["device"]["platform"] != "gpu":
        raise AssertionError(f"12b decode bench: {line}")
    return {"argv": " ".join(argv), "line": line,
            "wall_s": time.perf_counter() - t0}, dict(kernels.LAUNCHES)


def model_parallel_path(torch, kernels, tmp):
    """Phase 12 (module docstring). Returns (record, launches by run)."""
    from tpu_dist_torch.interop import export_flax_params
    from tpu_dist_torch.models.moe import MoETransformerLM
    from tpu_dist_torch.models.transformer import TransformerLM

    free_device(torch)
    t0 = time.perf_counter()
    layers = 8
    full = dataclasses.asdict(full_lm_config(
        batch_size=4, max_steps=P12_STEPS, print_freq=1))
    # one set of initial weights for the tiny card and CPU runs
    inits = {}
    for name, model in (
            ("dense", TransformerLM(vocab_size=64, num_layers=2, d_model=128,
                                    num_heads=2, max_len=96, device="cpu",
                                    seed=SEED)),
            ("moe", MoETransformerLM(vocab_size=64, num_layers=2,
                                     d_model=128, num_heads=2, num_experts=4,
                                     max_len=96, group_size=96,
                                     device="cpu", seed=SEED))):
        inits[name] = os.path.join(tmp, f"p12_{name}_init.pt")
        torch.save(export_flax_params(model), inits[name])

    def tiny(mode, kw):
        return {"name": f"tiny_{mode}", "kind": "lm12",
                "init": inits["moe" if "num_experts" in kw else "dense"],
                "cfg": {**P12_TINY, **kw}}

    tiny2 = [tiny(m, kw) for m, kw in P12_TINY_MODES.items()]
    tiny4 = [tiny("ep-moe+tp", P12_TINY_EPTP)]
    # the CPU twins run beside the card groups
    cpu2 = DpGroup("p12_cpu2", 2, "cpu", "gloo", tiny2, tmp)
    cpu4 = DpGroup("p12_cpu4", 4, "cpu", "gloo", tiny4, tmp)
    try:
        # one rank over nccl (the dp twin of 12a, dp-moe with and without
        # int8), two ranks and four, side by side: their step times share
        # the card
        groups = [DpGroup("p12_one", 1, "cuda", "nccl", [
            {"name": "dp", "kind": "lm12", "cfg": full},
            {"name": "dp-moe", "kind": "lm12",
             "cfg": dict(P12_MOE, max_steps=P12_STEPS, print_freq=1)},
            {"name": "dp-moe-int8", "kind": "lm12",
             "cfg": dict(P12_MOE, quant="int8", max_steps=2,
                         print_freq=1)}], tmp),
            DpGroup("p12_two", 2, "cuda", "gloo", [
                *({"name": m, "kind": "lm12", "cfg": {**full, **kw}}
                  for m, kw in P12_MODES.items()),
                {"name": "ep-moe", "kind": "lm12",
                 "cfg": dict(P12_MOE, max_steps=P12_STEPS, print_freq=1,
                             **P12_EP)},
                *tiny2], tmp),
            DpGroup("p12_four", 4, "cuda", "gloo", tiny4, tmp)]
        # the decode bench and the warm start in this process meanwhile
        try:
            decode, decode_launches = moe_decode_bench(torch, kernels)
            warm = warm_start_fixture(torch)
        except BaseException:
            for g in groups:
                g.kill()
            raise
        one, two, four = wait_groups(groups, (300, 600, 240))
        one = one[0]
    finally:
        res_cpu2, res_cpu4 = cpu2.wait(300), cpu4.wait(120)
    shapes = check_parallel_shapes(torch)

    # (a) each mode against the one-rank dp run
    dp = one["dp"]
    l0 = dp["losses"][0]
    n_eval = dp["eval_batches"]
    a = {"dp_1rank_nccl": {k: dp[k] for k in (
        "losses", "step_ms", "peak_mem_gb")}}
    for mode in P12_MODES:
        got = [r[mode] for r in two]
        r0 = got[0]
        if {g["mode"] for g in got} != {mode}:
            raise AssertionError(f"12a {mode}: modes {[g['mode'] for g in got]}")
        ls = r0["losses"]
        if len(ls) != P12_STEPS or not all(map(math.isfinite, ls)) or \
                not ls[-1] < ls[0] or abs(ls[0] - l0) > BF16_TOL * (1 + abs(l0)):
            raise AssertionError(f"12a {mode}: losses {ls} vs dp step 0 {l0}")
        flash = 0 if mode == "sp-ring" else layers
        want = {"flash_bwd_dq": flash * P12_STEPS,
                "flash_bwd_dkv": flash * P12_STEPS,
                "flash_fwd": flash * (P12_STEPS + r0["eval_batches"]),
                "adamw": P12_STEPS}
        for r, g in enumerate(got):
            bad = {k: (g["launches"][k], n) for k, n in want.items()
                   if g["launches"][k] != n}
            if bad:
                raise AssertionError(f"12a {mode} rank {r}: launches {bad}")
            if mode in ("fsdp", "tp") and not g["peak_mem_gb"] < \
                    dp["peak_mem_gb"]:
                raise AssertionError(f"12a {mode} rank {r}: peak "
                                     f"{g['peak_mem_gb']} GB not below dp's "
                                     f"{dp['peak_mem_gb']}")
        # ppermute hops a forward: the ring tp's four products a layer,
        # ring attention's one K/V hop a layer; as many again backward
        hops = {"tp-ring": 4 * layers, "sp-ring": layers}.get(mode, 0)
        staged = [g["p2p_host_staged"] for g in got]
        want_staged = hops * (2 * P12_STEPS + r0["eval_batches"])
        if staged != [want_staged] * 2:
            raise AssertionError(f"12a {mode}: host-staged ppermute calls "
                                 f"{staged}, expected {want_staged}")
        a[mode] = {"losses": ls, "dp_step0_loss": l0,
                   "step_ms_gloo": r0["step_ms"],
                   "collective_share_of_wall": [
                       g["comm_s"] / g["wall_s"] for g in got],
                   "peak_mem_gb_per_rank": [g["peak_mem_gb"] for g in got],
                   "launches_per_rank": [
                       {k: g["launches"][k] for k in want} for g in got],
                   "p2p_host_staged_per_rank": staged,
                   "p2p_route": r0["p2p_route"],
                   "local_batch": r0["local_batch"]}
    # (b) MoE: ep against dp-moe, int8 through fused_quant
    dm, q8 = one["dp-moe"], one["dp-moe-int8"]
    ep = [r["ep-moe"] for r in two]
    m0 = dm["losses"][0]
    for tag, ls in (("dp-moe", dm["losses"]), ("ep-moe", ep[0]["losses"])):
        if len(ls) != P12_STEPS or not all(map(math.isfinite, ls)) or \
                abs(ls[0] - m0) > BF16_TOL * (1 + abs(m0)):
            raise AssertionError(f"12b {tag}: losses {ls} vs dp-moe {m0}")
    if {g["mode"] for g in ep} != {"ep-moe"} or dm["mode"] != "dp-moe":
        raise AssertionError(f"12b modes {dm['mode']}, "
                             f"{[g['mode'] for g in ep]}")
    moe_layers, experts = P12_MOE["num_layers"], P12_MOE["num_experts"]
    # a forward: qkv, proj and two matmuls per expert a layer, the head
    per_fwd = moe_layers * (2 + 2 * experts) + 1
    want_q = per_fwd * (2 + q8["eval_batches"])
    if q8["launches"]["fused_quant"] != want_q or not all(
            map(math.isfinite, q8["losses"])):
        raise AssertionError(f"12b int8: fused_quant "
                             f"{q8['launches']['fused_quant']} (want "
                             f"{want_q}), losses {q8['losses']}")
    b = {"dp_moe_1rank_nccl": {k: dm[k] for k in (
            "losses", "router_aux", "router_mass", "step_ms",
            "peak_mem_gb")},
         "ep_moe_2rank_gloo": {
             "losses": ep[0]["losses"], "router_aux": ep[0]["router_aux"],
             "router_mass": ep[0]["router_mass"],
             "dropped_share_top2": [1 - m for m in ep[0]["router_mass"]],
             "step_ms_gloo": ep[0]["step_ms"],
             "peak_mem_gb_per_rank": [g["peak_mem_gb"] for g in ep],
             "launches_per_rank": [{k: g["launches"][k] for k in (
                 "flash_fwd", "flash_bwd_dq", "adamw")} for g in ep]},
         "dp_moe_int8": {"losses": q8["losses"],
                         "fused_quant_calls": q8["launches"]["fused_quant"],
                         "fused_quant_per_forward": per_fwd,
                         "step_ms": q8["step_ms"]},
         "decode_bench_num_experts_4": decode}
    # (c) tiny fp32 trainers, card ranks against CPU ranks
    c = {}
    for name, card, cpu in (
            *((t["name"], two[0][t["name"]], res_cpu2[0][t["name"]])
              for t in tiny2),
            ("tiny_ep-moe+tp", four[0]["tiny_ep-moe+tp"],
             res_cpu4[0]["tiny_ep-moe+tp"])):
        diff = p12_close(f"c {name}", card["losses"], cpu["losses"],
                         LOSS_TOL)
        c[name] = {"card": card["losses"], "cpu": cpu["losses"],
                   "mode": card["mode"], "max_abs_diff": diff}
    record = {"a_full_width_2rank_gloo": a, "b_moe": b,
              "c_small_card_vs_cpu": c, "d_warm_start": warm,
              "e_kernels_at_phase12_shapes": shapes,
              "wall_s": time.perf_counter() - t0,
              "note": "two ranks share one card over gloo with CUDA "
                      "tensors: step times measure gloo's host staging, "
                      "not the parallel mode; no scaling is measured"}
    by_path = {f"p12_{m}_rank0": two[0][m]["launches"] for m in P12_MODES}
    by_path.update({"p12_dp_1rank": dp["launches"],
                    "p12_dp_moe_1rank": dm["launches"],
                    "p12_dp_moe_int8_1rank": q8["launches"],
                    "p12_ep_moe_rank0": ep[0]["launches"],
                    "p12_decode_bench_moe": decode_launches})
    return record, by_path


# ---- phase 13: pipeline parallelism, sharded decode, ViT ring ---------------

P13_STEPS = 2
# (b)-(d): one step each (their gates hold step 0 and the launches)
P13_SHORT = 1
# (a) phase 6's LM at full width on data=1,stage=2: M microbatches of 2
# sequences (batch 2M), so the stash 1F1B bounds and the graphs GPipe keeps
# both scale with M
P13_PP = dict(mesh_shape=[1, 2], mesh_axes=["data", "stage"])
P13_PPTP = dict(mesh_shape=[1, 2, 2], mesh_axes=["data", "stage", "model"])
P13_TP = dict(mesh_shape=[1, 2], mesh_axes=["data", "model"])
# (g) ViT-B/16 on the synthetic 224 px, 1000-class set: one step of 128
P13_VIT = dict(VIT_INT8, quant="none", synth_train_size=128,
               synth_val_size=128, print_freq=1, workers=1)
# (e) tiny fp32 runs, card ranks against CPU ranks
P13_TINY_VIT = dict(arch="vit_cifar", dataset="cifar10", precision="fp32",
                    optimizer="sgd", batch_size=8, synth_train_size=16,
                    synth_val_size=8, epochs=1, seed=SEED, print_freq=1,
                    workers=1, lr=0.01)
# (f) the decode bench's one-shot mode at phase 5's model, its depth of
# decode cut to 64 tokens of one trial (the full recompute skipped)
P13_DECODE_ARGV = ["--batch", "8", "--prompt-len", "128", "--steps", "64",
                   "--trials", "1", "--requests", "1", "--skip-full",
                   "--backend", "gloo"]
P13_TINY_DECODE = dict(vocab_size=64, num_layers=2, d_model=64, num_heads=4,
                       max_len=32)
# (d) fused_quant's scaled pair at the tp row products of 12a's LM at batch
# 4 (M = 4 x 2048 tokens; K = this rank's half of the contracted dim)
P13_SCALED_SHAPES = {"proj (tp rank)": (8192, 512, 1024),
                     "mlp_out (tp rank)": (8192, 2048, 1024)}
# the one-call fused_quant on this phase's paths at shapes no earlier phase
# holds: 13d's column products and vocab-sharded head (a rank's half of N),
# and 13g's ViT-B/16 ring_ar at batch 128 (M = 128 x 197 tokens; columns a
# rank's half of N, rows a rank's half of K, each quantized by its own
# scales as the reference's ring does)
P13_FQ_SHAPES = {"tp qkv (tp rank)": (8192, 1024, 1536),
                 "tp mlp_in (tp rank)": (8192, 1024, 2048),
                 "tp head (vocab shard)": (8192, 1024, 16000),
                 "vit ring qkv (rank)": (25216, 768, 1152),
                 "vit ring proj (rank)": (25216, 384, 768),
                 "vit ring mlp_in (rank)": (25216, 768, 1536),
                 "vit ring mlp_out (rank)": (25216, 1536, 768)}


def p13_image_job(torch, kernels, job, out, rank):
    """One phase-13 image ``Trainer`` fit on this rank (the kernel counts
    reset just before it): its losses, launches, peak memory, mode."""
    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine.loop import Trainer
    from tpu_dist_torch.parallel import collectives as C

    device = job["device"]
    if device != "cpu":
        free_device(torch)
        torch.cuda.reset_peak_memory_stats()
    ledger = os.path.join(out, f"{job['name']}.r{rank}.jsonl")
    cfg = TrainConfig(**{**job["cfg"], "ledger_path": ledger, "log_csv": "",
                         "checkpoint_dir": os.path.join(
                             out, f"ck-{job['name']}-{rank}"),
                         "data": os.path.join(out, "no-data")})
    init = (None, None)
    if job.get("init"):     # one set of weights for the card and the CPU
        with open(job["init"], "rb") as f:
            init = torch.load(f, weights_only=False)
    tr = Trainer(cfg, device=device, init_params=init[0],
                 init_batch_stats=init[1])
    kernels.reset_launches()
    C.P2P_HOST_STAGED["calls"] = 0
    t0 = time.perf_counter()
    tr.fit()
    if device != "cpu":
        torch.cuda.synchronize()
    steps = ledger_steps(ledger) if tr.is_main else []
    return {"losses": [r["loss"] for r in steps],
            "launches": dict(kernels.LAUNCHES), "step": tr.state.step,
            "p2p_host_staged": C.P2P_HOST_STAGED["calls"],
            "wall_s": time.perf_counter() - t0,
            "step_ms": statistics.median([
                r["data_s"] + r["dispatch_s"] + r["device_s"]
                for r in steps] or [0.0]) * 1e3,
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if device != "cpu" else None)}


def p13_decode_job(torch, kernels, job, out, rank):
    """Tiny fp32 sharded greedy decode (``generate(mesh=)``) of a seeded
    LM over the whole group: the buffer."""
    from tpu_dist_torch.engine.generate import generate
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.parallel.mesh import make_mesh

    device = job["device"]
    mesh = make_mesh(job["shape"], job["axes"], device=device)
    model = p13_tiny_decoder(mesh.device)
    buf = generate(model, p13_prompt(), 12, use_cache=True, mesh=mesh)
    return {"tokens": buf.cpu().tolist()}


def p13_tiny_decoder(device):
    """The tiny decode LM, its weights drawn on the CPU (a CUDA generator
    draws other numbers from the same seed) and moved to ``device``."""
    from tpu_dist_torch.models.transformer import TransformerLM

    return TransformerLM(device="cpu", seed=SEED,
                         **P13_TINY_DECODE).to(device)


def p13_prompt():
    import numpy as np

    return np.random.default_rng(SEED + 13).integers(
        0, P13_TINY_DECODE["vocab_size"], (4, 8)).astype(np.int32)


def p13_decode_bench(flags, device="cuda"):
    """13f: start the decode bench's one-shot mode at phase 5's model over
    two ranks sharing the card (the bench starts them itself);
    :func:`p13_decode_result` reads its JSON."""
    here = os.path.dirname(os.path.abspath(__file__))
    return flags, device, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.tools.decode_bench", *flags,
         *P13_DECODE_ARGV, "--device", device], cwd=here,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=here))


def p13_decode_result(bench):
    flags, device, t0, proc = bench
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"13f decode bench {flags}: rc "
                             f"{proc.returncode}, {len(lines)} JSON lines; "
                             f"{err[-2000:]}")
    line = json.loads(lines[0])
    want = {"tp": 0, "dp": 0, **{f[2:]: int(v) for f, v in
                                 zip(flags[::2], flags[1::2])}}
    platform = "gpu" if device == "cuda" else "cpu"
    if line["tp"] != want["tp"] or line["dp"] != want["dp"] or \
            not line["kv_cache"] > 0 or line["device"]["platform"] != platform:
        raise AssertionError(f"13f decode bench {flags}: {line}")
    return {"argv": " ".join(flags + P13_DECODE_ARGV),
            "kv_cache_tokens_per_s": line["kv_cache"],
            "latency_ms": line["latency_ms"], "batch": line["batch"],
            "steps": line["steps"], "layers": line["layers"],
            "d_model": line["d_model"], "wall_s": time.perf_counter() - t0}


def check_pp_shapes(torch):
    """13 kernel check: the flash triple at a stage's microbatch (B2 L2048
    H8 D128) and at pp x tp's (B1 L2048, 4 heads a rank), ``adamw`` over a
    stage's leaves (4 blocks, the embeddings, ``ln_f`` and the head of
    phase 6's LM) with its clip slot off, as the pp step runs it, and the
    one-call ``fused_quant`` bit-equal at ``P13_FQ_SHAPES``."""
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.ops import pallas_adamw as pa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rec = {"flash": {}, "adamw": {}}
    for label, (b, lq, h, d) in (("pp stage microbatch", (2, 2048, 8, 128)),
                                 ("pp x tp microbatch", (1, 2048, 4, 128))):
        fwd, _ = check_flash_shape(torch, gen, b, lq, lq, h, d)
        bwd, _ = check_flash_bwd_shape(torch, gen, b, lq, lq, h, d)
        rec["flash"][label] = {"forward": fwd, "backward": bwd}
    model = TransformerLM(vocab_size=32000, num_layers=8, d_model=1024,
                          num_heads=8, max_len=2048, device="cpu", seed=None)
    shapes = [tuple(p.shape) for n, p in model.named_parameters()
              if not n.startswith("blocks.") or int(n.split(".")[1]) < 4]
    del model
    row = pa.scalar_row(1e-3, 0.9, 0.95, 1e-8, 0.1, 3,
                        torch.tensor(1.0, device="cuda"))
    p, g, m = ([torch.randn(s, generator=gen, device="cuda") for s in shapes]
               for _ in range(3))
    v = [torch.rand(s, generator=gen, device="cuda") * 1e-6 for s in shapes]
    m = [t * 1e-3 for t in m]
    rec["adamw"]["a stage's leaves"] = {
        "leaves": len(shapes), "elements": sum(math.prod(s) for s in shapes),
        "max_abs_err": adamw_case(torch, p, g, m, v, row)}
    del p, g, m, v
    rec["fused_quant"] = check_fused_quant_training(torch, P13_FQ_SHAPES,
                                                    SEED + 131)
    return rec


def check_scaled_pair(torch):
    """13d: ``fused_quant``'s two phases apart at the tp row products: the
    maxima bit-equal to the plain version's; scaled by them, the product
    bit-equal to the one-call kernel; scaled by a group's larger maxima,
    bit-equal to the plain pair. Timed beside the one-call kernel."""
    from tpu_dist_torch.ops import pallas_quant as pq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 130)
    recs = {}
    for label, (m, k, n) in P13_SCALED_SHAPES.items():
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / math.sqrt(k)).to(torch.bfloat16)
        xa, wa = pq.fused_quant_amax_cuda(x, w)
        pxa, pwa = pq.fused_quant_amax_plain(x, w)
        local = pq.fused_quant_scaled_cuda(x, w, xa, wa)
        one = pq.fused_quant_cuda(x, w)
        gxa = xa * (1 + torch.rand(m, generator=gen, device="cuda"))
        gwa = wa * (1 + torch.rand(n, generator=gen, device="cuda"))
        out = pq.fused_quant_scaled_cuda(x, w, gxa, gwa)
        ref = pq.fused_quant_scaled_plain(x, w, gxa, gwa)
        torch.cuda.synchronize()
        if not (torch.equal(xa, pxa) and torch.equal(wa, pwa)):
            raise AssertionError(f"13d amax {label}: not bit-equal")
        if not torch.equal(local, one):
            raise AssertionError(f"13d scaled {label}: local maxima not "
                                 "bit-equal to the one-call kernel")
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"13d scaled {label}: max|err| {err}, "
                                 "expected bit-equal")
        amax_ms = time_ms(torch, lambda: pq.fused_quant_amax_cuda(x, w))
        scaled_ms = time_ms(torch, lambda: pq.fused_quant_scaled_cuda(
            x, w, gxa, gwa))
        one_ms = time_ms(torch, lambda: pq.fused_quant_cuda(x, w))
        amax_plain = time_ms(torch, lambda: pq.fused_quant_amax_plain(x, w),
                             iters=5)
        scaled_plain = time_ms(torch, lambda: pq.fused_quant_scaled_plain(
            x, w, gxa, gwa), iters=5)
        lib_ms = time_ms(torch, lambda: torch.matmul(x, w))
        # amax reads x and w once and writes the maxima; the scaled product
        # reads x, w and the maxima and writes out, and does the int8 dot
        a_bytes = 2 * (m * k + k * n) + 4 * (m + n)
        s_bytes = 2 * (m * k + k * n + m * n) + 4 * (m + n)
        s_ops = 2.0 * m * n * k
        t_ops, t_bytes = s_ops / PEAK_INT8_OPS, s_bytes / PEAK_BYTES
        lib = ("none: no one PyTorch call computes this function; "
               "yardstick_ms times the bf16 torch.matmul of the unquantized "
               "operands")
        recs[label] = {
            "amax": {"shape": f"{label}: M{m} K{k} N{n} bf16",
                     "max_abs_err": 0.0, "tolerance": "bit-equal",
                     "ms": amax_ms, "plain_ms": amax_plain,
                     "bound_ms": a_bytes / PEAK_BYTES * 1e3,
                     "bound_by": "bytes", "library_ms": None},
            "scaled": {"shape": f"{label}: M{m} K{k} N{n} bf16",
                       "max_abs_err": err, "tolerance": "bit-equal",
                       "ms": scaled_ms, "plain_ms": scaled_plain,
                       "bound_ms": max(t_ops, t_bytes) * 1e3,
                       "bound_by": ("operations" if t_ops >= t_bytes
                                    else "bytes"), "library_ms": None},
            "one_call_ms": one_ms, "pair_ms": amax_ms + scaled_ms,
            "yardstick_ms": lib_ms, "library": lib}
        del x, w, out, ref, one, local
    return recs


def p13_close(tag, got, want, tol):
    return dp_close(f"13{tag}", got, want, tol)


def pipeline_path(torch, kernels, tmp, device="cuda"):
    """Phase 13 (module docstring). Returns (record, launches by run).
    ``device="cpu"`` rehearses its control flow on the CPU (the memory
    and host-staging checks, and the kernel checks, are the card's)."""
    from tpu_dist_torch.interop import (export_flax_image_params,
                                        export_flax_params)
    from tpu_dist_torch.models.moe import MoETransformerLM
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.models.vit import ViTCifar

    card_run = device == "cuda"
    if card_run:
        free_device(torch)
    t0 = time.perf_counter()
    stage_layers = 4          # 8 layers over 2 stages
    # one set of initial weights for each tiny card and CPU run, drawn on
    # the CPU
    inits = {}
    for name, tree in (
            ("dense", export_flax_params(TransformerLM(
                vocab_size=64, num_layers=2, d_model=128, num_heads=2,
                max_len=96, device="cpu", seed=SEED))),
            ("moe", export_flax_params(MoETransformerLM(
                vocab_size=64, num_layers=2, d_model=128, num_heads=2,
                num_experts=4, max_len=96, group_size=96, device="cpu",
                seed=SEED))),
            ("vit", export_flax_image_params(ViTCifar(
                num_classes=10, image_shape=(32, 32, 3), device="cpu",
                seed=SEED)))):
        inits[name] = os.path.join(tmp, f"p13_{name}_init.pt")
        torch.save(tree, inits[name])

    def lm(name, steps=P13_STEPS, **kw):
        cfg = dataclasses.asdict(full_lm_config(max_steps=steps,
                                                print_freq=1))
        return {"name": name, "kind": "lm12", "cfg": {**cfg, **kw}}

    def moe(name, **kw):
        return {"name": name, "kind": "lm12",
                "cfg": {**P12_MOE, "max_steps": P13_SHORT, "print_freq": 1,
                        **kw}}

    def vit(name, **kw):
        return {"name": name, "kind": "image13", "cfg": {**P13_VIT, **kw}}

    ring = dict(tp_impl="ring", mesh_shape=[1, 2],
                mesh_axes=["data", "model"])
    tiny_lm_kw = dict(P12_TINY, max_steps=4)
    tiny = [
        {"name": "tiny_pp-gpipe", "kind": "lm12", "init": inits["dense"],
         "cfg": dict(tiny_lm_kw, pp_microbatches=2, **P13_PP)},
        {"name": "tiny_pp-1f1b", "kind": "lm12", "init": inits["dense"],
         "cfg": dict(tiny_lm_kw, pp_microbatches=2, pp_schedule="1f1b",
                     **P13_PP)},
        {"name": "tiny_moe_pp-1f1b", "kind": "lm12", "init": inits["moe"],
         "cfg": dict(tiny_lm_kw, pp_microbatches=2, pp_schedule="1f1b",
                     num_experts=4, moe_group_size=96, **P13_PP)},
        {"name": "tiny_tp_int8", "kind": "lm12", "init": inits["dense"],
         "cfg": dict(tiny_lm_kw, quant="int8", optimizer="sgd", lr=0.05,
                     **P13_TP)},
        {"name": "tiny_vit_ring", "kind": "image13", "init": inits["vit"],
         "cfg": dict(P13_TINY_VIT, **ring)},
        *({"name": f"tiny_decode_{k}", "kind": "decode13", "shape": [2],
           "axes": [a]} for k, a in (("tp", "model"), ("dp", "data")))]
    tiny4 = [{"name": "tiny_pp-gpipe+tp", "kind": "lm12",
              "init": inits["dense"],
              "cfg": dict(tiny_lm_kw, pp_microbatches=2, **P13_PPTP)}]
    cpu2 = DpGroup("p13_cpu2", 2, "cpu", "gloo", tiny, tmp)
    cpu4 = DpGroup("p13_cpu4", 4, "cpu", "gloo", tiny4, tmp)
    # the two benches side by side with the groups (their tokens/s share
    # the card)
    benches = {k: p13_decode_bench(f, device) for k, f in (
        ("tp2", ["--tp", "2"]), ("dp2", ["--dp", "2"]))}
    try:
        # one rank over nccl: each mode's one-rank twin, beside the
        # two- and four-rank runs (their step times share the card)
        one = DpGroup("p13_one", 1, device, "nccl" if card_run else "gloo",
                      [
            lm("dp8", steps=1, batch_size=8),
            lm("dp4", steps=1, batch_size=4),
            lm("dp4_int8", steps=1, batch_size=4, quant="int8"),
            moe("dp-moe", max_steps=1),
            vit("vit"), vit("vit_int8", quant="int8")], tmp)
        two = DpGroup("p13_two", 2, device, "gloo", [
            lm("pp-gpipe", batch_size=8, pp_microbatches=4, **P13_PP),
            lm("pp-1f1b", batch_size=8, pp_microbatches=4,
               pp_schedule="1f1b", **P13_PP),
            lm("pp-gpipe_m8", steps=1, batch_size=16, pp_microbatches=8,
               **P13_PP),
            lm("pp-1f1b_m8", steps=1, batch_size=16, pp_microbatches=8,
               pp_schedule="1f1b", **P13_PP),
            moe("moe_pp-gpipe", pp_microbatches=4, **P13_PP),
            moe("moe_pp-1f1b", pp_microbatches=4, pp_schedule="1f1b",
                **P13_PP),
            lm("tp_int8", steps=P13_SHORT, batch_size=4, quant="int8",
               **P13_TP),
            vit("vit_ring", **ring), vit("vit_ring_int8", quant="int8",
                                         **ring),
            *tiny], tmp)
        try:
            decode = {k: p13_decode_result(b) for k, b in benches.items()}
            one = one.wait(400)[0]
            # the four ranks once the one-rank twin has freed its memory
            # (two's GPipe at M=8 holds about 40 GB)
            four = DpGroup("p13_four", 4, device, "gloo", [
                lm(f"pp-{s}+tp", steps=P13_SHORT, batch_size=4,
                   pp_microbatches=4,
                   pp_schedule=s, **P13_PPTP) for s in ("gpipe", "1f1b")
            ] + tiny4, tmp)
        except BaseException:
            for g in (one, two):
                if isinstance(g, DpGroup):
                    g.kill()
            raise
        two, four = wait_groups([two, four], (900, 600))
    finally:
        for _, _, _, proc in benches.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        res_cpu2, res_cpu4 = cpu2.wait(600), cpu4.wait(300)
    shapes = check_pp_shapes(torch) if card_run else {}
    scaled = check_scaled_pair(torch) if card_run else {}

    def gate(tag, ls, want0, n=P13_STEPS):
        if len(ls) != n or not all(map(math.isfinite, ls)) or \
                abs(ls[0] - want0) > BF16_TOL * (1 + abs(want0)):
            raise AssertionError(f"13{tag}: losses {ls} vs one rank's step "
                                 f"0 {want0}")

    def pp_launches(tag, got, m, sched, steps, layers=stage_layers):
        fwd = 2 if sched == "1f1b" else 1
        for r, g in enumerate(got):
            want = {"flash_fwd": layers * m * (fwd * steps
                                               + g["eval_batches"]),
                    "flash_bwd_dq": layers * m * steps,
                    "flash_bwd_dkv": layers * m * steps, "adamw": steps}
            bad = {k: (g["launches"][k], n) for k, n in want.items()
                   if g["launches"][k] != n}
            if bad and card_run:
                raise AssertionError(f"13{tag} rank {r}: launches {bad}")
            # every rank joins every hop: 2 a tick training, 1 evaluating
            ticks = m + 2 * (2 - 1) if sched == "1f1b" else 2 * (m + 1)
            hops = (ticks * 2 if sched == "1f1b" else ticks) * steps \
                + (m + 1) * g["eval_batches"]
            if card_run and g["p2p_host_staged"] != hops:
                raise AssertionError(f"13{tag} rank {r}: host-staged hops "
                                     f"{g['p2p_host_staged']}, want {hops}")
        return {k: [g["launches"][k] for g in got] for k in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "adamw")}

    # (a) pp at full width against the one-rank dp run at batch 8
    a = {"dp_1rank_nccl_batch8": one["dp8"]["losses"]}
    for sched in ("gpipe", "1f1b"):
        got = [r[f"pp-{sched}"] for r in two]
        if {g["mode"] for g in got} != {f"pp-{sched}"}:
            raise AssertionError(f"13a modes {[g['mode'] for g in got]}")
        gate(f"a pp-{sched}", got[0]["losses"], one["dp8"]["losses"][0])
        launches = pp_launches(f"a pp-{sched}", got, 4, sched, P13_STEPS)
        m8 = [r[f"pp-{sched}_m8"] for r in two]
        pp_launches(f"a pp-{sched} M8", m8, 8, sched, 1)
        peak = {"M4": [g["peak_mem_gb"] for g in got],
                "M8": [g["peak_mem_gb"] for g in m8]}
        ratio = [b / a_ for a_, b in zip(peak["M4"], peak["M8"])] \
            if card_run else [1.0]
        if sched == "1f1b" and max(ratio) > 1.25:
            raise AssertionError(f"13a 1f1b peak memory grows with M: "
                                 f"{peak}")
        if sched == "gpipe" and card_run and not min(ratio) > 1.0:
            raise AssertionError(f"13a gpipe peak memory does not grow "
                                 f"with M: {peak}")
        a[f"pp-{sched}"] = {
            "losses": got[0]["losses"], "step_ms_gloo": got[0]["step_ms"],
            "launches_per_rank": launches,
            "launches_per_rank_per_train_step": {
                "flash_fwd": stage_layers * 4 * (2 if sched == "1f1b"
                                                 else 1),
                "flash_bwd_dq": stage_layers * 4,
                "flash_bwd_dkv": stage_layers * 4, "adamw": 1},
            "p2p_host_staged_per_rank": [g["p2p_host_staged"] for g in got],
            "peak_mem_gb_per_rank": peak, "peak_ratio_m8_over_m4": ratio,
            "microbatch": 2, "eval_batches": got[0]["eval_batches"]}
    # (b) pp x tp on four ranks against the one-rank dp run at batch 4
    b = {"dp_1rank_nccl_batch4": one["dp4"]["losses"]}
    for sched in ("gpipe", "1f1b"):
        got = [r[f"pp-{sched}+tp"] for r in four[:4]]
        if {g["mode"] for g in got} != {f"pp-{sched}+tp"}:
            raise AssertionError(f"13b modes {[g['mode'] for g in got]}")
        gate(f"b pp-{sched}+tp", got[0]["losses"], one["dp4"]["losses"][0],
             n=P13_SHORT)
        b[f"pp-{sched}+tp"] = {
            "losses": got[0]["losses"], "step_ms_gloo": got[0]["step_ms"],
            "launches_per_rank": pp_launches(f"b pp-{sched}+tp", got, 4,
                                             sched, P13_SHORT),
            "peak_mem_gb_per_rank": [g["peak_mem_gb"] for g in got]}
    # (c) the MoE LM under pp against dp-moe's step 0
    c = {"dp_moe_1rank_nccl": one["dp-moe"]["losses"]}
    for sched in ("gpipe", "1f1b"):
        got = [r[f"moe_pp-{sched}"] for r in two]
        gate(f"c moe pp-{sched}", got[0]["losses"],
             one["dp-moe"]["losses"][0], n=P13_SHORT)
        c[f"moe_pp-{sched}"] = {
            "losses": got[0]["losses"], "router_aux": got[0]["router_aux"],
            "router_mass": got[0]["router_mass"],
            "step_ms_gloo": got[0]["step_ms"],
            "launches_per_rank": pp_launches(f"c moe pp-{sched}", got, 4,
                                             sched, P13_SHORT)}
    # (d) gspmd tp under int8: the scaled pair at the row products
    got = [r["tp_int8"] for r in two]
    gate("d tp int8", got[0]["losses"], one["dp4_int8"]["losses"][0],
         n=P13_SHORT)
    layers = 8
    per_fwd = {"fused_quant": 2 * layers + 1,      # qkv, mlp_in, the head
               "fused_quant_amax": 2 * layers,     # proj, mlp_out
               "fused_quant_scaled": 2 * layers}
    for r, g in enumerate(got):
        want = {k: n * (P13_SHORT + g["eval_batches"])
                for k, n in per_fwd.items()}
        bad = {k: (g["launches"][k], n) for k, n in want.items()
               if g["launches"][k] != n and card_run}
        if g["mode"] != "tp" or bad:
            raise AssertionError(f"13d rank {r}: mode {g['mode']}, "
                                 f"launches {bad}")
    d = {"dp4_int8_1rank_nccl": one["dp4_int8"]["losses"],
         "tp_int8_2rank_gloo": {
             "losses": got[0]["losses"], "step_ms_gloo": got[0]["step_ms"],
             "launches_per_forward": per_fwd,
             "launches_rank0": {k: got[0]["launches"][k] for k in per_fwd}},
         "scaled_pair": scaled}
    # (e) tiny fp32 runs, card against CPU
    e = {}
    for name, card, cpu in (
            *((t["name"], two[0][t["name"]], res_cpu2[0][t["name"]])
              for t in tiny if t["kind"] != "decode13"),
            ("tiny_pp-gpipe+tp", four[0]["tiny_pp-gpipe+tp"],
             res_cpu4[0]["tiny_pp-gpipe+tp"])):
        tol = INT8_LOSS_TOL if "int8" in name else LOSS_TOL
        diff = p13_close(f"e {name}", card["losses"], cpu["losses"], tol)
        e[name] = {"card": card["losses"], "cpu": cpu["losses"],
                   "mode": card.get("mode"), "max_abs_diff": diff,
                   "tolerance": f"{tol} (1 + |loss|)"}
    # (f) sharded decode: the bench, and tiny greedy tokens card vs CPU vs
    # one device
    from tpu_dist_torch.engine.generate import generate

    whole = generate(p13_tiny_decoder(device), p13_prompt(), 12,
                     use_cache=True).cpu().tolist()
    f = {"bench": decode}
    for k in ("tp", "dp"):
        card = [r[f"tiny_decode_{k}"]["tokens"] for r in two]
        cpu = [r[f"tiny_decode_{k}"]["tokens"] for r in res_cpu2]
        if any(t != whole for t in card + cpu):
            raise AssertionError(f"13f tiny decode {k}=2: tokens differ "
                                 "from the one-device decode")
        f[f"tiny_{k}2_tokens_equal"] = True
    # (g) ViT-B/16 ring against one rank
    g = {}
    for tag, one_name in (("vit_ring", "vit"), ("vit_ring_int8",
                                                "vit_int8")):
        got = [r[tag] for r in two]
        gate(f"g {tag}", got[0]["losses"], one[one_name]["losses"][0], n=1)
        fq = got[0]["launches"]["fused_quant"]
        want_fq = 48 * 3 if "int8" in tag else 0   # step, eval, FLOP count
        if card_run and any(x["launches"]["sgd"] != 1 or
                            x["launches"]["fused_quant"] != want_fq
                            for x in got):
            raise AssertionError(f"13g {tag}: launches "
                                 f"{[x['launches'] for x in got]}")
        g[tag] = {"losses": got[0]["losses"],
                  "one_rank_losses": one[one_name]["losses"],
                  "step_ms_gloo": got[0]["step_ms"],
                  "one_rank_step_ms": one[one_name]["step_ms"],
                  "peak_mem_gb_per_rank": [x["peak_mem_gb"] for x in got],
                  "fused_quant_calls_rank0": fq,
                  "p2p_host_staged_rank0": got[0]["p2p_host_staged"]}
    record = {"a_pp_full_width_2rank_gloo": a, "b_pp_x_tp_4rank_gloo": b,
              "c_moe_pp": c, "d_int8_tp_scaled_pair": d,
              "e_small_card_vs_cpu": e, "f_sharded_decode": f,
              "g_vit_ring": g, "kernels_at_phase13_shapes": shapes,
              "wall_s": time.perf_counter() - t0,
              "note": "ranks share one card over gloo with CUDA tensors: "
                      "the stage hops and ring all-reduces stage through "
                      "the host, so step times measure gloo, not the "
                      "schedule; no scaling is measured"}
    by_path = {"p13_pp-gpipe_rank0": two[0]["pp-gpipe"]["launches"],
               "p13_pp-1f1b_rank0": two[0]["pp-1f1b"]["launches"],
               "p13_pp-gpipe+tp_rank0": four[0]["pp-gpipe+tp"]["launches"],
               "p13_moe_pp-1f1b_rank0": two[0]["moe_pp-1f1b"]["launches"],
               "p13_tp_int8_rank0": two[0]["tp_int8"]["launches"],
               "p13_vit_ring_rank0": two[0]["vit_ring"]["launches"],
               "p13_vit_ring_int8_rank0":
                   two[0]["vit_ring_int8"]["launches"]}
    return record, by_path


# ---- phase 14: sp-sharded long-context serving ------------------------------

# (a) the decode bench's long-context replay of the checked-in trace at
# phase 5's model, and the virtual-clock numbers it must give: schedule
# arithmetic (no eos, so the same for any weights, width or device),
# held equal to the reference's replay on the CPU by
# tests/test_torch_longcontext.py, which reads them from here
P14_TRACE = os.path.join("tools", "traces", "longcontext_mix.json")
P14_LC_ARGV = ["--long-context", P14_TRACE, "--serve-slots", "4",
               "--page-size", "64", "--prefill-chunk", "128",
               "--long-monolithic"]
P14_LC_CARD_ARGV = ["--attn", "flash", "--kv-quant", "int8",
                    "--attn-read", "flash"]
P14_LC_PINS = {"requests": 15, "completed": 15, "long_requests": 1,
               "ticks": 183, "chunk_ticks": 128,
               "prefill_token_work": 17120, "requests_per_tick": 0.082,
               "occupancy": 0.6462, "ttft_long_p99": 146816.0,
               "tpot_short_p99": 1132.255, "tpot_baseline_p99": 1006.979,
               "tpot_interference_pct": 12.44,
               "monolithic": {"tpot_short_p99": 1597.63,
                              "tpot_interference_pct": 58.66,
                              "ticks": 183}}
# the full-width model the bench builds at its defaults (phase 5's);
# flags here narrow it for a rehearsal on the CPU
P14_LC_MODEL_ARGV = []
# (b) ServeEngine over an sp mesh of two ranks sharing the card (gloo),
# phase 5's model: one ~8k-token prompt past the sp threshold whose
# context outgrows a rank's 96 pages of 64 (6,144 tokens), one short
# prompt below it (the monolithic flash prefill), int8 pages read by the
# paged decode kernel; against the same requests on one rank over nccl
P14_MODEL = dict(vocab_size=32000, num_layers=8, d_model=1024, num_heads=8,
                 max_len=8192)
P14_SERVE = dict(max_slots=2, page_size=64, num_pages=192, kv_quant="int8",
                 attn_read="flash")
P14_THRESHOLD = 4096
P14_PROMPTS = (8000, 200)
P14_OUT = 16       # tokens decoded a request (32 before PR 23's cut)
# the bf16 run against one rank's sp engine: each prefill's first-token
# logits within P14_BF16_LOGIT_TOL (1 + |x|) and the same argmax, and
# every greedy token equal. Ring attention's fp32 online softmax rounds
# apart from one rank's, and every GEMM of a 4,096-row shard from the
# 8,192-row prefill's: on an H100 the long prompt's logits part by up to
# 0.0251 (1 + |x|), past BF16_TOL. The control (the same sp prefill with
# the second shard embedded P14_CTL_SHIFT positions off, a fault the
# limit must catch) is run beside it and must land past the limit
P14_BF16_LOGIT_TOL = 0.05
P14_CTL_SHIFT = -1
# (c) the tiny fp32 sharded engine, card ranks against CPU ranks (phase
# 4's geometry: head_dim 128, which the kernels take)
P14_TINY = dict(vocab_size=64, num_layers=2, d_model=256, num_heads=2,
                max_len=96)
P14_TINY_SERVE = dict(max_slots=2, page_size=16, num_pages=32,
                      sp_prefill_threshold=33)
P14_TINY_CASES = {"fp32": {},
                  "int8_flash": dict(kv_quant="int8", attn_read="flash")}


def p14_requests(model_kw, prompts, out):
    """The phase-14 requests: numpy-seeded prompts of the given lengths."""
    import numpy as np

    rng = np.random.default_rng(SEED + 14)
    return [(rng.integers(0, model_kw["vocab_size"], (n,)).astype(np.int32),
             out) for n in prompts]


def p14_serve_job(torch, kernels, job, out, rank):
    """One phase-14 rank: ``ServeEngine`` over an ``sp`` mesh of the whole
    group (its model seeded on the job's device, or for ``tiny`` drawn on
    the CPU and moved), serving the job's requests with the kernel counts
    and collective counters reset just before. Returns the tokens, the
    engine's numbers, launches, host-staged hops, byte sums, collective
    seconds and the peak memory; the first-token logits of each prefill
    go to ``<name>.logits.r<rank>.pt``."""
    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.ops.flash_attention import flash_attention_fn
    from tpu_dist_torch.parallel import collectives as C
    from tpu_dist_torch.parallel.mesh import make_mesh

    device = job["device"]
    mesh = make_mesh((job["world"],), ("sp",), device=device)
    if job.get("tiny"):
        model = TransformerLM(device="cpu", seed=SEED,
                              attn_fn=flash_attention_fn(),
                              **job["model"]).to(mesh.device)
    else:
        model = TransformerLM(dtype={"bf16": torch.bfloat16,
                                     "fp32": torch.float32}[job["dtype"]],
                              attn_fn=flash_attention_fn(),
                              device=mesh.device, seed=SEED, **job["model"])
    if job.get("shift"):
        # the control: the sp prefill's shards past the first embed their
        # rows job["shift"] positions off (their K/V pages stay in place)
        fwd = model.forward

        def forward(tokens, pos_offset=0, **kw):
            if kw.get("paged_prefill") and isinstance(pos_offset, int) \
                    and pos_offset > 0:
                pos_offset += job["shift"]
            return fwd(tokens, pos_offset=pos_offset, **kw)

        model.forward = forward
    reqs = p14_requests(job["model"], job["prompts"], job["out"])
    res = {}
    for name, cfg in job["cases"].items():
        if device != "cpu":
            free_device(torch)
            torch.cuda.reset_peak_memory_stats()
        eng = ServeEngine(model, ServeConfig(**cfg), mesh=mesh)
        first = []
        sample = eng._sample

        def record(logits, sample=sample, first=first):
            if logits.shape[0] == 1:          # a prefill's first token
                first.append(logits.float().cpu())
            return sample(logits)

        eng._sample = record
        kernels.reset_launches()
        C.P2P_HOST_STAGED["calls"] = 0
        C.SP_SUMS.update(calls=0, bytes=0)
        C.COMM_SECONDS["s"] = 0.0
        t0 = time.perf_counter()
        comps = eng.run([DecodeRequest(i, p, n)
                         for i, (p, n) in enumerate(reqs)])
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.save(first, os.path.join(
            out, f"{job['name']}.{name}.logits.r{rank}.pt"))
        st = eng.stats()
        res[name] = {
            "tokens": {str(c.rid): c.tokens.tolist() for c in comps},
            "wall_s": wall, "ticks": st["ticks"],
            "prefills": st["prefills"], "sp_prefills": st["sp_prefills"],
            "prefill_s": st["prefill_s"], "tick_s": st["tick_s"],
            "ms_per_tick": st["tick_s"] / max(st["ticks"], 1) * 1e3,
            "pages_per_device": st["pages_per_device"],
            "sharded_devices": st["sharded_devices"],
            "launches": dict(kernels.LAUNCHES),
            "p2p_host_staged": C.P2P_HOST_STAGED["calls"],
            "sum_calls": C.SP_SUMS["calls"],
            "sum_mb": C.SP_SUMS["bytes"] / 1e6,
            "comm_s": C.COMM_SECONDS["s"],
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if device != "cpu" else None)}
    return res


def check_paged_gathered(torch, F, gen, b, lk, h, d, lengths):
    """14d: the paged decode kernel's contiguous entry (the sharded tick's
    read of the summed view) against its plain version on gathered int8
    K/V of (b, lk, h, d) with the given lengths, timed beside the plain
    version and SDPA on the dequantized K/V."""
    from tpu_dist_torch.ops import flash_attention as fa
    from tpu_dist_torch.ops import paged_attention as pa

    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((b, lk, h, d), generator=gen, device="cuda")
            for _ in range(2))
    kq, ks, vq, vs = fa.quantize_kv(k, v)
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = pa.paged_decode_cuda(q, kq, ks, vq, vs, lengths)
    ref = pa.paged_decode_plain(q, kq, ks, vq, vs, lengths)
    torch.cuda.synchronize()
    # one bf16 rounding apart (INT8KV_ULP): at Lk 8192 a typical |out| is
    # about 0.015, so a bound of BF16_TOL (1 + |ref|) would pass a kernel
    # that dropped a page or a split of the long row
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if not bool((diff <= INT8KV_ULP * ref.float().abs() + INT8KV_ATOL).all()):
        raise AssertionError(f"14d paged_decode: max|err| {err} "
                             f"(tol {INT8KV_ULP} |ref| + {INT8KV_ATOL})")
    kd = (kq.float() * ks[..., None]).to(torch.bfloat16).transpose(1, 2)
    vd = (vq.float() * vs[..., None]).to(torch.bfloat16).transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    qh = q.transpose(1, 2).contiguous()
    mask = (torch.arange(lk, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    bound_ms, bound_by = paged_bound(b, h, d, lengths)
    return {"shape": f"B{b} Lk{lk} H{h} D{d} int8 K/V, bf16 q, lengths "
                     f"{lengths.tolist()} (the sharded tick's summed view)",
            "max_abs_err": err,
            "tolerance": f"{INT8KV_ULP} * |plain| + {INT8KV_ATOL}",
            "ms": time_ms(torch, lambda: pa.paged_decode_cuda(
                q, kq, ks, vq, vs, lengths)),
            "plain_ms": time_ms(torch, lambda: pa.paged_decode_plain(
                q, kq, ks, vq, vs, lengths)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kd, vd, attn_mask=mask)),
            "library": "scaled_dot_product_attention on dequantized bf16 "
                       "K/V with the length mask"}


def p14_long_context(torch, kernels, device="cuda"):
    """14a: the decode bench's long-context replay (``--long-context`` on
    the checked-in trace, ``P14_LC_ARGV`` + ``P14_LC_CARD_ARGV``) at phase
    5's model, through ``decode_bench.main`` with the kernel counts reset
    just before: the pins, every request served, one ``flash_fwd`` a
    layer for each monolithic prefill and one ``paged_decode`` a layer for
    each tick of the three replays."""
    import contextlib
    import io

    from tpu_dist_torch.tools import decode_bench

    argv = ["--device", device, *P14_LC_ARGV, *P14_LC_CARD_ARGV,
            *P14_LC_MODEL_ARGV]
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):    # its JSON line
        rec = decode_bench.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    srv = rec["serving"]
    for k, want in P14_LC_PINS.items():
        if srv[k] != want:
            raise AssertionError(f"14a {k}: {srv[k]} != pin {want}")
    with open(P14_TRACE) as f:
        plens = [r["prompt_len"] for r in json.load(f)["requests"]]
    chunk = int(P14_LC_ARGV[P14_LC_ARGV.index("--prefill-chunk") + 1])
    runs = srv["runs"]
    # prompts within one chunk prefill monolithic in the chunked runs
    mono = {"chunked": sum(n <= chunk for n in plens),
            "baseline": sum(n <= chunk for n in plens if n < 1024),
            "monolithic": len(plens)}
    layers = rec["layers"]
    want = {"flash_fwd": layers * sum(mono.values()),
            "paged_decode": layers * sum(r["ticks"] for r in runs.values())}
    if device == "cuda" and any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"14a launches {launches}, expected {want}")
    if any(r["completed"] != (14 if n == "baseline" else 15)
           for n, r in runs.items()):
        raise AssertionError(f"14a runs {runs}")
    return {"argv": " ".join(argv), "wall_s": wall,
            "replay_wall_s": {n: r["wall_s"] for n, r in runs.items()},
            "ticks": {n: r["ticks"] for n, r in runs.items()},
            "serving": {k: v for k, v in srv.items() if k != "runs"},
            "params_at": f"V{rec['vocab']} {layers}L d{rec['d_model']} "
                         f"{rec['heads']} heads {rec['precision']}",
            "launches": launches, "expected_launches": want}


def first_token_close(torch, got, want, tag, tol):
    """Each prefill's first-token logits within ``tol`` (1 + |want|);
    returns the largest difference."""
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} vs {len(want)} prefills")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        diff = (g - w).abs()
        if not bool((diff <= tol * (1 + w.abs())).all()):
            raise AssertionError(f"{tag} prefill {i}: first-token logits "
                                 f"max|diff| {diff.max().item()} (tol "
                                 f"{tol} (1 + |x|))")
        worst = max(worst, diff.max().item())
    return worst


def tokens_agreeing(got, want, prompt_lens):
    """Generated tokens equal up to the first difference, per request
    (``prompt_lens`` by request id: the prompt is not counted)."""
    out = {}
    for rid, toks in want.items():
        p = prompt_lens[int(rid)]
        n = 0
        for a, b in zip(got[rid][p:], toks[p:]):
            if a != b:
                break
            n += 1
        out[rid] = f"{n}/{len(toks) - p}"
    return out


def longcontext_path(torch, kernels, tmp, device="cuda"):
    """Phase 14 (module docstring). Returns (record, launches by run).
    ``device="cpu"`` rehearses its control flow on the CPU (with the
    constants narrowed; the kernel checks are the card's)."""
    import torch.nn.functional as F

    card_run = device == "cuda"
    t0 = time.perf_counter()
    rec, by_run = {}, {}
    if card_run:
        free_device(torch)

    fulls = [{"name": f"p14_{dt}", "kind": "sp14", "dtype": dt,
              "model": P14_MODEL, "prompts": list(P14_PROMPTS),
              "out": P14_OUT} for dt in ("bf16", "fp32")]
    tiny = {"name": "p14_tiny", "kind": "sp14", "tiny": True,
            "model": P14_TINY, "prompts": [40, 5], "out": 12,
            "cases": {n: {**P14_TINY_SERVE, **kw}
                      for n, kw in P14_TINY_CASES.items()}}
    sp_cfg = dict(P14_SERVE, sp_prefill_threshold=P14_THRESHOLD)
    # one rank: the same engine (its sp prefill over a one-rank axis: the
    # same ring attention math), and the unsharded flash prefill
    one = DpGroup("p14b_1rank", 1, device, "nccl" if card_run else "gloo",
                  [dict(f, world=1, cases={"sp": sp_cfg, "flash": P14_SERVE})
                   for f in fulls], tmp)
    # the control: the long prompt's sp prefill alone, with a fault
    ctl = {"name": "p14_bf16_ctl", "kind": "sp14", "dtype": "bf16",
           "model": P14_MODEL, "prompts": list(P14_PROMPTS[:1]), "out": 1,
           "shift": P14_CTL_SHIFT}
    # the three groups side by side (the card's two share its time)
    two = DpGroup("p14b_2rank", 2, device, "gloo",
                  [dict(f, world=2, cases={"sp": sp_cfg})
                   for f in fulls + [ctl]] + [dict(tiny, world=2)], tmp)
    cpu = DpGroup("p14c_cpu", 2, "cpu", "gloo", [dict(tiny, world=2)], tmp)
    # (a) in this process meanwhile
    try:
        a = p14_long_context(torch, kernels, device)
    except BaseException:
        for g in (one, two, cpu):
            g.kill()
        raise
    by_run["p14a_long_context"] = a["launches"]
    rec["a_long_context_replay"] = a
    log(f"phase 14a long-context replay: {a['wall_s']:.1f}s wall "
        f"(replays {json.dumps(a['replay_wall_s'])}), beside (b)'s groups")
    r1, r2, rc = wait_groups([one, two, cpu], (600, 900, 600))
    r1 = r1[0]

    # (b) the sharded engine at full width against the one-rank runs
    def logits(group, name, case, rank=0):
        return torch.load(os.path.join(
            tmp, group, f"{name}.{case}.logits.r{rank}.pt"))

    def gaps(got, want):
        """Per prefill: max |got - want| / (1 + |want|), the share of
        logits past BF16_TOL in it, and whether the argmax agrees."""
        out = []
        for g, w in zip(got, want):
            rel = (g - w).abs() / (1 + w.abs())
            out.append({"max_rel": rel.max().item(),
                        "share_past_bf16_tol": (rel > BF16_TOL).float()
                        .mean().item(),
                        "argmax_equal": bool(torch.equal(g.argmax(-1),
                                                         w.argmax(-1)))})
        return out

    layers = P14_MODEL["num_layers"]
    budget = P14_SERVE["num_pages"] // 2 * P14_SERVE["page_size"]
    context = P14_PROMPTS[0] + P14_OUT
    drop = lambda r: {k: v for k, v in r.items() if k != "tokens"}  # noqa
    b = {"context_tokens": context, "rank_token_budget": budget,
         "threshold": P14_THRESHOLD, "prompts": list(P14_PROMPTS)}
    for f in fulls:
        name, dt = f["name"], f["dtype"]
        one_sp, one_flash = r1[name]["sp"], r1[name]["flash"]
        ranks = [r[name]["sp"] for r in r2]
        for rank, r in enumerate(ranks):
            if r["tokens"] != ranks[0]["tokens"]:
                raise AssertionError(f"14b {dt}: the two ranks served "
                                     "different tokens")
            if r["sp_prefills"] != 1 or r["prefills"] != 2 or \
                    r["sharded_devices"] != 2 or not context > budget:
                raise AssertionError(f"14b {dt}: {drop(r)}")
            # the short prompt's monolithic prefill, every tick's read
            if card_run and (r["launches"]["flash_fwd"] != layers or
                             r["launches"]["paged_decode"]
                             != layers * r["ticks"]):
                raise AssertionError(f"14b {dt} launches {r['launches']}")
            by_run[f"p14b_{dt}_sp2_rank{rank}"] = r["launches"]
        if card_run and (one_sp["launches"]["flash_fwd"] != layers or
                         one_flash["launches"]["flash_fwd"] != 2 * layers):
            raise AssertionError(f"14b {dt} one rank: {one_sp['launches']}"
                                 f", {one_flash['launches']}")
        by_run[f"p14b_{dt}_one_rank_sp"] = one_sp["launches"]
        by_run[f"p14b_{dt}_one_rank_flash"] = one_flash["launches"]
        got = logits("p14b_2rank", name, "sp")
        want = logits("p14b_1rank", name, "sp")
        rec_dt = {"vs_one_rank_sp": gaps(got, want),
                  "vs_one_rank_flash": gaps(
                      got, logits("p14b_1rank", name, "flash")),
                  "tokens_agreeing": {
                      "one_rank_sp": tokens_agreeing(
                          ranks[0]["tokens"], one_sp["tokens"], P14_PROMPTS),
                      "one_rank_flash": tokens_agreeing(
                          ranks[0]["tokens"], one_flash["tokens"],
                          P14_PROMPTS)},
                  "per_rank": [drop(r) for r in ranks],
                  "one_rank_nccl": {"sp": drop(one_sp),
                                    "flash": drop(one_flash)}}
        if dt == "fp32":
            # the sharded machinery at full width, where rounding is
            # small: held against the same engine on one rank
            rec_dt["first_token_max_diff"] = max(
                first_token_close(
                    torch, logits("p14b_2rank", name, "sp", rank), want,
                    f"14b fp32 rank {rank}", LOSS_TOL)
                for rank in range(len(ranks)))
            rec_dt["tolerance"] = (f"{LOSS_TOL} (1 + |x|) against one "
                                   "rank's sp engine")
        else:
            # bf16 (P14_BF16_LOGIT_TOL): the limit, the argmax and every
            # greedy token against one rank's sp engine, and the control
            # past the limit
            rec_dt["first_token_max_diff"] = max(
                first_token_close(
                    torch, logits("p14b_2rank", name, "sp", rank), want,
                    f"14b bf16 rank {rank}", P14_BF16_LOGIT_TOL)
                for rank in range(len(ranks)))
            if not all(g["argmax_equal"] for g in rec_dt["vs_one_rank_sp"]):
                raise AssertionError(f"14b bf16: a first-token argmax "
                                     f"differs: {rec_dt['vs_one_rank_sp']}")
            if ranks[0]["tokens"] != one_sp["tokens"]:
                raise AssertionError(f"14b bf16: greedy tokens part from "
                                     f"one rank's: "
                                     f"{rec_dt['tokens_agreeing']}")
            ctl_gap = gaps(logits("p14b_2rank", ctl["name"], "sp"),
                           want[:1])[0]
            if ctl_gap["max_rel"] <= P14_BF16_LOGIT_TOL:
                raise AssertionError(f"14b bf16: the control {ctl_gap} is "
                                     f"within the limit "
                                     f"{P14_BF16_LOGIT_TOL}: it does not "
                                     "separate")
            rec_dt["control"] = dict(
                ctl_gap, fault=f"second shard embedded {P14_CTL_SHIFT} "
                               "position(s) off")
            rec_dt["tolerance"] = (f"{P14_BF16_LOGIT_TOL} (1 + |x|), equal "
                                   "argmax and greedy tokens, against one "
                                   "rank's sp engine")
        b[dt] = rec_dt
    rec["b_sp2_full_width_gloo"] = b

    # (c) tiny fp32: card ranks against CPU ranks, equal greedy tokens
    small = {}
    for case in P14_TINY_CASES:
        card = [r["p14_tiny"][case] for r in r2]
        host = [r["p14_tiny"][case] for r in rc]
        for r in card + host:
            if r["tokens"] != host[0]["tokens"] or r["sp_prefills"] != 1:
                raise AssertionError(f"14c {case}: {r} vs {host[0]}")
        small[case] = {"requests": len(host[0]["tokens"]),
                       "token_equal": True,
                       "card_launches": card[0]["launches"]}
    rec["c_small_card_vs_cpu"] = small
    # (d) the paged decode kernel at (b)'s gathered view
    if card_run:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
        pages = P14_MODEL["max_len"] // P14_SERVE["page_size"]
        lk = pages * P14_SERVE["page_size"]
        rec["d_paged_decode_gathered"] = check_paged_gathered(
            torch, F, gen, P14_SERVE["max_slots"], lk,
            P14_MODEL["num_heads"],
            P14_MODEL["d_model"] // P14_MODEL["num_heads"],
            [P14_PROMPTS[0] + P14_OUT // 2, P14_PROMPTS[1] + P14_OUT // 2])
    rec["wall_s"] = time.perf_counter() - t0
    rec["note"] = ("one card: the two ranks share it over gloo, so every "
                   "sum goes through the host; no scaling is measured")
    return rec, by_run


# ---- phase 15: restart and faults -----------------------------------------

P15_CHILD = "--p15-child"
# phase 6's LM at full width on a synthetic corpus of 32 train rows of
# 2049 tokens (4 steps an epoch at batch 8; one validation row, padded to
# one batch), 3 epochs to 12 steps, one drain a step (print_freq 1: the
# watchdog gets a beat a step, two of them before step 6)
P15_MODEL = dict(synth_tokens=70_000)
P15_RUN = dict(epochs=3, max_steps=12, print_freq=1)
# 15b: the same run cut to 2 epochs (8 steps; the constant LR makes its
# steps 0-7 those of 15a's)
P15B_RUN = dict(epochs=2, max_steps=8, print_freq=1)
P15_FAULTS = ("hang@step=6,attempt=0;preempt_deadline@step=9,attempt=1;"
              "hard_exit@step=10,attempt=2")
P15_CLASSES = ["stall", "preemption_snapshotted", "crash", "clean"]
P15_RESUMES = [4, 9, 9]
P15_SUPERVISE = ["--max-restarts", "4", "--backoff-s", "0.5",
                 "--stall-grace-s", "5"]
# 15c: BENCH_GEOMETRY cut to 4 steps an epoch and 2-step windows over 2
# epochs, so the fault lands mid-epoch; 15d: phase 4's tiny fp32 LM
P15_IMAGE = dict(synth_train_size=4096, synth_val_size=1024,
                 steps_per_dispatch=2, epochs=2)
P15_IMAGE_FAULT = "nan_batch@step=6,attempt=0"
P15_TINY_LM = dict(batch_size=4, seq_len=96, d_model=128, num_layers=2,
                   num_heads=1, vocab_size=64, synth_tokens=4000, seed=SEED,
                   attn="flash", optimizer="fused_adamw", lr=3e-3,
                   grad_clip=0.5, weight_decay=0.1, print_freq=1,
                   precision="fp32")
P15_SNAPSHOT_STEP = 5
P15_TINY_STEPS = 8


def lm_argv(cfg):
    """The ``--flag value`` pairs of an ``LMConfig`` that differ from the
    defaults (scalars only), for the script's parser."""
    from tpu_dist_torch.configs import LMConfig

    base = LMConfig()
    out = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if v != getattr(base, f.name) and isinstance(v, (int, float, str)) \
                and not isinstance(v, bool):
            out += [f"--{f.name.replace('_', '-')}", str(v)]
    return out


def p15_child(out_dir, argv):
    """One attempt of 15a's supervised command (``chip_smoke.py
    --p15-child OUT <script flags>``): ``scripts.lm_longcontext.main`` on
    ``argv`` (with the lineage flags the supervisor appends), writing the
    kernel counts, the trained steps and the validation batches of the
    run to ``OUT/launches.a<TPU_DIST_ATTEMPT>.json`` when it exits (a
    clean end or the preemption snapshot's exit 75; a killed attempt
    writes none). Returns the script's exit code."""
    import atexit

    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpu_dist_torch import kernels
    from tpu_dist_torch.engine import lm_loop
    from tpu_dist_torch.scripts import lm_longcontext

    made = []
    fit = lm_loop.LMTrainer.fit

    def tracked(self):
        made.append(self)
        return fit(self)

    lm_loop.LMTrainer.fit = tracked
    attempt = os.environ.get("TPU_DIST_ATTEMPT", "x")

    def dump():
        rec = {"launches": dict(kernels.LAUNCHES)}
        if made:
            tr = made[-1]
            rec["step"] = tr.state.step
            rec["eval_batches"] = len(tr._epoch_indices(tr.val_ds, False,
                                                        0)[0])
            rec["layers"] = tr.cfg.num_layers
        with open(os.path.join(out_dir, f"launches.a{attempt}.json"),
                  "w") as f:
            json.dump(rec, f)

    atexit.register(dump)
    kernels.reset_launches()
    lm_longcontext.main(argv)
    return 0


class StampedStderr:
    """Read a process's stderr on a thread, each line with its arrival
    time, and echo it to this process's stderr."""

    def __init__(self, pipe):
        import threading

        self.lines = []
        self._t = threading.Thread(target=self._run, args=(pipe,),
                                   daemon=True)
        self._t.start()

    def _run(self, pipe):
        for line in pipe:
            self.lines.append((time.time(), line))
            sys.stderr.write(line)

    def join(self):
        self._t.join(timeout=10)
        return self.lines


def p15_supervise(tmp, name, script_argv, device):
    """Start one ``python -m tpu_dist_torch.supervise`` run of the LM
    script through :func:`p15_child`; :func:`p15_supervised` waits for
    it."""
    d = os.path.join(tmp, name)
    os.makedirs(d, exist_ok=True)
    ledger = os.path.join(d, "run.jsonl")
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "tpu_dist_torch.supervise", "--ledger",
           ledger, "--ckpt-dir", os.path.join(d, "ck"), *P15_SUPERVISE,
           "--", sys.executable, os.path.join(here, "chip_smoke.py"),
           P15_CHILD, d, *script_argv, "--device", device]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_DIST_", "SLURM_"))}
    env["PYTHONPATH"] = here + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    t0 = time.time()
    proc = subprocess.Popen(cmd, env=env, cwd=here, stderr=subprocess.PIPE,
                            stdout=subprocess.DEVNULL, text=True,
                            errors="replace")
    return name, d, ledger, t0, proc, StampedStderr(proc.stderr)


def p15_supervised(run):
    """Wait for a :func:`p15_supervise` run: (record, attempt ledgers'
    records, child count files, stamped stderr lines)."""
    from tpu_dist_torch.obs.goodput import discover_attempt_paths
    from tpu_dist_torch.obs.ledger import read_ledger

    name, d, ledger, t0, proc, err = run
    try:
        rc = proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"15a {name}: the supervisor ran past 900s")
    wall = time.time() - t0
    lines = err.join()
    if rc != 0:
        tail = "".join(line for _, line in lines[-60:])
        raise AssertionError(f"15a {name}: supervise exited {rc}:\n{tail}")
    attempts = []
    pat = re.compile(r"attempt (\d+) ended: rc=(\S+) class=(\S+) \((\d+) "
                     r"step record\(s\) in ([\d.]+)s\)")
    for _, line in lines:
        m = pat.search(line)
        if m:
            attempts.append({"attempt": int(m.group(1)), "rc": m.group(2),
                             "class": m.group(3),
                             "step_records": int(m.group(4)),
                             "seconds": float(m.group(5))})
    recs = [read_ledger(p, validate=False, strict=False)
            for p in discover_attempt_paths(ledger)]
    counts = {}
    for a in attempts:
        p = os.path.join(d, f"launches.a{a['attempt']}.json")
        if os.path.exists(p):
            with open(p) as f:
                counts[a["attempt"]] = json.load(f)
    return ({"wall_s": wall, "attempts": attempts, "ledger": ledger},
            recs, counts, lines)


def p15_losses(recs):
    return {r["step"]: r["loss"] for r in recs if r["event"] == "step"}


def p15_clean_counts(tag, rec, steps, device):
    """Per step of a clean attempt: 8 (layers) flash_fwd, flash_bwd_dq and
    flash_bwd_dkv and 1 adamw launch, validation's forwards apart (no
    kernel runs on the CPU: there the counts are reported, not held)."""
    n, layers = rec["launches"], rec["layers"]
    evals = rec["evals"] * rec["eval_batches"]
    per = {"flash_fwd": (n["flash_fwd"] - layers * evals) / steps,
           "flash_bwd_dq": n["flash_bwd_dq"] / steps,
           "flash_bwd_dkv": n["flash_bwd_dkv"] / steps,
           "adamw": n["adamw"] / steps}
    want = {"flash_fwd": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers, "adamw": 1}
    if per != want and device == "cuda":
        raise AssertionError(f"{tag}: launches a step {per}, expected "
                             f"{want} ({n})")
    return per


def p15_supervised_lm(torch, kernels, tmp, device, meanwhile):
    """15a (module docstring): the uninterrupted run and the faulted one,
    each through ``python -m tpu_dist_torch.supervise``, side by side;
    ``meanwhile(want)`` (15b-e, given the uninterrupted run's losses) runs
    in this process once the uninterrupted run has ended, beside the
    faulted one's last attempts. Returns (record, launches by run, what
    ``meanwhile`` returned)."""
    from tpu_dist_torch.parallel.supervisor import classify_attempt

    cfg = full_lm_config(**P15_MODEL, **P15_RUN)
    argv = lm_argv(cfg)
    # the two runs side by side (each its own process tree on the card)
    faulted = p15_supervise(tmp, "faulted", argv + ["--faults", P15_FAULTS],
                            device)
    try:
        one, one_recs, one_counts, _ = p15_supervised(p15_supervise(
            tmp, "uninterrupted", argv, device))
        if [a["class"] for a in one["attempts"]] != ["clean"]:
            raise AssertionError(f"15a uninterrupted: {one['attempts']}")
        want = p15_losses(one_recs[0])
        if sorted(want) != list(range(P15_RUN["max_steps"])) or \
                not all(map(math.isfinite, want.values())):
            raise AssertionError(f"15a uninterrupted losses {want}")
        side = meanwhile(want)
    except BaseException:
        faulted[4].terminate()      # the supervisor takes its child down
        faulted[4].wait(timeout=120)
        raise
    run, recs, counts, lines = p15_supervised(faulted)
    classes = [a["class"] for a in run["attempts"]]
    if classes != P15_CLASSES:
        raise AssertionError(f"15a classes {classes}: {run['attempts']}")
    verdicts = [classify_attempt(r) for r in recs]
    # a SIGKILLed attempt's ledger alone reads as its last words: the
    # stall event with no run_end is 'stall', the hard exit 'crash'
    if verdicts != P15_CLASSES:
        raise AssertionError(f"15a ledger verdicts {verdicts}")
    per = [p15_losses(r) for r in recs]
    resumes = [min(p) for p in per[1:]]
    if resumes != P15_RESUMES:
        raise AssertionError(f"15a resumed at {resumes}, expected "
                             f"{P15_RESUMES}")
    stitched = {}
    for p in per:
        stitched.update(p)
    if sorted(stitched) != sorted(want):
        raise AssertionError(f"15a stitched steps {sorted(stitched)}")
    diffs = {k: abs(stitched[k] - want[k]) for k in want}
    for k, dv in diffs.items():
        if dv > LOSS_TOL * (1 + abs(want[k])):
            raise AssertionError(f"15a step {k}: {stitched[k]} vs "
                                 f"{want[k]} (tol {LOSS_TOL} (1 + |loss|))")
    # the stall: the watchdog's event after the last beat, the kill after
    stall = next(r for r in recs[0] if r["event"] == "stall")
    last_beat = max(r["ts"] for r in recs[0] if r["event"] == "step")
    kill_ts = next(ts for ts, line in lines
                   if "SIGKILLing" in line and "stall" in line)
    snap = next(r for r in recs[1] if r["event"] == "ckpt"
                and r.get("preempt"))
    # kernels a step on the clean attempts, read from the children
    launches = {}
    for tag, rec_c, recs_c in (("uninterrupted", one_counts.get(0),
                                one_recs[0]),
                               ("attempt 3", counts.get(3), recs[3])):
        if rec_c is None:
            raise AssertionError(f"15a {tag}: no counts from the child")
        rec_c["evals"] = sum(r["event"] == "eval" for r in recs_c)
        steps = sum(r["event"] == "step" for r in recs_c)
        rec_c["per_step"] = p15_clean_counts(f"15a {tag}", rec_c, steps,
                                             device)
        launches[tag] = rec_c
    return {"config": {"argv": argv, "faults": P15_FAULTS,
                       "supervise": P15_SUPERVISE},
            "classes": classes, "ledger_verdicts": verdicts,
            "resumed_at": resumes, "supervisor_rc": 0,
            "attempt_s": [a["seconds"] for a in run["attempts"]],
            "attempts": run["attempts"],
            "stall_detect_s": stall["ts"] - last_beat,
            "stall_threshold_s": stall["threshold_s"],
            "stall_kill_after_event_s": kill_ts - stall["ts"],
            "snapshot_write_s": snap["seconds"],
            "snapshot_step": next(r for r in recs[1]
                                  if r["event"] == "run_end")[
                                      "snapshot_step"],
            "restarts_wall_s": run["wall_s"],
            "uninterrupted_wall_s": one["wall_s"],
            "uninterrupted_attempt_s": one["attempts"][0]["seconds"],
            "stitched_losses": [stitched[k] for k in sorted(stitched)],
            "max_abs_loss_diff": max(diffs.values()),
            "bit_equal": all(dv == 0 for dv in diffs.values()),
            "tolerance": f"{LOSS_TOL} (1 + |loss|)",
            "clean_attempt_launches": launches}, {
        "p15a_uninterrupted": launches["uninterrupted"]["launches"],
        "p15a_attempt3_clean": launches["attempt 3"]["launches"]}, side


def p15_in_process(torch, kernels, tmp, device, want):
    """15b: ``run_supervised`` over the LMTrainer at 15a's width, a
    ``nan_batch`` at step 6 of attempt 0 under ``health="halt"``."""
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.obs import faults
    from tpu_dist_torch.obs.ledger import read_ledger
    from tpu_dist_torch.parallel.supervisor import (classify_attempt,
                                                    run_supervised)

    faults._reset_for_tests()
    d = os.path.join(tmp, "p15b")
    os.makedirs(d)
    cfg = full_lm_config(**P15_MODEL, **P15B_RUN, health="halt",
                         max_restarts=2, restart_backoff_s=0.5,
                         faults="nan_batch@step=6,attempt=0",
                         ledger_path=os.path.join(d, "run.jsonl"),
                         checkpoint_dir=os.path.join(d, "ck"))
    built = []

    def make(run_cfg):
        built.clear()
        free_device(torch)
        built.append(LMTrainer(run_cfg, device=device))
        return built[0]

    kernels.reset_launches()
    t0 = time.perf_counter()
    run_supervised(make, cfg)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    tr = built[0]
    faults._reset_for_tests()
    recs = [read_ledger(os.path.join(d, p), validate=False)
            for p in ("run.jsonl", "run.a1.jsonl")]
    classes = [classify_attempt(r) for r in recs]
    if classes != ["health_halt", "clean"] or \
            tr.state.step != P15B_RUN["max_steps"]:
        raise AssertionError(f"15b classes {classes}, step {tr.state.step}")
    first, after = p15_losses(recs[0]), p15_losses(recs[1])
    # the ledger writes the NaN loss of step 6 as null
    if min(after) != 4 or first.get(6, 0.0) is not None:
        raise AssertionError(f"15b resumed at {min(after)}, step 6 loss "
                             f"{first.get(6)}")
    diffs = {k: abs(v - want[k]) for k, v in after.items()}
    for k, dv in diffs.items():
        if dv > LOSS_TOL * (1 + abs(want[k])):
            raise AssertionError(f"15b step {k}: {after[k]} vs {want[k]}")
    trained = 7 + len(after)
    if device == "cuda" and (launches["adamw"] != trained or
                             launches["flash_bwd_dq"] != 8 * trained):
        raise AssertionError(f"15b launches {launches} for {trained} steps")
    health = next(r for r in recs[0] if r["event"] == "health")
    return {"classes": classes, "halt_at_step": health["step"],
            "resumed_at": min(after), "steps_after_restart": len(after),
            "max_abs_loss_diff_vs_15a": max(diffs.values()),
            "bit_equal_vs_15a": all(dv == 0 for dv in diffs.values()),
            "tolerance": f"{LOSS_TOL} (1 + |loss|)", "wall_s": wall,
            "launches": launches}, launches


def p15_image(torch, kernels, tmp, device):
    """15c: ``scripts.image_train`` at BENCH_GEOMETRY cut to P15_IMAGE,
    ``--max-restarts 1 --health halt`` and a ``nan_batch``."""
    from tpu_dist_torch.obs import faults
    from tpu_dist_torch.obs.ledger import read_ledger
    from tpu_dist_torch.parallel.supervisor import classify_attempt
    from tpu_dist_torch.scripts import image_train

    faults._reset_for_tests()
    d = os.path.join(tmp, "p15c")
    os.makedirs(d)
    geom = {**image_train.BENCH_GEOMETRY, **P15_IMAGE}
    argv = [a for k, v in geom.items()
            for a in (f"--{k.replace('_', '-')}", str(v))]
    argv += ["--data", os.path.join(d, "no-data"), "--checkpoint-dir",
             os.path.join(d, "ck"), "--ledger-path",
             os.path.join(d, "run.jsonl"), "--log-csv", "",
             "--print-freq", "16", "--max-restarts", "1", "--health",
             "halt", "--restart-backoff-s", "0.5", "--faults",
             P15_IMAGE_FAULT, "--device", device]
    kernels.reset_launches()
    t0 = time.perf_counter()
    tr = image_train.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    faults._reset_for_tests()
    recs = [read_ledger(os.path.join(d, p), validate=False)
            for p in ("run.jsonl", "run.a1.jsonl")]
    classes = [classify_attempt(r) for r in recs]
    windows = [[r for r in rs if r["event"] == "step"] for rs in recs]
    dispatched = sum(r["steps_in_dispatch"] for w in windows for r in w)
    final = windows[1][-1]["loss"]
    if classes != ["health_halt", "clean"] or not math.isfinite(final):
        raise AssertionError(f"15c classes {classes}, final loss {final}")
    if launches["sgd"] != (dispatched if device == "cuda" else 0) or \
            tr.state.step != geom["epochs"] * tr.steps_per_epoch:
        raise AssertionError(f"15c sgd {launches['sgd']} for {dispatched} "
                             f"steps, step {tr.state.step}")
    return {"config": geom, "fault": P15_IMAGE_FAULT, "classes": classes,
            "resumed_at": windows[1][0]["step"] -
            windows[1][0]["steps_in_dispatch"] + 1,
            "window_losses": [[r["loss"] for r in w] for w in windows],
            "final_loss": final, "steps_dispatched": dispatched,
            "sgd_launches_per_step": launches["sgd"] / dispatched,
            "wall_s": wall}, launches


def p15_restart_job(torch, kernels, job, out, rank):
    """A 15d rank: the tiny LM with this rank's resume (``job["resume"]``:
    rank -> path), ``TPU_DIST_PEER_RESUME`` set for the construction, to
    ``max_steps``; this rank's ledger losses, the step and a digest of its
    params after the restore."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.obs.ledger import per_process_path

    path = os.path.join(out, f"{job['name']}.jsonl")
    cfg = LMConfig(**job["cfg"], ledger_path=path,
                   resume=job["resume"].get(str(rank), ""))
    os.environ["TPU_DIST_PEER_RESUME"] = "1"
    try:
        tr = LMTrainer(cfg, device=job["device"])
    finally:
        del os.environ["TPU_DIST_PEER_RESUME"]
    res = {"step0": tr.state.step,
           "digest0": [float(p.detach().double().sum().item())
                       for p in tr.state.params],
           "peer_restored": tr._peer_restored}
    kernels.reset_launches()
    tr.fit()
    res["launches"] = dict(kernels.LAUNCHES)
    res["losses"] = {r["step"]: r["loss"] for r in
                     ledger_steps(per_process_path(path, rank))}
    return res


def p15_peer_and_enospc(torch, kernels, tmp, device):
    """15d and 15e (module docstring)."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine import checkpoint as ckpt
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.obs import faults
    from tpu_dist_torch.parallel.supervisor import latest_checkpoint

    d = os.path.join(tmp, "p15d")
    os.makedirs(d)
    faults._reset_for_tests()
    ck = os.path.join(d, "ck")
    base = dict(P15_TINY_LM, max_steps=P15_TINY_STEPS)
    tr = LMTrainer(LMConfig(**base, checkpoint_dir=ck,
                            ledger_path=os.path.join(d, "snap.jsonl"),
                            faults=f"preempt_deadline@step="
                                   f"{P15_SNAPSHOT_STEP}"), device=device)
    try:
        tr.fit()
        raise AssertionError("15d: the snapshot run did not exit")
    except SystemExit as e:
        if e.code != 75:
            raise
    faults._reset_for_tests()
    snap = latest_checkpoint(ck)
    del tr
    one_path = os.path.join(d, "one.jsonl")
    LMTrainer(LMConfig(**base, resume=snap, ledger_path=one_path),
              device=device).fit()
    one = {r["step"]: r["loss"] for r in ledger_steps(one_path)}
    job = {"name": "p15d", "kind": "restart15", "cfg": base,
           "resume": {"0": snap}}
    two = DpGroup("p15d_2rank", 2, device, "gloo", [job], tmp).wait(300)
    r0, r1 = (r["p15d"] for r in two)
    if not (r0["peer_restored"] and r1["peer_restored"]) or \
            not r0["step0"] == r1["step0"] == P15_SNAPSHOT_STEP or \
            r0["digest0"] != r1["digest0"]:
        raise AssertionError(f"15d restore: steps {r0['step0']} "
                             f"{r1['step0']}, digests equal "
                             f"{r0['digest0'] == r1['digest0']}")
    nxt = str(P15_SNAPSHOT_STEP)
    if r0["losses"][nxt] != r1["losses"][nxt]:
        raise AssertionError(f"15d: step {nxt} loss {r0['losses'][nxt]} "
                             f"vs {r1['losses'][nxt]}")
    gap = abs(r0["losses"][nxt] - one[P15_SNAPSHOT_STEP])
    if gap > LOSS_TOL * (1 + abs(one[P15_SNAPSHOT_STEP])):
        raise AssertionError(f"15d: 2 ranks {r0['losses'][nxt]} vs one "
                             f"rank {one[P15_SNAPSHOT_STEP]}")
    peer = {"restored_step": r0["step0"], "params_equal": True,
            "next_step_loss": [r0["losses"][nxt], r1["losses"][nxt]],
            "one_rank_loss": one[P15_SNAPSHOT_STEP],
            "abs_diff": gap, "tolerance": f"{LOSS_TOL} (1 + |loss|)",
            "launches": [r0["launches"], r1["launches"]]}

    # 15e: the trainer's own epoch-end write fails in the container write
    ck_e = os.path.join(d, "ck-enospc")
    cfg = LMConfig(**{**P15_TINY_LM, "epochs": 2}, checkpoint_dir=ck_e,
                   faults="ckpt_enospc@nth=2")
    tr = LMTrainer(cfg, device=device)
    try:
        tr.fit()
        raise AssertionError("15e: the failed write did not surface")
    except RuntimeError as e:
        cause = e.__cause__
        if not (isinstance(cause, OSError) and "injected" in str(cause)):
            raise
    faults._reset_for_tests()
    newest = latest_checkpoint(ck_e)
    meta = ckpt.read_checkpoint_meta(newest)
    fresh = LMTrainer(LMConfig(**P15_TINY_LM), device=device)
    ckpt.load_checkpoint(newest, fresh.state)
    if meta["step"] != tr.steps_per_epoch or fresh.state.step != meta["step"]:
        raise AssertionError(f"15e: newest valid checkpoint at step "
                             f"{meta['step']}, expected "
                             f"{tr.steps_per_epoch}")
    enospc = {"error": str(cause), "newest_valid_step": meta["step"],
              "run_reached_step": tr.state.step, "pointer_unchanged": True,
              "reloaded_on": device}
    return peer, enospc, {"p15d_rank0": r0["launches"],
                          "p15d_rank1": r1["launches"]}


def restart_path(torch, kernels, tmp, device="cuda"):
    """Phase 15 (module docstring). Returns (record, launches by run).
    ``device="cpu"`` rehearses its control flow on the CPU (with
    P15_MODEL and P15_IMAGE narrowed and ``full_lm_config`` patched to a
    tiny width)."""
    t0 = time.perf_counter()
    if device == "cuda":
        free_device(torch)
    rec, by_run = {}, {}

    def meanwhile(want):          # 15b-e, beside 15a's faulted run
        t1 = time.perf_counter()
        b, by_run["p15b_in_process"] = p15_in_process(torch, kernels, tmp,
                                                      device, want)
        rec["b_in_process_restart"] = b
        if device == "cuda":
            free_device(torch)
        c, by_run["p15c_image"] = p15_image(torch, kernels, tmp, device)
        rec["c_image_restart"] = c
        if device == "cuda":
            free_device(torch)
        peer, enospc, d_launches = p15_peer_and_enospc(torch, kernels, tmp,
                                                       device)
        by_run.update(d_launches)
        rec["d_peer_restore"] = peer
        rec["e_ckpt_enospc"] = enospc
        return time.perf_counter() - t1

    a, a_launches, side_s = p15_supervised_lm(torch, kernels, tmp, device,
                                              meanwhile)
    rec["a_supervised_full_width"] = a
    by_run.update(a_launches)
    log(f"phase 15a supervised LM: classes {a['classes']}, resumed at "
        f"{a['resumed_at']}, {time.perf_counter() - t0:.1f}s (15b-e "
        f"{side_s:.1f}s of it, beside the faulted run)")
    rec["wall_s"] = time.perf_counter() - t0
    rec["note"] = ("one card: 15b-e run beside 15a's faulted run, 15d's "
                   "two ranks share it over gloo; nccl at world > 1 and a "
                   "real multi-host shrink are not run")
    return rec, by_run


# ---- phase 16: the observers ----------------------------------------------

P16_STEPS = 8
# 16a's progress floor: above what any run reaches, so the first judged
# step records breach it (steps/min)
P16_SLO_STEPS_PER_MIN = 1e7
P16_WINDOW = 3                 # the flight recorder's trace window, records
P16_IMAGE = dict(synth_train_size=4096, synth_val_size=1024,
                 steps_per_dispatch=1, epochs=1)
# 16c: the tiny LM on three ranks (with two the reference's spike rule,
# spread >= 4 x p50, cannot hold: p50 of two ranks is their mean), a
# 2 s hang on rank 1 at step 3
P16_RANKS = 3
P16_TINY_LM = dict(batch_size=6, seq_len=96, d_model=128, num_layers=2,
                   num_heads=1, vocab_size=64, synth_tokens=4000, seed=SEED,
                   attn="flash", optimizer="fused_adamw", lr=3e-3,
                   grad_clip=0.5, weight_decay=0.1, print_freq=1,
                   max_steps=8, skew_every=2, flightrec_trace_steps=2,
                   watchdog_factor=0.0)
P16_HANG = "hang@step=3,secs=2"
# kernel-name fragments of the trace's device events (csrc/*.cu)
P16_TRACE_KERNELS = {"flash_fwd": "flash_fwd_kernel",
                     "flash_bwd_dq": "flash_bwd_dq_kernel",
                     "flash_bwd_dkv": "flash_bwd_dkv_kernel",
                     "adamw": "adamw_kernel", "sgd": "sgd_kernel"}


def free_ports(n):
    """A base port with ``n`` free ports from it (the metrics endpoints of
    ``n`` ranks)."""
    import socket

    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("0.0.0.0", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError(f"no {n} consecutive free ports")


def scrape(port, path="/metrics"):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.read().decode()


def series(text, name):
    """The value of an unlabeled series in a Prometheus text scrape."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


class Scraper:
    """Scrapes ``ports`` every ``every_s`` from a thread until stopped;
    ``seen`` holds (steps_total, mfu) of each scrape that answered."""

    def __init__(self, ports, every_s=0.05):
        import threading

        self.ports, self.every_s = ports, every_s
        self.seen = {p: [] for p in ports}
        self.errors = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self._stop.wait(self.every_s):
            for p in self.ports:
                try:
                    text = scrape(p)
                except OSError as e:
                    self.errors.append(repr(e))
                    continue
                self.seen[p].append((series(text, "tpu_dist_steps_total"),
                                     series(text, "tpu_dist_mfu")))

    def stop(self):
        self._stop.set()
        self._t.join(timeout=10)


def trace_kernels(path):
    """{kernel: device launches} of a Chrome trace, by P16_TRACE_KERNELS's
    name fragments, and the trace's ``ProfilerStep#`` ranges."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {k: 0 for k in P16_TRACE_KERNELS}
    steps = set()
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "kernel":
            for k, frag in P16_TRACE_KERNELS.items():
                if frag in name:
                    counts[k] += 1
        elif name.startswith("ProfilerStep#"):
            steps.add(name)
    return counts, len(steps)


def p16_step_ms(recs, skip):
    """Median step ms of the hot step records outside ``skip`` (steps)."""
    ms = [(r["data_s"] + r["dispatch_s"] + r["device_s"]) * 1e3
          for r in recs if r["event"] == "step" and not r["warm"]
          and r["step"] not in skip]
    return statistics.median(ms), len(ms)


def p16_lm_run(torch, kernels, d, name, device, **kw):
    """One 16a run of phase 6's LM for P16_STEPS steps, a drain a step:
    (records, launches, wall, trainer facts)."""
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.obs.ledger import read_ledger

    path = os.path.join(d, f"{name}.jsonl")
    cfg = full_lm_config(max_steps=P16_STEPS, print_freq=1, ledger_path=path,
                         **kw)
    if device == "cuda":
        free_device(torch)
    kernels.reset_launches()
    t0 = time.perf_counter()
    tr = LMTrainer(cfg, device=device)
    tr.fit()
    wall = time.perf_counter() - t0
    facts = {"layers": cfg.num_layers,
             "eval_batches": len(tr._epoch_indices(tr.val_ds, False, 0)[0])}
    del tr
    return read_ledger(path), dict(kernels.LAUNCHES), wall, facts


def p16_lm(torch, kernels, tmp, device):
    """16a (module docstring): phase 6's LM with the observers on, off, and
    under a ``profile_dir`` session."""
    d = os.path.join(tmp, "p16a")
    os.makedirs(d)
    port = free_ports(1)
    on_kw = dict(metrics_port=port, telemetry_csv=os.path.join(d, "hbm.csv"),
                 skew_every=4, watchdog_factor=10.0,
                 flightrec_trace_steps=P16_WINDOW,
                 slo_steps_per_min=P16_SLO_STEPS_PER_MIN)
    scraper = Scraper([port])
    try:
        on, on_launches, on_wall, facts = p16_lm_run(
            torch, kernels, d, "on", device, **on_kw)
    finally:
        scraper.stop()
    off, off_launches, _, _ = p16_lm_run(
        torch, kernels, d, "off", device, watchdog_factor=0.0,
        flightrec_trace_steps=0)
    prof_dir = os.path.join(d, "profile")
    prof, prof_launches, prof_wall, _ = p16_lm_run(
        torch, kernels, d, "profiled", device, profile_dir=prof_dir,
        **dict(on_kw, metrics_port=0, telemetry_csv=""))
    layers, n_eval = facts["layers"], facts["eval_batches"]
    ev = [r["event"] for r in on]
    steps = [r for r in on if r["event"] == "step"]
    if len(steps) != P16_STEPS or ev[-2:] != ["metrics_snapshot", "run_end"]:
        raise AssertionError(f"16a events {ev}")
    # the scrapes: steps_total rising, the MFU gauge one of the records'
    answered = [s for s in scraper.seen[port] if s[0]]
    rising = [(a, b) for a, b in zip(answered, answered[1:])
              if b[0] > a[0]]
    # off the card the records' mfu is None and the gauge stays at 0
    mfus = {r["mfu"] if r["mfu"] is not None else 0.0 for r in steps}
    if not rising or answered[-1][1] not in mfus:
        raise AssertionError(f"16a scrapes {scraper.seen[port]} "
                             f"(errors {scraper.errors[:3]}), mfu {mfus}")
    snap = on[-2]["metrics"]
    if snap["tpu_dist_mfu"][""] != (steps[-1]["mfu"] or 0.0) or \
            snap["tpu_dist_steps_total"][""] != P16_STEPS:
        raise AssertionError(f"16a metrics_snapshot {snap['tpu_dist_mfu']} "
                             f"{snap['tpu_dist_steps_total']}")
    # the telemetry CSV
    with open(on_kw["telemetry_csv"]) as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    hbm = [r for r in on if r["event"] == "hbm"]
    t_span = float(rows[-1][0]) - float(rows[0][0]) if rows else 0.0
    filled = [int(r[1]) for r in rows if r[1]]
    limit = int(rows[-1][3]) if rows and rows[-1][3] else None
    # about a row each 0.5 s: fewer where a row's hbm event waited on the
    # ledger's lock, which the recorder holds while it writes its window's
    # trace (under a second), never more
    per_span = t_span / 0.5 + 1
    if device == "cuda" and (
            not rows or len(filled) != len(rows) or limit is None
            or max(filled) > limit or len(hbm) != len(rows)
            or not 0.6 * per_span <= len(rows) <= per_span + 1):
        raise AssertionError(f"16a telemetry: {len(rows)} rows over "
                             f"{t_span:.2f}s, {len(hbm)} hbm events, "
                             f"filled {len(filled)}, limit {limit}")
    # the slo breach's bundle and its trace window
    diag = [r for r in on if r["event"] == "diagnosis"]
    if len(diag) != 1 or diag[0]["reason"] != "slo":
        raise AssertionError(f"16a diagnosis {diag}")
    bundle = diag[0]["bundle"]
    with open(os.path.join(bundle, "manifest.json")) as f:
        manifest = json.load(f)
    want_files = {"stacks.txt", "hbm.json", "events_tail.jsonl"}
    if device == "cuda":
        want_files.add("memory_snapshot.pickle")
    window_trace = os.path.join(bundle, "trace", "trace.json")
    if set(manifest["files"]) != want_files or \
            manifest["trace"]["status"] != "captured" or \
            not os.path.isfile(window_trace):
        raise AssertionError(f"16a bundle manifest {manifest}")
    # the window holds the steps dispatched after the record that started
    # it, up to the record that stopped it
    first = diag[0]["step"] + 2
    window_steps = list(range(first, first + P16_WINDOW))
    win_counts, win_marks = trace_kernels(window_trace)
    want_win = {"flash_fwd": layers * P16_WINDOW,
                "flash_bwd_dq": layers * P16_WINDOW,
                "flash_bwd_dkv": layers * P16_WINDOW,
                "adamw": P16_WINDOW, "sgd": 0}
    # the whole-fit profile: every dispatch and validation's forwards
    prof_counts, prof_marks = trace_kernels(os.path.join(prof_dir,
                                                         "trace.json"))
    want_prof = {"flash_fwd": layers * (P16_STEPS + n_eval),
                 "flash_bwd_dq": layers * P16_STEPS,
                 "flash_bwd_dkv": layers * P16_STEPS,
                 "adamw": P16_STEPS, "sgd": 0}
    if device == "cuda" and (win_counts != want_win
                             or prof_counts != want_prof
                             or prof_marks != P16_STEPS):
        raise AssertionError(f"16a trace kernels: window {win_counts} "
                             f"(want {want_win}), profile {prof_counts} "
                             f"(want {want_prof}), {prof_marks} step marks")
    prof_diag = [r for r in prof if r["event"] == "diagnosis"]
    if [r["trace"] for r in prof_diag] != ["skipped"]:
        raise AssertionError(f"16a profiled run's diagnosis {prof_diag}: "
                             "the window must stand down")
    # compile and cost_model
    comp = [r for r in on if r["event"] == "compile"]
    cost = [r for r in on if r["event"] == "cost_model"]
    if len(comp) != 1 or len(cost) != 1:
        raise AssertionError(f"16a compile {comp} cost_model {cost}")
    buckets = cost[0]["buckets"]
    top = max(buckets, key=lambda c: buckets[c]["flops"])
    if top != "matmul" or comp[0]["flops"] != cost[0]["total_flops"] or \
            (device == "cuda" and not comp[0]["hbm_bytes"]):
        raise AssertionError(f"16a cost buckets {buckets}, compile "
                             f"{comp[0]}")
    skews = [r for r in on if r["event"] == "skew"]
    if [r["n_procs"] for r in skews] != [1] * (P16_STEPS // 4):
        raise AssertionError(f"16a skew {skews}")
    # what the observers cost: hot steps outside the window, on vs off
    on_ms, n_on = p16_step_ms(on, set(window_steps))
    off_ms, n_off = p16_step_ms(off, set())
    prof_ms, n_prof = p16_step_ms(prof, set())
    return {
        "steps": P16_STEPS, "knobs": {k: v for k, v in on_kw.items()
                                      if k != "telemetry_csv"},
        "scrapes": len(scraper.seen[port]),
        "scraped_steps_total": [s[0] for s in answered],
        "scraped_mfu_last": answered[-1][1],
        "telemetry_rows": len(rows), "telemetry_span_s": t_span,
        "hbm_bytes_in_use_max": max(filled) if filled else None,
        "hbm_bytes_limit": limit,
        "slo_bundle": {"step": diag[0]["step"], "files": manifest["files"],
                       "trace": manifest["trace"],
                       "window_steps": window_steps,
                       "window_trace_kernels": win_counts},
        "profile_trace_kernels": prof_counts,
        "profile_step_marks": prof_marks,
        "profiled_run_window": prof_diag[0]["trace"],
        "compile": {k: comp[0][k] for k in ("program", "seconds",
                                            "hbm_bytes", "flops")},
        "cost_model_flops": {c: b["flops"] for c, b in buckets.items()},
        "cost_model_bytes": {c: b["bytes"] for c, b in buckets.items()},
        "skew_events": len(skews),
        "step_ms_observers_on": on_ms, "step_ms_observers_off": off_ms,
        "step_ms_profiled": prof_ms,
        "hot_steps_compared": [n_on, n_off, n_prof],
        "observer_cost_ms_per_step": on_ms - off_ms,
        "wall_s": {"on": on_wall, "profiled": prof_wall},
    }, {"p16a_observers_on": on_launches, "p16a_observers_off": off_launches,
        "p16a_profiled": prof_launches}


def p16_image(torch, kernels, tmp, device):
    """16b (module docstring): ``scripts.image_train`` at BENCH_GEOMETRY cut
    to P16_IMAGE, with telemetry, a profile and skew every 2 steps, and a
    SIGUSR1 once the ledger shows step 1."""
    import signal
    import threading

    from tpu_dist_torch.obs.ledger import read_ledger
    from tpu_dist_torch.scripts import image_train

    d = os.path.join(tmp, "p16b")
    os.makedirs(d)
    path = os.path.join(d, "run.jsonl")
    geom = {**image_train.BENCH_GEOMETRY, **P16_IMAGE}
    argv = [a for k, v in geom.items()
            for a in (f"--{k.replace('_', '-')}", str(v))]
    prof_dir = os.path.join(d, "profile")
    argv += ["--data", os.path.join(d, "no-data"), "--checkpoint-dir", "",
             "--ledger-path", path, "--log-csv", "", "--print-freq", "1",
             "--telemetry-csv", os.path.join(d, "hbm.csv"),
             "--profile-dir", prof_dir, "--skew-every", "2",
             "--device", device]
    sent = []
    done = threading.Event()

    def send_at_step_1():
        while not done.wait(0.05):
            try:
                recs = read_ledger(path, validate=False, strict=False)
            except OSError:
                continue
            if any(r["event"] == "step" and r["step"] >= 1 for r in recs):
                os.kill(os.getpid(), signal.SIGUSR1)
                sent.append(time.time())
                return

    # a signal that lands after the run restored its handler is ignored
    prev = signal.signal(signal.SIGUSR1, lambda *a: None)
    sender = threading.Thread(target=send_at_step_1, daemon=True)
    sender.start()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        tr = image_train.main(argv)
    finally:
        done.set()
        sender.join(timeout=10)
        signal.signal(signal.SIGUSR1, prev)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    recs = read_ledger(path)
    steps = [r for r in recs if r["event"] == "step"]
    diag = [r for r in recs if r["event"] == "diagnosis"]
    skews = [r for r in recs if r["event"] == "skew"]
    n = sum(r["steps_in_dispatch"] for r in steps)
    counts, marks = trace_kernels(os.path.join(prof_dir, "trace.json"))
    with open(os.path.join(d, "hbm.csv")) as f:
        rows = f.read().splitlines()[1:]
    if not sent or [r["reason"] for r in diag] != ["sigusr1"]:
        raise AssertionError(f"16b SIGUSR1 sent {sent}, diagnosis {diag}")
    if n != tr.steps_per_epoch or len(skews) != n // 2 or not rows:
        raise AssertionError(f"16b {n} steps, skew {skews}, {len(rows)} "
                             "telemetry rows")
    if device == "cuda" and (counts["sgd"] != n or launches["sgd"] != n
                             or marks != n):
        raise AssertionError(f"16b trace {counts}, {marks} step marks, "
                             f"launches {launches} for {n} steps")
    return {"config": geom, "steps": n, "sigusr1_diagnosis": {
                k: diag[0][k] for k in ("reason", "step", "trace")},
            "skew_events": len(skews), "telemetry_rows": len(rows),
            "trace_kernels": counts, "trace_step_marks": marks,
            "step_ms": p16_step_ms(recs, set())[0], "wall_s": wall}, launches


def p16_rank_job(torch, kernels, job, out, rank):
    """A 16c rank: the tiny LM with skew, the flight recorder and the
    metrics endpoint at ``metrics_port + rank`` (rank 1 with the hang),
    scraping every rank's endpoint while it trains."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.obs.ledger import per_process_path, read_ledger

    cfg = dict(job["cfg"], ledger_path=os.path.join(out, "obs16.jsonl"))
    if rank == 1:
        cfg["faults"] = P16_HANG
    base = cfg["metrics_port"]
    scraper = Scraper([base + r for r in range(job["world"])], every_s=0.2)
    kernels.reset_launches()
    try:
        LMTrainer(LMConfig(**cfg), device=job["device"]).fit()
    finally:
        scraper.stop()
    recs = read_ledger(per_process_path(cfg["ledger_path"], rank))
    return {"launches": dict(kernels.LAUNCHES),
            "skew": [r for r in recs if r["event"] == "skew"],
            "diagnosis": [r for r in recs if r["event"] == "diagnosis"],
            "scraped": {str(p): [s[0] for s in v]
                        for p, v in scraper.seen.items()}}


def p16_ranks(torch, kernels, tmp, device):
    """16c (module docstring): P16_RANKS gloo ranks sharing the device, then
    the port's trace_merge over their ledgers."""
    from tpu_dist_torch.tools import trace_merge

    base = free_ports(P16_RANKS)
    job = {"name": "p16c", "kind": "obs16", "world": P16_RANKS,
           "cfg": dict(P16_TINY_LM, metrics_port=base)}
    group = DpGroup("p16c", P16_RANKS, device, "gloo", [job], tmp)
    res = [r["p16c"] for r in group.wait(300)]
    skews = [r["skew"] for r in res]
    stats = [[{k: v for k, v in s.items() if k not in ("ts", "pid")}
              for s in sk] for sk in skews]
    if any(s != stats[0] for s in stats) or \
            {s["n_procs"] for s in stats[0]} != {P16_RANKS}:
        raise AssertionError(f"16c skew differs by rank: {stats}")
    spike = [s for s in stats[0] if s["spread_s"] >= 0.5]
    if len(spike) != 1 or spike[0]["straggler"] != 1:
        raise AssertionError(f"16c straggler: {stats[0]}")
    diags = [[(d["reason"], d["step"]) for d in r["diagnosis"]] for r in res]
    if any(dg != [("skew", spike[0]["step"])] for dg in diags):
        raise AssertionError(f"16c skew bundles by rank: {diags}")
    answered = {p: max(v or [0]) for p, v in res[0]["scraped"].items()}
    if sorted(answered) != [str(base + r) for r in range(P16_RANKS)] or \
            not all(v and v > 0 for v in answered.values()):
        raise AssertionError(f"16c endpoints: {res[0]['scraped']}")
    out = os.path.join(group.out, "merged.json")
    if trace_merge.main([os.path.join(group.out, "obs16.jsonl"), "-o", out]):
        raise AssertionError("16c trace_merge failed")
    with open(out) as f:
        merged = json.load(f)
    lanes = {e["pid"] for e in merged["traceEvents"]
             if e.get("name") == "process_name"}
    if merged["otherData"]["processes"] != P16_RANKS or \
            lanes != set(range(P16_RANKS)):
        raise AssertionError(f"16c merged lanes {lanes}: "
                             f"{merged['otherData']}")
    return {"ranks": P16_RANKS, "hang": P16_HANG, "skew": stats[0],
            "spike": spike[0], "bundles_by_rank": diags,
            "endpoints_steps_total": answered,
            "merged": {"processes": merged["otherData"]["processes"],
                       "events": len(merged["traceEvents"])}}, {
        f"p16c_rank{r}": x["launches"] for r, x in enumerate(res)}


def observers_path(torch, kernels, tmp, device="cuda"):
    """Phase 16 (module docstring). Returns (record, launches by run).
    ``device="cpu"`` rehearses its control flow on the CPU (with
    ``full_lm_config`` patched to a tiny width and P16_IMAGE narrowed)."""
    t0 = time.perf_counter()
    rec, by_run = {}, {}
    rec["a_lm_observers"], a_launches = p16_lm(torch, kernels, tmp, device)
    by_run.update(a_launches)
    log(f"phase 16a took {time.perf_counter() - t0:.1f}s")
    if device == "cuda":
        free_device(torch)
    rec["b_image_observers"], by_run["p16b_image"] = p16_image(
        torch, kernels, tmp, device)
    rec["c_ranks"], c_launches = p16_ranks(torch, kernels, tmp, device)
    by_run.update(c_launches)
    rec["wall_s"] = time.perf_counter() - t0
    rec["note"] = (f"one card: 16c's {P16_RANKS} ranks share it over gloo; "
                   "16a's observer cost compares runs of one call")
    return rec, by_run


# ---- phase 17: the plan lowering -------------------------------------------

# phase 6's LM as the tuner's workload: its parameters, tokens a step, one
# device
P17_WORKLOAD = {"n_params": LM_PARAMS, "tokens_per_step": 8 * 2048,
                "devices": 1}
P17_STEPS = 8
# the tiles 17b's second run forces when the plan's are the defaults
P17_OTHER_TILES = ((256, 128, 512), 1024)
# 17c: fused_quant at phase 6's int8 shapes (M = B x L = 16,384) and a
# decode tick's lm_head, for every instantiated tile at bk 0 and 512
P17_QUANT_SHAPES = {"qkv": (16384, 1024, 3072), "proj": (16384, 1024, 1024),
                    "mlp_in": (16384, 1024, 4096),
                    "mlp_out": (16384, 4096, 1024),
                    "head": (16384, 1024, 32000),
                    "decode lm_head": (8, 1024, 32000)}
P17_BKS = (0, 512)
P17_ROWS = (8, 512, 1024)
# 17d: BENCH_GEOMETRY cut to 4 steps
P17_IMAGE = dict(synth_train_size=4096, synth_val_size=1024, epochs=1)
# 17e: phase 4's tiny image model on a (1, 2) data x model mesh, 4 steps
P17_TINY_IMAGE = dict(DP_TINY_IMAGE, synth_train_size=64)


def p17_tune(torch, tmp, device_kind, card=True):
    """17a: ``python -m tpu_dist_torch.tools.tune`` twice for the card's
    kind at phase 6's workload: byte-identical output, the port's peaks
    (``card``: the H100's); returns (record, plan file path)."""
    from tpu_dist_torch.plan.ir import Plan, plan_hash, plan_knob_summary
    from tpu_dist_torch.plan.tune import device_peaks

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(tmp, "plans.json")
    outs, t0 = [], time.perf_counter()
    for i in range(2):
        r = subprocess.run(
            [sys.executable, "-m", "tpu_dist_torch.tools.tune",
             "--device-kind", device_kind, "--workload",
             json.dumps(P17_WORKLOAD), "--json"]
            + (["--out", path] if i == 0 else []),
            cwd=here, capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise AssertionError(f"17a tune: rc {r.returncode}\n{r.stderr}")
        outs.append(r.stdout)
    if outs[0] != outs[1] or not outs[0].strip():
        raise AssertionError("17a: the tuner's two outputs differ")
    peaks = device_peaks(device_kind)
    entry = json.loads(outs[0])["plans"][device_kind]
    plan = Plan.from_dict(entry)
    if card and ((peaks["tflops"], peaks["gbps"], peaks["nominal"],
                  entry["score"]["peaks_nominal"]) !=
                 (989.0, 3350.0, False, False)):
        raise AssertionError(f"17a peaks {peaks}, entry {entry}")
    if plan_hash(plan) != entry["hash"]:
        raise AssertionError(f"17a plan entry {entry}")
    return {"device_kind": device_kind, "workload": P17_WORKLOAD,
            "peaks": peaks, "candidates": entry["score"]["candidates"],
            "plan_hash": entry["hash"], "knobs": plan_knob_summary(plan),
            "step_s_estimate": entry["score"]["step_s"],
            "byte_identical": True, "bytes": len(outs[0]),
            "two_runs_s": time.perf_counter() - t0}, path


def p17_lm_run(torch, kernels, tmp, name, plan_path, device):
    """One 17b run: phase 6's LM driven by ``plan_path`` for P17_STEPS
    steps; (trainer, step losses, ledger records, launches)."""
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.obs.ledger import read_ledger

    if device == "cuda":
        free_device(torch)
    path = os.path.join(tmp, f"{name}.jsonl")
    cfg = full_lm_config(plan=plan_path, max_steps=P17_STEPS, print_freq=1,
                         ledger_path=path)
    tr = LMTrainer(cfg, device=device)
    kernels.reset_launches()
    tr.fit()
    launches = dict(kernels.LAUNCHES)
    recs = read_ledger(path)
    return tr, [r["loss"] for r in recs if r["event"] == "step"], recs, \
        launches


def p17_lm(torch, kernels, tmp, plan_path, device):
    """17b (module docstring): the tuned plan's run and the same steps at
    other tiles, bit-equal."""
    from tpu_dist_torch.plan.compile import current_switches, device_kind
    from tpu_dist_torch.plan.ir import (DEFAULT_OPT_BLOCK_ROWS,
                                        DEFAULT_QUANT_BLOCK, load_plan_file,
                                        plan_for_device, plan_hash)

    kind = device_kind(device)
    plan = plan_for_device(load_plan_file(plan_path), kind)
    t0 = time.perf_counter()
    tr, losses, recs, launches = p17_lm_run(torch, kernels, tmp, "p17b",
                                            plan_path, device)
    wall_a = time.perf_counter() - t0
    for k in ("quant", "precision", "grad_bucket_mb", "steps_per_dispatch",
              "grad_accum_steps", "health", "loss_chunk"):
        if getattr(tr.cfg, k) != getattr(plan, k):
            raise AssertionError(f"17b cfg.{k} {getattr(tr.cfg, k)!r} != "
                                 f"the plan's {getattr(plan, k)!r}")
    sw = current_switches()
    if (sw["quant_block"], sw["opt_block_rows"]) != \
            (plan.quant_block, plan.opt_block_rows):
        raise AssertionError(f"17b switches {sw} for plan {plan}")
    events = [r["event"] for r in recs]
    if events[:2] != ["run_start", "plan"] or events.count("plan") != 1 or \
            recs[0]["plan_hash"] != plan_hash(plan):
        raise AssertionError(f"17b ledger head {events[:3]}, run_start "
                             f"hash {recs[0].get('plan_hash')}")
    if len(losses) != P17_STEPS or not all(map(math.isfinite, losses)) or \
            not statistics.mean(losses[-3:]) < statistics.mean(losses[:3]):
        raise AssertionError(f"17b losses {losses}")
    n_eval = len(tr._epoch_indices(tr.val_ds, False, 0)[0])
    layers, dense = 8, 8 * 4 + 1     # qkv, proj, mlp_in, mlp_out; head
    int8 = plan.quant == "int8" and plan.fused_quant != "off"
    want = {"adamw": P17_STEPS,
            "fused_quant": dense * (P17_STEPS + n_eval) if int8 else 0,
            "flash_bwd_dq": layers * P17_STEPS,
            "flash_fwd": layers * (P17_STEPS + n_eval)}
    if device == "cuda" and any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"17b launches {launches}, want {want}")
    step_ms = statistics.median(
        (r["data_s"] + r["dispatch_s"] + r["device_s"]) * 1e3
        for r in recs if r["event"] == "step" and not r["warm"])
    # the same steps at other tiles: the defaults, or (the plan's being
    # the defaults) the ones of P17_OTHER_TILES
    if (plan.quant_block, plan.opt_block_rows) == \
            (DEFAULT_QUANT_BLOCK, DEFAULT_OPT_BLOCK_ROWS):
        qb, rows = P17_OTHER_TILES
    else:
        qb, rows = DEFAULT_QUANT_BLOCK, DEFAULT_OPT_BLOCK_ROWS
    other = dataclasses.replace(plan, quant_block=qb, opt_block_rows=rows)
    other_path = os.path.join(tmp, "plan_other_tiles.json")
    with open(other_path, "w") as f:
        f.write(other.to_json())
    del tr
    t0 = time.perf_counter()
    tr2, losses2, recs2, launches2 = p17_lm_run(torch, kernels, tmp,
                                                "p17b_tiles", other_path,
                                                device)
    wall_b = time.perf_counter() - t0
    if current_switches()["quant_block"] != tuple(qb) or \
            recs2[0]["plan_hash"] != plan_hash(other):
        raise AssertionError(f"17b second run: {current_switches()}")
    if losses2 != losses:
        raise AssertionError(f"17b losses at tiles {qb}/{rows}: {losses2} "
                             f"!= the plan's {losses}")
    if device == "cuda" and launches2 != launches:
        raise AssertionError(f"17b launches {launches2} != {launches}")
    step_ms2 = statistics.median(
        (r["data_s"] + r["dispatch_s"] + r["device_s"]) * 1e3
        for r in recs2 if r["event"] == "step" and not r["warm"])
    del tr2
    return {"plan_hash": plan_hash(plan), "precision": plan.precision,
            "quant": plan.quant, "quant_block": list(plan.quant_block),
            "opt_block_rows": plan.opt_block_rows, "steps": P17_STEPS,
            "losses": losses, "step_ms_median": step_ms,
            "launches": {k: launches[k] for k in want},
            "launches_per_step_train": {
                "adamw": launches["adamw"] / P17_STEPS,
                "flash_bwd_dq": launches["flash_bwd_dq"] / P17_STEPS},
            "eval_batches": n_eval,
            "other_tiles": {"quant_block": list(qb), "opt_block_rows": rows,
                            "plan_hash": plan_hash(other),
                            "losses_bit_equal": True,
                            "step_ms_median": step_ms2},
            "walls_s": [wall_a, wall_b]}, {"p17b_plan_lm": launches,
                                           "p17b_other_tiles": launches2}


def p17_quant_sweep(torch):
    """17c, fused_quant: every instantiated tile at bk 0 and 512 on
    P17_QUANT_SHAPES, bit-equal to the plain version and to the default
    tile, timed; a tile the plan IR refuses refused by the IR."""
    from tpu_dist_torch.ops import pallas_quant as pq

    own = torch.Generator(device="cuda").manual_seed(SEED + 17)
    recs = {}
    try:
        for label, (m, k, n) in P17_QUANT_SHAPES.items():
            x = torch.randn((m, k), generator=own, device="cuda").to(
                torch.bfloat16)
            w = (torch.randn((k, n), generator=own, device="cuda")
                 / math.sqrt(k)).to(torch.bfloat16)
            ref = pq.fused_quant_matmul_plain(x, w)
            plain_ms = time_ms(torch, lambda: pq.fused_quant_matmul_plain(
                x, w), iters=3, warmup=1)
            pq.set_quant_blocks()
            default = pq.fused_quant_cuda(x, w)
            if not torch.equal(default, ref):
                raise AssertionError(f"17c {label}: the default tile is not "
                                     "bit-equal to the plain version")
            del ref
            ops = 2.0 * m * n * k
            nbytes = 2 * (m * k + k * n + m * n)
            t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
            row = {"shape": f"M{m} K{k} N{n} bf16", "plain_ms": plain_ms,
                   "bound_ms": max(t_ops, t_bytes) * 1e3,
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "ms": {}}
            for bm, bn in pq.INSTANTIATED_TILES:
                for bk in P17_BKS:
                    pq.set_quant_blocks(bm, bn, bk)
                    out = pq.fused_quant_cuda(x, w)
                    if not torch.equal(out, default):
                        raise AssertionError(
                            f"17c {label} tile {(bm, bn, bk)}: not bit-equal "
                            "to the default tile")
                    del out
                    row["ms"][f"{bm}x{bn}/bk{bk}"] = time_ms(
                        torch, lambda: pq.fused_quant_cuda(x, w))
            recs[label] = row
            del x, w, default
            free_device(torch)
        from tpu_dist_torch.plan.ir import PlanError

        try:
            pq.set_quant_blocks(12, 128, 0)  # bm not a multiple of 8
        except PlanError as e:
            if "quant_block bm=12" not in str(e):
                raise
            refusal = str(e)
        else:
            raise AssertionError("17c: tile (12, 128, 0) was not refused")
    finally:
        pq.set_quant_blocks()
    return {"shapes": recs, "bit_equal": "every tile and bk, to the plain "
            "version and to the default 128x128/bk0", "refused": refusal}


def p17_rows_sweep(torch):
    """17c, sgd and adamw: ResNet-50's 161 leaves and the LM's 85 at
    opt_block_rows in P17_ROWS, within FP32_TOL of the plain version and
    bit-equal across the values, timed."""
    from tpu_dist_torch.models.registry import create_model
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.ops import pallas_adamw as pa
    from tpu_dist_torch.ops import pallas_sgd as ps

    own = torch.Generator(device="cuda").manual_seed(SEED + 18)
    rand = lambda s: torch.randn(s, generator=own, device="cuda")
    out = {}
    for name, model in (
            ("sgd", create_model("resnet50", num_classes=10, stem="s2d",
                                 device="cuda", seed=SEED)),
            ("adamw", TransformerLM(vocab_size=32000, num_layers=8,
                                    d_model=1024, num_heads=8, max_len=2048,
                                    device="cuda", seed=SEED))):
        shapes = [tuple(p.shape) for p in model.parameters()]
        del model
        n = sum(math.prod(s) for s in shapes)
        p0 = [rand(s) for s in shapes]
        g = [rand(s) for s in shapes]
        m0 = [rand(s) * 1e-3 for s in shapes]
        v0 = [torch.rand(s, generator=own, device="cuda") * 1e-6
              for s in shapes]
        if name == "sgd":
            row = ps.scalar_row(0.1, 0.9, 1e-4,
                                torch.tensor(0.3, device="cuda"))
            bufs = (m0,)
            kernel = lambda p, m: ps.fused_sgd_multi_cuda(p, g, *m, row)
            plain = lambda i, p, m: ps.fused_sgd_plain(p[i], g[i], m[0][i],
                                                       row)
            per_el = 20.0
        else:
            row = pa.scalar_row(1e-3, 0.9, 0.95, 1e-8, 0.1, 3,
                                torch.tensor(0.5, device="cuda"))
            bufs = (m0, v0)
            kernel = lambda p, m: pa.fused_adamw_multi_cuda(p, g, *m, row)
            plain = lambda i, p, m: pa.fused_adamw_plain(
                p[i], g[i], m[0][i], m[1][i], row)
            per_el = 28.0
        ref = [[t.clone() for t in ts] for ts in (p0, *bufs)]
        for i in range(len(shapes)):
            plain(i, ref[0], ref[1:])
        results, rec = {}, {"leaves": len(shapes), "elements": n, "ms": {},
                            "bound_ms": per_el * n / PEAK_BYTES * 1e3,
                            "bound_by": "bytes"}
        try:
            for rows in P17_ROWS:
                ps.set_block_rows(rows)
                got = [[t.clone() for t in ts] for ts in (p0, *bufs)]
                kernel(got[0], got[1:])
                torch.cuda.synchronize()
                for a_list, r_list in zip(got, ref):
                    for a, r in zip(a_list, r_list):
                        if not bool(((a - r).abs() <= FP32_TOL * (
                                1 + r.abs())).all()):
                            raise AssertionError(
                                f"17c {name} rows {rows}: beyond "
                                f"{FP32_TOL} (1 + |plain|)")
                results[rows] = got
                work = [[t.clone() for t in ts] for ts in (p0, *bufs)]
                rec["ms"][str(rows)] = time_ms(
                    torch, lambda: kernel(work[0], work[1:]))
                del work
        finally:
            ps.set_block_rows()
        for rows in P17_ROWS:
            if not all(torch.equal(a, b) for x, y in zip(results[rows],
                                                         results[512])
                       for a, b in zip(x, y)):
                raise AssertionError(f"17c {name}: rows {rows} not "
                                     "bit-equal to 512")
        rec["chunk_elements"] = {str(r): ps.ROW * r for r in P17_ROWS}
        rec["bit_equal_across_rows"] = True
        out[name] = rec
        del p0, g, m0, v0, ref, results
        free_device(torch)
    return out


def p17_image_auto(torch, kernels, tmp, device):
    """17d: the image Trainer with plan="auto" on ResNet-50 at
    BENCH_GEOMETRY cut to P17_IMAGE, without cuDNN's autotuning."""
    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine.loop import Trainer
    from tpu_dist_torch.obs.ledger import read_ledger
    from tpu_dist_torch.scripts import image_train

    path = os.path.join(tmp, "p17d.jsonl")
    cfg = TrainConfig(**{**image_train.BENCH_GEOMETRY, **P17_IMAGE},
                      plan="auto", ledger_path=path, log_csv="",
                      checkpoint_dir="", print_freq=1,
                      data=os.path.join(tmp, "no-data"))
    t0 = time.perf_counter()
    tr = Trainer(cfg, device=device)
    # no cuDNN autotuning for 4 steps (the time limit), as 11a
    torch.backends.cudnn.benchmark = False
    kernels.reset_launches()
    try:
        tr.fit()
    finally:
        torch.backends.cudnn.benchmark = device == "cuda"
    launches = dict(kernels.LAUNCHES)
    recs = read_ledger(path)
    info = tr._plan_info
    steps = [r for r in recs if r["event"] == "step"]
    n = sum(r["steps_in_dispatch"] for r in steps)
    if info["source"] != "auto" or recs[0]["plan_hash"] != info["hash"] or \
            [r["event"] for r in recs].count("plan") != 1:
        raise AssertionError(f"17d plan {info}, run_start "
                             f"{recs[0].get('plan_hash')}")
    if n != tr.steps_per_epoch or (device == "cuda"
                                   and launches["sgd"] != n):
        raise AssertionError(f"17d {n} steps, launches {launches}")
    rec = {"plan_hash": info["hash"], "source": info["source"],
           "knobs": info["knobs"], "variant": tr.cfg.variant, "steps": n,
           "losses": [r["loss"] for r in steps],
           "sgd_launches": launches["sgd"], "wall_s":
           time.perf_counter() - t0}
    del tr
    return rec, launches


def p17_rank_job(torch, kernels, job, out, rank):
    """A 17e rank: phase 4's tiny image Trainer on the job's mesh; the
    step losses (rank 0) and a digest of the final params."""
    import hashlib

    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine.loop import Trainer

    cfg = dict(job["cfg"], ledger_path=os.path.join(out, f"{job['name']}"
                                                    ".jsonl"),
               data=os.path.join(out, "no-data"), checkpoint_dir="")
    with open(job["init"], "rb") as f:
        init = torch.load(f, weights_only=False)
    kernels.reset_launches()
    tr = Trainer(TrainConfig(**cfg), device=job["device"],
                 init_params=init[0], init_batch_stats=init[1])
    tr.fit()
    digest = hashlib.sha256()
    for p in tr.state.params:
        digest.update(p.detach().float().cpu().numpy().tobytes())
    res = {"digest": digest.hexdigest(), "step": tr.state.step,
           "layout": tr.compiled.plan.layout,
           "local_batch": tr.local_batch, "launches": dict(kernels.LAUNCHES)}
    if rank == 0:
        res["losses"] = [r["loss"] for r in ledger_steps(cfg["ledger_path"])]
    return res


def p17_gspmd_start(torch, tmp, device):
    """Start 17e's two ranks (they run beside 17a-d); returns what
    :func:`p17_gspmd` needs."""
    from tpu_dist_torch.interop import export_flax_image_params
    from tpu_dist_torch.models.resnet import ResNet18

    init_path = os.path.join(tmp, "p17e_init.pt")
    torch.save(export_flax_image_params(ResNet18(device="cpu", seed=SEED)),
               init_path)
    job = {"name": "p17e", "kind": "plan17", "init": init_path,
           "cfg": dict(P17_TINY_IMAGE, mesh_shape=[1, 2],
                       mesh_axes=["data", "model"], tp_impl="gspmd")}
    return (DpGroup("p17e", 2, device, "gloo", [job], tmp), init_path,
            time.perf_counter())


def p17_gspmd(torch, kernels, tmp, device, started):
    """17e: two gloo ranks sharing the device on a (1, 2) data x model
    mesh under tp_impl="gspmd" (started by :func:`p17_gspmd_start`),
    against one rank's dp run (in this process) at the same batch and
    weights."""
    group, init_path, t0 = started
    out = os.path.join(tmp, "p17e_dp")
    os.makedirs(out)
    single = p17_rank_job(torch, kernels, {
        "name": "p17e_dp", "init": init_path, "device": device,
        "cfg": dict(P17_TINY_IMAGE)}, out, 0)
    pair = [r["p17e"] for r in group.wait(300)]
    got, want = pair[0]["losses"], single["losses"]
    if len(got) != 4 or len(want) != 4:
        raise AssertionError(f"17e steps: {got} vs {want}")
    for i, (a, b) in enumerate(zip(got, want)):
        if abs(a - b) > LOSS_TOL * (1 + abs(b)):
            raise AssertionError(f"17e step {i}: {a} vs the one-rank "
                                 f"{b} (tol {LOSS_TOL} (1 + |loss|))")
    if pair[0]["digest"] != pair[1]["digest"] or \
            {r["layout"] for r in pair} != {"tp"} or \
            {r["local_batch"] for r in pair} != {P17_TINY_IMAGE[
                "batch_size"]}:
        raise AssertionError(f"17e ranks: {pair}")
    return {"mesh": {"data": 1, "model": 2}, "tp_impl": "gspmd",
            "losses": got, "one_rank_losses": want,
            "max_abs_diff": max(abs(a - b) for a, b in zip(got, want)),
            "params_bit_equal_across_ranks": True,
            "wall_s": time.perf_counter() - t0}, {
        "p17e_rank0": pair[0]["launches"], "p17e_rank1": pair[1]["launches"],
        "p17e_one_rank": single["launches"]}


def plan_path(torch, kernels, tmp, device="cuda"):
    """Phase 17 (module docstring). Returns (record, launches by run).
    ``device="cpu"`` rehearses its control flow on the CPU (with
    ``full_lm_config`` patched to a tiny width, P17_IMAGE narrowed and 17c
    left out: it times the kernels)."""
    from tpu_dist_torch.plan.compile import activate_plan
    from tpu_dist_torch.plan.ir import Plan

    t0 = time.perf_counter()
    rec, by_run = {}, {}
    kind = (torch.cuda.get_device_name(0) if device == "cuda" else "cpu")
    # 17e's ranks start first and run beside the tuner (17a)
    started = p17_gspmd_start(torch, tmp, device)
    try:
        rec["a_tuner"], plan_file = p17_tune(torch, tmp, kind,
                                             card=device == "cuda")
        rec["b_plan_lm"], b_launches = p17_lm(torch, kernels, tmp,
                                              plan_file, device)
        by_run.update(b_launches)
        if device == "cuda":
            free_device(torch)
            rec["c_tiles"] = {"fused_quant": p17_quant_sweep(torch),
                              **p17_rows_sweep(torch)}
        rec["d_image_auto"], by_run["p17d_image_auto"] = p17_image_auto(
            torch, kernels, tmp, device)
        activate_plan(Plan())     # 17e's one-rank twin at the defaults
        rec["e_gspmd_model_axis"], e_launches = p17_gspmd(
            torch, kernels, tmp, device, started)
        by_run.update(e_launches)
    except BaseException:
        started[0].kill()
        raise
    finally:
        activate_plan(Plan())     # the plans' switches are process-wide
    rec["wall_s"] = time.perf_counter() - t0
    rec["note"] = ("one card: 17e's two ranks share it over gloo, started "
                   "beside 17a; 17b's two runs and 17c's tiles compare "
                   "within one call")
    return rec, by_run


# ---- phase 18: the fleet ---------------------------------------------------

# 18a: scripts/fleet_ci.json with phase 5's widths (fp32: the scenario
# grammar has no dtype both packages read alike) and the int8 flash pages
P18_CI_MODEL = dict(vocab_size=32000, num_layers=8, d_model=1024,
                    num_heads=8, max_len=2048)
P18_CI_SERVE = dict(page_size=16, num_pages=1024, kv_quant="int8",
                    attn_read="flash")
P18_CI_HISTOGRAM = {"preemption_snapshotted": 3, "clean": 3}
P18_UP_WINDOW = 64       # ticks after the burst's start for the first up
P18_TIMEOUT_S = 240      # each fleet's wall bound (the runner's own too)


def p18_fleet(scenario, out, device, device_kind=None):
    """Start ``python -m tpu_dist_torch.sim.runner`` on ``scenario`` into
    ``out`` (its stderr to ``out``.log): the Popen and the log path."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_DIST_", "SLURM_"))}
    env["PYTHONPATH"] = here + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "tpu_dist_torch.sim.runner", "--scenario",
           scenario, "--out", out, "--device", device,
           "--timeout-s", str(P18_TIMEOUT_S)]
    if device_kind:
        cmd += ["--device-kind", device_kind]
    log_path = out + ".log"
    with open(log_path, "w") as errf:
        proc = subprocess.Popen(cmd, env=env, cwd=here, stderr=errf,
                                stdout=subprocess.DEVNULL)
    return proc, log_path


def p18_wait(name, proc, log_path):
    try:
        rc = proc.wait(timeout=P18_TIMEOUT_S + 120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    if rc != 0:
        with open(log_path, errors="replace") as f:
            tail = f.read()[-6000:]
        raise AssertionError(f"18 {name}: the runner exited {rc}:\n{tail}")


def p18_attempt_ends(out):
    """Every worker attempt's ``run_end`` record, by host: a list of
    (ledger name, run_end or None)."""
    from tpu_dist_torch.obs.goodput import discover_attempt_paths
    from tpu_dist_torch.obs.ledger import read_ledger

    ends = {}
    for d in sorted(os.listdir(out)):
        m = re.fullmatch(r"host(\d+)", d)
        base = os.path.join(out, d, "run.jsonl")
        if not m or not os.path.exists(base):
            continue
        rows = []
        for path in discover_attempt_paths(base):
            recs = read_ledger(path, validate=False, strict=False)
            end = [r for r in recs if r.get("event") == "run_end"]
            rows.append((os.path.basename(path), end[-1] if end else None))
        ends[int(m.group(1))] = rows
    return ends


def p18_launches(kernels, ends):
    """Kernel launches summed over every attempt's run_end extras."""
    total = {k: 0 for k in kernels.LAUNCHES}
    for rows in ends.values():
        for _, end in rows:
            for k, n in ((end or {}).get("launches") or {}).items():
                total[k] = total.get(k, 0) + n
    return total


def p18_check_ci(kernels, out, scenario, layers, device):
    """18a's checks (module docstring) over the finished fleet dir."""
    import contextlib
    import io

    from tpu_dist_torch.obs.goodput import (job_accounting, load_job_records,
                                            split_attempts)
    from tpu_dist_torch.sim.fleet import FleetLedger
    from tpu_dist_torch.sim.scenario import (expected_restart_classes,
                                             load_scenario)
    from tpu_dist_torch.tools import request_report

    sc = load_scenario(scenario)
    fleet = FleetLedger.discover(out, warn=lambda m: None)
    report = json.loads(json.dumps(fleet.report(), default=str))
    want = {str(h): c for h, c in expected_restart_classes(sc).items()}
    if report["restart_classes"] != want or \
            report["restart_histogram"] != P18_CI_HISTOGRAM:
        raise AssertionError(f"18a restart classes "
                             f"{report['restart_classes']} (want {want}), "
                             f"histogram {report['restart_histogram']}")
    elas = report["elasticity"]
    scales = [(e["action"], e["processes"]) for e in elas
              if e["host"] == 0 and e["action"] in ("shrink", "expand")]
    if scales != [("shrink", 2), ("expand", 3)] or not any(
            e["action"] == "drain" and e["host"] == 1 for e in elas):
        raise AssertionError(f"18a elasticity {elas}")
    acct = report["fleet"]
    if abs(acct["sum_check"] - 1.0) > 0.02:
        raise AssertionError(f"18a goodput sum_check {acct}")
    tenants = report["per_tenant"]
    if set(tenants) != {"chat", "batch"} or \
            not all(t["requests"] > 0 for t in tenants.values()):
        raise AssertionError(f"18a tenants {tenants}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = request_report.main([out, "--json"])
    req = json.loads(buf.getvalue())
    ex = req["slo_exemplars"]
    if rc != 0 or len(ex) != report["slo_breaches"] or \
            not all(b["exemplars"] for b in ex) or \
            not req["tail_attribution"]["sum_check"]["ok"]:
        raise AssertionError(f"18a request report: {len(ex)} breach "
                             f"exemplar sets for {report['slo_breaches']} "
                             f"breaches, sum_check "
                             f"{req['tail_attribution']['sum_check']}")
    ends = p18_attempt_ends(out)
    per_attempt = {}
    for h, rows in ends.items():
        for led, end in rows:
            if end is None or "ticks" not in end:
                raise AssertionError(f"18a host {h} {led}: no run_end "
                                     f"with the extras ({end})")
            n = end["launches"].get("paged_decode", 0)
            per_attempt[f"host{h}/{led}"] = {"ticks": end["ticks"],
                                             "paged_decode": n}
            if device == "cuda" and n < layers * end["ticks"]:
                raise AssertionError(f"18a host {h} {led}: paged_decode "
                                     f"{n} < {layers} x {end['ticks']} "
                                     "ticks")
    gaps, tick_rates = {}, {}
    for h in sorted(fleet.hosts):
        base = os.path.join(out, f"host{h}", "run.jsonl")
        job = job_accounting(split_attempts(
            load_job_records(base, warn=lambda m: None)))
        gaps[h] = [a["restart_gap_s"] for a in job["attempts"][1:]]
        steps = [r for r in fleet.hosts[h] if r.get("event") == "step"]
        ticks = sum(r.get("steps_in_dispatch") or 1 for r in steps)
        busy = sum(r["dispatch_s"] + r["device_s"] for r in steps)
        run_s = sum(end["seconds"] for _, end in ends[h])
        tick_rates[h] = {"ticks": ticks,
                         "paced_per_s": ticks / run_s if run_s else None,
                         "busy_per_s": ticks / busy if busy else None}
    return {
        "restart_classes": report["restart_classes"],
        "restart_histogram": report["restart_histogram"],
        "elasticity": [(e["host"], e["action"], e["processes"])
                       for e in elas],
        "slo_breaches": report["slo_breaches"],
        "goodput_ratio": acct["goodput_ratio"],
        "sum_check": acct["sum_check"],
        "per_tenant": {k: {"requests": t["requests"],
                           "ttft_p50_s": t["ttft_s"]["p50"],
                           "ttft_p99_s": t["ttft_s"]["p99"]}
                       for k, t in tenants.items()},
        "served": report["serving"],
        "ticks_per_s": tick_rates,
        "restart_gaps_s": gaps,
        "attempts": per_attempt,
        "launches": p18_launches(kernels, ends),
    }


def p18_check_autoscale(kernels, out, scenario, kind):
    """18b's checks (module docstring) over the finished fleet dir."""
    from tpu_dist_torch.plan.tune import tune
    from tpu_dist_torch.sim.fleet import FleetLedger
    from tpu_dist_torch.sim.scenario import RID_STRIDE, load_scenario
    from tpu_dist_torch.sim.worker import WINDOW_TICKS

    sc = load_scenario(scenario)
    fleet = FleetLedger.discover(out, warn=lambda m: None)
    report = json.loads(json.dumps(fleet.report(), default=str))
    auto = report["autoscale"] or {}
    rows = auto.get("decisions") or []
    burst0 = min(ev["tick"] for ev in sc.events if ev["type"] == "burst")
    ups = [r for r in rows if r["direction"] == "up"]
    downs = [r for r in rows if r["direction"] == "down"]
    if not rows or rows[0]["direction"] != "up" or not downs or \
            (ups[0]["hosts_from"], ups[0]["target_hosts"]) != (2, 3) or \
            ups[0]["tick"] > burst0 + P18_UP_WINDOW or \
            (downs[0]["hosts_from"], downs[0]["target_hosts"]) != (3, 2) or \
            downs[0]["tick"] <= ups[0]["tick"]:
        raise AssertionError(f"18b decisions {rows}")
    # The fleet clock is the slowest live host's tick. On one card the
    # workers start seconds apart (a second is 33 ticks of 30 ms), so a
    # host ahead serves the burst while the clock still reads before it:
    # the up decision is held to come after the first step record of any
    # host at the burst's window (the window just before its first tick)
    up_ts = fleet.t0() + ups[0]["t_rel"]
    window0 = burst0 // WINDOW_TICKS * WINDOW_TICKS
    steps = [(r["ts"], h, r["step"]) for h, recs in fleet.hosts.items()
             for r in recs if r.get("event") == "step"]
    reached = [ts for ts, _, step in steps if step >= window0]
    if not reached or min(reached) > up_ts + 1e-3:
        raise AssertionError(f"18b: the up decision at {up_ts} precedes "
                             f"every host's tick {window0} (first at "
                             f"{min(reached) if reached else None})")
    host_ticks_at_up = {h: max([step for ts, hh, step in steps
                                if hh == h and ts <= up_ts], default=None)
                        for h in sorted(fleet.hosts)}
    if auto["paired"] != len(rows) or auto["unattributed_scales"] or \
            auto["applied_with_plan_hash"] != len(rows) or \
            any(r["scale_events"] != 1 for r in rows):
        raise AssertionError(f"18b pairing {auto}")
    hashes = {}
    for r in rows:
        app = r["applied"]
        devices = app["processes"] * sc.worker_devices
        _, results = tune(device_kinds=[kind],
                          workload={"devices": devices})
        best = results[kind]["best"]["hash"]
        plan = os.path.join(out, "plans", f"plan_epoch{app['epoch']}.json")
        if app["plan_hash"] != best or not os.path.isfile(plan):
            raise AssertionError(f"18b {r['decision']}: plan hash "
                                 f"{app['plan_hash']} (the tuner's best at "
                                 f"{devices} devices: {best}), {plan}")
        hashes[r["decision"]] = {"devices": devices,
                                 "plan_hash": app["plan_hash"]}
    standby = sc.standby_hosts()[0]
    crossed = [t for t in report["traces"].values()
               if t["readmits"] and t["completed"]
               and t["rid"] // RID_STRIDE == standby
               and standby not in t["hosts"]]
    if auto["shed_lost"] != 0 or not crossed:
        raise AssertionError(f"18b shed_lost {auto['shed_lost']}, "
                             f"{len(crossed)} crossed readmitted traces")
    return {
        "decisions": [{k: r[k] for k in ("decision", "direction", "tick",
                                         "hosts_from", "target_hosts",
                                         "signal", "lag_s")}
                      for r in rows],
        "up_lag_ticks": ups[0]["tick"] - burst0,
        "host_ticks_at_up": host_ticks_at_up,
        "plan_hashes": hashes, "device_kind": kind,
        "shed_lost": auto["shed_lost"], "crossed_traces": len(crossed),
        "slo_breaches": report["slo_breaches"],
        "goodput_ratio": report["fleet"]["goodput_ratio"],
        "launches": p18_launches(kernels, p18_attempt_ends(out)),
    }


def fleet_path(torch, kernels, tmp, device="cuda"):
    """Phase 18 (module docstring): 18a and 18b side by side, each a
    ``tpu_dist_torch.sim.runner`` process whose workers share the card.
    Returns (record, launches by run). ``device="cpu"`` rehearses its
    control flow on the CPU (with P18_CI_MODEL and P18_CI_SERVE patched
    to a tiny width)."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with open(os.path.join(here, "scripts", "fleet_ci.json")) as f:
        doc = json.load(f)
    doc["model"] = dict(P18_CI_MODEL)
    doc["serve"] = {**doc["serve"], **P18_CI_SERVE}
    ci_scenario = os.path.join(tmp, "fleet_ci_full_width.json")
    with open(ci_scenario, "w") as f:
        json.dump(doc, f, indent=1)
    auto_scenario = os.path.join(here, "scripts", "fleet_autoscale.json")
    kind = (torch.cuda.get_device_name(0) if device == "cuda" else "cpu")
    ci_out = os.path.join(tmp, "p18a")
    auto_out = os.path.join(tmp, "p18b")
    runs = {"a": p18_fleet(ci_scenario, ci_out, device),
            "b": p18_fleet(auto_scenario, auto_out, device,
                           device_kind=None if device == "cuda" else kind)}
    for name, (proc, log_path) in runs.items():
        p18_wait(name, proc, log_path)
    fleets_s = time.perf_counter() - t0
    rec = {"a_fleet_ci": p18_check_ci(kernels, ci_out, ci_scenario,
                                      P18_CI_MODEL["num_layers"], device),
           "b_fleet_autoscale": p18_check_autoscale(kernels, auto_out,
                                                    auto_scenario, kind)}
    by_run = {"p18a_fleet_ci": rec["a_fleet_ci"].pop("launches"),
              "p18b_fleet_autoscale":
                  rec["b_fleet_autoscale"].pop("launches")}
    rec["fleets_wall_s"] = fleets_s
    rec["wall_s"] = time.perf_counter() - t0
    rec["note"] = ("one card: both fleets' workers share it, 18a and 18b "
                   "run side by side")
    return rec, by_run


# ---- phase 19: the program audit and the convergence tools ------------------

P19_STEPS = 4            # 19a: phase 6's LM, audit on then off
# 19b: phase 7's ResNet-50 cut to 2 steps (one window of 2) and a 1024
# validation set
P19_IMAGE = dict(synth_train_size=2048, synth_val_size=1024,
                 steps_per_dispatch=2)
# 19d: the int8 step (phase 4's small int8 LM in bf16) on both devices
P19_INT8_LM = dict(batch_size=4, seq_len=96, d_model=128, num_layers=2,
                   num_heads=1, vocab_size=64, synth_tokens=4000, seed=SEED,
                   quant="int8", precision="bf16", optimizer="sgd", lr=1e-2,
                   max_steps=2, print_freq=1)
# 19c: phase 5's serving LM and request count
P19_SERVE_MODEL = dict(vocab_size=32000, num_layers=8, d_model=1024,
                       num_heads=8, max_len=2048)
P19_SERVE_REQUESTS = 16
P19_GROUP_TIMEOUT_S = 60  # 19e: the swap's gloo group
# 19f: BASELINE.md's geometries (the tools' defaults), through the
# kernels; the LM at its own 4 heads of 32 (the kernels' head-dim-32
# instances)
P19_IMAGE_CONVERGENCE = ["--optimizer", "fused_sgd"]
P19_LM_CONVERGENCE = ["--precision", "bf16", "--attn", "flash"]


def p19_audits(recs):
    return [r for r in recs if r["event"] == "audit"]


def p19_lm(torch, kernels, tmp, device):
    """19a: phase 6's LM for P19_STEPS steps with audit="record", then the
    same run with audit="none"; one audit event, clean, launches as phase
    6's, the audited first step's seconds and the hot step ms of both."""
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.obs.ledger import read_ledger

    runs, launches = {}, {}
    for mode in ("record", "none"):
        path = os.path.join(tmp, f"p19a_{mode}.jsonl")
        cfg = full_lm_config(max_steps=P19_STEPS, print_freq=1,
                             ledger_path=path, audit=mode)
        if device == "cuda":
            free_device(torch)
        kernels.reset_launches()
        t0 = time.perf_counter()
        tr = LMTrainer(cfg, device=device)
        tr.fit()
        wall = time.perf_counter() - t0
        launches[mode] = dict(kernels.LAUNCHES)
        facts = {"layers": cfg.num_layers, "eval_batches": len(
            tr._epoch_indices(tr.val_ds, False, 0)[0])}
        del tr
        recs = read_ledger(path)
        ms, n = p16_step_ms(recs, set())
        (compile_ev,) = [r for r in recs if r["event"] == "compile"]
        runs[mode] = {"audits": p19_audits(recs), "hot_step_ms": ms,
                      "hot_steps": n, "first_step_s": compile_ev["seconds"],
                      "wall_s": wall, "losses": [r["loss"] for r in recs
                                                 if r["event"] == "step"]}
        layers, n_eval = facts["layers"], facts["eval_batches"]
        want = {"flash_bwd_dq": layers * P19_STEPS,
                "flash_bwd_dkv": layers * P19_STEPS, "adamw": P19_STEPS,
                "flash_fwd": layers * (P19_STEPS + n_eval)}
        got = {k: launches[mode][k] for k in want}
        if device == "cuda" and got != want:
            raise AssertionError(f"19a {mode}: launches {got}, want {want}")
    (ev,) = runs["record"]["audits"]
    if (ev["program"], ev["mode"], ev["findings"], ev["waived"]) != \
            ("train_step", "record", 0, 0) or runs["none"]["audits"]:
        raise AssertionError(f"19a audit events {runs['record']['audits']}, "
                             f"{runs['none']['audits']}")
    # the audit only watches: the same losses, to the card's own run-to-run
    # spread
    diff = dp_close("19a audit on vs off", runs["record"]["losses"],
                    runs["none"]["losses"], LOSS_TOL)
    rec = {"config": "phase 6's LM", "steps": P19_STEPS,
           "audit_event": {k: ev[k] for k in ("program", "mode", "findings",
                                              "waived", "detail")},
           "first_step_s_audit_on": runs["record"]["first_step_s"],
           "first_step_s_audit_off": runs["none"]["first_step_s"],
           "hot_step_ms_audit_on": runs["record"]["hot_step_ms"],
           "hot_step_ms_audit_off": runs["none"]["hot_step_ms"],
           "hot_steps": runs["record"]["hot_steps"],
           "losses_max_abs_diff_on_vs_off": diff,
           "launches_per_step": {k: launches["record"][k] / P19_STEPS
                                 for k in ("flash_bwd_dq", "flash_bwd_dkv",
                                           "adamw")},
           "wall_s": runs["record"]["wall_s"] + runs["none"]["wall_s"]}
    return rec, {"p19a_lm_audit_record": launches["record"],
                 "p19a_lm_audit_none": launches["none"]}


def p19_image(torch, kernels, tmp, device):
    """19b: phase 7's ResNet-50 for 2 steps with audit="record", without
    cuDNN's autotuning (as 17d): one clean audit event, one sgd launch a
    step."""
    from tpu_dist_torch.configs import TrainConfig
    from tpu_dist_torch.engine.loop import Trainer
    from tpu_dist_torch.obs.ledger import read_ledger
    from tpu_dist_torch.scripts import image_train

    path = os.path.join(tmp, "p19b.jsonl")
    cfg = TrainConfig(**{**image_train.BENCH_GEOMETRY, **P19_IMAGE},
                      audit="record", ledger_path=path, log_csv="",
                      checkpoint_dir="", print_freq=1,
                      data=os.path.join(tmp, "no-data"))
    if device == "cuda":
        free_device(torch)
    t0 = time.perf_counter()
    tr = Trainer(cfg, device=device)
    torch.backends.cudnn.benchmark = False
    kernels.reset_launches()
    try:
        tr.fit()
    finally:
        torch.backends.cudnn.benchmark = device == "cuda"
    launches = dict(kernels.LAUNCHES)
    recs = read_ledger(path)
    n = sum(r["steps_in_dispatch"] for r in recs if r["event"] == "step")
    audits = p19_audits(recs)
    if [(a["program"], a["findings"]) for a in audits] != \
            [("window_step", 0)] or n != 2:
        raise AssertionError(f"19b: {n} steps, audits {audits}")
    if device == "cuda" and launches["sgd"] != n:
        raise AssertionError(f"19b: sgd launched {launches['sgd']} times "
                             f"for {n} steps")
    (compile_ev,) = [r for r in recs if r["event"] == "compile"]
    rec = {"config": "phase 7's ResNet-50, 2 steps", "steps": n,
           "audit_event": {k: audits[0][k] for k in ("program", "mode",
                                                     "findings", "detail")},
           "first_window_s": compile_ev["seconds"],
           "sgd_launches": launches["sgd"],
           "wall_s": time.perf_counter() - t0}
    del tr
    return rec, launches


def p19_serve(torch, kernels, device):
    """19c: phase 5's serving with the audit armed: every request served,
    no PL005, prefill signatures within the bucket ladder, one
    paged_decode call a layer a decode tick."""
    import numpy as np

    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.obs.ledger import Ledger
    from tpu_dist_torch.ops.flash_attention import flash_attention_fn
    from tpu_dist_torch.plan import compile as pc

    m = P19_SERVE_MODEL
    layers = m["num_layers"]
    model = TransformerLM(**m, dtype=torch.bfloat16,
                          attn_fn=flash_attention_fn(), device=device,
                          seed=SEED)
    cfg = ServeConfig(max_slots=8, page_size=16, num_pages=1024,
                      kv_quant="int8", attn_read="flash")
    rng = np.random.default_rng(SEED)
    n_req = P19_SERVE_REQUESTS
    prompts = [rng.integers(0, m["vocab_size"], (int(rng.integers(
        16, m["max_len"] // 2 + 1)),)).astype(np.int32)
        for _ in range(n_req)]
    outs = rng.integers(32, 129, n_req)
    led = Ledger(None)
    events = []
    led.add_sink(events.append)
    t0 = time.perf_counter()
    pc.set_audit("record", led)
    try:
        eng = ServeEngine(model, cfg, device=device)
        kernels.reset_launches()
        comps = eng.run([DecodeRequest(i, prompts[i], int(outs[i]))
                         for i in range(n_req)])
        launches = dict(kernels.LAUNCHES)
        sentry = pc._AUDIT["sentry"]
        sigs = {p: sentry.signatures(p) for p in (
            "serve_prefill", "serve_chunk_prefill", "serve_tick")}
    finally:
        pc.set_audit("none")
    audits = p19_audits(events)
    if len(comps) != n_req or audits:
        raise AssertionError(f"19c: served {len(comps)}/{n_req}, audit "
                             f"events {audits}")
    if not 1 <= sigs["serve_prefill"] <= len(eng.buckets) or \
            sigs["serve_tick"] != 1:
        raise AssertionError(f"19c signatures {sigs}, {len(eng.buckets)} "
                             "buckets")
    if device == "cuda" and launches["paged_decode"] != layers * eng.ticks:
        raise AssertionError(f"19c: paged_decode {launches['paged_decode']}"
                             f" for {eng.ticks} ticks x {layers}")
    rec = {"served": len(comps), "requests": n_req, "ticks": eng.ticks,
           "prefills": eng.prefills, "signatures": sigs,
           "buckets": len(eng.buckets), "pl005_events": 0,
           "paged_decode_per_tick": launches["paged_decode"] / eng.ticks,
           "wall_s": time.perf_counter() - t0}
    del eng, model
    return rec, launches


def p19_halted(fn):
    """``fn()`` under audit="halt": the AuditError's check IDs (None when
    it did not raise)."""
    from tpu_dist_torch.analysis.proglint import AuditError
    from tpu_dist_torch.plan import compile as pc

    pc.set_audit("halt")
    try:
        fn()
    except AuditError as e:
        return sorted(set(re.findall(r"PL00\d", str(e))))
    finally:
        pc.set_audit("none")
    return None


def p19_int8_step(torch, kernels, tmp, device):
    """The int8 step of 19d: phase 4's small int8 LM in bf16 for 2 steps
    under audit="halt"; its audit event's check IDs and its launches."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.interop import export_flax_params
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.obs.ledger import read_ledger

    init = export_flax_params(TransformerLM(
        vocab_size=64, num_layers=2, d_model=128, num_heads=1, max_len=96,
        device="cpu", seed=SEED))
    path = os.path.join(tmp, f"p19d_int8_{device}.jsonl")
    kernels.reset_launches()
    LMTrainer(LMConfig(**P19_INT8_LM, audit="halt", ledger_path=path),
              device=device, init_params=init).fit()
    (ev,) = p19_audits(read_ledger(path))
    return (sorted({d["check"] for d in ev["detail"] or ()}),
            dict(kernels.LAUNCHES))


def p19_hazards(torch, kernels, tmp, device):
    """19d: the injected hazards under audit="halt", each raising
    AuditError naming its check, on ``device`` and on the CPU (the same
    program, the same findings), and the int8 step clean on both.
    Returns (record, the int8 step's launches on ``device``)."""
    from tpu_dist_torch.engine.state import TrainState
    from tpu_dist_torch.plan import compile as pc

    def fp32_mm(dev):
        x = torch.ones(64, 64, device=dev)
        return lambda: pc.audit_program("p19d_fp32_mm", lambda a: a @ a, x,
                                        precision="bf16", device=dev)

    def rebind(dev):
        params = [torch.ones(8, device=dev) for _ in range(3)]
        state = TrainState(step=0, params=params,
                           opt_state=([torch.zeros(8, device=dev)
                                       for _ in params],),
                           param_names=["w0", "w1", "w2"])

        def step(s):     # the optimizer that rebinds one parameter
            s.params[1] = s.params[1] - 0.1
            s.opt_state[0][0].add_(1.0)
        return lambda: pc.audit_program("p19d_rebind", step, state,
                                        state=state, device=dev)

    def shapes(dev):
        def two_shapes():
            pc.register_audit_program("p19d_vary", allowed=1)
            for n in (8, 16):
                pc.note_audit_dispatch("p19d_vary",
                                       torch.ones(n, device=dev))
            pc.check_audit_sentry()
        return two_shapes

    t0 = time.perf_counter()
    rec = {}
    for name, make, want in (("fp32_mm_in_bf16", fp32_mm, ["PL004"]),
                             ("rebinding_optimizer", rebind, ["PL003"]),
                             ("two_shapes_allowed_1", shapes, ["PL005"])):
        got = {d: p19_halted(make(d)) for d in dict.fromkeys((device,
                                                              "cpu"))}
        if any(v != want for v in got.values()):
            raise AssertionError(f"19d {name}: raised {got}, want {want}")
        rec[name] = {"raised": want, "same_on_cpu": True}
    int8 = {d: p19_int8_step(torch, kernels, tmp, d)
            for d in dict.fromkeys(("cpu", device))}
    if any(ids for ids, _ in int8.values()):
        raise AssertionError(f"19d int8 step: findings {int8}")
    if device == "cuda" and not int8["cuda"][1]["fused_quant"]:
        raise AssertionError("19d int8 step: no fused_quant launch")
    rec["int8_step"] = {"findings": [], "same_on_cpu": True,
                        "fused_quant_launches":
                            int8[device][1]["fused_quant"]}
    rec["wall_s"] = time.perf_counter() - t0
    return rec, int8[device][1]


def p19_rank_job(torch, kernels, job, out, rank):
    """A 19e rank: phase 10's tiny LM twin on the two ranks with
    audit="record" (its audit event), then the same-shape all-reduces as
    SUM then MAX on rank 0 and MAX then SUM on rank 1 over a gloo group
    with a timeout, audited (its findings)."""
    from datetime import timedelta

    import torch.distributed as dist

    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.engine.lm_loop import LMTrainer
    from tpu_dist_torch.obs.ledger import Ledger, per_process_path, read_ledger
    from tpu_dist_torch.parallel.mesh import register_axis_group
    from tpu_dist_torch.plan import compile as pc

    dev = job["device"]
    path = os.path.join(out, "p19e.jsonl")
    kernels.reset_launches()
    LMTrainer(LMConfig(**job["cfg"], audit="record", ledger_path=path,
                       mesh_shape=(2,)), device=dev).fit()
    launches = dict(kernels.LAUNCHES)
    lm = p19_audits(read_ledger(per_process_path(path, rank)))
    group = dist.new_group([0, 1],
                           timeout=timedelta(seconds=P19_GROUP_TIMEOUT_S))
    register_axis_group(group, "data")
    SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX
    first, then = (SUM, MAX) if rank == 0 else (MAX, SUM)

    def swap(v):
        dist.all_reduce(v, op=first, group=group)
        dist.all_reduce(v, op=then, group=group)

    led = Ledger(None, process_index=rank)
    events = []
    led.add_sink(events.append)
    pc.set_audit("record", led)
    try:
        fs = pc.audit_program("p19e_swap", swap,
                              torch.ones(1024, device=dev), device=dev)
    finally:
        pc.set_audit("none")
    return {"lm_audits": lm, "launches": launches,
            "swap": [f.to_json() for f in fs],
            "swap_events": p19_audits(events)}


def p19_ranks_start(torch, tmp, device):
    """19e's two gloo ranks sharing ``device``, started (a DpGroup)."""
    job = {"name": "p19e", "kind": "audit19",
           "cfg": dict(DP_TINY_LM, max_steps=3, grad_bucket_mb=0.0)}
    return DpGroup("p19e", 2, device, "gloo", [job], tmp)


def p19_ranks_check(group):
    """19e's results: the dp step clean on both ranks, PL002 on both."""
    pair = [r["p19e"] for r in group.wait(300)]
    for rank, res in enumerate(pair):
        lm = [(a["program"], a["findings"]) for a in res["lm_audits"]]
        checks = [f["check"] for f in res["swap"]]
        if lm != [("train_step", 0)] or checks != ["PL002"] or \
                "at position 0" not in res["swap"][0]["message"]:
            raise AssertionError(f"19e rank {rank}: lm {lm}, swap "
                                 f"{res['swap']}")
    return {"dp_step_clean_both_ranks": True,
            "pl002_both_ranks": [res["swap"][0]["message"] for res in pair],
            "group_timeout_s": P19_GROUP_TIMEOUT_S}, {
        "p19e_rank0": pair[0]["launches"], "p19e_rank1": pair[1]["launches"]}


def p19_tool(module, argv):
    """One convergence tool's ``main(argv)`` in this process, its JSON
    line captured (the trainer's lines go to the log)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    lines = buf.getvalue().splitlines()
    if rc != 0 or not lines or not lines[-1].startswith("{"):
        raise AssertionError(f"19f {module.__name__}: rc {rc}, "
                             f"{lines[-5:]}")
    return json.loads(lines[-1])


def p19_convergence(torch, kernels, device, image_argv=(), lm_argv=()):
    """19f: both convergence tools at BASELINE.md's geometries (their
    defaults) through the kernels; steps and seconds to threshold."""
    from tpu_dist_torch.tools import convergence, lm_convergence

    rec, launches = {}, {}
    for name, module, argv in (
            ("image", convergence, [*P19_IMAGE_CONVERGENCE, *image_argv]),
            ("lm", lm_convergence, [*P19_LM_CONVERGENCE, *lm_argv])):
        if device == "cuda":
            free_device(torch)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = p19_tool(module, ["--device", device, *argv])
        launches[name] = dict(kernels.LAUNCHES)
        if out["steps_to_threshold"] is None:
            raise AssertionError(f"19f {name}: {out}")
        rec[name] = {**out, "wall_s": time.perf_counter() - t0}
    if device == "cuda" and (
            launches["image"]["sgd"] != rec["image"]["steps_to_threshold"]
            or not launches["lm"]["flash_bwd_dq"]):
        raise AssertionError(f"19f launches {launches}")
    rec["reference_steps"] = {"image": 30, "lm": 116}
    return rec, {"p19f_image_convergence": launches["image"],
                 "p19f_lm_convergence": launches["lm"]}


def audit_path(torch, kernels, tmp, device="cuda"):
    """Phase 19 (module docstring). Returns (record, launches by run).
    ``device="cpu"`` rehearses its control flow on the CPU (with the
    widths patched small by the caller)."""
    t0 = time.perf_counter()
    rec, by_run = {}, {}
    rec["a_lm_audit"], launches = p19_lm(torch, kernels, tmp, device)
    by_run.update(launches)
    group = p19_ranks_start(torch, tmp, device)
    try:
        rec["b_image_audit"], by_run["p19b_image_audit"] = p19_image(
            torch, kernels, tmp, device)
        rec["c_serve_audit"], by_run["p19c_serve_audit"] = p19_serve(
            torch, kernels, device)
        rec["d_hazards_halt"], by_run["p19d_int8_step"] = p19_hazards(
            torch, kernels, tmp, device)
        rec["f_convergence"], launches = p19_convergence(torch, kernels,
                                                         device)
        by_run.update(launches)
    except BaseException:
        group.kill()
        raise
    rec["e_two_ranks"], launches = p19_ranks_check(group)
    by_run.update(launches)
    rec["wall_s"] = time.perf_counter() - t0
    rec["note"] = ("one card: 19e's two gloo ranks share it with 19b-19f; "
                   "19a's two runs compare within one call")
    return rec, by_run


# ---- phase 20: dropout drawn from (seed, step, microbatch, rank) ------------

# the archs of tests/test_torch_dropout.py at a card's batch: 8 steps of
# 256 (2 epochs of 4), bf16 over fp32 masters, fused_sgd, a step a
# dispatch from the host so that the cut lands on step P20_CUT
P20_ARCHS = {"lenet": dict(arch="lenet", dataset="mnist"),
             "squeezenet1_1": dict(arch="squeezenet1_1", dataset="cifar10")}
P20_RUN = dict(batch_size=256, epochs=2, synth_train_size=1024,
               synth_val_size=256, precision="bf16", optimizer="fused_sgd",
               lr=0.05, seed=SEED, print_freq=1, workers=1,
               steps_per_dispatch=1, data_placement="host", log_csv="")
P20_STEPS = 8
P20_CUT = 5


def p20_fit(torch, kernels, cfg, device, cut=None):
    """Fit ``cfg`` (stopped by an interrupt at global step ``cut``, which
    leaves its mid-epoch checkpoint); returns (the per-step losses of its
    ledger, its launches, its last step). cuDNN runs deterministic and
    untuned here, so that two runs can be bit-equal."""
    from tpu_dist_torch.engine.loop import Trainer

    tr = Trainer(cfg, device=device)
    torch.backends.cudnn.benchmark = False
    if cut is not None:
        step = tr._step

        def interrupted(images, labels, gstep):
            if gstep == cut:
                raise KeyboardInterrupt
            return step(images, labels, gstep)

        tr._step = interrupted
    kernels.reset_launches()
    try:
        tr.fit()
    except KeyboardInterrupt:
        if cut is None:
            raise
    launches = dict(kernels.LAUNCHES)
    return ([r["loss"] for r in ledger_steps(cfg.ledger_path)], launches,
            tr.state.step)


def dropout_path(torch, kernels, tmp, device="cuda"):
    """Phase 20 (module docstring). Returns (record, launches by run)."""
    from tpu_dist_torch.configs import TrainConfig

    t0 = time.perf_counter()
    det, bench = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    rec, by_run = {}, {}
    try:
        for arch, kw in P20_ARCHS.items():
            d = os.path.join(tmp, arch)
            os.makedirs(d)

            def cfg(name, **extra):
                return TrainConfig(**{
                    **P20_RUN, **kw, "data": os.path.join(d, "no-data"),
                    "checkpoint_dir": os.path.join(d, f"{name}-ck"),
                    "ledger_path": os.path.join(d, f"{name}.jsonl"),
                    **extra})

            runs = {}
            for name in ("a", "b"):
                runs[name] = p20_fit(torch, kernels, cfg(name), device)
            runs["cut"] = p20_fit(torch, kernels, cfg("cut"), device,
                                  cut=P20_CUT)
            resume = os.path.join(d, "cut-ck", f"{arch}-checkpoint.pt")
            runs["resumed"] = p20_fit(torch, kernels,
                                      cfg("resumed", resume=resume), device)
            (la, sa, na), (lb, sb, nb) = runs["a"], runs["b"]
            lr_, sr, nr = runs["resumed"]
            steps = {k: v[2] for k, v in runs.items()}
            if steps != {"a": P20_STEPS, "b": P20_STEPS, "cut": P20_CUT,
                         "resumed": P20_STEPS}:
                raise AssertionError(f"20 {arch}: steps {steps}")
            if len(la) != P20_STEPS or not all(map(math.isfinite, la)):
                raise AssertionError(f"20 {arch}: losses {la}")
            if la != lb:
                raise AssertionError(f"20 {arch}: one seed, two runs: {la} "
                                     f"!= {lb} (bit-equal expected)")
            if lr_ != la[P20_CUT:]:
                raise AssertionError(f"20 {arch}: resumed at {P20_CUT}: "
                                     f"{lr_} != {la[P20_CUT:]}")
            # one sgd launch a step, in every run
            per_step = {k: v[1]["sgd"] / (v[2] - (P20_CUT if k == "resumed"
                                                  else 0))
                        for k, v in runs.items()}
            if device == "cuda" and set(per_step.values()) != {1.0}:
                raise AssertionError(f"20 {arch}: sgd launches a step "
                                     f"{per_step}")
            rec[arch] = {"losses": la, "resumed_losses": lr_,
                         "bit_equal_two_runs": True,
                         "bit_equal_resumed_from": P20_CUT,
                         "sgd_launches_per_step": per_step,
                         "steps": steps}
            by_run[f"p20_{arch}"] = sa
            by_run[f"p20_{arch}_resumed"] = sr
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench
    rec["config"] = {k: v for k, v in P20_RUN.items()
                     if k not in ("print_freq", "workers", "log_csv")}
    rec["wall_s"] = time.perf_counter() - t0
    return rec, by_run


# ---- phase 21: the reference's own small LM configurations -----------------

# 21a: tiny_lm at the reference's defaults (V 256, 2 layers, d_model 64 in
# 4 heads of 16, max_len 512), fp32, a flash prefill and int8 pages read by
# the paged decode kernel, card against CPU
P21_SERVE = dict(max_slots=4, page_size=16, num_pages=96, kv_quant="int8",
                 attn_read="flash")
P21_PROMPTS = (5, 33, 64, 130, 17, 200)
P21_OUTS = (20, 12, 30, 24, 16, 40)
# 21b: LMTrainer at LMConfig's defaults (V 512, 4 layers, d_model 256 in 8
# heads of 32, L 512, batch 16, sgd at 3e-2) with attn="flash": the fp32
# twin for P21_STEPS steps, and bf16 on the card for P21_BF16_STEPS; the
# synthetic corpus cut to what the steps read
P21_STEPS = 5
P21_BF16_STEPS = 20
P21_TOKENS = 200_000


def p21_tiny_lm_serving(torch, kernels, device="cuda"):
    """21a: ``tiny_lm`` served on ``device`` (the kernels) and on the CPU
    (their plain versions) from the same weights: every request's greedy
    tokens equal, and on the card ``flash_fwd`` and ``paged_decode``
    launched. Returns (record, the card run's launches)."""
    import inspect

    import numpy as np

    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.models.transformer import tiny_lm
    from tpu_dist_torch.ops.flash_attention import flash_attention_fn

    defaults = {k: p.default for k, p in
                inspect.signature(tiny_lm).parameters.items()
                if k in ("vocab_size", "num_layers", "d_model", "num_heads",
                         "max_len")}
    vocab = defaults["vocab_size"]
    cpu_lm = tiny_lm(device="cpu", seed=SEED, attn_fn=flash_attention_fn())
    card_lm = tiny_lm(device=device, seed=None, attn_fn=flash_attention_fn())
    card_lm.load_state_dict(cpu_lm.state_dict())
    rng = np.random.default_rng(SEED + 21)
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n in P21_PROMPTS]
    reqs = lambda: [DecodeRequest(i, p, n) for i, (p, n) in
                    enumerate(zip(prompts, P21_OUTS))]
    got, launches, ticks = {}, None, 0
    for dev, lm in (("cpu", cpu_lm), (device, card_lm)):
        kernels.reset_launches()
        eng = ServeEngine(lm, ServeConfig(**P21_SERVE), device=dev)
        got[dev] = {c.rid: c.tokens for c in eng.run(reqs())}
        launches, ticks = dict(kernels.LAUNCHES), eng.ticks
    for rid, toks in got["cpu"].items():
        if not np.array_equal(toks, got[device][rid]):
            raise AssertionError(f"21a request {rid}: card tokens "
                                 f"{got[device][rid].tolist()} != CPU "
                                 f"{toks.tolist()}")
    layers = defaults["num_layers"]
    if device == "cuda" and (
            launches["flash_fwd"] < layers * len(P21_PROMPTS)
            or launches["paged_decode"] < layers * ticks):
        raise AssertionError(f"21a launches {launches} for {ticks} ticks "
                             f"x {layers} layers")
    return {"model": {**defaults, "head_dim": defaults["d_model"]
                      // defaults["num_heads"], "dtype": "fp32"},
            "serve": P21_SERVE, "requests": len(got["cpu"]),
            "token_equal": len(got["cpu"]), "ticks": ticks,
            "launches": {k: launches[k] for k in ("flash_fwd",
                                                   "paged_decode")}}, \
        launches


def p21_lmconfig(torch, kernels, device="cuda"):
    """21b: ``LMTrainer`` at ``LMConfig``'s defaults with ``attn="flash"``:
    the fp32 twin on ``device`` and the CPU from the same weights, per-step
    losses within LOSS_TOL (1 + |loss|); then bf16 on ``device`` for
    P21_BF16_STEPS steps, finite and falling, with each flash kernel
    launched. Returns (record, launches by run)."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.interop import export_flax_params
    from tpu_dist_torch.models.transformer import TransformerLM

    cfg = LMConfig(attn="flash", max_steps=P21_STEPS, synth_tokens=P21_TOKENS,
                   print_freq=100, seed=SEED)
    init = export_flax_params(TransformerLM(
        vocab_size=cfg.vocab_size, num_layers=cfg.num_layers,
        d_model=cfg.d_model, num_heads=cfg.num_heads, max_len=cfg.seq_len,
        device="cpu", seed=SEED))
    _, cpu_losses = run_trainer(cfg, "cpu", init)
    kernels.reset_launches()
    _, card_losses = run_trainer(cfg, device, init)
    fp32_launches = dict(kernels.LAUNCHES)
    if len(card_losses) != P21_STEPS or len(cpu_losses) != P21_STEPS:
        raise AssertionError(f"21b steps: card {len(card_losses)}, cpu "
                             f"{len(cpu_losses)}")
    for i, (a, r) in enumerate(zip(card_losses, cpu_losses)):
        if abs(a - r) > LOSS_TOL * (1 + abs(r)):
            raise AssertionError(f"21b step {i}: card loss {a} != CPU {r} "
                                 f"(tol {LOSS_TOL} (1 + |loss|))")
    bf16 = dataclasses.replace(cfg, precision="bf16",
                               max_steps=P21_BF16_STEPS)
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, bf16_losses = run_trainer(bf16, device, init)
    wall = time.perf_counter() - t0
    bf16_launches = dict(kernels.LAUNCHES)
    if len(bf16_losses) != P21_BF16_STEPS or not all(
            math.isfinite(x) for x in bf16_losses) \
            or not bf16_losses[-1] < bf16_losses[0]:
        raise AssertionError(f"21b bf16 losses {bf16_losses}")
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    if device == "cuda" and not all(run[n] for run in (fp32_launches,
                                                       bf16_launches)
                                    for n in names):
        raise AssertionError(f"21b launches: fp32 {fp32_launches}, bf16 "
                             f"{bf16_launches}")
    return {"config": {k: getattr(cfg, k) for k in (
                "vocab_size", "num_layers", "d_model", "num_heads",
                "seq_len", "batch_size", "optimizer", "lr", "attn")},
            "head_dim": cfg.d_model // cfg.num_heads,
            "fp32": {"card": card_losses, "cpu": cpu_losses,
                     "max_abs_diff": max(abs(a - r) for a, r in
                                         zip(card_losses, cpu_losses)),
                     "tolerance": f"{LOSS_TOL} * (1 + |loss|)",
                     "launches": {n: fp32_launches[n] for n in names}},
            "bf16": {"losses": bf16_losses, "wall_s": wall,
                     "launches": {n: bf16_launches[n] for n in names}}}, \
        {"p21b_lmconfig_fp32": fp32_launches,
         "p21b_lmconfig_bf16": bf16_launches}


def small_configs_path(torch, kernels, device="cuda"):
    """Phase 21 (module docstring). Returns (record, launches by run).
    ``device="cpu"`` rehearses its control flow on the CPU."""
    serving, serve_launches = p21_tiny_lm_serving(torch, kernels, device)
    training, train_launches = p21_lmconfig(torch, kernels, device)
    return {"a_tiny_lm_serving": serving, "b_lmconfig_flash": training}, \
        {"p21a_tiny_lm_serving": serve_launches, **train_launches}


# ---- phase 22: four heads of 256 ------------------------------------------

# the LM of phases 5 and 6 with 4 heads instead of 8, so each head is 256
# wide (the reference's LMConfig(vocab_size=32000, num_layers=8,
# d_model=1024, num_heads=4, seq_len=2048), bench.py with BENCH_HEADS=4):
# the same parameters, every attention kernel on its 256 instance
P22_HEADS = 4
P22_STEPS = 10
# 22c: the fp32 twins, (d_model, heads) at head dims 24 and 256
P22_TWINS = {"head_dim_24": (48, 2), "head_dim_256": (512, 2)}


def p22_twins(torch, kernels, twins=P22_TWINS, tag="22c"):
    """22c: tiny fp32 LMs at head dims 24 and 256 (P22_TWINS; ``twins``),
    each served on the card and on the CPU (equal greedy tokens, phase 4's
    requests) and trained 5 steps on both (losses within LOSS_TOL (1 +
    |loss|)), the card's runs through the kernels. Returns (record,
    launches by run)."""
    recs, by_run = {}, {}
    for name, (d_model, heads) in twins.items():
        kernels.reset_launches()
        n = small_input_agreement(torch, d_model=d_model, num_heads=heads)
        serve = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        train = small_trainer_agreement(torch, d_model, heads)
        fit = dict(kernels.LAUNCHES)
        if not (serve["flash_fwd"] and serve["paged_decode"]
                and fit["flash_bwd_dq"] and fit["flash_bwd_dkv"]):
            raise AssertionError(f"{tag} {name}: launches serve {serve}, "
                                 f"train {fit}")
        recs[name] = {"d_model": d_model, "heads": heads,
                      "head_dim": d_model // heads,
                      "requests_token_equal": n, "training": train,
                      "launches": {
                          "serve": {k: serve[k] for k in ("flash_fwd",
                                                          "paged_decode")},
                          "train": {k: fit[k] for k in (
                              "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                              "adamw")}}}
        by_run[f"p{tag}_{name}_serve"] = serve
        by_run[f"p{tag}_{name}_train"] = fit
    return recs, by_run


def wide_heads_path(torch, kernels):
    """Phase 22 (module docstring): 22a phase 6's run and 22b phase 5's
    with P22_HEADS heads, 22c the twins. Returns (record, launches by
    run)."""
    training, train_launches = training_path(torch, kernels, P22_STEPS,
                                             num_heads=P22_HEADS)
    free_device(torch)
    serving, serve_launches = main_path(torch, kernels, P22_HEADS)[:2]
    free_device(torch)
    twins, twin_launches = p22_twins(torch, kernels)
    return {"a_training": training, "b_serving": serving,
            "c_fp32_twins": twins}, \
        {"p22a_training": train_launches, "p22b_serving": serve_launches,
         **twin_launches}


# the LM of phases 5 and 6 with 2 heads instead of 8, so each head is 512
# wide (the reference's LMConfig(vocab_size=32000, num_layers=8,
# d_model=1024, num_heads=2, seq_len=2048), bench.py with BENCH_HEADS=2):
# the same parameters, every attention kernel on the wide path
P23_HEADS = 2
P23_STEPS = 10
# 23c: the fp32 twins, (d_model, heads) at head dims 320 and 1024
P23_TWINS = {"head_dim_320": (640, 2), "head_dim_1024": (1024, 1)}
# 23d: IR-legal fused_quant tiles outside TDT_FQ_TILES (bm 8 and 24 cut an
# m16 fragment; bk 128 and 256 split K), at phase 17c's prefill shapes and
# a ragged one
P23_TILES = ((8, 128, 0), (24, 384, 0), (64, 128, 0), (192, 256, 128),
             (512, 128, 0), (128, 640, 256))
P23_QUANT_SHAPES = {**{k: v for k, v in P17_QUANT_SHAPES.items()
                       if v[0] > 16},
                    "ragged": (1000, 1000, 1000)}


def p23_quant_tiles(torch, tiles=P23_TILES, shapes=P23_QUANT_SHAPES):
    """23d: ``fused_quant`` at each tile of ``tiles`` on each shape of
    ``shapes`` (bf16), bit-equal to the default tile and to the plain
    version, timed beside the default 128 x 128 and the bf16
    ``torch.matmul`` of the unquantized operands (the yardstick; no one
    PyTorch call computes the kernel's function)."""
    from tpu_dist_torch.ops import pallas_quant as pq

    own = torch.Generator(device="cuda").manual_seed(SEED + 23)
    recs = {}
    try:
        for label, (m, k, n) in shapes.items():
            x = torch.randn((m, k), generator=own, device="cuda").to(
                torch.bfloat16)
            w = (torch.randn((k, n), generator=own, device="cuda")
                 / math.sqrt(k)).to(torch.bfloat16)
            ref = pq.fused_quant_matmul_plain(x, w)
            pq.set_quant_blocks()
            default = pq.fused_quant_cuda(x, w)
            if not torch.equal(default, ref):
                raise AssertionError(f"23d {label}: the default tile is not "
                                     "bit-equal to the plain version")
            del ref
            row = {"shape": f"M{m} K{k} N{n} bf16",
                   "ms_default_128x128": time_ms(
                       torch, lambda: pq.fused_quant_cuda(x, w)),
                   "yardstick_ms": time_ms(torch, lambda: x @ w),
                   "ms": {}}
            for tile in tiles:
                pq.set_quant_blocks(*tile)
                out = pq.fused_quant_cuda(x, w)
                if not torch.equal(out, default):
                    raise AssertionError(f"23d {label} tile {tile}: not "
                                         "bit-equal to the default tile")
                del out
                row["ms"]["x".join(map(str, tile[:2])) + f"/bk{tile[2]}"] = \
                    time_ms(torch, lambda: pq.fused_quant_cuda(x, w))
            pq.set_quant_blocks()
            recs[label] = row
            del x, w, default
            free_device(torch)
    finally:
        pq.set_quant_blocks()
    return {"shapes": recs, "bit_equal": "every tile, to the default "
            "128x128/bk0 and to the plain version"}


def wide_path(torch, kernels):
    """Phase 23 (module docstring): 23a phase 6's run and 23b phase 5's
    with P23_HEADS heads, 23c the twins, 23d the fused_quant tiles.
    Returns (record, launches by run)."""
    training, train_launches = training_path(torch, kernels, P23_STEPS,
                                             num_heads=P23_HEADS)
    free_device(torch)
    serving, serve_launches = main_path(torch, kernels, P23_HEADS)[:2]
    free_device(torch)
    twins, twin_launches = p22_twins(torch, kernels, P23_TWINS, "23c")
    tiles = p23_quant_tiles(torch)
    return {"a_training": training, "b_serving": serving,
            "c_fp32_twins": twins, "d_fused_quant_tiles": tiles}, \
        {"p23a_training": train_launches, "p23b_serving": serve_launches,
         **twin_launches}


def importable(name):
    import importlib.util

    return importlib.util.find_spec(name) is not None


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "tpu_dist_torch")):
        print("chip_smoke: run from the repository (tpu_dist_torch/ "
              "missing beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import torch.nn.functional as F

    from tpu_dist_torch import kernels

    t_start = time.perf_counter()
    # every phase's seconds, printed as it ends and together before the
    # total
    phase_s, since = {}, [t_start, t_start]

    def took(n, note=""):
        now = time.perf_counter()
        phase_s[n] = now - since[0]
        since[:] = [now, now]
        log(f"phase {n} took {phase_s[n]:.1f}s" + (f" ({note})" if note
                                                    else ""))

    def took_part(label):       # a part of a phase, since the last part
        now = time.perf_counter()
        log(f"phase {label} took {now - since[1]:.1f}s")
        since[1] = now

    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 1 device: {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")

    took(1)

    # 2. build
    t0 = time.perf_counter()
    built = kernels.build()
    built = {k: round(v, 2) for k, v in built.items()}
    log(f"phase 2 build: {json.dumps(built)} in "
        f"{time.perf_counter() - t0:.1f}s wall")
    for k in kernels.SOURCES:
        logp = os.path.join(kernels.build_dir(), f"{k}.log")
        if os.path.isfile(logp):
            with open(logp) as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        log(f"  ptxas {k}: {line.strip()}")

    took(2)

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash = {L: check_flash(torch, F, L, gen) for L in (1024, 2048)}
    flash_more = check_flash_more(torch, F)
    paged = check_paged(torch, F, gen)
    bwd = check_flash_bwd(torch, F, gen)
    adamw = check_adamw(torch, gen)
    sgd = check_sgd(torch, gen)
    quant = check_fused_quant(torch, gen)
    int8kv = check_flash_int8kv(torch, F, gen)
    head_dims = check_head_dims(torch, F)
    hd_sweep = check_head_dim_sweep(torch, kernels)
    log(f"phase 3 kernels: flash_fwd {json.dumps(flash)}")
    log(f"phase 3 kernels: flash_fwd more shapes {json.dumps(flash_more)}")
    log(f"phase 3 kernels: paged_decode {json.dumps(paged)}")
    log(f"phase 3 kernels: flash_bwd {json.dumps(bwd)}")
    log(f"phase 3 kernels: adamw {json.dumps(adamw)}")
    log(f"phase 3 kernels: sgd {json.dumps(sgd)}")
    log(f"phase 3 kernels: fused_quant {json.dumps(quant)}")
    log(f"phase 3 kernels: flash_fwd_int8kv {json.dumps(int8kv)}")
    log(f"phase 3 kernels at head dims {list(P3_HEAD_DIMS)}: "
        f"{json.dumps(head_dims)}")
    for kname, recs in head_dims.items():
        log(f"phase 3 {kname} ms by head dim: " + ", ".join(
            f"D{d} H{h} {r['ms']:.4f} (bound {r['bound_ms']:.4f}, SDPA "
            f"{r['library_ms']:.4f})" for (d, h), r in zip(P3_HEAD_DIMS,
                                                          recs)))
    log(f"phase 3 general instances at head dims {list(P3_SWEEP_DIMS)}, "
        f"fp32 and bf16, aligned and misaligned: {json.dumps(hd_sweep)}")
    log(f"phase 3 ptxas: " + json.dumps(
        {k: ptxas_report(kernels, k) for k in ("adamw", "sgd", "fused_quant",
                                               "paged_decode")}))

    took(3)

    # 4. small input: card == CPU reference
    n = small_input_agreement(torch)
    log(f"phase 4 small-input agreement: {n}/{n} requests token-equal "
        "(card kernels vs CPU plain versions, fp32)")
    n = small_input_agreement(torch, dict(quant="int8"), dict(quant="int8"))
    log(f"phase 4 small-input agreement, quant=int8: {n}/{n} requests "
        "token-equal (card fused_quant kernel vs CPU plain version, fp32)")
    n = small_input_agreement(torch, dict(spec_k=3), {})
    log(f"phase 4 small-input agreement, spec_k=3: {n}/{n} requests on the "
        "card token-equal to the CPU engine without speculation (fp32)")
    agree = small_trainer_agreement(torch)
    log(f"phase 4 small-input training: 5 steps, per-step losses agree "
        f"within {LOSS_TOL} (1 + |loss|): {json.dumps(agree)}")
    agree = small_int8_trainer_agreement(torch)
    log(f"phase 4 small-input int8 training: 5 steps, per-step losses "
        f"agree within {INT8_LOSS_TOL} (1 + |loss|): {json.dumps(agree)}")
    agree = small_image_trainer_agreement(torch)
    log(f"phase 4 small-input image training: 5 steps, per-step losses "
        f"agree within {LOSS_TOL} (1 + |loss|): {json.dumps(agree)}")

    took(4)

    # 5. the serving main path at full width
    serving, serve_launches, model, prompts, outs = main_path(torch, kernels)
    log(f"phase 5 serving: {json.dumps(serving)} on {card}")

    took(5)

    # 6. the training main path at full width
    training, train_launches = training_path(torch, kernels)
    log(f"phase 6 training: {json.dumps(training)} on {card}")

    took(6)

    # 7. the image main path at full width (its checkpoints kept for 9d)
    ck7 = tempfile.TemporaryDirectory()
    image, image_launches = image_path(torch, kernels, ck7.name)
    log(f"phase 7 image training: {json.dumps(image)} on {card}")

    took(7)

    # 8. quantized and speculative serving at full width
    qspec, quant_launches, spec_launches = quant_spec_path(
        torch, kernels, model, prompts, outs)
    del model
    log(f"phase 8 int8 serving: {json.dumps(qspec['int8'])} on {card}")
    log(f"phase 8 speculative serving (spec_k={SPEC_K}): "
        f"{json.dumps(qspec['spec'])} on {card}")
    took(8)

    # 9. the one-device training knobs at full width
    windows, window_launches = lm_windows_resume(torch, kernels, training)
    log(f"phase 9a LM windows, chunked loss, resume: {json.dumps(windows)} "
        f"on {card}")
    took_part("9a")
    accum, accum_launches = lm_knob_run(torch, kernels, training,
                                        grad_accum_steps=2)
    if accum_launches["adamw"] != 4 or \
            accum_launches["flash_bwd_dq"] != 8 * 2 * 4:
        raise AssertionError(f"9b: launches {accum_launches}")
    log(f"phase 9b LM accumulation: {json.dumps(accum)} on {card}")
    took_part("9b")
    blockwise, block_launches = lm_knob_run(torch, kernels, training,
                                            attn="blockwise")
    flash_names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "flash_fwd_int8kv")
    if any(block_launches[n] for n in flash_names):
        raise AssertionError(f"9c: a flash kernel ran: {block_launches}")
    log(f"phase 9c LM blockwise attention: {json.dumps(blockwise)} on "
        f"{card}")
    head = chunked_head_timing(torch)
    log(f"phase 9 chunked head: {json.dumps(head)} on {card}")
    took_part("9c")
    img_knobs, img_knob_launches = image_knobs(
        torch, kernels, image,
        os.path.join(ck7.name, "resnet50-model_best.pt"))
    ck7.cleanup()
    log(f"phase 9d image accumulation, loss scale, warm start: "
        f"{json.dumps(img_knobs)} on {card}")
    took_part("9d")
    bench, bench_launches = decode_bench_one_shot(torch, kernels)
    log(f"phase 9e decode bench one-shot: {json.dumps(bench)} on {card}")
    took(9)

    # 10. multi-process data parallelism
    with tempfile.TemporaryDirectory() as tmp:
        dp, dp_launches = dp_path(torch, kernels, training, image, tmp)
    log(f"phase 10 data parallelism: {json.dumps(dp)} on {card}")
    took(10)

    # 11. the image side on one card; 11c's sweep, then its card-vs-CPU
    # check, in a process of its own beside 11a, 11b and 11d (the sweep's
    # seconds are cuDNN's first build of each conv shape, on the host)
    free_device(torch)
    sweep_dir = tempfile.TemporaryDirectory()
    sweep_group = DpGroup("p11c_sweep", 1, "cuda", "gloo", [
        {"name": "sweep", "kind": "zoo11", "archs": ZOO_SWEEP},
        {"name": "agree", "kind": "zoo11_agree"}], sweep_dir.name)
    try:
        s6, s6_launches = script6_path(torch, kernels)
        log(f"phase 11a script 6: {json.dumps(s6)} on {card}")
        took_part("11a")
        free_device(torch)
        vit8, vit8_launches = vit_int8_path(torch, kernels)
        vit_quant = check_fused_quant_training(torch)
        log(f"phase 11b ViT-B/16 int8: {json.dumps(vit8)} on {card}")
        log(f"phase 11b fused_quant at training shapes: "
            f"{json.dumps(vit_quant)} on {card}")
        took_part("11b")
        free_device(torch)
        torch.backends.cudnn.benchmark = True
        folder, folder_launches = imagefolder_path(
            torch, kernels, s6["train_img_per_s_window1_excluded"])
        log(f"phase 11d ImageFolder: {json.dumps(folder)} on {card}")
        took_part("11d")
    except BaseException:
        sweep_group.kill()
        raise
    side = sweep_group.wait(600)[0]
    sweep_dir.cleanup()
    sweep, sweep_sgd = side["sweep"]["sweep"], side["sweep"]["sgd"]
    log(f"phase 11c zoo card-vs-CPU (fp32, beside 11a-d): "
        f"{json.dumps(side['agree'])}")
    log(f"phase 11c zoo sweep ({len(sweep)} archs, one a family, 1000 "
        f"classes, bf16 fused_sgd step at batch 8, beside 11a-d): "
        f"{json.dumps(sweep)} on {card}")
    took(11)

    # 12. the LM's model-parallel axes
    with tempfile.TemporaryDirectory() as tmp:
        mp, mp_launches = model_parallel_path(torch, kernels, tmp)
    for part in ("a_full_width_2rank_gloo", "b_moe", "c_small_card_vs_cpu",
                 "d_warm_start", "e_kernels_at_phase12_shapes"):
        log(f"phase 12{part[0]} {part[2:]}: {json.dumps(mp[part])} on "
            f"{card}")
    took(12, mp["note"])

    # 13. pipeline parallelism, sharded decode, ViT ring
    with tempfile.TemporaryDirectory() as tmp:
        pp, pp_launches = pipeline_path(torch, kernels, tmp)
    for part in ("a_pp_full_width_2rank_gloo", "b_pp_x_tp_4rank_gloo",
                 "c_moe_pp", "d_int8_tp_scaled_pair", "e_small_card_vs_cpu",
                 "f_sharded_decode", "g_vit_ring",
                 "kernels_at_phase13_shapes"):
        log(f"phase 13{part[0] if part[1] == '_' else ''} {part}: "
            f"{json.dumps(pp[part])} on {card}")
    took(13, pp["note"])

    # 14. sp-sharded long-context serving
    with tempfile.TemporaryDirectory() as tmp:
        lc, lc_launches = longcontext_path(torch, kernels, tmp)
    for part in ("a_long_context_replay", "b_sp2_full_width_gloo",
                 "c_small_card_vs_cpu", "d_paged_decode_gathered"):
        log(f"phase 14{part[0]} {part[2:]}: {json.dumps(lc[part])} on "
            f"{card}")
    took(14, lc["note"])

    # 15. restart and faults
    with tempfile.TemporaryDirectory() as tmp:
        rs, rs_launches = restart_path(torch, kernels, tmp)
    for part in ("a_supervised_full_width", "b_in_process_restart",
                 "c_image_restart", "d_peer_restore", "e_ckpt_enospc"):
        log(f"phase 15{part[0]} {part[2:]}: {json.dumps(rs[part])} on "
            f"{card}")
    took(15, rs["note"])

    # 16. the observers
    with tempfile.TemporaryDirectory() as tmp:
        obs, obs_launches = observers_path(torch, kernels, tmp)
    for part in ("a_lm_observers", "b_image_observers", "c_ranks"):
        log(f"phase 16{part[0]} {part[2:]}: {json.dumps(obs[part])} on "
            f"{card}")
    a = obs["a_lm_observers"]
    log(f"phase 16 observer cost: {a['step_ms_observers_on']:.3f} ms a step "
        f"with every observer on (metrics, telemetry, skew, watchdog, "
        f"flight recorder; its window's steps left out) against "
        f"{a['step_ms_observers_off']:.3f} ms off, "
        f"{a['step_ms_profiled']:.3f} ms under a profile_dir session, on "
        f"{card}")
    took(16, obs["note"])

    # 17. the plan lowering
    with tempfile.TemporaryDirectory() as tmp:
        plan, plan_launches = plan_path(torch, kernels, tmp)
    for part in ("a_tuner", "b_plan_lm", "c_tiles", "d_image_auto",
                 "e_gspmd_model_axis"):
        log(f"phase 17{part[0]} {part[2:]}: {json.dumps(plan[part])} on "
            f"{card}")
    took(17, plan["note"])

    # 18. the fleet
    with tempfile.TemporaryDirectory() as tmp:
        fl, fleet_launches = fleet_path(torch, kernels, tmp)
    a = fl["a_fleet_ci"]
    for part in ("a_fleet_ci", "b_fleet_autoscale"):
        log(f"phase 18{part[0]} {part[2:]}: {json.dumps(fl[part])} on "
            f"{card}")
    log(f"phase 18a: {a['slo_breaches']} SLO breaches, fleet goodput ratio "
        f"{a['goodput_ratio']}, TTFT p50/p99 by tenant "
        + ", ".join(f"{k} {t['ttft_p50_s']:.4f}/{t['ttft_p99_s']:.4f} s"
                    for k, t in a["per_tenant"].items())
        + ", ticks a second by host (paced) "
        + ", ".join(f"{h}: {r['paced_per_s']}"
                    for h, r in a["ticks_per_s"].items())
        + f", restart gaps {json.dumps(a['restart_gaps_s'])} s, "
        f"paged_decode {fleet_launches['p18a_fleet_ci']['paged_decode']}, "
        f"on {card}")
    took(18, fl["note"])

    # 19. the program audit and the convergence tools
    with tempfile.TemporaryDirectory() as tmp:
        au, audit_launches = audit_path(torch, kernels, tmp)
    for part in ("a_lm_audit", "b_image_audit", "c_serve_audit",
                 "d_hazards_halt", "e_two_ranks", "f_convergence"):
        log(f"phase 19{part[0]} {part[2:]}: {json.dumps(au[part])} on "
            f"{card}")
    a, f = au["a_lm_audit"], au["f_convergence"]
    log(f"phase 19a audit cost: the audited first step took "
        f"{a['first_step_s_audit_on']:.3f} s against "
        f"{a['first_step_s_audit_off']:.3f} s without the audit; hot step "
        f"{a['hot_step_ms_audit_on']:.3f} ms with it armed against "
        f"{a['hot_step_ms_audit_off']:.3f} ms off, on {card}")
    log(f"phase 19f convergence: ResNet-50 {f['image']['steps_to_threshold']}"
        f" steps to 90% top-1 in {f['image']['seconds_to_threshold']} s, the "
        f"LM {f['lm']['steps_to_threshold']} steps to ppl 4 in "
        f"{f['lm']['seconds_to_threshold']} s (the reference's step counts: "
        f"30 and 116), on {card}")
    took(19, au["note"])

    # 20. dropout drawn from (seed, step, microbatch, rank)
    with tempfile.TemporaryDirectory() as tmp:
        dr, dropout_launches = dropout_path(torch, kernels, tmp)
    for arch in P20_ARCHS:
        r = dr[arch]
        log(f"phase 20 {arch}: {json.dumps(r)} on {card}")
        log(f"phase 20 {arch}: two runs of one seed bit-equal at all "
            f"{P20_STEPS} steps, the run resumed at step {P20_CUT} "
            f"bit-equal from there, sgd launches a step "
            f"{json.dumps(r['sgd_launches_per_step'])}")
    took(20)

    # 21. the reference's own small LM configurations
    small, small_launches = small_configs_path(torch, kernels)
    for part in ("a_tiny_lm_serving", "b_lmconfig_flash"):
        log(f"phase 21{part[0]} {part[2:]}: {json.dumps(small[part])} on "
            f"{card}")
    took(21)

    # 22. four heads of 256
    wide, wide_launches = wide_heads_path(torch, kernels)
    for part in ("a_training", "b_serving", "c_fp32_twins"):
        log(f"phase 22{part[0]} {part[2:]}: {json.dumps(wide[part])} on "
            f"{card}")
    a, b = wide["a_training"], wide["b_serving"]
    log(f"phase 22: {P22_HEADS} heads of {a['head_dim']}, training "
        f"{a['step_ms']:.2f} ms a step, "
        f"peak {a['peak_mem_gb']:.2f} GB, launches a step "
        f"{json.dumps(a['launches_per_step'])}; serving "
        f"{b['completed']}/{b['requests']} requests, flash_fwd "
        f"{b['launches']['flash_fwd']}, paged_decode "
        f"{b['launches']['paged_decode']}, on {card}")
    took(22)

    # 23. two heads of 512 (the wide path), fused_quant at other tiles
    wide2, wide2_launches = wide_path(torch, kernels)
    for part in ("a_training", "b_serving", "c_fp32_twins",
                 "d_fused_quant_tiles"):
        log(f"phase 23{part[0]} {part[2:]}: {json.dumps(wide2[part])} on "
            f"{card}")
    a, b = wide2["a_training"], wide2["b_serving"]
    log(f"phase 23: {P23_HEADS} heads of {a['head_dim']}, training "
        f"{a['step_ms']:.2f} ms a step (phase 6, 8 heads of 128: "
        f"{training['step_ms']:.2f}), peak {a['peak_mem_gb']:.2f} GB "
        f"(phase 6: {training['peak_mem_gb']:.2f}), launches a step "
        f"{json.dumps(a['launches_per_step'])}; serving "
        f"{b['completed']}/{b['requests']} requests, flash_fwd "
        f"{b['launches']['flash_fwd']}, paged_decode "
        f"{b['launches']['paged_decode']}, on {card}")
    for label, r in wide2["d_fused_quant_tiles"]["shapes"].items():
        log(f"phase 23d fused_quant {r['shape']}: 128x128/bk0 "
            f"{r['ms_default_128x128']:.4f} ms (bf16 matmul "
            f"{r['yardstick_ms']:.4f}); " + ", ".join(
                f"{t} {ms:.4f}" for t, ms in r["ms"].items()) + f" on {card}")
    took(23)
    dp_launches = {**dp_launches, **mp_launches, **pp_launches,
                   **rs_launches, **obs_launches, **plan_launches,
                   **fleet_launches, **audit_launches, **dropout_launches,
                   **small_launches, **wide_launches, **wide2_launches,
                   "script6_imagenet": s6_launches,
                   "vit_base_int8": vit8_launches,
                   "zoo_sweep": {**{k: 0 for k in kernels.SOURCES},
                                 "sgd": sweep_sgd},
                   "imagefolder_script6": folder_launches}

    # every main-path run's own counts, for a kernel that no single path owns
    by_path = {**dp_launches,
               "serving": serve_launches, "training": train_launches,
               "image_training": image_launches,
               "int8_serving": quant_launches, "spec_serving": spec_launches,
               "lm_windows_chunked": window_launches,
               "lm_accumulation": accum_launches,
               "lm_blockwise": block_launches,
               "image_accum_loss_scale": img_knob_launches,
               "decode_bench_one_shot": bench_launches}
    knob_paths = ("lm_windows_chunked", "lm_accumulation", "lm_blockwise",
                  "image_accum_loss_scale", "decode_bench_one_shot",
                  *dp_launches)
    int8kv_by_path = {p: n["flash_fwd_int8kv"] for p, n in by_path.items()}
    entries = []
    for kname, rec, src, replaces, launches in (
            ("flash_fwd", flash[1024], "tpu_dist_torch/csrc/flash_fwd.cu",
             "tpu_dist/ops/flash_attention.py:138", serve_launches),
            ("paged_decode", paged, "tpu_dist_torch/csrc/paged_decode.cu",
             "tpu_dist/ops/paged_attention.py:294", serve_launches),
            ("flash_bwd_dq", bwd["flash_bwd_dq"],
             "tpu_dist_torch/csrc/flash_bwd_dq.cu",
             "tpu_dist/ops/flash_attention.py:201", train_launches),
            ("flash_bwd_dkv", bwd["flash_bwd_dkv"],
             "tpu_dist_torch/csrc/flash_bwd_dkv.cu",
             "tpu_dist/ops/flash_attention.py:246", train_launches),
            ("adamw", adamw, "tpu_dist_torch/csrc/adamw.cu",
             "tpu_dist/ops/pallas_adamw.py:57", train_launches),
            ("sgd", sgd, "tpu_dist_torch/csrc/sgd.cu",
             "tpu_dist/ops/pallas_sgd.py:93", image_launches),
            ("fused_quant", quant["decode lm_head"],
             "tpu_dist_torch/csrc/fused_quant.cu",
             "tpu_dist/ops/pallas_quant.py:104", quant_launches),
            ("flash_fwd_int8kv", int8kv,
             "tpu_dist_torch/csrc/flash_fwd_int8kv.cu",
             "tpu_dist/ops/flash_attention.py:446",
             {"flash_fwd_int8kv": sum(int8kv_by_path.values())})):
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[kname]}
        entry.update({k: rec[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "tolerance")})
        if kname in ("sgd", "adamw"):
            entry.update({k: rec[k] for k in (
                "ms_is", "eager_ms", "errors", "more_shapes")})
        if kname in ("adamw", "fused_quant"):
            entry.update(ptxas_report(kernels, kname))
        if kname in ("flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_int8kv"):
            entry.update({k: rec[k] for k in (
                "more_shapes", "spill_stores", "registers")})
        if kname in ("flash_bwd_dq", "flash_bwd_dkv", "adamw", "sgd"):
            entry["launches_by_path"] = {
                p: by_path[p][kname]
                for p in ("training", "image_training", *knob_paths)}
        if kname == "flash_fwd":
            entry["more_shapes"] = [flash[2048], *flash_more]
            entry.update(ptxas_report(kernels, "flash_fwd"))
            entry["launches_by_path"] = {
                "serving": serve_launches["flash_fwd"],
                "training": train_launches["flash_fwd"],
                "int8_serving": quant_launches["flash_fwd"],
                "spec_serving": spec_launches["flash_fwd"],
                **{p: by_path[p]["flash_fwd"] for p in knob_paths}}
        if kname == "paged_decode":
            entry.update({k: paged[k] for k in (
                "ms_is", "more_shapes", "nan_scale_arenas",
                "length0_exact_zeros")})
            entry["launches_by_path"] = {
                "serving": serve_launches["paged_decode"],
                "int8_serving": quant_launches["paged_decode"],
                "spec_serving": spec_launches["paged_decode"]}
            entry["more_shapes"].append(lc["d_paged_decode_gathered"])
        if kname == "fused_quant":
            entry["library"] = rec["library"]
            entry["yardstick_ms"] = rec["yardstick_ms"]
            entry["more_shapes"] = [r for k, r in quant.items()
                                    if k != "decode lm_head"]
            entry["more_shapes"] += list(vit_quant.values())
            entry["more_shapes"] += list(
                pp["kernels_at_phase13_shapes"]["fused_quant"].values())
            entry["launches_by_path"] = {
                "int8_serving": quant_launches["fused_quant"],
                "vit_base_int8": vit8_launches["fused_quant"],
                "p12_dp_moe_int8_1rank":
                    mp_launches["p12_dp_moe_int8_1rank"]["fused_quant"]}
        if kname == "flash_fwd_int8kv":
            entry["launches_by_path"] = int8kv_by_path
            entry["note"] = ("no path in the JAX package calls the TPU "
                             "kernel (only tests/test_flash.py); held "
                             "against its plain version in phase 3 alone")
        if kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "adamw",
                     "sgd", "fused_quant"):
            entry.setdefault("launches_by_path", {}).update(
                {p: n[kname] for p, n in pp_launches.items()})
        if kname in ("flash_fwd", "paged_decode"):
            entry["launches_by_path"].update(
                {p: n[kname] for p, n in lc_launches.items()})
        entry["launches_by_path"].update(
            {p: n[kname] for p, n in {**rs_launches, **obs_launches,
                                      **plan_launches, **fleet_launches,
                                      **audit_launches, **dropout_launches,
                                      **small_launches, **wide_launches,
                                      **wide2_launches}.items()})
        if kname in head_dims:
            entry["head_dims"] = dict(zip(
                (f"D{d}" for d, _ in P3_HEAD_DIMS), head_dims[kname]))
            entry["head_dim_sweep"] = {
                dim: {dt: {"max_abs_err": {
                    n: e for n, e in r["max_abs_err"].items()
                    if n in kernel_outputs(kname)},
                    **{k: r[k] for k in ("tolerance",
                                         "misaligned_offset_elements",
                                         "bit_equal_misaligned",
                                         "sentinels_untouched",
                                         "dead_exact_zero")}}
                      for dt, r in recs.items()}
                for dim, recs in hd_sweep.items()}
        entries.append(entry)
    # fused_quant's two phases apart: gspmd tp's int8 row products (13d)
    scaled = pp["d_int8_tp_scaled_pair"]["scaled_pair"]
    for kname, part in (("fused_quant_amax", "amax"),
                        ("fused_quant_scaled", "scaled")):
        first = scaled["proj (tp rank)"]
        entry = {"name": kname, "route": "cuda",
                 "source": "tpu_dist_torch/csrc/fused_quant.cu",
                 "replaces": "tpu_dist/ops/pallas_quant.py:104",
                 "launches": pp_launches["p13_tp_int8_rank0"][kname]}
        entry.update({k: first[part][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "tolerance")})
        entry["more_shapes"] = [r[part] for k, r in scaled.items()
                                if k != "proj (tp rank)"]
        entry["one_call_ms"] = {k: r["one_call_ms"]
                                for k, r in scaled.items()}
        entry["pair_ms"] = {k: r["pair_ms"] for k, r in scaled.items()}
        entry["yardstick_ms"] = {k: r["yardstick_ms"]
                                 for k, r in scaled.items()}
        entry["library"] = first["library"]
        entry["launches_by_path"] = {p: n[kname] for p, n in
                                     {**pp_launches, **rs_launches,
                                      **obs_launches, **plan_launches,
                                      **fleet_launches, **audit_launches,
                                      **dropout_launches,
                                      **small_launches, **wide_launches,
                                      **wide2_launches}.items()}
        entries.append(entry)
    log("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()}))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == DP_WORKER:
        sys.exit(dp_worker(sys.argv[2]))
    if len(sys.argv) >= 3 and sys.argv[1] == P15_CHILD:
        sys.exit(p15_child(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
