#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (tpu_dist_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU (the
kernels are built for sm_90a with the CUDA toolkit's nvcc). Every phase
raises on failure; the script prints no result and exits non-zero without
CUDA or without the repository beside it. Phases:

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
   sgd and fused_quant). The fused int8 matmul is held bit-equal at every
   dense shape of a decode tick and a prefill (no one PyTorch call
   computes it: ``library_ms`` is null, and ``yardstick_ms`` times the
   bf16 ``torch.matmul`` of the unquantized operands), the int8-K/V flash
   forward at L=2048 (library: SDPA on the dequantized K/V);
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
   device-resident rows and a checkpoint directory: run A trains 12
   steps, run B is interrupted after 2 windows and leaves a mid-epoch
   checkpoint, run C resumes from it, skips 8 batches and must match A's
   steps 9-12 (loss within LOSS_TOL; whether bit-equal is reported), with
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
   reference's defaults with the flash kernel in the full recompute.

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


def check_paged(torch, F, gen):
    """The paged decode kernel against its plain version at the serving
    width: over gathered K/V (B8 Lk2048 H8 D128, the reference's layout),
    and over the same keys scattered to 1,024 pages of 16 through a
    shuffled (8, 128) block table (bit-equal to the gathered result: the
    same keys in the same splits); on arenas whose scales are NaN wherever
    no row may read (bit-equal again: never read); and with one row of
    length 0 (exact zeros)."""
    from tpu_dist_torch.ops import flash_attention as fa
    from tpu_dist_torch.ops import paged_attention as pa

    b, lk, h, d = 8, 2048, 8, 128
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
    ``fq_decode_kernel<bf16, 1>``; the symbol itself where no
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
        t = re.match(r"f|13__nv_bfloat16|Li(\d+)E", rest)
        if not t:
            return fn
        args.append(t.group(1) or ("float" if t.group() == "f" else "bf16"))
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
    from tpu_dist_torch.ops import flash_attention as fa

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
                       "backward (autograd.grad)",
            "more_shapes": more, **ptxas_report(kernels, name)}
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
    from tpu_dist_torch.ops import flash_attention as fa

    b, L, h, d = 1, 2048, 8, 128
    rec, (q, kv) = check_int8kv_shape(torch, gen, b, L, L, h, d)
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
    own = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rec["more_shapes"] = [
        check_int8kv_shape(torch, own, 1, 1000, 1000, 8, 64, q_offset=24)[0],
        check_int8kv_shape(torch, own, 1, 130, 200, 8, 128, kv_offset=40)[0]]
    rec.update(ptxas_report(kernels, "flash_fwd_int8kv"))
    return rec


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


def small_trainer_agreement(torch):
    """Tiny fp32 trainer, flash + fused_adamw with the clip slot: 5 steps
    on the card (kernels) and on the CPU (plain) from the same weights."""
    from tpu_dist_torch.configs import LMConfig
    from tpu_dist_torch.interop import export_flax_params
    from tpu_dist_torch.models.transformer import TransformerLM

    cfg = LMConfig(batch_size=4, seq_len=96, d_model=128, num_layers=2,
                   num_heads=1, vocab_size=64, synth_tokens=4000, seed=SEED,
                   attn="flash", optimizer="fused_adamw", lr=3e-3,
                   grad_clip=0.5, weight_decay=0.1, max_steps=5,
                   print_freq=100)
    # one set of initial weights for both (the CPU and CUDA generators of
    # one seed give different numbers)
    init = export_flax_params(TransformerLM(
        vocab_size=64, num_layers=2, d_model=128, num_heads=1, max_len=96,
        device="cpu", seed=SEED))
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


def training_path(torch, kernels):
    """The training main path at full width (module docstring, phase 6)."""
    layers = 8
    cfg = full_lm_config(max_steps=TRAIN_STEPS, print_freq=5)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    tr, losses = run_trainer(cfg, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    leaves = len(tr.state.params)
    n_eval = len(tr._epoch_indices(tr.val_ds, False, 0)[0])
    if len(losses) != TRAIN_STEPS or tr.state.step != TRAIN_STEPS:
        raise AssertionError(f"trained {tr.state.step} steps, "
                             f"{len(losses)} losses")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    first, last = (statistics.mean(losses[:5]), statistics.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"losses not falling: first 5 mean {first}, "
                             f"last 5 mean {last}: {losses}")
    want = {"flash_bwd_dq": layers * TRAIN_STEPS,
            "flash_bwd_dkv": layers * TRAIN_STEPS,
            "adamw": TRAIN_STEPS,              # one call over all leaves
            "flash_fwd": layers * (TRAIN_STEPS + n_eval)}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"expected {n}")
    params = sum(p.numel() for p in tr.state.params)
    # the epoch rate leaves out the first step (kernel builds and the
    # allocator's warm-up ride on it)
    tokens = cfg.batch_size * cfg.seq_len
    training = {
        "params": params, "leaves": leaves, "steps": TRAIN_STEPS,
        "losses": losses, "first5_mean": first, "last5_mean": last,
        "tokens_per_s": tr.last_tok_s,
        "step_ms": tokens / tr.last_tok_s * 1e3,
        "wall_s_incl_build_and_eval": wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "launches_per_step": {k: launches[k] / TRAIN_STEPS for k in (
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


def small_input_agreement(torch, card_kw=None, cpu_kw=None):
    """Tiny fp32 model: kernels on the card == plain versions on the CPU,
    with ``card_kw`` / ``cpu_kw`` added to each side's ServeConfig."""
    import numpy as np

    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.models.transformer import tiny_lm
    from tpu_dist_torch.ops.flash_attention import flash_attention_fn

    geom = dict(vocab_size=64, num_layers=2, d_model=256, num_heads=2,
                max_len=96, attn_fn=flash_attention_fn())
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


def main_path(torch, kernels):
    """The serving main path at full width (module docstring, phase 5).
    Returns (record, launches, model, prompts, outs): phase 8 serves the
    same model and requests."""
    import numpy as np

    from tpu_dist_torch.engine.serve import ServeConfig
    from tpu_dist_torch.models.transformer import TransformerLM
    from tpu_dist_torch.ops.flash_attention import flash_attention_fn

    layers = 8
    model = TransformerLM(vocab_size=32000, num_layers=layers, d_model=1024,
                          num_heads=8, max_len=2048, dtype=torch.bfloat16,
                          attn_fn=flash_attention_fn(), device="cuda",
                          seed=SEED)
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
    run C resumes from it to step 12. ``base`` is phase 6's record."""
    from tpu_dist_torch.engine import checkpoint as ckpt
    from tpu_dist_torch.engine.lm_loop import LMTrainer

    steps, k, layers = 12, 4, 8
    free_device(torch)
    with tempfile.TemporaryDirectory() as tmp:
        def cfg(name, **kw):
            return full_lm_config(
                loss_chunk=1024, steps_per_dispatch=k,
                data_placement="device", max_steps=steps, print_freq=k,
                checkpoint_dir=os.path.join(tmp, name),
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
    from tpu_dist_torch.ops.fused_xent import chunked_softmax_xent, mm_route

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


def decode_bench_one_shot(torch, kernels):
    """9e: the decode bench's one-shot mode at the reference's defaults
    (batch 8, prompt 128, 384 steps) on the LM's width with the flash
    kernel in the full recompute."""
    import contextlib
    import io

    from tpu_dist_torch.tools import decode_bench

    argv = ["--batch", "8", "--prompt-len", "128", "--steps", "384",
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
    # the full recompute runs 384 forwards per call (a warm call and one
    # trial); the cached decode attends exactly over its cache
    want = 2 * 384 * 8
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
    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 1 device: {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")

    # 2. build
    t0 = time.perf_counter()
    took = kernels.build()
    took = {k: round(v, 2) for k, v in took.items()}
    log(f"phase 2 build: {json.dumps(took)} in "
        f"{time.perf_counter() - t0:.1f}s wall")
    for k in kernels.SOURCES:
        logp = os.path.join(kernels.build_dir(), f"{k}.log")
        if os.path.isfile(logp):
            with open(logp) as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        log(f"  ptxas {k}: {line.strip()}")

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
    log(f"phase 3 kernels: flash_fwd {json.dumps(flash)}")
    log(f"phase 3 kernels: flash_fwd more shapes {json.dumps(flash_more)}")
    log(f"phase 3 kernels: paged_decode {json.dumps(paged)}")
    log(f"phase 3 kernels: flash_bwd {json.dumps(bwd)}")
    log(f"phase 3 kernels: adamw {json.dumps(adamw)}")
    log(f"phase 3 kernels: sgd {json.dumps(sgd)}")
    log(f"phase 3 kernels: fused_quant {json.dumps(quant)}")
    log(f"phase 3 kernels: flash_fwd_int8kv {json.dumps(int8kv)}")
    log(f"phase 3 ptxas: " + json.dumps(
        {k: ptxas_report(kernels, k) for k in ("adamw", "sgd",
                                               "fused_quant")}))

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

    # 5. the serving main path at full width
    serving, serve_launches, model, prompts, outs = main_path(torch, kernels)
    log(f"phase 5 serving: {json.dumps(serving)} on {card}")

    # 6. the training main path at full width
    training, train_launches = training_path(torch, kernels)
    log(f"phase 6 training: {json.dumps(training)} on {card}")

    # 7. the image main path at full width (its checkpoints kept for 9d)
    ck7 = tempfile.TemporaryDirectory()
    image, image_launches = image_path(torch, kernels, ck7.name)
    log(f"phase 7 image training: {json.dumps(image)} on {card}")

    # 8. quantized and speculative serving at full width
    t0 = time.perf_counter()
    qspec, quant_launches, spec_launches = quant_spec_path(
        torch, kernels, model, prompts, outs)
    del model
    log(f"phase 8 int8 serving: {json.dumps(qspec['int8'])} on {card}")
    log(f"phase 8 speculative serving (spec_k={SPEC_K}): "
        f"{json.dumps(qspec['spec'])} on {card}")
    log(f"phase 8 took {time.perf_counter() - t0:.1f}s")

    # 9. the one-device training knobs at full width
    t0 = time.perf_counter()
    windows, window_launches = lm_windows_resume(torch, kernels, training)
    log(f"phase 9a LM windows, chunked loss, resume: {json.dumps(windows)} "
        f"on {card}")
    accum, accum_launches = lm_knob_run(torch, kernels, training,
                                        grad_accum_steps=2)
    if accum_launches["adamw"] != 4 or \
            accum_launches["flash_bwd_dq"] != 8 * 2 * 4:
        raise AssertionError(f"9b: launches {accum_launches}")
    log(f"phase 9b LM accumulation: {json.dumps(accum)} on {card}")
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
    img_knobs, img_knob_launches = image_knobs(
        torch, kernels, image,
        os.path.join(ck7.name, "resnet50-model_best.pt"))
    ck7.cleanup()
    log(f"phase 9d image accumulation, loss scale, warm start: "
        f"{json.dumps(img_knobs)} on {card}")
    bench, bench_launches = decode_bench_one_shot(torch, kernels)
    log(f"phase 9e decode bench one-shot: {json.dumps(bench)} on {card}")
    log(f"phase 9 took {time.perf_counter() - t0:.1f}s")

    # every main-path run's own counts, for a kernel that no single path owns
    by_path = {"serving": serve_launches, "training": train_launches,
               "image_training": image_launches,
               "int8_serving": quant_launches, "spec_serving": spec_launches,
               "lm_windows_chunked": window_launches,
               "lm_accumulation": accum_launches,
               "lm_blockwise": block_launches,
               "image_accum_loss_scale": img_knob_launches,
               "decode_bench_one_shot": bench_launches}
    knob_paths = ("lm_windows_chunked", "lm_accumulation", "lm_blockwise",
                  "image_accum_loss_scale", "decode_bench_one_shot")
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
        if kname == "fused_quant":
            entry["library"] = rec["library"]
            entry["yardstick_ms"] = rec["yardstick_ms"]
            entry["more_shapes"] = [r for k, r in quant.items()
                                    if k != "decode lm_head"]
            entry["launches_by_path"] = {
                "int8_serving": quant_launches["fused_quant"]}
        if kname == "flash_fwd_int8kv":
            entry["launches_by_path"] = int8kv_by_path
            entry["note"] = ("no path in the JAX package calls the TPU "
                             "kernel (only tests/test_flash.py); held "
                             "against its plain version in phase 3 alone")
        entries.append(entry)
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
