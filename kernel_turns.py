#!/usr/bin/env python3
"""Time the five attention kernels of this checkout against another
checkout's, in turns, on one card.

    python3 kernel_turns.py --other PATH

Run from the repository root on a machine with an NVIDIA Hopper GPU.
``PATH`` holds the other tree's ``tpu_dist_torch/csrc`` (for example a
``git archive`` of the parent commit unpacked under ``build/``). Both
trees' attention sources are built with this tree's flags (the other
tree's into ``<build dir>/turns``), and their C entries, which share one
signature, are driven through this tree's wrappers. For each (head dim,
heads) of ``TURN_DIMS`` at the phase-3 shapes of ``chip_smoke.py`` (flash
forward B1 and B8 L2048, backward pair B8 L2048, int8-K/V forward B1
L2048, paged decode B8 Lk2048), and for ``fused_quant`` at each of its
compiled tiles (``pallas_quant.INSTANTIATED_TILES``, bk 0) on
``QUANT_TURN_SHAPES``, the two outputs must be bit-equal, and
each side is timed twice in the order other, this, this, other (CUDA-event
medians, ``chip_smoke.time_ms``). Then this tree's kernels alone:
``chip_smoke.check_head_dims`` at ``TIMED_DIMS`` (times beside SDPA, the
plain versions and the bound) and ``chip_smoke.check_head_dim_sweep``.
Prints ptxas's registers and spills for each attention source, each
turn, and one JSON line with everything; ``--out`` also writes it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import chip_smoke as cs

# head dims timed in turns: 48 (the general instance of 64, whole rows)
# and 128 (exact) at 8 heads, 256 (exact) at 4
TURN_DIMS = ((48, 8), (128, 8), (256, 4))
# fused_quant's shapes timed in turns: phase 6's int8 qkv and mlp_out
# products (M = B x L = 16,384)
QUANT_TURN_SHAPES = {"qkv": (16384, 1024, 3072),
                     "mlp_out": (16384, 4096, 1024)}
# this tree's rows beside SDPA: 48, 100 (rows of any width, on 128), 200
# (whole rows on 256), 256, and 512 (the wide path), at the heads of
# phase 3
TIMED_DIMS = ((48, 8), (100, 8), (200, 4), (256, 4), (512, 2))
ATTENTION = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "flash_fwd_int8kv", "paged_decode")
BUILT = (*ATTENTION, "fused_quant")


def build_other(kernels, csrc: str) -> dict:
    """Compile the other tree's attention and fused_quant sources, all
    ``nvcc`` processes started together; {name: library path}."""
    out_dir = os.path.join(kernels.build_dir(), "turns")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in BUILT:
        lib = os.path.join(out_dir, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", lib,
             os.path.join(csrc, kernels.SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the other tree's {name} failed to build:\n"
                               f"{log}")
        libs[name] = lib
    return libs


def entries(kernels, libs=None) -> dict:
    """The five attention C entries and fused_quant's product and
    workspace entries: this tree's (``libs`` None) or the other's."""
    from tpu_dist_torch.ops import flash_attention as fa
    from tpu_dist_torch.ops import paged_attention as pa
    from tpu_dist_torch.ops import pallas_quant as pq

    def fn(name, symbol, argtypes):
        if libs is None:
            return kernels.function(name, symbol, argtypes)
        f = getattr(ctypes.CDLL(os.path.abspath(libs[name])), symbol)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        return f

    return {"flash": fn("flash_fwd", "tdt_flash_fwd", fa._FLASH_ARGS),
            "dq": fn("flash_bwd_dq", "tdt_flash_bwd_dq", fa._BWD_DQ_ARGS),
            "dkv": fn("flash_bwd_dkv", "tdt_flash_bwd_dkv",
                      fa._BWD_DKV_ARGS),
            "int8kv": fn("flash_fwd_int8kv", "tdt_flash_fwd_int8kv",
                         fa._INT8KV_ARGS),
            "paged": fn("paged_decode", "tdt_paged_decode", pa._PAGED_ARGS),
            "quant": fn("fused_quant", "tdt_fused_quant",
                        pq._FUSED_QUANT_ARGS),
            "quant_ws": fn("fused_quant", "tdt_fused_quant_workspace",
                           pq._WORKSPACE_ARGS)}


def turns(torch, trees: dict) -> dict:
    """{row: {"bit_equal", "other": [ms, ms], "this": [ms, ms]}} at each
    head dim of TURN_DIMS."""
    from tpu_dist_torch.ops import flash_attention as fa
    from tpu_dist_torch.ops import paged_attention as pa

    st = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa
    res = {}
    for d, h in TURN_DIMS:
        bf = torch.bfloat16
        q1, k1, v1 = (rnd(1, 2048, h, d).to(bf) for _ in range(3))
        q8, k8, v8, g8 = (rnd(8, 2048, h, d).to(bf) for _ in range(4))
        out8, lse8 = fa.flash_forward_cuda(q8, k8, v8, True)
        delta = fa.bwd_delta(out8, g8)
        kv = fa.quantize_kv(k1.float(), v1.float())
        qd = rnd(8, 1, h, d).to(bf)
        pk = fa.quantize_kv(rnd(8, 2048, h, d), rnd(8, 2048, h, d))
        lens = torch.randint(1, 2049, (8,), generator=gen, device="cuda",
                             dtype=torch.int32)
        rows = {}
        for tree, e in trees.items():
            bwd = (q8, k8, v8, g8, lse8, delta, True, 0, 0, st)
            rows[tree] = {
                "fwd B1 L2048": lambda e=e: fa._launch(
                    e["flash"], q1, k1, v1, True, 0, 0, st),
                "fwd B8 L2048": lambda e=e: fa._launch(
                    e["flash"], q8, k8, v8, True, 0, 0, st),
                "dq B8 L2048": lambda e=e, a=bwd: fa._launch_bwd_dq(
                    e["dq"], *a),
                "dkv B8 L2048": lambda e=e, a=bwd: fa._launch_bwd_dkv(
                    e["dkv"], *a),
                "int8kv B1 L2048": lambda e=e: fa._launch_int8kv(
                    e["int8kv"], q1, kv, True, 0, 0, st),
                "paged B8 Lk2048": lambda e=e: pa._launch(
                    e["paged"], qd, *pk, lens, st)}
        for name in rows["other"]:
            a, b = rows["other"][name](), rows["this"][name]()
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            rec = {"bit_equal": all(torch.equal(x, y)
                                    for x, y in zip(a, b)),
                   "other": [], "this": []}
            for tree in ("other", "this", "this", "other"):
                rec[tree].append(cs.time_ms(torch, rows[tree][name]))
            res[f"D{d} H{h} {name}"] = rec
            cs.log(f"D{d} H{h} {name}: bit-equal {rec['bit_equal']}, "
                   f"other {rec['other']}, this {rec['this']}")
        del q8, k8, v8, g8, out8, lse8, delta
    res.update(quant_turns(torch, trees))
    return res


def quant_turns(torch, trees: dict) -> dict:
    """fused_quant at each compiled tile on QUANT_TURN_SHAPES, as turns()
    times the attention kernels."""
    from tpu_dist_torch.ops import pallas_quant as pq

    st = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    res = {}
    for label, (m, k, n) in QUANT_TURN_SHAPES.items():
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / k ** 0.5).to(torch.bfloat16)
        for bm, bn in pq.INSTANTIATED_TILES:
            run = {tree: (lambda e=e, t=(bm, bn, 0): pq._launch(
                e["quant"], e["quant_ws"], x, w, st, tile=t))
                for tree, e in trees.items()}
            rec = {"bit_equal": torch.equal(run["other"](), run["this"]()),
                   "other": [], "this": []}
            for tree in ("other", "this", "this", "other"):
                rec[tree].append(cs.time_ms(torch, run[tree]))
            name = f"fused_quant {label} M{m} K{k} N{n} {bm}x{bn}/bk0"
            res[name] = rec
            cs.log(f"{name}: bit-equal {rec['bit_equal']}, other "
                   f"{rec['other']}, this {rec['this']}")
        del x, w
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", required=True,
                   help="a directory holding the other tree's "
                        "tpu_dist_torch/csrc")
    p.add_argument("--out", default="",
                   help="also write the JSON record to this file")
    args = p.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_turns: CUDA is not available", file=sys.stderr)
        return 2
    from tpu_dist_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card}")
    t0 = time.perf_counter()
    other = build_other(kernels, os.path.join(args.other, "tpu_dist_torch",
                                              "csrc"))
    kernels.build(BUILT)
    cs.log(f"both trees built in {time.perf_counter() - t0:.1f}s")
    rec = {"card": card,
           "ptxas": {n: cs.ptxas_report(kernels, n) for n in ATTENTION}}
    for n, r in rec["ptxas"].items():
        cs.log(f"ptxas {n}: registers {json.dumps(r['registers'])} "
               f"spills {json.dumps(r['spill_stores'])}")
    rec["turns"] = turns(torch, {"other": entries(kernels, other),
                                 "this": entries(kernels)})
    rec["timed"] = {k: dict(zip((f"D{d} H{h}" for d, h in TIMED_DIMS), v))
                    for k, v in cs.check_head_dims(torch, F,
                                                   TIMED_DIMS).items()}
    for k, v in rec["timed"].items():
        cs.log(f"{k}: " + ", ".join(
            f"{dim} {r['ms']:.4f} (bound {r['bound_ms']:.4f}, SDPA "
            f"{r['library_ms']:.4f}, plain {r['plain_ms']:.3f})"
            for dim, r in v.items()))
    rec["sweep"] = cs.check_head_dim_sweep(torch, kernels)
    line = json.dumps(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
