"""Communication microbenchmark for the port (``tools/comm_bench.py``): on
the ``torch.distributed`` group, per buffer size,

1. ``allreduce``: the explicit ring (``parallel.collectives
   .ring_allreduce``, point-to-point rounds) against one ``all_reduce``
   of the same buffer;
2. ``grad_sync``: bucketed sync (``parallel.overlap.bucketed_grad_sync``,
   ``rs_ag`` buckets of ``--bucket-mb``) against one ``all_reduce`` over
   the whole tree, on a ragged tree (one leaf of half the size, one of a
   quarter, one of an eighth and the rest);
3. ``latency``: ``collectives.allreduce_bench`` (mean latency and
   algorithm bandwidth).

Times are CUDA events on the card and the host clock on the CPU, the mean
of ``--iters`` calls after one warm call. Rank 0 prints the tables as one
JSON line::

    python -m tpu_dist_torch.tools.comm_bench --nprocs 2 --device cpu
    python -m tpu_dist_torch.tools.comm_bench                 # one card, nccl
    python -m tpu_dist_torch.tools.comm_bench --nprocs 2 --backend gloo

``--nprocs N`` starts N ranks on this host (``parallel.launch.spawn``); a
launcher's ``TPU_DIST_*`` or Slurm variables work as for the trainers. A
collective that the backend does not run (the ring on CUDA tensors over
gloo) is reported with its error instead of a time.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

from tpu_dist_torch.parallel import collectives as C
from tpu_dist_torch.parallel import launch
from tpu_dist_torch.parallel.mesh import make_mesh
from tpu_dist_torch.parallel.overlap import bucketed_grad_sync


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nprocs", type=int, default=1,
                    help="ranks to start on this host (1: this process)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on CUDA, gloo on the CPU")
    ap.add_argument("--sizes-mb", type=float, nargs="+",
                    default=[0.25, 4.0, 32.0])
    ap.add_argument("--bucket-mb", type=float, default=25.0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--port", type=int, default=0,
                    help="loopback rendezvous port for --nprocs > 1 (0: "
                         "any free port, bound and held by this process)")
    return ap.parse_args(argv)


def _timeit(fn, device, iters: int, group) -> float:
    fn()                                   # warm
    C.barrier(device, group)
    start, stop = C.timer(device)
    start()
    for _ in range(iters):
        fn()
    return stop() / iters


def _attempt(fn, device, iters, group):
    """(seconds, None), or (None, the refusal) where the port refuses the
    collective on this backend."""
    try:
        return _timeit(fn, device, iters, group), None
    except NotImplementedError as e:
        return None, str(e)


def bench(args) -> dict:
    mesh = make_mesh(device=args.device)
    dev, group = mesh.device, mesh.group()
    out = {"metric": "torch_comm_bench", "world": mesh.size,
           "backend": C.backend_of(group), "device": str(dev),
           "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "iters": args.iters, "bucket_mb": args.bucket_mb,
           "timer": "cuda events" if dev.type == "cuda" else "host clock",
           "allreduce": [], "grad_sync": []}
    for mb in args.sizes_mb:
        n = max(mesh.size, int(mb * 1e6 / 4))
        x = torch.ones(n, device=dev)
        ring_s, ring_err = _attempt(lambda: C.ring_allreduce(x, group), dev,
                                    args.iters, group)
        psum_s, _ = _attempt(lambda: C.all_reduce_(x, group), dev,
                             args.iters, group)
        out["allreduce"].append({"size_mb": mb, "bytes": n * 4,
                                 "ring_s": ring_s, "all_reduce_s": psum_s,
                                 **({"ring_error": ring_err} if ring_err
                                    else {})})
        tree = [torch.ones(n // 2, device=dev), torch.ones(n // 4, device=dev),
                torch.ones(n // 8, device=dev),
                torch.ones(n - n // 2 - n // 4 - n // 8, device=dev)]
        b_s, _ = _attempt(lambda: bucketed_grad_sync(
            tree, args.bucket_mb, group=group), dev, args.iters, group)
        m_s, _ = _attempt(lambda: bucketed_grad_sync(
            tree, math.inf, impl="psum", group=group), dev, args.iters,
            group)
        out["grad_sync"].append({"size_mb": mb, "bytes": n * 4,
                                 "bucketed_s": b_s, "monolithic_s": m_s})
    out["latency"] = {str(k): v for k, v in C.allreduce_bench(
        sizes_mb=args.sizes_mb, iters=args.iters, device=dev,
        group=group).items()}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _args(argv)
    if args.nprocs > 1 and "TPU_DIST_PROCESS_ID" not in os.environ:
        launch.spawn("tpu_dist_torch.tools.comm_bench", args.nprocs, argv,
                     f"127.0.0.1:{args.port}")
        return 0
    info = launch.initialize(backend=args.backend, device=args.device)
    out = bench(args)
    if info.process_id == 0:
        if out["card"] != "cpu":
            out["power_limit"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip()
        launch.say(json.dumps(out))
    launch.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
