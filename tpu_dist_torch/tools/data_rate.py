"""Host data-path throughput of the port (``tools/data_rate.py``): how
fast each dataset flavor assembles batches, beside the rate a device step
consumes them.

* ``get_batch`` img/s of the in-memory ``ArrayDataset`` gather, native
  (``native.gather_batch``, C++ row memcpy) against the numpy route
  (``native=False``);
* ``get_batch`` img/s of the lazy ImageFolder decode: the native libjpeg
  route and, where PIL is importable, PIL's;
* the prefetch-overlap probe over ``data.loader.prefetch_to_device``: the
  consumer's wait for each batch (the trainer's ``data_s``) while a
  calibrated matmul stands in for the step, against the same uploads
  copied inline.

A synthetic ImageFolder tree (``train`` and ``val``; random pixels at
``--src-size`` x 3/4 of it, the shape of an average ImageNet photo) is
written under ``--root``_<src-size> when absent: with PIL where it is importable, else with libjpeg's own
compressor (``native.write_jpeg_fixture``). ``--device-rate`` is the step
rate the host must keep up with, as a training run on the card measured
it (``chip_smoke.py`` passes phase 11a's); the JSON line says whether
the decode keeps up. One JSON line on stdout, with the routes each call
took and, on CUDA, the card's name and power limit::

    python -m tpu_dist_torch.tools.data_rate                 # on the card
    python -m tpu_dist_torch.tools.data_rate --images 16 --batch 8 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpu_dist_torch import native
from tpu_dist_torch.data import imagefolder
from tpu_dist_torch.data.datasets import _synthetic
from tpu_dist_torch.data.loader import prefetch_to_device
from tpu_dist_torch.device import resolve_device


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(
        tempfile.gettempdir(), "tpu_dist_torch_imagefolder"))
    ap.add_argument("--images", type=int, default=256)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--src-size", type=int, default=500,
                    help="stored JPEG width (height 3/4 of it)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--prefetch-batches", type=int, default=16,
                    help="batches for the overlap probe (0: no probe)")
    ap.add_argument("--prefetch-mb", type=float, default=8.0)
    ap.add_argument("--step-ms", type=float, default=20.0)
    ap.add_argument("--device-rate", type=float, default=None,
                    help="img/s a training step on the card consumes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def make_tree(root: str, n_images: int, classes: int, src_size: int) -> str:
    """``root/{train,val}/class<c>/img<i>.jpg`` (random pixels, quality
    85): ``n_images`` in train and an eighth as many in val, so the root is
    a whole ImageFolder dataset; returns the train split."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    rng = np.random.default_rng(0)
    shape = (src_size * 3 // 4, src_size, 3)
    for split, n in (("train", n_images), ("val", max(n_images // 8,
                                                        classes))):
        for c in range(classes):
            cdir = os.path.join(root, split, f"class{c}")
            os.makedirs(cdir, exist_ok=True)
            for i in range(n // classes):
                path = os.path.join(cdir, f"img{i}.jpg")
                if os.path.exists(path):
                    continue
                arr = rng.integers(0, 255, shape, np.uint8)
                if Image is not None:
                    Image.fromarray(arr).save(path, quality=85)
                else:
                    native.write_jpeg_fixture(arr, path, quality=85)
    return os.path.join(root, "train")


def rate(get_batch, n: int, batch: int, seconds: float) -> float:
    """img/s of ``get_batch`` on random indices, after one warm call."""
    rng = np.random.default_rng(1)
    get_batch(rng.integers(0, n, batch))
    done, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        get_batch(rng.integers(0, n, batch))
        done += batch
    return done / (time.perf_counter() - t0)


def prefetch_overlap(device, batch_mb: float, batches: int,
                     step_ms: float) -> dict:
    """The consumer's wait for each batch through ``prefetch_to_device``
    while a calibrated matmul loop stands in for the step, against the
    same uploads copied inline on the consumer's thread. ``hidden_frac``
    is the share of the inline copy time that left the critical path."""
    n = max(1, int(batch_mb * 1e6) // 4)
    rng = np.random.default_rng(0)
    host = [rng.random(n).astype(np.float32) for _ in range(min(batches, 4))]
    feed = [(host[i % len(host)],) for i in range(batches)]
    a = torch.ones((512, 512), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    a @ a
    sync()
    reps = max(1, int(step_ms / 1e3 / max(time.perf_counter() - t0, 1e-6)))

    def step():
        for _ in range(reps):
            out = a @ a
        sync()
        return out

    inline_s = 0.0
    for (b,) in feed:                    # the un-prefetched world
        t0 = time.perf_counter()
        t = torch.from_numpy(b).to(device)
        sync()
        inline_s += time.perf_counter() - t0
        del t
        step()
    wait_s = 0.0
    it = prefetch_to_device(iter(feed), device)
    while True:                          # the overlapped world
        t0 = time.perf_counter()
        got = next(it, None)
        wait_s += time.perf_counter() - t0
        if got is None:
            break
        step()
    hidden = (max(0.0, min(1.0, 1.0 - wait_s / inline_s))
              if inline_s > 0 else None)
    return {"batches": batches, "batch_mb": batch_mb, "step_ms": step_ms,
            "inline_copy_s": inline_s, "prefetch_wait_s": wait_s,
            "hidden_frac": hidden}


def main(argv=None) -> dict:
    args = _args(argv)
    device = resolve_device(args.device)
    native.reset_routes()
    arr = _synthetic(args.images, (args.size, args.size, 3), args.classes,
                     proto_seed=0, sample_seed=1, name="synth-224")
    numpy_rate = rate(lambda i: native.gather_batch(
        arr.images, arr.labels, i, native=False), len(arr), args.batch,
        args.seconds)
    native_rate = rate(arr.get_batch, len(arr), args.batch, args.seconds)
    print(f"ArrayDataset gather ({args.size}px): numpy {numpy_rate:,.0f}, "
          f"native {native_rate:,.0f} img/s", file=sys.stderr)

    split = make_tree(f"{args.root}_{args.src_size}", args.images,
                      args.classes, args.src_size)
    folder = imagefolder.ImageFolderDataset(split, size=args.size,
                                            workers=args.workers)
    decode_rate = None
    if native.decode_available():
        decode_rate = rate(folder.get_batch, len(folder), args.batch,
                           args.seconds)
    pil_rate = None
    try:
        import PIL  # noqa: F401
    except ImportError:
        pass
    else:
        with ThreadPoolExecutor(args.workers) as pool:
            def pil_batch(idx):
                return np.stack(list(pool.map(
                    lambda i: imagefolder._pil_decode(
                        folder.samples[int(i)][0], args.size), idx)))
            pil_rate = rate(pil_batch, len(folder), args.batch,
                            args.seconds)
    folder.close()
    print(f"ImageFolder decode ({args.workers} workers, {args.src_size}px "
          f"-> {args.size}px): native {decode_rate}, PIL {pil_rate} img/s",
          file=sys.stderr)
    prefetch = (prefetch_overlap(device, args.prefetch_mb,
                                 args.prefetch_batches, args.step_ms)
                if args.prefetch_batches > 0 else None)
    best = max(r for r in (decode_rate, pil_rate, 0.0) if r is not None)
    out = {
        "metric": "torch_host_data_path_images_per_sec",
        "array_gather_native": native_rate,
        "array_gather_numpy": numpy_rate,
        "imagefolder_decode_native": decode_rate,
        "imagefolder_decode_pil": pil_rate,
        "routes": {**native.ROUTES, "folder": dict(folder.routes)},
        "batch": args.batch, "image_size": args.size,
        "src_size": [args.src_size * 3 // 4, args.src_size],
        "workers": args.workers, "prefetch": prefetch,
        "device": str(device),
        "device_rate": args.device_rate,
        "decode_keeps_up": (None if args.device_rate is None
                            else best >= args.device_rate),
    }
    if device.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
