"""Device memory telemetry for the port (``tpu_dist/utils/telemetry.py``).

The reference cookbook samples GPU memory every 500 ms with nvidia-smi from
a separate process (``statistics.sh``). The port reads the CUDA caching
allocator instead, in process, on the trainer's own device:
``bytes_in_use`` is ``allocated_bytes.all.current``, ``peak_bytes_in_use``
``allocated_bytes.all.peak`` and ``bytes_limit`` the card's total memory.
:func:`start_hbm_sampler` writes the reference's CSV (:data:`CSV_HEADER`,
unchanged) every ``interval_s`` with host RSS beside it, plus one ``hbm``
ledger event a row. Off CUDA the device columns stay empty, as the
reference leaves them on backends without counters, so the CSV schema is
the same in tests.

The sampler thread reads the counters of the device it was given by index
and never makes a CUDA context of its own: before the process has one, or
off CUDA, :func:`device_memory_stats` returns ``{}``. The reference's
``program_stats`` reads an XLA executable and has no counterpart; the
trainers' ``compile`` event takes its ``hbm_bytes`` from the allocator's
peak over the first step (:func:`peak_hbm_bytes`).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

CSV_HEADER = "ts,hbm_bytes_in_use,hbm_peak_bytes,hbm_bytes_limit,host_rss_kb"


def _cuda_index(device) -> Optional[int]:
    """The CUDA device index whose allocator to read (``device``'s, or the
    current device's), or None off CUDA and before the process made a CUDA
    context."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    idx = None if device is None else torch.device(device).index
    return torch.cuda.current_device() if idx is None else idx


def device_memory_stats(device=None) -> dict:
    """The CUDA allocator's counters of ``device`` (default: the current
    CUDA device) under the reference's names, or {} off CUDA and before
    the process made a CUDA context."""
    import torch

    idx = _cuda_index(device)
    if idx is None:
        return {}
    s = torch.cuda.memory_stats(idx)
    return {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(idx).total_memory,
            "bytes_reserved": s.get("reserved_bytes.all.current", 0),
            "num_alloc_retries": s.get("num_alloc_retries", 0)}


def peak_hbm_bytes(device=None) -> Optional[int]:
    """The allocator's high-water mark on ``device`` since the process
    started or since the last ``torch.cuda.reset_peak_memory_stats``; None
    off CUDA."""
    return device_memory_stats(device).get("peak_bytes_in_use")


def reset_peak(device) -> None:
    """Restart the allocator's high-water mark on a CUDA ``device`` (a
    no-op elsewhere)."""
    import torch

    idx = _cuda_index(device)
    if idx is not None:
        torch.cuda.reset_peak_memory_stats(idx)


def _host_rss_kb() -> Optional[int]:
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def start_hbm_sampler(path: str, interval_s: float = 0.5, ledger=None,
                      device=None) -> Callable[[], None]:
    """Write :data:`CSV_HEADER` rows to ``path`` every ``interval_s`` from
    a daemon thread until the returned stop() is called, each row also an
    ``hbm`` event on ``ledger`` when one is given. ``device`` is the
    trainer's device (its counters, read by index). stop() is idempotent,
    and the file is closed once, in the thread's ``finally``."""
    f = open(path, "w", buffering=1)
    f.write(CSV_HEADER + "\n")
    stop = threading.Event()

    def run():
        try:
            while not stop.is_set():
                s = device_memory_stats(device)
                rss = _host_rss_kb()
                row = (time.time(), s.get("bytes_in_use", ""),
                       s.get("peak_bytes_in_use", ""),
                       s.get("bytes_limit", ""), rss or "")
                f.write(",".join(str(x) for x in row) + "\n")
                if ledger is not None:
                    ledger.emit("hbm", bytes_in_use=s.get("bytes_in_use"),
                                peak_bytes=s.get("peak_bytes_in_use"),
                                bytes_limit=s.get("bytes_limit"),
                                host_rss_kb=rss)
                stop.wait(interval_s)
        finally:
            if not f.closed:
                f.flush()
                f.close()

    t = threading.Thread(target=run, name="tpu-dist-hbm-sampler", daemon=True)
    t.start()

    def stop_fn():
        if stop.is_set():
            return
        stop.set()
        t.join(timeout=5)

    return stop_fn
