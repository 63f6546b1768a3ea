"""Host batch loader and device prefetcher for the port
(``tpu_dist/data/loader.py``).

* :class:`DataLoader` yields ``(images_u8, labels_i32)`` numpy batches
  (plus the float32 ``valid`` mask with ``emit_valid``) for a
  :class:`~tpu_dist_torch.data.sampler.DistributedSampler`, assembled by a
  background thread through :func:`stream_prefetch`, as the reference's;
* :func:`stream_prefetch` is the reference's bounded producer-thread
  pipeline (``:69``), copied;
* :func:`prefetch_to_device` replaces the reference's ``device_put``
  staging (``:130-259``) with the CUDA idiom: each batch is pinned and
  copied with ``non_blocking=True`` on a side CUDA stream by the producer
  thread; the consumer's stream waits on an event recorded after that
  batch's copies, and every tensor is ``record_stream``-ed on the consumer
  stream, so the allocator never hands its memory to the side stream while
  the step still reads it. This is the reference cookbook's apex
  ``data_prefetcher`` (4.apex_distributed.py:80-133) with the stream
  synchronisation its version lacked. On the CPU the batches are plain
  tensors over the numpy arrays.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np
import torch

from tpu_dist_torch.data.sampler import DistributedSampler


class DataLoader:
    """Yields (images_u8, labels_i32) numpy batches for this process's
    shard (``tpu_dist/data/loader.py:33``)."""

    def __init__(self, dataset, sampler: DistributedSampler, batch_size: int,
                 workers: int = 2, queue_depth: int = 4,
                 emit_valid: bool = False):
        if sampler.batch_size not in (None, batch_size):
            raise ValueError("sampler.batch_size disagrees with loader batch_size")
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.queue_depth = queue_depth
        # emit_valid: also yield a float32 validity mask distinguishing real
        # samples from the sampler's wrap-around padding (exact eval metrics)
        self.emit_valid = emit_valid

    def __len__(self) -> int:
        return self.sampler.num_samples // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        idx, valid = self.sampler.indices_with_valid()

        def batches():
            for b in range(len(self)):
                sel = slice(b * self.batch_size, (b + 1) * self.batch_size)
                batch = self.dataset.get_batch(idx[sel])
                if self.emit_valid:
                    batch = (*batch, valid[sel].astype(np.float32))
                yield batch

        yield from stream_prefetch(batches(), depth=self.queue_depth)


def stream_prefetch(iterable, depth: int = 2):
    """Bounded background pipeline over any iterable: items are produced
    in a producer thread while the consumer computes, with at most
    ``depth`` items staged; exceptions propagate to the consumer, and
    abandoning the generator stops the producer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    # control flows in tagged envelopes, so items that happen to be None or
    # exception instances pass through untouched
    def producer():
        try:
            for item in iterable:
                if not _put(("item", item)):
                    return
            _put(("done", None))
        except BaseException as e:  # surface assembly/upload errors
            _put(("err", e))

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            tag, payload = q.get()
            if tag == "done":
                return
            if tag == "err":
                raise payload
            yield payload
    finally:
        stop.set()


def prefetch_to_device(iterator, device, size: int = 2):
    """Tensors on ``device`` for each numpy tuple of ``iterator``, with up
    to ``size`` batches staged ahead (module docstring: side-stream copies,
    event wait, ``record_stream``)."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield tuple(torch.from_numpy(np.ascontiguousarray(a))
                        for a in batch)
        return
    side = torch.cuda.Stream(device)

    def staged():
        with torch.cuda.device(device), torch.cuda.stream(side):
            for batch in iterator:
                out = tuple(torch.from_numpy(np.ascontiguousarray(a))
                            .pin_memory().to(device, non_blocking=True)
                            for a in batch)
                yield out, side.record_event()

    for out, ready in stream_prefetch(staged(), depth=size):
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(ready)
        for t in out:
            t.record_stream(consumer)
        yield out
