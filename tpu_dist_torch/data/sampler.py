"""Per-process shard sampling for the port: a numpy copy of
``tpu_dist/data/sampler.py`` (``DistributedSampler``), so row order matches
the reference step for step -- the ``seed * 1_000_003 + epoch``
permutation, wrap-around padding to whole global batches, and
``indices_with_valid`` marking the padding.

The reference's notes (reference component C5):

Reproduces ``torch.utils.data.DistributedSampler`` semantics TPU-first
(reference 2.distributed.py:138,155 and set_epoch at :167-168):

* deterministic shuffle per epoch — torch reseeds a generator with
  ``seed + epoch``; here the epoch is folded into the sampler seed the same
  way (``set_epoch`` ≡ new permutation key), SURVEY.md §7 'Per-epoch
  reshuffling';
* the index list is padded by wrap-around so every replica sees the same
  number of samples — torch pads to ``ceil(N / world) * world``; we
  additionally pad to a multiple of ``world * batch`` so every *batch* has a
  static shape (XLA requires static shapes for a single compiled step);
* per-rank assignment: with ``batch_size`` set, each *global batch* is a
  contiguous window of the permutation and rank r takes rows
  ``[r*B:(r+1)*B]`` of it, so the global device array assembled across
  processes is ordering-identical to the single-process batch — an N-process
  run reproduces the 1-process trajectory exactly (positional randomness like
  dropout included; verified by tests/test_multiprocess.py). This is a
  deliberate delta from torch's strided ``indices[rank::world]``, which
  permutes samples within the global batch per world size; the strided
  flavor is kept for the batch-unaware mode (``batch_size=None``).
"""

from __future__ import annotations

import math
from typing import Iterator, Optional

import numpy as np


class DistributedSampler:
    """Index sampler for one process's shard of a dataset."""

    def __init__(self, dataset_len: int, num_replicas: int, rank: int,
                 shuffle: bool = True, seed: int = 0,
                 batch_size: Optional[int] = None, drop_last: bool = False):
        if rank >= num_replicas or rank < 0:
            raise ValueError(f"invalid rank {rank} for world size {num_replicas}")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.batch_size = batch_size  # per-replica batch; None = no batch padding
        self.drop_last = drop_last
        chunk = num_replicas * (batch_size or 1)
        if drop_last:
            self.total_size = (dataset_len // chunk) * chunk
            if self.total_size == 0:
                raise ValueError("dataset smaller than one global batch with drop_last")
        else:
            self.total_size = max(1, math.ceil(dataset_len / chunk)) * chunk
        self.num_samples = self.total_size // num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Reference 2.distributed.py:167-168 — reshuffle shard assignment."""
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        return self.indices_with_valid()[0]

    def indices_with_valid(self) -> tuple[np.ndarray, np.ndarray]:
        """(indices, valid) for this rank; valid=False marks wrap-around
        padding entries. Exact metrics divide by sum(valid), not len(indices)
        — the reference counted padding duplicates in eval (its val set is
        padded by DistributedSampler too), which tpu_dist fixes."""
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 1_000_003 + self.epoch)
            idx = rng.permutation(self.dataset_len)
        else:
            idx = np.arange(self.dataset_len)
        valid = np.ones(len(idx), bool)
        if self.drop_last:
            idx = idx[: self.total_size]
            valid = valid[: self.total_size]
        else:
            pad = self.total_size - len(idx)
            if pad > 0:
                # wrap-around padding, as torch DistributedSampler does
                reps = int(np.ceil(pad / len(idx)))
                idx = np.concatenate([idx] + [idx] * reps)[: self.total_size]
                valid = np.concatenate(
                    [valid, np.zeros(self.total_size - len(valid), bool)])
        if self.batch_size:
            # batch-blocked: global batch b = idx[b*W*B:(b+1)*W*B]; rank r
            # holds its contiguous sub-block, so cross-process assembly
            # reconstructs the exact single-process ordering (see module doc)
            def take(a: np.ndarray) -> np.ndarray:
                blocks = a.reshape(-1, self.num_replicas, self.batch_size)
                return blocks[:, self.rank, :].reshape(-1)
            return take(idx), take(valid)
        return (idx[self.rank :: self.num_replicas],
                valid[self.rank :: self.num_replicas])

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices())

    def __len__(self) -> int:
        return self.num_samples
