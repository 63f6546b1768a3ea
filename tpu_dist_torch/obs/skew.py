"""Cross-rank step-time skew for the port (``tpu_dist/obs/skew.py``).

Logs are rank 0's, so a slow rank (a throttled card, a contended loader, a
neighbour on the host) shows only as everyone's step time creeping up. Every
``every`` optimizer steps each rank puts its trailing means ``[step_s,
data_s]`` into one 2-float tensor on its own device and all ranks all-gather
it (``parallel.collectives.all_gather`` over the world; gloo takes CUDA
tensors there too). Each rank then emits the same ``skew`` event: p50/p99 of
the ranks' step times, their spread (max - min), the straggler's rank and its
step and data seconds. One rank is a row of one: spread 0, straggler 0.

The exchange is a collective, so every rank must call :meth:`SkewMonitor.
record` on the same records, including ranks that write no ledger file. The
trainers call it for each step record of a drain, which every rank reaches
at the same steps. The cadence counts accumulated optimizer steps
(``n_steps`` of a K-step window), not ``step % every``, so windows whose
strides never land on a multiple of ``every`` still exchange.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tpu_dist_torch.obs.ledger import Ledger


class SkewMonitor:
    """Windowed cross-rank step-time sampler over the whole world (a
    single process needs no group) with the tensors on ``device``.
    :meth:`record` returns the stats on exchange records, None
    otherwise."""

    def __init__(self, every: int, ledger: Optional[Ledger] = None,
                 device="cpu"):
        if every < 1:
            raise ValueError("skew_every must be >= 1")
        self.every = every
        self.ledger = ledger
        self.device = device
        self._step_s = []
        self._data_s = []
        self._accum = 0
        self.last_stats: Optional[dict] = None

    def record(self, step: int, step_s: float, data_s: float = 0.0,
               n_steps: int = 1) -> Optional[dict]:
        self._step_s.append(float(step_s))
        self._data_s.append(float(data_s))
        self._accum += n_steps
        if self._accum < self.every:
            return None
        self._accum = 0
        local = np.array([np.mean(self._step_s), np.mean(self._data_s)],
                         np.float32)
        self._step_s.clear()
        self._data_s.clear()
        return self._exchange(step, local)

    def _gather(self, local: np.ndarray) -> np.ndarray:
        """(n_ranks, 2): row i is rank i's [step_s, data_s] means."""
        import torch

        from tpu_dist_torch.parallel.collectives import all_gather

        t = torch.from_numpy(local).to(self.device)
        return all_gather(t).cpu().numpy()

    def _exchange(self, step: int, local: np.ndarray) -> dict:
        rows = self._gather(local)
        step_times = rows[:, 0]
        worst = int(np.argmax(step_times))
        stats = {
            "step": step,
            "p50_s": float(np.percentile(step_times, 50)),
            "p99_s": float(np.percentile(step_times, 99)),
            "spread_s": float(step_times.max() - step_times.min()),
            "straggler": worst,
            "straggler_step_s": float(step_times.max()),
            "straggler_data_s": float(rows[worst, 1]),
            "n_procs": int(rows.shape[0]),
        }
        self.last_stats = stats
        if self.ledger is not None:
            self.ledger.emit("skew", **stats)
        return stats
