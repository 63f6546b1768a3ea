"""Progress meters for the port: a copy of ``tpu_dist/utils/meters.py:34
MeterBank``, which renders the cookbook's progress line (``Name last
(avg)`` cells after an ``[i/N]`` header) from exact per-window sums.
"""

from __future__ import annotations


class MeterBank:
    """Named running sums for one epoch of host-side telemetry (C17).

    ``fields`` is an ordered ``(name, format_spec)`` sequence — the spec is a
    plain Python format spec (e.g. ``".4e"``, ``"6.3f"``) applied to both the
    last value and the running average in the progress line. Device metrics
    are fed in at print-frequency boundaries as exact per-window sums; host
    timings are fed every iteration, so every average is
    total/size-weighted — there is no meter whose mean depends on how often
    the loop prints.
    """

    def __init__(self, total_batches: int, fields, prefix: str = ""):
        self.total_batches = total_batches
        self.prefix = prefix
        self._fields = list(fields)
        # per name: [weighted sum, total weight, last value]
        self._stats = {name: [0.0, 0, 0.0] for name, _ in self._fields}

    def update(self, name: str, value, n: int = 1) -> None:
        s = self._stats[name]
        v = float(value)
        s[0] += v * n
        s[1] += n
        s[2] = v

    def avg(self, name: str) -> float:
        s = self._stats[name]
        return s[0] / max(s[1], 1)

    def last(self, name: str) -> float:
        return self._stats[name][2]

    def snapshot(self) -> dict:
        """One read of every field: {name: {"last": x, "avg": y}}.

        THE shared view the loops feed both the progress printer and the
        run ledger from (``line()`` renders from this same dict), so the
        printed numbers and the recorded numbers can never drift — and
        callers stop reaching into the private ``_stats``.
        """
        return {name: {"last": self.last(name), "avg": self.avg(name)}
                for name, _ in self._fields}

    def line(self, batch: int, snapshot: dict = None) -> str:
        snap = snapshot if snapshot is not None else self.snapshot()
        w = len(str(self.total_batches))
        cells = [f"{self.prefix}[{batch:{w}d}/{self.total_batches}]"]
        cells += [f"{name} {snap[name]['last']:{spec}} "
                  f"({snap[name]['avg']:{spec}})"
                  for name, spec in self._fields]
        return "\t".join(cells)

    def display(self, batch: int, printer=print) -> None:
        printer(self.line(batch))
