"""LM train loop (``engine/lm_loop.py``): the host's dispatch time a step,
the trainer's own ``dispatch_s`` of each window step, median, in ms."""

import statistics


def read(run):
    d = run.counters.get("dispatch_s")
    return 1e3 * statistics.median(d) if d else None
