"""LM train step (``engine/lm_steps.py``, ``models/transformer.py``): the
window's model FLOPs (6 x non-embedding params + 6 x layers x L x d a
token, no recomputation) over the window's time and the card's bf16 peak,
in %."""

from benchmark import work


def read(run):
    rate = run.metrics.get("train_tokens_per_s")
    flops = run.counters.get("flops_per_token")
    name = run.counters.get("device_name", "")
    if not rate or not flops or "H100" not in name:
        return None
    return 100.0 * rate * flops / work.peak(name, "bf16")
