"""Attention kernels' backward (``csrc/flash_bwd_dq.cu``,
``csrc/flash_bwd_dkv.cu``): the least time causal attention's backward
needs at the cell's shapes (``work.attention_bwd_work``) over the device
time of everything its autograd nodes launched (the ``bench.attn_bwd``
ranges), in %."""

from benchmark import work


def read(run):
    t, a = run.trace, run.counters.get("attention")
    steps = run.counters.get("traced_steps")
    name = run.counters.get("device_name", "")
    if t is None or not a or "H100" not in name:
        return None
    spent = t.span_device_s("bench.attn_bwd")
    if not spent:
        return None
    flops, nbytes = work.attention_bwd_work(a["batch"], a["heads"], a["seq"],
                                            a["head_dim"])
    least = work.bound_s(flops, nbytes, name) * a["layers"] * steps
    return 100.0 * least / spent
