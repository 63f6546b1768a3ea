"""LM ops outside the kernels (``ops/*``, ``models/transformer.py``):
device ms a traced step in kernels that are not cuBLAS products, the flash
attention kernels or the fused AdamW (``tools/profile_lm.py``'s "rest"
bucket: elementwise, reductions, copies, the embedding and the loss)."""

# kernel-name fragments of what is not "rest", as tools/profile_lm.py
# buckets them
NOT_EAGER = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
             "adamw_kernel", "nvjet", "gemm", "xmma", "cutlass", "sm90_",
             "cublas")


def read(run):
    t, steps = run.trace, run.counters.get("traced_steps")
    if t is None or not steps or not t.device_ops:
        return None
    rest = sum(s for name, s in t.device_s_by_name().items()
               if not any(k in name for k in NOT_EAGER))
    return 1e3 * rest / steps
