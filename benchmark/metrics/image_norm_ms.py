"""Image model's norms and elementwise work (``models/resnet.py``): device
ms a traced step in kernels that are neither convolutions, products nor
the fused SGD (``tools/profile_image.py``'s BatchNorm and elementwise,
copies and casts, and rest buckets)."""

# kernel-name fragments of the convolutions, products and the optimizer,
# as tools/profile_image.py buckets them
NOT_NORM = ("sgd_kernel", "conv", "cudnn", "xmma", "implicit_gemm", "dgrad",
            "wgrad", "fprop", "cutlass", "nvjet", "gemm", "sm90_", "sm80_",
            "cublas", "nccl")


def read(run):
    t, steps = run.trace, run.counters.get("traced_steps")
    if t is None or not steps or not t.device_ops:
        return None
    rest = sum(s for name, s in t.device_s_by_name().items()
               if not any(k in name.lower() for k in NOT_NORM))
    return 1e3 * rest / steps
