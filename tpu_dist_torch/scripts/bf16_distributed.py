"""Variant 4 of the cookbook (``scripts/4.bf16_distributed.py``): mixed
precision over the multi-process group, bf16 compute over fp32 master
weights with no loss scaling (``--loss-scale`` turns dynamic scaling on).

    python -m tpu_dist_torch.scripts.bf16_distributed --epochs 1
"""

from tpu_dist_torch.configs import TrainConfig
from tpu_dist_torch.scripts.cookbook import run

DEFAULTS = TrainConfig(arch="resnet18", epochs=10, batch_size=3200,
                       dataset="cifar10", variant="jit", precision="bf16")


def main(argv=None):
    return run(DEFAULTS, __doc__, argv, banner=lambda info, cfg: (
        f"[proc {info.process_id}/{info.num_processes}] "
        f"precision={cfg.precision}"))


if __name__ == "__main__":
    main()
