"""Variant 1 of the cookbook (``scripts/1.dataparallel.py``): one process,
no launcher, no rendezvous.

    python -m tpu_dist_torch.scripts.dataparallel --epochs 1

The reference drives every local chip from this one process. The port runs
one process per device, so this variant trains on one device; a mesh wider
than 1 raises (use ``distributed`` or ``multiprocessing_spawn``, one
process per GPU).
"""

from tpu_dist_torch.configs import TrainConfig
from tpu_dist_torch.scripts.cookbook import run

DEFAULTS = TrainConfig(arch="resnet101", epochs=5, batch_size=3200,
                       dataset="cifar10", variant="jit",
                       log_csv="dataparallel.csv")


def main(argv=None):
    return run(DEFAULTS, __doc__, argv, launch_group=False)


if __name__ == "__main__":
    main()
