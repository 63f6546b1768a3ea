"""Variant 2 of the cookbook (``scripts/2.distributed.py``): launcher-driven
multi-process data parallelism, one process per GPU.

    TPU_DIST_COORDINATOR=host:port TPU_DIST_NUM_PROCESSES=N \\
    TPU_DIST_PROCESS_ID=i python -m tpu_dist_torch.scripts.distributed

(or under Slurm). Each process joins the group over ``tcp://`` and trains
``batch_size / N`` rows a step; the ``jit`` variant averages the
gradients over the group after the backward.
"""

from tpu_dist_torch.configs import TrainConfig
from tpu_dist_torch.scripts.cookbook import run

DEFAULTS = TrainConfig(arch="resnet18", epochs=2, batch_size=3200,
                       dataset="cifar10", variant="jit")


def main(argv=None):
    return run(DEFAULTS, __doc__, argv, banner=lambda info, cfg: (
        f"[proc {info.process_id}/{info.num_processes}] "
        f"rendezvous={info.method}"))


if __name__ == "__main__":
    main()
