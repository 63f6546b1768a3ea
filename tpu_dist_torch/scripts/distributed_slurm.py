"""Variant 6 of the cookbook (``scripts/6.distributed_slurm.py``): Slurm
multi-node training on ImageNet, one process per GPU.

    srun -N<nodes> --ntasks-per-node=<gpus> \\
        python -m tpu_dist_torch.scripts.distributed_slurm --data /imagenet

Each process reads its rank from ``SLURM_PROCID`` and the world from
``SLURM_NPROCS``, and rendezvouses on the first host of
``SLURM_JOB_NODELIST`` (``parallel.launch``; the ``TPU_DIST_*`` variables
override). The dataset is ``imagenet``: ``<data>/{train,val}/<class>/``
through ``data.imagefolder`` (JPEGs on the native libjpeg decoder), or,
without those folders, the reference's synthetic 224 x 224 x 3, 1000-class
set. Checkpoints are rank 0's and the evaluation is sharded, the two fixes
the reference made to the cookbook's script.
"""

from tpu_dist_torch.configs import TrainConfig
from tpu_dist_torch.scripts.cookbook import run

DEFAULTS = TrainConfig(arch="resnet50", epochs=90, batch_size=3200,
                       dataset="imagenet", variant="jit",
                       log_csv="distributed.csv")


def main(argv=None):
    return run(DEFAULTS, __doc__, argv, banner=lambda info, cfg: (
        f"[proc {info.process_id}/{info.num_processes}] via {info.method}"))


if __name__ == "__main__":
    main()
