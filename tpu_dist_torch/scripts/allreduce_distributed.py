"""Variant 5 of the cookbook (``scripts/5.allreduce_distributed.py``):
explicit all-reduce data parallelism (Horovod's): the ``shard_map``
variant syncs the gradients with an explicit sum over the group, bf16
compressed by default (``hvd.Compression.fp16``), with
``--gradient-predivide-factor``, ``--adasum`` and ``--grad-bucket-mb``.

    python -m tpu_dist_torch.scripts.allreduce_distributed --epochs 1

Every rank starts from the same seed, so no parameter broadcast is needed.
"""

from tpu_dist_torch.configs import TrainConfig
from tpu_dist_torch.scripts.cookbook import run

DEFAULTS = TrainConfig(arch="resnet18", epochs=10, batch_size=3200,
                       dataset="cifar10", variant="shard_map",
                       grad_compression="bf16")


def main(argv=None):
    return run(DEFAULTS, __doc__, argv, banner=lambda info, cfg: (
        f"[proc {info.process_id}/{info.num_processes}] "
        f"compression={cfg.grad_compression}"))


if __name__ == "__main__":
    main()
