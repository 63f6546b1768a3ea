"""Variant 5.2 of the cookbook (``scripts/5.2.mnist.py``): the MNIST LeNet
with the all-reduce optimizer: batch 64, lr 0.01 scaled by the world
size, bf16-compressed gradient sums, ``--adasum`` and
``--gradient-predivide-factor`` available.

    python -m tpu_dist_torch.scripts.mnist --epochs 1

Every process shards one dataset by its rank (no per-rank dataset dirs).
"""

from tpu_dist_torch.configs import TrainConfig
from tpu_dist_torch.scripts.cookbook import run

DEFAULTS = TrainConfig(arch="lenet", epochs=10, batch_size=64, lr=0.01,
                       momentum=0.5, weight_decay=0.0, dataset="mnist",
                       variant="shard_map", grad_compression="bf16",
                       lr_scale_by_world=True)


def main(argv=None):
    return run(DEFAULTS, __doc__, argv)


if __name__ == "__main__":
    main()
