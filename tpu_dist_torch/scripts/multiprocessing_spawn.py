"""Variant 3 of the cookbook (``scripts/3.multiprocessing_spawn.py``): the
script forks its own worker pool (``mp.spawn``'s role), one process per
device, rendezvousing over loopback TCP on a store the parent binds and
holds (``parallel.launch.host_store``).

    TPU_DIST_NPROCS_SPAWN=2 python -m tpu_dist_torch.scripts.multiprocessing_spawn \\
        --device cpu --epochs 1

With ``TPU_DIST_NPROCS_SPAWN`` above 1 (and no ``TPU_DIST_PROCESS_ID`` in
the environment) it starts that many copies of itself with the
``TPU_DIST_COORDINATOR`` / ``TPU_DIST_NUM_PROCESSES`` /
``TPU_DIST_PROCESS_ID`` variables set, as the reference does, and waits
for them; otherwise it trains. ``--backend gloo`` puts CUDA tensors on
gloo (nccl is the default on CUDA).
"""

import os
import sys

from tpu_dist_torch.configs import TrainConfig
from tpu_dist_torch.parallel.launch import spawn
from tpu_dist_torch.scripts.cookbook import run

DEFAULTS = TrainConfig(arch="resnet18", epochs=2, batch_size=3200,
                       dataset="cifar10", variant="jit")
RDZV = "127.0.0.1:0"     # any free port, bound and held by the parent


def main(argv=None, coordinator: str = RDZV):
    argv = sys.argv[1:] if argv is None else list(argv)
    nprocs = int(os.environ.get("TPU_DIST_NPROCS_SPAWN", "0") or 0)
    if nprocs > 1 and "TPU_DIST_PROCESS_ID" not in os.environ:
        spawn("tpu_dist_torch.scripts.multiprocessing_spawn", nprocs, argv,
              coordinator)
        return None
    return run(DEFAULTS, __doc__, argv, backend=True,
               banner=lambda info, cfg: (
                   f"[proc {info.process_id}/{info.num_processes}] "
                   f"rendezvous={info.method}"))


if __name__ == "__main__":
    main()
