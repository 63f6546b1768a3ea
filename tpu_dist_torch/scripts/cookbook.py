"""What the port's cookbook scripts (``dataparallel``, ``distributed``,
``multiprocessing_spawn``, ``bf16_distributed``, ``allreduce_distributed``,
``mnist``) share: every ``TrainConfig`` field as a ``--flag`` with the
script's defaults, ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions), the rendezvous (``parallel.launch.initialize``), the fit and
the ``best_acc1`` line. The port runs one process per device, so a data
axis of N is N processes, launched by a launcher (``TPU_DIST_*`` or Slurm
variables) or by ``multiprocessing_spawn``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional

from tpu_dist_torch.configs import TrainConfig, add_args


def run(defaults: TrainConfig, doc: str, argv=None, *,
        launch_group: bool = True, backend: bool = False,
        banner: Optional[Callable] = None):
    """Parse ``argv``, join the process group (``launch_group``), train,
    print ``best_acc1``; returns the Trainer. ``banner(info, cfg)`` is the
    script's first line."""
    from tpu_dist_torch.engine.loop import Trainer
    from tpu_dist_torch.parallel import launch

    ap = argparse.ArgumentParser(description=doc)
    add_args(ap, defaults)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    if backend:
        ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="torch.distributed backend (default: nccl on "
                             "CUDA, gloo on the CPU)")
    args = ap.parse_args(argv)
    cfg = TrainConfig(**{f.name: getattr(args, f.name)
                         for f in dataclasses.fields(TrainConfig)})
    if launch_group:
        info = launch.initialize(backend=getattr(args, "backend", None),
                                 device=args.device)
        if banner is not None:
            launch.say(banner(info, cfg))
    trainer = Trainer(cfg, device=args.device)
    best = trainer.fit()
    launch.say(f"best_acc1 {best * 100:.3f}")
    if launch_group:
        launch.shutdown()
    return trainer
