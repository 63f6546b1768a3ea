"""Train an image classifier through the port's ``Trainer`` (the port of
``scripts/7.jax_tpu.py``, the flagship: ResNet-50 on CIFAR-10 with bf16
compute over fp32 master weights, 16 steps per window, the dataset resident
on the device)::

    python -m tpu_dist_torch.scripts.image_train --epochs 1 \\
        --stem s2d --norm-dtype bf16 --optimizer fused_sgd

Every ``TrainConfig`` field is a ``--flag`` with the reference script's
defaults (:data:`DEFAULTS`); ``--device`` picks the device (default
``cuda``; ``cpu`` runs the plain versions). Without ``cifar-10-batches-py``
under ``--data`` the dataset is the reference's deterministic synthetic
CIFAR-10. Under ``TPU_DIST_*`` or Slurm rendezvous variables the process
joins its group first (``parallel.launch.initialize``), as the cookbook
scripts do. ``--max-restarts N`` (N > 0) runs the trainer under the
in-process supervisor (``parallel.supervisor.run_supervised``, the
reference's ``:42-50``): a ``HealthError`` halt or a crash rebuilds the
``Trainer`` from the newest valid checkpoint with the next attempt's
ledger; process-killing faults need ``python -m tpu_dist_torch.supervise``.
"""

from __future__ import annotations

import argparse
import dataclasses

from tpu_dist_torch.configs import TrainConfig, add_args

DEFAULTS = TrainConfig(arch="resnet50", epochs=10, batch_size=1024,
                       dataset="cifar10", variant="jit", precision="bf16",
                       steps_per_dispatch=16, log_csv="jax_tpu.csv")

# the repo's headline image geometry (bench.py's ResNet-50/CIFAR-10 cell:
# bf16 convs over fp32 masters, bf16 norm outputs, space-to-depth stem,
# batch 1024, make_optimizer(0.1, 0.9, 1e-4) through the fused kernel, 16
# steps a window over the device-resident set), cut in length only: one
# epoch of 32 steps
BENCH_GEOMETRY = dict(arch="resnet50", dataset="cifar10", batch_size=1024,
                      precision="bf16", norm_dtype="bf16", stem="s2d",
                      optimizer="fused_sgd", lr=0.1, momentum=0.9,
                      weight_decay=1e-4, steps_per_dispatch=16,
                      data_placement="auto", synth_train_size=32768,
                      synth_val_size=10000, epochs=1, seed=0)


def main(argv=None):
    """Parse ``argv``, train, print ``best_acc1``; returns the Trainer."""
    from tpu_dist_torch.engine.loop import Trainer
    from tpu_dist_torch.parallel import launch

    ap = argparse.ArgumentParser(description=__doc__)
    add_args(ap, DEFAULTS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    cfg = TrainConfig(**{f.name: getattr(args, f.name)
                         for f in dataclasses.fields(TrainConfig)})
    info = launch.initialize(device=args.device)
    built = []

    def build(run_cfg):
        built[:] = []          # the dead attempt's trainer goes first
        built.append(Trainer(run_cfg, device=args.device))
        tr = built[0]
        print(f"[proc {info.process_id}/{info.num_processes}] via "
              f"{info.method} device={tr.device} "
              f"data={'device' if tr.device_data else 'host'} "
              f"dataset={tr.train_ds.name} steps/epoch="
              f"{tr.steps_per_epoch}", flush=True)
        return tr

    if cfg.max_restarts > 0:
        from tpu_dist_torch.parallel.supervisor import run_supervised

        best = run_supervised(build, cfg)
    else:
        best = build(cfg).fit()
    print(f"best_acc1 {best * 100:.3f}", flush=True)
    return built[0]


if __name__ == "__main__":
    main()
