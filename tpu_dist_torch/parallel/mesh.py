"""The process group as a mesh, for the port (``tpu_dist/parallel/mesh.py``).

The reference's mesh is a grid of devices that one program spans. The
port runs one process per device instead, so a JAX ``data=N`` mesh is N
processes of a ``torch.distributed`` group with one device each, and the
mesh here describes that group: this process's rank, the world size, and
the device this rank drives (``cuda:(local_rank % device_count)``).

Only the ``data`` axis is ported. Its size must be the world size (``-1``
is inferred from it, as a reshape would); every other axis raises
``NotImplementedError`` naming itself. The axis names are copied from the
reference, which declares every axis the framework can carry.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch

from tpu_dist_torch.device import resolve_device

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"    # pipeline parallel
EXPERT_AXIS = "expert"  # MoE expert parallel
SP_AXIS = "sp"          # serving sequence parallel


def _dist():
    """``torch.distributed`` when a process group is up, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world_info() -> Tuple[int, int, int, int]:
    """(process_index, process_count, local_devices, global_devices): one
    device per process, so the last is the world size."""
    dist = _dist()
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist else (0, 1)
    return rank, world, 1, world


def local_rank(global_rank: Optional[int] = None) -> int:
    """This process's index on its host: ``LOCAL_RANK`` or
    ``SLURM_LOCALID`` where a launcher set one, else the global rank (one
    host)."""
    env = os.environ.get("LOCAL_RANK") or os.environ.get("SLURM_LOCALID")
    if env is not None:
        return int(env)
    return world_info()[0] if global_rank is None else global_rank


def rank_device(device=None, global_rank: Optional[int] = None
                ) -> torch.device:
    """The device this rank drives: ``device`` as given, except that a
    bare ``"cuda"`` (the default) means ``cuda:(local_rank %
    device_count)``, made current."""
    dev = resolve_device(device)
    if dev.type == "cuda" and (device is None or torch.device(device).index
                               is None):
        dev = torch.device("cuda", local_rank(global_rank)
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


@dataclass(frozen=True)
class Mesh:
    """The data axis over the process group: ``group`` is None when no
    process group is up (one process, no collectives)."""
    shape: dict
    rank: int
    size: int
    device: torch.device
    group: Optional[Any] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(shape: Optional[Sequence[int]] = None,
              axes: Sequence[str] = (DATA_AXIS,), device=None) -> Mesh:
    """The data mesh over every process of the group (default: the whole
    world on the data axis); ``device`` as in :func:`rank_device`."""
    axes = tuple(axes)
    other = [a for a in axes if a != DATA_AXIS]
    if other:
        raise NotImplementedError(
            f"mesh axis {other[0]!r} is not ported yet: the port's mesh has "
            "the data axis only (the model-parallel axes are ROADMAP Queue 1 "
            "item 3)")
    rank, world, _, _ = world_info()
    shape = [world] if shape is None else list(shape)
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} rank != axes {axes}")
    if shape[0] == -1:
        shape[0] = world
    if shape[0] != world:
        raise ValueError(
            f"mesh shape {tuple(shape)} != {world} process(es): the port runs "
            "one process per device, so a data axis of N needs N processes "
            "(launch them with tpu_dist_torch.scripts.distributed or "
            "multiprocessing_spawn)")
    dist = _dist()
    return Mesh({DATA_AXIS: world}, rank, world, rank_device(device),
                dist.group.WORLD if dist else None)
