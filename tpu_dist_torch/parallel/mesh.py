"""The process group as a mesh, for the port (``tpu_dist/parallel/mesh.py``).

The reference's mesh is a grid of devices that one program spans. The
port runs one process per device instead, so a JAX mesh of shape
``(N, M)`` over ``("data", "model")`` is N x M processes of a
``torch.distributed`` group with one device each, and the mesh here
describes that group: this process's rank and coordinates, the device it
drives (``cuda:(local_rank % device_count)``), and one process group per
axis.

Ranks take their mesh coordinates in the reference's row-major order
(``np.asarray(devices).reshape(shape)``, ``:63``): the last axis varies
fastest. A ``-1`` in the shape is inferred from the world size
(``:55-58``). The axes are ``data``, ``model``, ``seq``, ``expert``,
``stage`` (pipeline parallelism, ``parallel.pp``) and ``sp`` (the
serving engine's sharded page pool, ``engine.serve``).

:func:`make_mesh` makes the groups of every axis: for each axis of size
above 1, one ``dist.new_group`` per slice of ranks that differ only along
it. Every rank makes every group, in the same order (a rank that skipped
one would hang the others in ``new_group``); an axis that spans the whole
world uses the world group. :meth:`Mesh.group` and :meth:`Mesh.axis` give
this rank's group of an axis; an axis of size 1 has none, and collectives
over it are no-ops. The mesh records which group serves which axis names
(:func:`axis_names_of`): the program audit (``analysis.proglint``) names
each collective's axis by it, as a JAX collective carries its axis name.
The world group, where no one axis spans it, serves every axis of the
mesh at once (a mean over all of them, as ``psum`` over a tuple of axes).

:func:`shard_leaf` and :func:`gather_leaf` cut a full tensor to this
rank's shard under a spec (a tuple with one axis name or None per dim,
the reference's ``PartitionSpec``) and put the shards back together. A
dim sharded with ``fused > 1`` (the fused ``[q | k | v]`` projection)
takes its rank's slice of each of the ``fused`` equal segments instead of
one contiguous slice, so each rank holds whole heads of q, k and v.
"""

from __future__ import annotations

import os
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from tpu_dist_torch.device import resolve_device

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"    # pipeline parallel
EXPERT_AXIS = "expert"  # MoE expert parallel
SP_AXIS = "sp"          # serving sequence parallel

PORTED_AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, EXPERT_AXIS, STAGE_AXIS,
               SP_AXIS)


# group -> the axis names it serves (see axis_names_of); weak, so a
# destroyed group is not kept alive until the interpreter's exit (gloo
# can abort tearing a group down that late)
_AXIS_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def register_axis_group(group, *names: str) -> None:
    """Record that process group ``group`` serves the mesh axes ``names``
    (added to any it already serves). The mesh registers its own groups;
    code that makes a group of its own registers it too."""
    if group is None:
        return
    _AXIS_GROUPS[group] = tuple(dict.fromkeys(
        (axis_names_of(group) or ()) + names))


def axis_names_of(group) -> Optional[Tuple[str, ...]]:
    """The axis names ``group`` was registered with, or None."""
    return None if group is None else _AXIS_GROUPS.get(group)


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
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index
    along it, and the process group of the ranks that share every other
    coordinate (None when the size is 1)."""
    name: str
    size: int = 1
    index: int = 0
    group: Optional[Any] = None


@dataclass(frozen=True)
class Mesh:
    """The mesh over the process group: ``shape`` maps each axis to its
    size, ``rank`` and ``size`` are this process's rank and the world
    size, ``axes`` this rank's :class:`Axis` of each axis."""
    shape: dict
    rank: int
    size: int
    device: torch.device
    axes: Dict[str, Axis] = field(default_factory=dict)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def axis(self, name: str) -> Axis:
        """This rank's view of axis ``name`` (size 1 if the mesh lacks
        it)."""
        return self.axes.get(name) or Axis(name)

    def group(self, name: str = DATA_AXIS):
        """The process group of axis ``name`` (default: data), None when
        the axis has one process."""
        return self.axis(name).group

    def coord(self, name: str) -> int:
        return self.axis(name).index


def axis_mesh(mesh: Mesh, name: str, as_name: str) -> Mesh:
    """The one-axis mesh of ``mesh``'s axis ``name`` as this rank sees it
    (its size, index and group; no new group), named ``as_name``: script
    8 serves on the ranks of its ``seq`` axis as an ``sp`` mesh."""
    ax = mesh.axis(name)
    register_axis_group(ax.group, as_name)
    return Mesh({as_name: ax.size}, mesh.rank, mesh.size, mesh.device,
                {as_name: Axis(as_name, ax.size, ax.index, ax.group)})


def _coords(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    """Row-major coordinates of ``rank`` in a grid of ``sizes``."""
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _rank_of(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def make_mesh(shape: Optional[Sequence[int]] = None,
              axes: Sequence[str] = (DATA_AXIS,), device=None) -> Mesh:
    """The mesh over every process of the group (default: the whole world
    on the data axis); ``device`` as in :func:`rank_device`. Every rank
    must call it, with the same arguments (module docstring)."""
    axes = tuple(axes)
    for a in axes:
        if a not in PORTED_AXES:
            raise ValueError(f"unknown mesh axis {a!r} "
                             f"({'|'.join(PORTED_AXES)})")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes} repeat a name")
    rank, world, _, _ = world_info()
    shape = [world] if shape is None else list(shape)
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} rank != axes {axes}")
    if -1 in shape:
        known = 1
        for s in shape:
            known *= s if s != -1 else 1
        shape[shape.index(-1)] = world // max(known, 1)
    total = 1
    for s in shape:
        total *= s
    if total != world:
        raise ValueError(
            f"mesh shape {tuple(shape)} != {world} process(es): the port runs "
            "one process per device, so a mesh of N devices needs N processes "
            "(launch them with tpu_dist_torch.scripts.distributed or "
            "multiprocessing_spawn)")
    dist = _dist()
    mine = _coords(rank, shape)
    views = {}
    for i, name in enumerate(axes):
        group = None
        if shape[i] > 1 and dist is not None:
            if shape[i] == world:
                group = dist.group.WORLD
            else:
                # every slice along this axis, in one order on every rank
                others = [s for j, s in enumerate(shape) if j != i]
                for fixed in range(world // shape[i]):
                    rest = list(_coords(fixed, others))
                    ranks = [_rank_of(rest[:i] + [c] + rest[i:], shape)
                             for c in range(shape[i])]
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        group = g
        views[name] = Axis(name, shape[i], mine[i], group)
        register_axis_group(group, name)
    if dist is not None and world > 1 and world not in shape:
        register_axis_group(dist.group.WORLD,
                            *(a for a, s in zip(axes, shape) if s > 1))
    return Mesh(dict(zip(axes, shape)), rank, world, rank_device(device),
                views)


# ---- shards of one leaf ---------------------------------------------------

Spec = Tuple[Optional[str], ...]


def _slice_dim(t: torch.Tensor, dim: int, index: int, size: int,
               fused: int) -> torch.Tensor:
    seg = t.shape[dim] // fused
    if seg % size:
        raise ValueError(f"dim {dim} of shape {tuple(t.shape)} (in {fused} "
                         f"segment(s)) does not divide by {size}")
    n = seg // size
    parts = [t.narrow(dim, s * seg + index * n, n) for s in range(fused)]
    return parts[0] if fused == 1 else torch.cat(parts, dim)


def shard_leaf(full: torch.Tensor, spec: Spec, mesh: Mesh,
               fused: int = 1) -> torch.Tensor:
    """This rank's shard of ``full`` under ``spec`` (a contiguous copy;
    ``full`` itself when the spec shards nothing)."""
    out = full
    for dim, name in enumerate(spec):
        ax = mesh.axis(name) if name else None
        if ax is not None and ax.size > 1:
            out = _slice_dim(out, dim, ax.index, ax.size,
                             fused if name == MODEL_AXIS else 1)
    return out if out is full else out.contiguous()


def _gather_dim(t: torch.Tensor, dim: int, ax: Axis, fused: int):
    from tpu_dist_torch.parallel.collectives import all_gather

    parts = all_gather(t, ax.group).unbind(0)      # one per rank
    if fused == 1:
        return torch.cat(parts, dim)
    seg = t.shape[dim] // fused
    return torch.cat([p.narrow(dim, s * seg, seg) for s in range(fused)
                      for p in parts], dim)


def gather_leaf(local: torch.Tensor, spec: Spec, mesh: Mesh,
                fused: int = 1) -> torch.Tensor:
    """The full tensor from every rank's shard under ``spec``: one
    all-gather per sharded axis, the inverse of :func:`shard_leaf`. Every
    rank of each axis group must call it."""
    out = local
    for dim, name in enumerate(spec):
        ax = mesh.axis(name) if name else None
        if ax is not None and ax.size > 1:
            out = _gather_dim(out, dim, ax,
                              fused if name == MODEL_AXIS else 1)
    return out
