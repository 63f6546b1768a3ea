"""Process launch and rendezvous for the port (``tpu_dist/parallel/launch.py``).

The rendezvous address is discovered as the reference does it, in
priority order:

1. explicit arguments, then the ``TPU_DIST_COORDINATOR`` /
   ``TPU_DIST_NUM_PROCESSES`` / ``TPU_DIST_PROCESS_ID`` environment (the
   ``env://`` flavour; ``TPU_DIST_MESH_EPOCH`` offsets the port);
2. Slurm (``SLURM_PROCID`` / ``SLURM_NPROCS`` / ``SLURM_JOB_NODELIST``),
   the coordinator on the first host of the node list;
3. TPU pod metadata, which has no counterpart here: that method raises;
4. nothing set: one local process, no process group.

:func:`initialize` then calls ``torch.distributed.init_process_group`` on
``tcp://<coordinator>`` (or, where the launcher holds the store,
:func:`host_store`, as a client of it) inside
:func:`rendezvous_with_retry` (the same
``TPU_DIST_RENDEZVOUS_*`` knobs and backoff). ``backend=None`` picks
``nccl`` for a CUDA device and ``gloo`` for the CPU; a caller that wants
gloo with CUDA tensors names it. A failed init raises: no code switches
backend. The ``rendezvous_fail`` fault site (``obs.faults``, the
reference's ``:142``) fails the first ``times=K`` tries with
``ConnectionError``, so the retry path runs without a flaky coordinator.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

BACKENDS = ("nccl", "gloo")


@dataclass
class LaunchInfo:
    coordinator: Optional[str]
    num_processes: int
    process_id: int
    method: str  # env | slurm | tpu-metadata | local


def _slurm_first_host(nodelist: str) -> str:
    """Expand 'prefix[a-b,c],other' to its first hostname (no external tools)."""
    m = re.match(r"([^\[,]+)(\[([^\]]+)\])?", nodelist)
    if not m:
        return nodelist.split(",")[0]
    prefix, _, body = m.groups()
    if not body:
        return prefix
    first = body.split(",")[0].split("-")[0]
    return prefix + first


def epoch_coordinator(coordinator: str, epoch: int) -> str:
    """Offset the coordinator port by the mesh epoch
    (``TPU_DIST_MESH_EPOCH``), so a re-formed group rendezvouses on a fresh
    port. Pure; unparseable inputs pass through."""
    if not coordinator or epoch <= 0 or ":" not in coordinator:
        return coordinator
    host, _, port = coordinator.rpartition(":")
    try:
        return f"{host}:{int(port) + epoch}"
    except ValueError:
        return coordinator


def _mesh_epoch(env) -> int:
    try:
        return int(env.get("TPU_DIST_MESH_EPOCH", "0") or 0)
    except ValueError:
        return 0


def detect_launch(coordinator: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None,
                  port: int = 8476) -> LaunchInfo:
    env = os.environ
    if coordinator or env.get("TPU_DIST_COORDINATOR"):
        return LaunchInfo(
            epoch_coordinator(coordinator or env["TPU_DIST_COORDINATOR"],
                              _mesh_epoch(env)),
            int(num_processes if num_processes is not None
                else env.get("TPU_DIST_NUM_PROCESSES", "1")),
            int(process_id if process_id is not None
                else env.get("TPU_DIST_PROCESS_ID", "0")),
            "env")
    if "SLURM_PROCID" in env and env.get("SLURM_NPROCS", "1") != "1":
        # the TPU_DIST_* overrides win over the static Slurm env, as a
        # relaunch after a shrink exports them
        host = _slurm_first_host(env.get("SLURM_JOB_NODELIST", "localhost"))
        return LaunchInfo(
            epoch_coordinator(f"{host}:{port}", _mesh_epoch(env)),
            int(num_processes if num_processes is not None
                else env.get("TPU_DIST_NUM_PROCESSES")
                or env["SLURM_NPROCS"]),
            int(process_id if process_id is not None
                else env.get("TPU_DIST_PROCESS_ID") or env["SLURM_PROCID"]),
            "slurm")
    workers = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    if len(workers) > 1 or env.get("MEGASCALE_COORDINATOR_ADDRESS"):
        return LaunchInfo(None, -1, -1, "tpu-metadata")
    return LaunchInfo(None, 1, 0, "local")


def rendezvous_with_retry(init_fn: Callable[[], None], info: LaunchInfo,
                          retries: Optional[int] = None,
                          timeout_s: Optional[float] = None,
                          backoff_s: Optional[float] = None,
                          sleep: Callable[[float], None] = time.sleep) -> int:
    """Bounded retry with exponential backoff around one rendezvous call:
    up to ``TPU_DIST_RENDEZVOUS_RETRIES`` attempts (default 5), waits of
    ``TPU_DIST_RENDEZVOUS_BACKOFF_S`` (default 2 s) doubling up to 30 s,
    under a ``TPU_DIST_RENDEZVOUS_TIMEOUT_S`` total deadline (default
    300 s). Returns the attempts used; on exhaustion raises one error
    naming the coordinator, the method and the attempt count. The
    ``rendezvous_fail`` fault site fails a try with ``ConnectionError``
    before ``init_fn`` runs (``times=K``: the first K tries)."""
    from tpu_dist_torch.obs import faults
    env = os.environ
    retries = int(env.get("TPU_DIST_RENDEZVOUS_RETRIES", "5")
                  if retries is None else retries)
    timeout_s = float(env.get("TPU_DIST_RENDEZVOUS_TIMEOUT_S", "300")
                      if timeout_s is None else timeout_s)
    backoff_s = float(env.get("TPU_DIST_RENDEZVOUS_BACKOFF_S", "2")
                      if backoff_s is None else backoff_s)
    t0 = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(1, max(retries, 1) + 1):
        try:
            if faults.fire("rendezvous_fail", attempt_no=attempt):
                raise ConnectionError("injected rendezvous failure")
            init_fn()
            return attempt
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # store and socket failures arrive as assorted types
            last = e
            elapsed = time.monotonic() - t0
            wait = min(backoff_s * (2 ** (attempt - 1)), 30.0)
            if attempt >= retries or elapsed + wait >= timeout_s:
                break
            print(f"rendezvous attempt {attempt}/{retries} with "
                  f"{info.coordinator} failed ({e}); retrying in "
                  f"{wait:.1f}s", file=sys.stderr, flush=True)
            sleep(wait)
    raise RuntimeError(
        f"rendezvous failed: could not reach coordinator "
        f"{info.coordinator!r} ({info.method} method, process "
        f"{info.process_id}/{info.num_processes}) after {attempt} "
        f"attempt(s) over {time.monotonic() - t0:.1f}s "
        f"(TPU_DIST_RENDEZVOUS_RETRIES={retries}, "
        f"TPU_DIST_RENDEZVOUS_TIMEOUT_S={timeout_s:g}). "
        f"Last error: {last}") from last


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device=None) -> LaunchInfo:
    """Join the process group (idempotent): the ``init_process_group``
    of the reference's variants. ``device`` (default ``"cuda"``) is the
    device this rank will drive; it picks the backend when ``backend`` is
    None and becomes the current CUDA device before the group forms."""
    import torch.distributed as dist

    from tpu_dist_torch.parallel.mesh import rank_device

    info = detect_launch(coordinator, num_processes, process_id)
    if info.method == "tpu-metadata":
        raise NotImplementedError(
            "rendezvous method 'tpu-metadata' (TPU pod metadata) has no "
            "counterpart in the port: set TPU_DIST_COORDINATOR, "
            "TPU_DIST_NUM_PROCESSES and TPU_DIST_PROCESS_ID, or run "
            "under Slurm")
    if info.method == "local" or dist.is_initialized():
        return info
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} ({'|'.join(BACKENDS)})")
    dev = rank_device(device, info.process_id)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")

    def join():
        if os.environ.get("TPU_DIST_STORE_HELD") == "1":
            # the launcher holds the store (host_store): join as a client
            host, _, port = info.coordinator.rpartition(":")
            store = dist.TCPStore(host, int(port), info.num_processes,
                                  is_master=False)
            dist.init_process_group(backend, store=store,
                                    world_size=info.num_processes,
                                    rank=info.process_id)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://{info.coordinator}",
                world_size=info.num_processes, rank=info.process_id)

    rendezvous_with_retry(join, info)
    return info


def shutdown() -> None:
    """Leave the process group, if one was joined: a barrier, so that no
    rank leaves while another still talks to it, then
    ``destroy_process_group``. A process that exits with its group alive
    can abort in gloo's threads at teardown (``terminate called without
    an active exception``) after its work is done."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def say(line: str) -> None:
    """Print ``line`` with one write: ranks that share a pipe (an
    unbuffered stdout writes ``print``'s text and its newline apart)
    never split each other's lines."""
    sys.stdout.write(f"{line}\n")
    sys.stdout.flush()


def host_store(coordinator: str, world: int):
    """Bind the rendezvous store at ``coordinator`` (``host:port``; port 0
    takes any free port) in this process and hold it for as long as the
    returned store lives: returns ``(store, "host:port")``. Ranks started
    with ``TPU_DIST_STORE_HELD=1`` and that address join it as clients, so
    no other process can take the port between its choice and the ranks'
    arrival (a port picked, released and bound later by rank 0 can be)."""
    import torch.distributed as dist

    host, _, port = coordinator.rpartition(":")
    store = dist.TCPStore(host, int(port), world, is_master=True,
                          wait_for_workers=False)
    return store, f"{host}:{store.port}"


def spawn(module: str, nprocs: int, argv, coordinator: str) -> None:
    """``mp.spawn``'s role: start ``nprocs`` copies of ``python -m
    module argv`` on this host with the rendezvous variables set
    (``TPU_DIST_COORDINATOR`` / ``TPU_DIST_NUM_PROCESSES`` /
    ``TPU_DIST_PROCESS_ID``) and wait for all; a failed worker raises
    ``SystemExit`` with every exit code. This process binds the store at
    ``coordinator`` first (port 0: any free port) and holds it until the
    workers are done (:func:`host_store`)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    store, coordinator = host_store(coordinator, nprocs)
    procs = []
    for rank in range(nprocs):
        env = dict(os.environ, TPU_DIST_COORDINATOR=coordinator,
                   TPU_DIST_NUM_PROCESSES=str(nprocs),
                   TPU_DIST_PROCESS_ID=str(rank), TPU_DIST_STORE_HELD="1",
                   PYTHONPATH=root + (os.pathsep + path if path else ""))
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv],
                                      env=env))
    rc = [p.wait() for p in procs]
    del store
    if any(rc):
        raise SystemExit(f"worker exit codes {rc}")
