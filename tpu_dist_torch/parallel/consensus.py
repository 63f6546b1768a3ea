"""Supervisor consensus for the port (``tpu_dist/parallel/consensus.py``):
cross-host agreement on the live host set.

The port's own copy of the reference module (stdlib only): the same member
and epoch files, the same survivors-first dense renumbering and the same
``host_return`` fault site, so supervisors of either package agree on one
consensus directory.

The consensus-less ``degraded_env`` shrink has a KNOWN LIMIT: each
host's supervisor sees only its own environment, so a MID-numbered host
loss leaves an id hole the survivors cannot close — the shrunken
rendezvous needs dense ``TPU_DIST_PROCESS_ID``s and nobody can renumber,
so those runs end in ``restarts_exhausted``. This module closes that
limit with a small file-based consensus protocol (the shared-FS
substrate every checkpoint dir already assumes; the reference's variant
6 keyed its file:// rendezvous off the same assumption):

* each host's supervisor **registers** a member file
  (``host-<id>.json``) and refreshes its heartbeat timestamp while its
  child runs; a member whose heartbeat ages past ``lease_s`` — or whose
  file was removed by an explicit :meth:`~ConsensusDir.leave` — is dead;
* :meth:`~ConsensusDir.resolve` derives the agreed :class:`MeshView` from
  the membership: live hosts ordered **survivors-first** (the prior
  epoch's order filtered to the living, returners appended in id order —
  so process 0 is always a survivor holding the freshest state, the
  anchor both checkpoint resume and the peer-broadcast recovery pull
  from), process ids renumbered **densely** over that order, and a
  **rendezvous epoch** bumped on every membership change;
* the epoch record (``epoch.json``) is written atomically; because the
  successor view is a pure function of (previous view, live set), racing
  writers with the same inputs write identical bytes — the race is
  benign, and the next resolve converges any transient disagreement.

Everything here is stdlib-only (the supervisor never touches the device);
the ``host_return`` fault site (:mod:`tpu_dist_torch.obs.faults`)
re-registers lost planned hosts on
demand so the whole shrink -> re-expand cycle is provable on one CPU box.
"""

from __future__ import annotations

import glob
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from tpu_dist_torch.obs import faults as _faults

_MEMBER_PREFIX = "host-"
_EPOCH_FILE = "epoch.json"


@dataclass(frozen=True)
class MeshView:
    """One agreed mesh layout: the consensus output of a resolve round."""

    epoch: int            # rendezvous epoch; bumped on membership change
    hosts: Tuple[int, ...]  # original host ids, survivors-first order
    planned: int          # the job's full world size

    @property
    def world_size(self) -> int:
        return len(self.hosts)

    @property
    def degraded(self) -> bool:
        return len(self.hosts) < self.planned

    def process_id(self, host_id: int) -> int:
        """The DENSE process id of ``host_id`` under this view — closing
        the id hole a mid-numbered loss leaves in the original numbering."""
        try:
            return self.hosts.index(host_id)
        except ValueError:
            raise KeyError(
                f"host {host_id} is not in the live set {list(self.hosts)} "
                f"(epoch {self.epoch})") from None


def successor_hosts(prev_hosts: List[int], live: List[int]) -> List[int]:
    """The next view's host order: survivors keep their relative order
    (so their dense ids only ever shift DOWN and process 0 stays a
    survivor), returners/joiners append in id order. Pure — the lint gate
    and racing epoch writers both rely on this being a function."""
    live_set = set(live)
    out = [h for h in prev_hosts if h in live_set]
    out += sorted(h for h in live_set if h not in set(prev_hosts))
    return out


class ConsensusDir:
    """One host's handle on the shared consensus directory.

    ``now`` is injectable (tests drive lease expiry with a virtual
    clock); everything else is stdlib file I/O.
    """

    def __init__(self, path: str, host_id: int, planned: int,
                 lease_s: float = 10.0,
                 now: Callable[[], float] = time.time):
        if planned < 1:
            raise ValueError("planned world size must be >= 1")
        self.path = path
        self.host_id = int(host_id)
        self.planned = int(planned)
        self.lease_s = float(lease_s)
        self._now = now
        # destination for host_return `fault` events (the supervisor
        # attaches its scale ledger; bare/unit use records to stderr only)
        self.fault_ledger = None
        os.makedirs(path, exist_ok=True)

    # -- membership -----------------------------------------------------
    def member_path(self, host_id: Optional[int] = None) -> str:
        h = self.host_id if host_id is None else host_id
        return os.path.join(self.path, f"{_MEMBER_PREFIX}{int(h)}.json")

    def register(self, host_id: Optional[int] = None) -> None:
        """Write/refresh a member heartbeat (atomic tmp+rename, unique tmp
        per writer so concurrent heartbeats never tear each other)."""
        h = self.host_id if host_id is None else int(host_id)
        rec = {"host": h, "ts": self._now()}
        tmp = self.member_path(h) + f".tmp.{self.host_id}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.member_path(h))

    def leave(self, host_id: Optional[int] = None) -> None:
        """Deregister (clean shutdown: peers see the loss immediately
        instead of waiting out the lease)."""
        try:
            os.remove(self.member_path(host_id))
        except OSError:
            pass

    def alive(self) -> List[int]:
        """Live member ids: registered and heartbeat within the lease."""
        now = self._now()
        out = []
        for p in glob.glob(os.path.join(self.path, f"{_MEMBER_PREFIX}*.json")):
            try:
                with open(p) as f:
                    rec = json.load(f)
                host, ts = int(rec["host"]), float(rec["ts"])
            except (OSError, ValueError, KeyError, TypeError):
                continue  # torn write mid-crash: treat as absent this round
            if now - ts <= self.lease_s:
                out.append(host)
        return sorted(set(out))

    # -- the consensus round --------------------------------------------
    def _read_epoch(self) -> Optional[Dict]:
        try:
            with open(os.path.join(self.path, _EPOCH_FILE)) as f:
                rec = json.load(f)
            return {"epoch": int(rec["epoch"]),
                    "hosts": [int(h) for h in rec["hosts"]]}
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _write_epoch(self, epoch: int, hosts: List[int]) -> None:
        tmp = os.path.join(self.path, f"{_EPOCH_FILE}.tmp.{self.host_id}")
        with open(tmp, "w") as f:
            json.dump({"epoch": epoch, "hosts": hosts, "ts": self._now()}, f)
        os.replace(tmp, os.path.join(self.path, _EPOCH_FILE))

    def resolve(self, heartbeat: bool = True) -> MeshView:
        """One consensus round: heartbeat, observe the live set, and agree
        on (epoch, dense host order). Membership change -> epoch bump,
        written atomically; unchanged membership returns the recorded view
        verbatim (every host converges on the same bytes)."""
        if heartbeat:
            self.register()
        fault = _faults.fire("host_return", ledger=self.fault_ledger)
        if fault is not None:
            # deterministic re-expansion on demand: resurrect the lost
            # planned host(s) — `host=N` names one, default all missing
            live_now = set(self.alive())
            want = int(fault.args["host"]) if "host" in fault.args else None
            for h in range(self.planned):
                if h not in live_now and (want is None or h == want):
                    self.register(h)
        live = self.alive()
        if self.host_id not in live:
            live = sorted(set(live) | {self.host_id})
        prev = self._read_epoch()
        prev_hosts = prev["hosts"] if prev else []
        if prev is not None and set(prev_hosts) == set(live):
            return MeshView(prev["epoch"], tuple(prev_hosts), self.planned)
        hosts = (successor_hosts(prev_hosts, live) if prev is not None
                 else sorted(live))
        epoch = prev["epoch"] + 1 if prev is not None else 0
        self._write_epoch(epoch, hosts)
        return MeshView(epoch, tuple(hosts), self.planned)

    def wait_for_peers(self, timeout_s: float = 30.0,
                       sleep: Callable[[float], None] = time.sleep,
                       poll_s: float = 0.2) -> MeshView:
        """Block (bounded) until the planned world has registered — the
        startup join barrier, so the first epoch is the full mesh rather
        than a racey one-host view per supervisor start order."""
        deadline = self._now() + timeout_s
        self.register()
        while self._now() < deadline:
            if len(self.alive()) >= self.planned:
                break
            sleep(poll_s)
        return self.resolve()


def consensus_env(env: Dict[str, str], view: MeshView,
                  host_id: int) -> Dict[str, str]:
    """The relaunch environment under an agreed view: dense process id,
    agreed world size, the rendezvous epoch (parallel.launch offsets the
    coordinator port by it so a re-formed mesh never reconnects to the
    previous epoch's half-dead coordination service), and the degraded
    marker only while the mesh is actually short of plan. Pure."""
    out = dict(env)
    out["TPU_DIST_NUM_PROCESSES"] = str(view.world_size)
    out["TPU_DIST_PROCESS_ID"] = str(view.process_id(host_id))
    out["TPU_DIST_MESH_EPOCH"] = str(view.epoch)
    if view.degraded:
        out["TPU_DIST_DEGRADED"] = "1"
    else:
        out.pop("TPU_DIST_DEGRADED", None)
    return out
