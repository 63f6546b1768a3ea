"""Elastic run supervisor for the port (``tpu_dist/parallel/supervisor.py``):
close the detect->remediate loop.

The port's own copy of the reference module (stdlib only; the supervising
process launches its children with ``subprocess.Popen`` and never makes a
CUDA context, so the card's memory belongs to the child, and a killed
child's memory is free before the next attempt starts: ``proc.wait()``
comes before the relaunch). It keeps the reference's failure classes,
``PREEMPT_SNAPSHOT_RC``, flags, attempt ledgers and ``<stem>.sup.jsonl``
``scale`` events, so ``tools/ledger_report.py`` reads a port job as it
reads a reference one. What differs: :func:`latest_checkpoint` reads the
port's containers (the ``*-checkpoint.index.json`` pointer, then the
newest ``*-checkpoint.pt``), and ``Supervisor(retune=...)`` runs the
port's plan tuner (``plan.tune``, which touches no device) and requires
``device_kind`` in its config (the reference defaults it to a TPU's name;
the supervisor never opens the card to read one).

Rounds 2-7 built the *detect* half of self-healing — watchdog stalls,
``health record|skip|halt``, auto-triggered flight recorder, restart-aware
``job_id``/``attempt`` lineage with ``restart_gap`` goodput — but nothing
ever acted: a hang, a ``HealthError`` halt, a preemption or a crashed host
simply ended the run, and recovery was a human re-running the script. The
reference's variant 6 (``6.distributed_slurm_main.py``) leaned on Slurm
``--requeue`` for exactly this; the torch ecosystem answer is
torchelastic's supervised restarts. This module is the TPU-native version,
in two flavors:

* **Subprocess CLI** — ``python -m tpu_dist_torch.supervise --ledger
  run.jsonl --ckpt-dir ck -- python -m tpu_dist_torch.scripts.lm_longcontext
  ...``:
  :class:`Supervisor` launches the training command, watches liveness
  through the attempt ledger's tail and a heartbeat file, classifies every
  exit (:func:`classify_attempt`), and restarts under a bounded policy —
  ``attempt=-1`` auto-lineage so the attempt stitching and goodput see
  every attempt, ``--resume`` pointed at the newest VALID checkpoint
  (:func:`latest_checkpoint` — the pointer only ever names a committed
  container), exponential backoff, crash-loop cutoff when K consecutive
  attempts die before their first ``step`` event, and on confirmed
  rendezvous/host loss a degraded dp-only relaunch on the survivors
  (:func:`degraded_env`). A watchdog-confirmed stall (the child's own
  ``stall`` ledger event with no progress after it) is SIGKILLed and
  restarted — the one failure class where waiting is the wrong move.

* **Library API** — :func:`run_supervised` wraps a trainer factory in the
  same policy loop *in process* (both engine scripts opt in via the
  ``max_restarts`` config knob): ``HealthError`` halts and organic
  exceptions restart from the newest valid checkpoint with fresh attempt
  lineage. Process-killing failures (``os._exit``, SIGKILL, host loss)
  need the subprocess flavor by construction.

Round 13 makes the capacity ELASTIC, not just shrinking: with a
``consensus`` directory configured (:mod:`tpu_dist_torch.parallel.consensus`,
file-based and stdlib-only like everything here), per-host supervisors agree
on the live host set every rendezvous epoch — a mid-numbered host loss
renumbers ``TPU_DIST_PROCESS_ID`` densely over the survivors instead of
dying in ``restarts_exhausted`` (the old ``degraded_env`` KNOWN LIMIT),
and a lost host re-registering bumps the epoch and relaunches the
children at the restored world size (shrink is two-way). A preemption
SIGTERM is forwarded into the child with a deadline
(``TPU_DIST_PREEMPT_DEADLINE_S``): the engine finishes the in-flight
step, writes a coordinated snapshot and exits
``preemption_snapshotted`` (rc ``PREEMPT_SNAPSHOT_RC``), so the restart
resumes from the pre-preemption step, not the last periodic checkpoint.
Every transition lands as a ``scale`` ledger event in the supervisor's
own ``<stem>.sup.jsonl`` sibling, which ``tools/ledger_report`` stitches
into the elasticity timeline.

Everything here is stdlib-only; the training child owns all device
state. Deterministic fault injection for every path lives in
:mod:`tpu_dist_torch.obs.faults`.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tpu_dist_torch.obs.goodput import attempt_path, next_attempt_index
from tpu_dist_torch.parallel.consensus import (ConsensusDir, MeshView,
                                               consensus_env)

# every attempt ends in exactly one of these
FAILURE_CLASSES = ("clean", "health_halt", "stall", "preemption",
                   "preemption_snapshotted", "rendezvous", "crash")

# the exit code of a preemption honored WITH a coordinated snapshot
# (EX_TEMPFAIL: "try again later" — the engines exit with it after the
# barriered checkpoint lands, so the restart resumes the exact step)
PREEMPT_SNAPSHOT_RC = 75

# ledger events that prove the run is making forward progress (the stall
# event itself grows the ledger too — it must NOT reset the liveness clock)
_PROGRESS_EVENTS = frozenset({
    "run_start", "compile", "step", "epoch", "eval", "ckpt", "decode"})


class CrashLoopError(RuntimeError):
    """K consecutive attempts died before their first step — restarting
    again would burn the allocation on the same deterministic failure."""


@dataclass
class RestartPolicy:
    """Bounded-restart knobs (pure data)."""

    max_restarts: int = 10          # restarts, not attempts (N+1 attempts)
    backoff_base_s: float = 1.0     # base * 2^(restart-1), capped below
    backoff_max_s: float = 60.0
    crash_loop_k: int = 3           # consecutive pre-first-step deaths
    # idle backstop, deliberately generous: the FIRST liveness signal is
    # the post-compile heartbeat, so this must exceed any first XLA
    # compile (large LM programs take many minutes) — SIGKILLing a
    # healthy compile would read as a pre-first-step death and trip the
    # crash-loop cutoff. Real hangs are caught much faster by the
    # child's own watchdog 'stall' event + stall_grace_s below.
    stall_timeout_s: float = 1800.0  # ledger/heartbeat silence -> SIGKILL
    stall_grace_s: float = 10.0     # after a watchdog 'stall' event lands
    shrink_on_host_loss: bool = True
    # deterministic per-host backoff spread (fraction of the base wait):
    # without it, N hosts restarting after one shared failure all sleep
    # the SAME exponential schedule and stampede the rendezvous
    # coordinator in lockstep on every retry
    backoff_jitter: float = 0.5
    # seconds the child gets between SIGTERM and SIGKILL to finish its
    # in-flight step and write the coordinated preemption snapshot
    preempt_deadline_s: float = 30.0


def _jitter_u(host_id: int, restart_no: int) -> float:
    """Deterministic uniform-ish [0, 1) from (host, restart): a tiny
    integer hash, NOT random — the same host always picks the same
    offset (reproducible runs), different hosts decorrelate, and the
    restart ordinal keeps repeat collisions from re-aligning."""
    x = (host_id * 2654435761 + restart_no * 40503 + 0x9E3779B9) \
        & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 2246822519) & 0xFFFFFFFF
    x ^= x >> 13
    return x / 2.0 ** 32


def compute_backoff(restart_no: int, policy: RestartPolicy,
                    host_id: Optional[int] = None) -> float:
    """Seconds to wait before restart #``restart_no`` (1-based):
    exponential from ``backoff_base_s``, capped at ``backoff_max_s``.
    With a ``host_id``, a deterministic per-host jitter stretches the
    wait by up to ``backoff_jitter`` x itself, de-synchronizing the
    cross-host restart stampede; without one (report-side/unit callers)
    the schedule is the bare exponential."""
    if restart_no <= 0:
        return 0.0
    wait = min(policy.backoff_base_s * (2.0 ** (restart_no - 1)),
               policy.backoff_max_s)
    if host_id is not None and policy.backoff_jitter > 0:
        wait *= 1.0 + policy.backoff_jitter * _jitter_u(host_id, restart_no)
    return wait


def classify_attempt(records: List[dict], returncode: Optional[int] = None,
                     killed_for_stall: bool = False,
                     stderr_tail: str = "") -> str:
    """One attempt's failure class, from its ledger records + exit status.

    Pure and stdlib-only: the supervisor calls it with the child's returncode
    and captured stderr tail; ``tools/ledger_report`` calls it with
    records alone (``returncode=None``) to classify attempts after the
    fact. Precedence: a supervisor-confirmed stall kill beats everything
    (the rc is just our own SIGKILL); then the run's own account
    (``run_end`` status/error), then the exit code, then stderr."""
    if killed_for_stall:
        return "stall"
    ends = [r for r in records if r.get("event") == "run_end"]
    end = ends[-1] if ends else None
    status = (end or {}).get("status")
    err = str((end or {}).get("error") or "")
    if returncode == 0 or (returncode is None and end is not None
                           and status in (None, "ok")):
        return "clean"
    if status == "preempted" or returncode == PREEMPT_SNAPSHOT_RC:
        # the preemption was HONORED: the engine finished its in-flight
        # step and committed the coordinated snapshot before exiting, so
        # the restart resumes the exact pre-preemption step
        return "preemption_snapshotted"
    if "HealthError" in err or "health=halt" in err:
        return "health_halt"
    if ("SIGTERM" in err or status == "interrupted"
            or returncode in (-signal.SIGTERM, 128 + signal.SIGTERM)):
        return "preemption"
    blob = (err + "\n" + stderr_tail).lower()
    # only a launch-phase death (no run_end: the child never got far
    # enough to account for itself) may be blamed on rendezvous, and only
    # on the EXHAUSTION message — the retry wrapper's per-attempt
    # "rendezvous attempt k/N ... retrying" warnings linger in the stderr
    # tail of runs that rendezvoused fine and died later of other causes
    if end is None and ("rendezvous failed" in blob
                        or "could not reach coordinator" in blob
                        or "deadline_exceeded" in blob):
        return "rendezvous"
    if end is None and any(r.get("event") == "stall" for r in records):
        # the child died mid-stall without our kill (OOM-killer, operator)
        return "stall"
    return "crash"


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest VALID checkpoint in a dir, without torch or
    deserialization: the ``*-checkpoint.index.json`` pointer when present
    (engine.checkpoint writes it only after a fully-committed container,
    so an ENOSPC'd or torn write never advances it), else the newest
    ``*-checkpoint.pt`` by mtime (the port's container; the reference's
    ``.msgpack`` is a warm-start donor, not a resume source)."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    # newest pointer first, not alphabetical: a dir that ever held another
    # arch's checkpoints must not resume this run from the wrong model
    idx_files = sorted(glob.glob(
        os.path.join(ckpt_dir, "*-checkpoint.index.json")),
        key=os.path.getmtime, reverse=True)
    for idx in idx_files:
        try:
            with open(idx) as f:
                pointer = json.load(f)
            path = os.path.join(ckpt_dir, pointer["newest"])
        except (OSError, ValueError, KeyError, TypeError):
            continue
        if os.path.exists(path):
            return path
    cands = glob.glob(os.path.join(ckpt_dir, "*-checkpoint.pt"))
    return max(cands, key=os.path.getmtime) if cands else None


def degraded_env(env: Dict[str, str],
                 lost: int = 1) -> Tuple[Dict[str, str], int]:
    """The relaunch environment after confirmed host loss: the mesh
    re-forms on the survivors (``TPU_DIST_NUM_PROCESSES`` shrunk by
    ``lost``) and ``TPU_DIST_DEGRADED=1`` marks the run so reports can
    tell a degraded layout from the planned one. Returns (env, survivors).
    Pure — unit-testable without processes.

    NOTE: ``TPU_DIST_PROCESS_ID`` is NOT renumbered here — this is the
    consensus-LESS fallback (no shared dir configured), where each host's
    supervisor only sees its own env. It re-forms cleanly when the LOST
    host held the highest id (ids stay dense) and for the 1-survivor
    case. Closing a MID-numbered id hole needs the cross-host agreement
    of :mod:`tpu_dist_torch.parallel.consensus` (round 13): with a
    ``--consensus-dir``, :func:`consensus_env` renumbers densely over the
    agreed survivor order and this function never runs."""
    n = int(env.get("TPU_DIST_NUM_PROCESSES", "1") or 1)
    survivors = max(n - max(lost, 0), 1)
    out = dict(env)
    if survivors < n:
        out["TPU_DIST_NUM_PROCESSES"] = str(survivors)
        out["TPU_DIST_DEGRADED"] = "1"
    return out, survivors


# the dp-only degraded layout: mesh shape reset to auto (all remaining
# devices) over the plain data axis — appended on relaunch after shrink
DEGRADED_FLAGS = ("--mesh-shape", "", "--mesh-axes", "data")


@dataclass
class AttemptResult:
    attempt: int
    returncode: Optional[int]
    failure_class: str
    steps: int
    seconds: float
    ledger: str = ""


@dataclass
class SupervisorResult:
    status: str  # clean | crash_loop | restarts_exhausted | stopped
    attempts: List[AttemptResult] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.status == "clean"


class _StderrTail(threading.Thread):
    """Forward the child's stderr to ours while keeping the last N lines
    (classification evidence for deaths that never reached the ledger)."""

    def __init__(self, pipe, maxlen: int = 50):
        super().__init__(name="supervise-stderr", daemon=True)
        self._pipe = pipe
        self.lines: deque = deque(maxlen=maxlen)

    def run(self) -> None:
        try:
            for line in self._pipe:
                self.lines.append(line)
                sys.stderr.write(line)
        except ValueError:
            pass  # pipe closed under us at kill time
        finally:
            try:
                self._pipe.close()
            except OSError:
                pass

    def tail(self) -> str:
        return "".join(self.lines)


class _LedgerTail:
    """Incremental reader of an attempt ledger: which events arrived since
    the last poll (partial trailing lines are held back, not mangled)."""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0
        self._partial = b""

    def poll(self) -> List[str]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size <= self._offset:
            return []
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            chunk = f.read(size - self._offset)
        self._offset = size
        data = self._partial + chunk
        lines = data.split(b"\n")
        self._partial = lines.pop()  # "" on a complete trailing newline
        events = []
        for line in lines:
            try:
                rec = json.loads(line)
                ev = rec.get("event")
                if ev:
                    events.append(ev)
            except (ValueError, AttributeError):
                continue  # torn line mid-crash: liveness only, not truth
        return events


def _read_records(path: str) -> List[dict]:
    """Best-effort full read of an attempt ledger (schema-lenient: the
    crashed child is exactly the one with torn lines)."""
    from tpu_dist_torch.obs.ledger import read_ledger

    try:
        return read_ledger(path, validate=False, strict=False)
    except OSError:
        return []


class Supervisor:
    """Launch, watch, classify, restart — the policy loop around one
    training command. See the module docstring for the contract; every
    knob of :class:`RestartPolicy` applies."""

    def __init__(self, cmd: List[str], ledger: str, ckpt_dir: str = "",
                 policy: Optional[RestartPolicy] = None,
                 env: Optional[Dict[str, str]] = None,
                 forward_flags: bool = True, poll_s: float = 0.25,
                 sleep: Callable[[float], None] = time.sleep,
                 consensus: Optional[ConsensusDir] = None,
                 consensus_poll_s: float = 1.0,
                 on_attempt: Optional[Callable[["AttemptResult"],
                                               None]] = None,
                 retune: Optional[Dict] = None):
        if not cmd:
            raise ValueError("supervisor needs a training command "
                             "(everything after '--')")
        if not ledger:
            raise ValueError("supervisor needs --ledger: the attempt "
                             "ledgers are its liveness + lineage signal")
        self.cmd = list(cmd)
        self.ledger = ledger
        self.ckpt_dir = ckpt_dir
        self.policy = policy or RestartPolicy()
        self.env = dict(os.environ if env is None else env)
        self.forward_flags = forward_flags
        self.poll_s = poll_s
        self._sleep = sleep
        self.degraded = False
        # elastic consensus (round 13): cross-host membership + dense
        # renumbering; None keeps the single-host fallback paths
        self.consensus = consensus
        self.consensus_poll_s = consensus_poll_s
        try:
            self.host_id = (consensus.host_id if consensus is not None else
                            int(self.env.get("TPU_DIST_PROCESS_ID", "0")
                                or 0))
        except ValueError:
            self.host_id = 0
        self._view: Optional[MeshView] = None   # the view the child runs at
        self._scale_relaunch = False            # WE ended the attempt to
        self._peer_resume_next = False          # rescale, not a failure
        self._scale_ledger = None
        # scenario hooks (round 14, the reference's fleet simulator): the
        # simulator observes every classified attempt and can end the
        # policy loop externally
        self.on_attempt = on_attempt
        self._stop = threading.Event()
        # autoscaling (the reference's obs.autoscale): a retune config
        # re-runs the plan tuner at every world-size transition
        # (_maybe_retune); the device kind is the config's, since this
        # process never opens the card
        if retune and not retune.get("device_kind"):
            raise ValueError(
                "Supervisor(retune=...) needs retune['device_kind'] (the "
                "card's name, as nvidia-smi gives it): the supervisor plans "
                "for the children's device without opening it")
        self.retune = dict(retune) if retune else None
        self.autoscale_decision: Optional[str] = None

    def request_stop(self) -> None:
        """Ask the policy loop to end (thread-safe, callable from any
        thread): a running child is terminated gracefully — SIGTERM with
        the preemption deadline, so a snapshot-capable child drains and
        exits ``PREEMPT_SNAPSHOT_RC`` — and no further restarts happen
        (``SupervisorResult.status == "stopped"``). The fleet simulator's
        scenario-end teardown; also the backstop for a wedged run."""
        self._stop.set()

    def _log(self, msg: str) -> None:
        print(f"[supervise] {msg}", file=sys.stderr, flush=True)

    # -- scale events (the supervisor's own ledger sibling) --------------
    def _ensure_scale_ledger(self):
        """Lazily open ``<stem>.sup.jsonl`` — the supervisor's own ledger
        (obs.ledger is stdlib-only, so this stays device-free);
        ledger_report merges it into the job timeline."""
        if self._scale_ledger is None:
            from tpu_dist_torch.obs.goodput import sup_sibling_path
            from tpu_dist_torch.obs.ledger import Ledger

            try:
                self._scale_ledger = Ledger(sup_sibling_path(self.ledger))
            except OSError as e:
                self._log(f"warning: no scale ledger ({e})")
                self._scale_ledger = False
        return self._scale_ledger or None

    def _emit_scale(self, action: str, processes: int,
                    epoch: Optional[int], **extra) -> None:
        self._ensure_scale_ledger()
        if self._scale_ledger:
            try:
                self._scale_ledger.emit("scale", action=action,
                                        processes=processes, epoch=epoch,
                                        **extra)
            except Exception as e:
                self._log(f"warning: scale event dropped ({e})")

    def _resolve_view(self) -> Optional[MeshView]:
        """One consensus round + the env/flag fallout: dense renumbering,
        degraded marking, shrink/expand scale events, and the one-shot
        peer-resume marker for a re-expansion relaunch."""
        if self.consensus is None:
            return None
        if self.consensus.fault_ledger is None:
            # a host_return injection must leave its `fault` event on the
            # record (injected-vs-organic accounting) — route it into the
            # scale-event sibling
            self.consensus.fault_ledger = self._ensure_scale_ledger()
        view = self.consensus.resolve()
        prev = self._view
        self.env = consensus_env(self.env, view, self.host_id)
        self.degraded = view.degraded
        if prev is None or view.epoch != prev.epoch:
            whence = f"{prev.world_size}->" if prev is not None else ""
            self._log(f"consensus epoch {view.epoch}: "
                      f"{whence}{view.world_size}/{view.planned} host(s) "
                      f"{list(view.hosts)} (process "
                      f"{view.process_id(self.host_id)} here)"
                      + (" DEGRADED" if view.degraded else ""))
        # transitions key on WORLD-SIZE changes, not degraded-flag edges:
        # a second loss while already degraded (3->2) is still a shrink,
        # and one of two lost hosts returning (2->3, still short of plan)
        # is still an expansion that needs the peer-resume relaunch
        world_from = prev.world_size if prev is not None else view.planned
        if view.world_size < world_from:
            dec, self.autoscale_decision = self.autoscale_decision, None
            self._emit_scale("shrink", view.world_size, view.epoch,
                             hosts=list(view.hosts), world_from=world_from,
                             decision=dec)
            self._maybe_retune(view, "shrink", dec)
        elif view.world_size > world_from:
            dec, self.autoscale_decision = self.autoscale_decision, None
            self._emit_scale("expand", view.world_size, view.epoch,
                             hosts=list(view.hosts), world_from=world_from,
                             decision=dec)
            self._maybe_retune(view, "expand", dec)
            # the grown world: a returning host has no local checkpoint,
            # so dp-pure engines pull state from a survivor over the wire
            # (engine.checkpoint.peer_restore_state)
            self._peer_resume_next = True
        self._view = view
        return view

    def _maybe_retune(self, view: MeshView, action: str,
                      decision: Optional[str]) -> None:
        """The decision's follow-up (``:489-530``): re-run the
        deterministic plan tuner (``plan.tune``) at the new world size,
        write its plan file as ``plan_epoch<N>.json`` under ``plan_dir``
        and stamp the best plan's hash into an ``applied`` event beside
        the scale event. A re-run of the tuner at the same world size
        reproduces the hash."""
        if not self.retune:
            return
        kind = self.retune["device_kind"]
        devices = view.world_size * int(
            self.retune.get("devices_per_host", 1))
        plan_hash = None
        try:
            from tpu_dist_torch.plan.tune import tune
            text, results = tune(
                measurement_files=self.retune.get("measurement_files"),
                device_kinds=[kind],
                workload={**(self.retune.get("workload") or {}),
                          "devices": devices})
            best = (results.get(kind) or {}).get("best")
            plan_hash = best["hash"] if best else None
            plan_dir = self.retune.get("plan_dir")
            if plan_dir:
                os.makedirs(plan_dir, exist_ok=True)
                with open(os.path.join(
                        plan_dir, f"plan_epoch{view.epoch}.json"), "w") as f:
                    f.write(text)
        except Exception as e:
            self._log(f"warning: retune at world {view.world_size} "
                      f"failed ({e})")
        self._ensure_scale_ledger()
        if self._scale_ledger:
            try:
                self._scale_ledger.emit(
                    "applied", decision=decision, action=action,
                    processes=view.world_size, epoch=view.epoch,
                    plan_hash=plan_hash, devices=devices)
            except Exception as e:
                self._log(f"warning: applied event dropped ({e})")

    # -- one attempt ----------------------------------------------------
    def _child_argv(self, resume: Optional[str]) -> List[str]:
        argv = list(self.cmd)
        if self.forward_flags:
            # argparse last-wins: the lineage/resume flags override
            # whatever the base command carries
            argv += ["--ledger-path", self.ledger, "--attempt", "-1"]
            if self.ckpt_dir:
                argv += ["--checkpoint-dir", self.ckpt_dir]
            if resume:
                argv += ["--resume", resume]
            if self.degraded:
                argv += list(DEGRADED_FLAGS)
        return argv

    def _run_child(self, argv: List[str], env: Dict[str, str],
                   attempt_file: str,
                   hb_file: str) -> Tuple[Optional[int], bool, str]:
        """(returncode, killed_for_stall, stderr_tail) for one attempt."""
        pol = self.policy
        proc = subprocess.Popen(argv, env=env, stderr=subprocess.PIPE,
                                text=True, errors="replace")
        tail = _StderrTail(proc.stderr)
        tail.start()
        try:
            ledger_tail = _LedgerTail(attempt_file)
            last_progress = time.monotonic()
            stall_confirmed: Optional[float] = None
            killed_for_stall = False
            scale_term = False
            launch_view = self._view
            last_consensus = time.monotonic()
            hb_mtime = 0.0
            while proc.poll() is None:
                self._sleep(self.poll_s)
                now = time.monotonic()
                if self._stop.is_set():
                    # external teardown (request_stop): same graceful
                    # SIGTERM-with-deadline path as a rescale — a
                    # snapshot-capable child drains and accounts for
                    # itself before the SIGKILL backstop
                    self._log("stop requested — SIGTERM, graceful "
                              "deadline, then teardown")
                    scale_term = True
                    proc.terminate()
                    break
                if (self.consensus is not None
                        and now - last_consensus >= self.consensus_poll_s):
                    # heartbeat our membership + watch for an epoch bump
                    # while the child runs: a returning host (or a further
                    # loss) re-forms the mesh NOW, not at the next crash
                    last_consensus = now
                    view = self._resolve_view()
                    if (launch_view is not None and view is not None
                            and view.epoch != launch_view.epoch):
                        grow = view.world_size > launch_view.world_size
                        self._log(
                            f"mesh epoch {launch_view.epoch} -> "
                            f"{view.epoch} mid-attempt "
                            f"({'re-expansion' if grow else 'shrink'} to "
                            f"{view.world_size}) — SIGTERM for snapshot, "
                            "then relaunch at the new world size")
                        self._scale_relaunch = True
                        scale_term = True
                        proc.terminate()
                        break
                progressed = False
                for ev in ledger_tail.poll():
                    if ev in _PROGRESS_EVENTS:
                        progressed = True
                        stall_confirmed = None  # the run moved again
                    elif ev == "stall":
                        stall_confirmed = stall_confirmed or now
                try:
                    mt = os.path.getmtime(hb_file)
                    if mt > hb_mtime:
                        hb_mtime = mt
                        # a heartbeat only counts while no stall is
                        # confirmed: the watchdog thread's own dump must
                        # not keep a hung step loop alive forever
                        if stall_confirmed is None:
                            progressed = True
                except OSError:
                    pass
                if progressed:
                    last_progress = now
                    continue
                idle = now - last_progress
                if ((stall_confirmed is not None
                     and now - stall_confirmed >= pol.stall_grace_s)
                        or idle >= pol.stall_timeout_s):
                    why = ("watchdog-confirmed stall" if stall_confirmed
                           else "no ledger/heartbeat progress for "
                                f"{idle:.0f}s")
                    self._log(f"{why} — SIGKILLing pid {proc.pid} "
                              "for restart")
                    killed_for_stall = True
                    proc.kill()
                    break
            if scale_term:
                # graceful rescale: the child gets the preemption deadline
                # to finish its in-flight step and commit the coordinated
                # snapshot (it exits PREEMPT_SNAPSHOT_RC), then SIGKILL
                try:
                    rc = proc.wait(timeout=pol.preempt_deadline_s)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    rc = proc.wait()
            else:
                rc = proc.wait()
        finally:
            # the supervisor must NEVER orphan a live trainer: a dying
            # supervisor (SIGTERM'd by the scheduler — run() converts it
            # to SystemExit so this unwinds — or any internal error)
            # would otherwise leave the child racing its own requeue on
            # the same ledger + checkpoint dir. SIGTERM first (the child
            # snapshots within the forwarded preemption deadline, or at
            # minimum the crash guard gets its run_end), SIGKILL after.
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=max(5.0, pol.preempt_deadline_s))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        tail.join(timeout=5.0)
        return rc, killed_for_stall, tail.tail()

    # -- the policy loop ------------------------------------------------
    def run(self) -> SupervisorResult:
        # a SIGTERM'd supervisor (scheduler preemption signals THIS pid,
        # not the child) must unwind through _run_child's finally and take
        # the child down with it; default SIGTERM disposition would kill
        # the supervisor instantly and orphan a live trainer. Library
        # callers on non-main threads keep their own handling.
        prev_term = None
        try:
            prev_term = signal.signal(
                signal.SIGTERM,
                lambda signum, frame: sys.exit(128 + signum))
        except ValueError:
            pass  # not the main thread
        try:
            return self._run_policy_loop()
        finally:
            if self.consensus is not None:
                # explicit deregistration: peers see this host's loss NOW
                # (clean finish or our own preemption) instead of waiting
                # out the membership lease
                self.consensus.leave()
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)

    def _run_policy_loop(self) -> SupervisorResult:
        pol = self.policy
        attempts: List[AttemptResult] = []
        consecutive_dead = 0
        restarts = 0
        while True:
            if self._stop.is_set():
                # a stop that lands during backoff must not launch one
                # more child just to tear it down again
                return SupervisorResult("stopped", attempts)
            # two counters on purpose: the LEDGER ordinal only advances
            # when a child lived long enough to create its attempt file (a
            # pre-RunObs death must not burn a lineage slot), while the
            # supervisor's own attempt number always advances — it is what
            # TPU_DIST_ATTEMPT exports, so attempt-gated faults and
            # diagnostics see every launch, including the ledgerless ones
            attempt_no = len(attempts)
            ordinal = next_attempt_index(self.ledger)
            attempt_file = attempt_path(self.ledger, ordinal)
            # the consensus round: dense renumbering + degraded marking
            # land in self.env BEFORE the child env is derived from it
            self._resolve_view()
            resume = (latest_checkpoint(self.ckpt_dir)
                      if self.ckpt_dir else None)
            argv = self._child_argv(resume)
            env = dict(self.env)
            env["TPU_DIST_ATTEMPT"] = str(attempt_no)
            env["TPU_DIST_PREEMPT_DEADLINE_S"] = str(pol.preempt_deadline_s)
            if self._peer_resume_next:
                # one relaunch only: the re-expansion attempt pulls state
                # from a survivor over the wire where its local disk has
                # no (or a stale) checkpoint
                env["TPU_DIST_PEER_RESUME"] = "1"
                self._peer_resume_next = False
            else:
                env.pop("TPU_DIST_PEER_RESUME", None)
            hb_file = attempt_file + ".hb"
            env["TPU_DIST_HEARTBEAT_FILE"] = hb_file
            self._log(f"attempt {attempt_no}: {' '.join(argv)}"
                      + (f" (resume {resume})" if resume else ""))
            t0 = time.monotonic()
            rc, killed_for_stall, stderr_tail = self._run_child(
                argv, env, attempt_file, hb_file)
            records = _read_records(attempt_file)
            cls = classify_attempt(records, rc, killed_for_stall,
                                   stderr_tail)
            steps = sum(1 for r in records if r.get("event") == "step")
            result = AttemptResult(attempt_no, rc, cls, steps,
                                   round(time.monotonic() - t0, 3),
                                   ledger=attempt_file)
            attempts.append(result)
            self._log(f"attempt {attempt_no} ended: rc={rc} class={cls} "
                      f"({steps} step record(s) in {result.seconds:.1f}s)")
            if self.on_attempt is not None:
                try:
                    self.on_attempt(result)
                except Exception as e:  # an observer must never kill policy
                    self._log(f"warning: on_attempt hook failed ({e})")
            if self._stop.is_set():
                return SupervisorResult(
                    "clean" if cls == "clean" else "stopped", attempts)
            if self._scale_relaunch:
                # WE ended this attempt to re-form the mesh at a new
                # epoch: not a failure — no restart budget, no backoff,
                # no crash-loop accounting; relaunch immediately
                self._scale_relaunch = False
                self._log("rescale relaunch (no restart budget consumed)")
                continue
            if cls == "clean":
                return SupervisorResult("clean", attempts)
            consecutive_dead = consecutive_dead + 1 if steps == 0 else 0
            if consecutive_dead >= pol.crash_loop_k:
                self._log(
                    f"CRASH LOOP: {consecutive_dead} consecutive attempts "
                    f"died before their first step (last class {cls!r}) — "
                    "the failure is deterministic, not transient; fix the "
                    "run instead of restarting it")
                return SupervisorResult("crash_loop", attempts)
            if restarts >= pol.max_restarts:
                self._log(f"giving up: {restarts} restart(s) used "
                          f"(max_restarts={pol.max_restarts})")
                return SupervisorResult("restarts_exhausted", attempts)
            # shrink only on the SECOND consecutive rendezvous failure:
            # the first full-size retry rides out a transient coordinator
            # outage (the common case); a repeat is the host-loss signal.
            # Consensus-less fallback only — with a shared dir, membership
            # (lease expiry / explicit leave) is the loss signal and
            # _resolve_view owns sizing
            if (cls == "rendezvous" and pol.shrink_on_host_loss
                    and self.consensus is None):
                rdzv_streak = 0
                for a in reversed(attempts):
                    if a.failure_class != "rendezvous":
                        break
                    rdzv_streak += 1
                if rdzv_streak >= 2:
                    self.env, survivors = degraded_env(self.env)
                    if self.env.get("TPU_DIST_DEGRADED") == "1":
                        self.degraded = True
                        self._log("host loss confirmed (2 consecutive "
                                  "rendezvous failures) — re-forming the "
                                  f"mesh dp-only on {survivors} surviving "
                                  "process(es)")
            restarts += 1
            # per-host jitter: N hosts restarting after one shared failure
            # must not hit the rendezvous coordinator in lockstep
            wait = compute_backoff(restarts, pol, host_id=self.host_id)
            self._log(f"restart {restarts}/{pol.max_restarts} in "
                      f"{wait:.1f}s")
            if self.consensus is None:
                self._sleep(wait)
            else:
                # heartbeat THROUGH the backoff: a capped backoff (60s+)
                # dwarfs the membership lease (10s), and a silently
                # sleeping host would be declared lost by its peers —
                # one crash-looping host must not shrink a healthy mesh
                remaining = wait
                slice_s = max(self.consensus.lease_s / 3.0, 0.1)
                while remaining > 0:
                    self._sleep(min(remaining, slice_s))
                    remaining -= slice_s
                    self.consensus.register()


# -- in-process library API (the engines' config opt-in) --------------------

def run_supervised(make_trainer: Callable, cfg, *,
                   policy: Optional[RestartPolicy] = None,
                   sleep: Callable[[float], None] = time.sleep):
    """Policy-looped ``make_trainer(cfg).fit()``: the in-process flavor.

    Each attempt rebuilds the trainer with ``attempt=-1`` auto-lineage and
    ``resume`` pointed at the newest valid checkpoint, so a ``HealthError``
    halt (or any organic exception) restarts from the last good state with
    the restart visible in the stitched ledger. Bounded by the same
    :class:`RestartPolicy` (defaults come from the config's
    ``max_restarts`` / ``restart_backoff_s`` / ``crash_loop_k`` knobs);
    exhaustion re-raises the last failure, a crash loop raises
    :class:`CrashLoopError`. Process-killing failures (``os._exit``,
    SIGKILL, host loss) need the subprocess CLI by construction."""
    import dataclasses

    from tpu_dist_torch.obs.health import HealthError

    if policy is None:
        policy = RestartPolicy(
            max_restarts=int(getattr(cfg, "max_restarts", 0) or 0),
            backoff_base_s=float(getattr(cfg, "restart_backoff_s", 1.0)
                                 or 0.0),
            crash_loop_k=int(getattr(cfg, "crash_loop_k", 3) or 3))
    restarts = 0
    consecutive_dead = 0
    while True:
        resume = getattr(cfg, "resume", "")
        if restarts > 0 and getattr(cfg, "checkpoint_dir", ""):
            resume = latest_checkpoint(cfg.checkpoint_dir) or resume
        run_cfg = dataclasses.replace(
            cfg, resume=resume,
            attempt=-1 if getattr(cfg, "ledger_path", "") else
            getattr(cfg, "attempt", 0))
        trainer = None  # drop the dead attempt's params/opt-state BEFORE
        # the rebuild re-allocates them — restarts must fit in HBM
        try:
            # construction is INSIDE the policy: an OOM while the rebuild
            # re-allocates, or an FS blip loading the resume checkpoint,
            # is a classifiable pre-first-step death (backoff + crash-loop
            # counting), same as a child dying at startup in the
            # subprocess flavor — not an abort of the whole supervised run
            trainer = make_trainer(run_cfg)
            return trainer.fit()
        except KeyboardInterrupt:
            raise  # the operator's ^C is not a failure to remediate
        except Exception as e:
            cls = "health_halt" if isinstance(e, HealthError) else "crash"
            steps = int(getattr(getattr(trainer, "obs", None), "steps", 0)
                        or 0)
            consecutive_dead = consecutive_dead + 1 if steps == 0 else 0
            if consecutive_dead >= policy.crash_loop_k:
                raise CrashLoopError(
                    f"{consecutive_dead} consecutive attempts died before "
                    f"their first step (last: {cls}: {e}) — deterministic "
                    "failure, not restarting") from e
            if restarts >= policy.max_restarts:
                raise
            restarts += 1
            wait = compute_backoff(restarts, policy)
            print(f"[supervise] {cls}: {e}\n[supervise] in-process restart "
                  f"{restarts}/{policy.max_restarts} in {wait:.1f}s",
                  file=sys.stderr, flush=True)
            sleep(wait)
