"""CLI for the port's elastic run supervisor
(tpu_dist_torch.parallel.supervisor; the port of ``tpu_dist/supervise.py``,
with the same flags and exit codes).

    python -m tpu_dist_torch.supervise --ledger run.jsonl --ckpt-dir ck -- \\
        python -m tpu_dist_torch.scripts.lm_longcontext --epochs 4

The supervisor launches the command after ``--``, appends the lineage
flags (``--ledger-path``/``--attempt -1``/``--checkpoint-dir`` and, on
restarts, ``--resume <newest valid checkpoint>``), watches liveness via
the attempt ledger's tail + a heartbeat file, classifies every exit, and
restarts under a bounded policy (exponential backoff, crash-loop cutoff,
degraded dp-only relaunch on confirmed host loss). Exit code 0 iff the
run completed cleanly. Never touches a device: the child owns the card.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from tpu_dist_torch.parallel.supervisor import (RestartPolicy, Supervisor,
                                          SupervisorResult)


def build_parser() -> argparse.ArgumentParser:
    p = RestartPolicy()
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.supervise",
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--ledger", required=True,
                    help="base ledger path; attempts write <stem>.aN.jsonl")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint dir to resume restarts from "
                    "(newest-valid pointer; empty = no auto-resume)")
    ap.add_argument("--max-restarts", type=int, default=p.max_restarts)
    ap.add_argument("--backoff-s", type=float, default=p.backoff_base_s,
                    help="restart backoff base (doubles per restart)")
    ap.add_argument("--backoff-max-s", type=float, default=p.backoff_max_s)
    ap.add_argument("--crash-loop-k", type=int, default=p.crash_loop_k,
                    help="stop after K consecutive pre-first-step deaths")
    ap.add_argument("--stall-timeout-s", type=float,
                    default=p.stall_timeout_s,
                    help="SIGKILL after this much ledger/heartbeat silence")
    ap.add_argument("--stall-grace-s", type=float, default=p.stall_grace_s,
                    help="SIGKILL this long after a watchdog 'stall' event "
                    "with no progress")
    ap.add_argument("--no-forward-flags", action="store_true",
                    help="do not append --ledger-path/--attempt/--resume "
                    "to the command (it manages its own lineage)")
    ap.add_argument("--no-shrink", action="store_true",
                    help="never shrink the mesh on rendezvous/host loss")
    ap.add_argument("--backoff-jitter", type=float,
                    default=p.backoff_jitter,
                    help="deterministic per-host restart-backoff spread "
                    "(fraction of the wait; de-stampedes the coordinator)")
    ap.add_argument("--preempt-deadline-s", type=float,
                    default=p.preempt_deadline_s,
                    help="seconds the child gets between SIGTERM and "
                    "SIGKILL to write its coordinated preemption snapshot")
    ap.add_argument("--consensus-dir", default="",
                    help="shared directory for cross-host supervisor "
                    "consensus (parallel.consensus): dense process-id "
                    "renumbering on host loss + mesh re-expansion when a "
                    "host returns; empty = single-host fallback behavior")
    ap.add_argument("--host-id", type=int, default=None,
                    help="this host's consensus id (default: "
                    "TPU_DIST_PROCESS_ID)")
    ap.add_argument("--planned-processes", type=int, default=None,
                    help="the job's full world size (default: "
                    "TPU_DIST_NUM_PROCESSES)")
    ap.add_argument("--lease-s", type=float, default=10.0,
                    help="consensus membership lease: a host whose "
                    "heartbeat ages past this is declared lost")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- then the training command")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    policy = RestartPolicy(
        max_restarts=args.max_restarts, backoff_base_s=args.backoff_s,
        backoff_max_s=args.backoff_max_s, crash_loop_k=args.crash_loop_k,
        stall_timeout_s=args.stall_timeout_s,
        stall_grace_s=args.stall_grace_s,
        shrink_on_host_loss=not args.no_shrink,
        backoff_jitter=args.backoff_jitter,
        preempt_deadline_s=args.preempt_deadline_s)
    consensus = None
    if args.consensus_dir:
        import os

        from tpu_dist_torch.parallel.consensus import ConsensusDir

        host_id = (args.host_id if args.host_id is not None else
                   int(os.environ.get("TPU_DIST_PROCESS_ID", "0") or 0))
        planned = (args.planned_processes if args.planned_processes
                   is not None else
                   int(os.environ.get("TPU_DIST_NUM_PROCESSES", "1") or 1))
        consensus = ConsensusDir(args.consensus_dir, host_id=host_id,
                                 planned=planned, lease_s=args.lease_s)
        # startup join barrier: the first epoch should be the full mesh,
        # not a racey one-host view per supervisor start order
        consensus.wait_for_peers()
    sup = Supervisor(cmd, ledger=args.ledger, ckpt_dir=args.ckpt_dir,
                     policy=policy,
                     forward_flags=not args.no_forward_flags,
                     consensus=consensus)
    result: SupervisorResult = sup.run()
    print(f"[supervise] {result.status}: {len(result.attempts)} attempt(s) "
          + ", ".join(f"a{a.attempt}={a.failure_class}"
                      for a in result.attempts),
          file=sys.stderr, flush=True)
    return 0 if result.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
