"""Deterministic fault injection for the port (``tpu_dist/obs/faults.py``).

The port's own copy of the reference module, stdlib-only at import time:
the same spec grammar, sites, ``fault`` ledger events and
``TPU_DIST_FAULTS`` variable, so a spec written for the reference drives
the port's engines and supervisor unchanged. What differs is
:func:`poison_params`, which NaN-poisons the first floating parameter of a
``TrainState`` in place under ``torch.no_grad`` (the fp32 masters, as the
reference's replacement of ``state.params`` does).

A remediation layer (``parallel.supervisor``) is only trustworthy if every
failure class it claims to handle can be *produced on demand*. This module
injects failures at named sites, deterministically (a spec names the site
and the step/epoch/attempt it fires at), so a hang, a hard kill, a full
disk or a flaky coordinator is a one-line env var away on a CPU dev box:

    TPU_DIST_FAULTS="hard_exit@step=10,attempt=0" \\
        python -m tpu_dist_torch.supervise ...

Spec grammar (``TPU_DIST_FAULTS`` env var or the ``faults`` config knob;
entries separated by ``;``)::

    site@key=val[,key=val...]

where *site* is one of :data:`SITES` and the keys split into match
conditions and site arguments:

* ``step=N``   — fire at the first step whose ordinal is >= N (window
  dispatches may never land on N exactly);
* ``epoch=N``  — same, for epoch-scoped sites;
* ``nth=N``    — fire on the N-th *check* of the site (1-based; e.g. the
  2nd checkpoint write). Sites with no condition fire on the first check;
* ``attempt=N``— additionally require restart-attempt ordinal N (so an
  injected crash does not re-fire after the supervisor restarts the run
  and resumes *before* the fault step);
* ``times=K``  — fire up to K times (default 1; rendezvous faults use
  this to fail the first K connection attempts);
* ``secs=S``   — ``hang``: sleep S seconds (default 3600);
  ``preempt_deadline``: the forwarded snapshot deadline (default the
  ``TPU_DIST_PREEMPT_DEADLINE_S`` env, then 30);
* ``code=C``   — ``hard_exit`` only: ``os._exit`` status (default 13).

Sites (:data:`SITES`):

* ``nan_batch``       — step-scoped; the engine poisons the step's numbers
  with NaN (inputs here are integer tokens / uint8 pixels, so the
  injection lands on the param tree: the step's loss/grads go non-finite
  exactly as a NaN batch would make them, and the health sentry trips);
* ``hard_exit``       — step-scoped ``os._exit`` (SIGKILL-class death: no
  atexit, no run_end — the torn-ledger crash the supervisor must classify);
* ``hang``            — step-scoped sleep on the step thread (the
  watchdog-confirmed-stall path: stall event fires, the loop never
  advances, the supervisor SIGKILLs and restarts);
* ``preempt_sigterm`` — step-scoped ``SIGTERM`` to self (the scheduler's
  preemption signal; the crash guard's handler runs, run_end lands);
* ``ckpt_enospc``     — checkpoint-write ``OSError(ENOSPC)`` raised inside
  the container write (engine.checkpoint), before any byte lands;
* ``rendezvous_fail`` — ``launch.initialize`` raises ``ConnectionError``
  instead of calling ``init_process_group`` (exercises the retry/
  backoff/deadline path without a real flaky coordinator);
* ``preempt_deadline``— step-scoped; the engine receives the scheduler's
  advance preemption notice (``secs=S`` deadline, default 30) WITHOUT a
  real SIGTERM: the loop finishes the in-flight step, writes the
  coordinated snapshot and exits ``preemption_snapshotted`` — the
  round-13 elastic path, provable on CPU;
* ``host_return``     — consensus-round site (parallel.consensus): a lost
  planned host re-registers (``host=N`` names one, default all missing),
  driving mesh re-expansion deterministically with no real second host.

Every injection emits one ``fault`` ledger event (EVENT_SCHEMA) — reports
must distinguish *injected* failures from organic ones — and prints a
stderr line (the ledger may be the thing being killed). The module is
stdlib-only at import time (the supervisor imports it); torch appears only
inside :func:`poison_params`.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

SITES = ("nan_batch", "hard_exit", "hang", "preempt_sigterm",
         "ckpt_enospc", "rendezvous_fail", "preempt_deadline",
         "host_return")

# sites the engines check once per optimizer-step loop iteration
STEP_SITES = ("nan_batch", "hard_exit", "hang", "preempt_sigterm",
              "preempt_deadline")

# match conditions vs site arguments (anything not a condition is an arg)
_CONDITIONS = ("step", "epoch", "nth", "attempt")

ENV_VAR = "TPU_DIST_FAULTS"


@dataclass
class Fault:
    """One parsed spec entry: a site plus when/how it fires."""

    site: str
    when: Dict[str, int]
    args: Dict[str, float]
    spec: str
    fired: int = 0

    @property
    def times(self) -> int:
        return int(self.args.get("times", 1))

    def matches(self, nth: int, ctx: Dict) -> bool:
        if self.fired >= self.times:
            return False
        for key, want in self.when.items():
            if key == "nth":
                if nth < want:
                    return False
            elif key == "attempt":
                have = ctx.get("attempt")
                if have is None or int(have) != want:
                    return False
            else:  # step / epoch: first opportunity >= N
                have = ctx.get(key)
                if have is None or int(have) < want:
                    return False
        return True


def _parse_entry(entry: str) -> Fault:
    entry = entry.strip()
    site, _, rest = entry.partition("@")
    site = site.strip()
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r} in {entry!r} "
                         f"(sites: {', '.join(SITES)})")
    when: Dict[str, int] = {}
    args: Dict[str, float] = {}
    if rest:
        for kv in rest.split(","):
            key, sep, val = kv.partition("=")
            key = key.strip()
            if not sep or not val.strip():
                raise ValueError(f"malformed fault condition {kv!r} in "
                                 f"{entry!r} (want key=value)")
            try:
                num = float(val)
            except ValueError:
                raise ValueError(f"non-numeric fault value {kv!r} in "
                                 f"{entry!r}") from None
            if key in _CONDITIONS:
                when[key] = int(num)
            else:
                args[key] = num
    return Fault(site=site, when=when, args=args, spec=entry)


@dataclass
class FaultPlan:
    """The parsed spec: every entry, plus per-site check counters.

    ``fire`` is the one entry point: it matches, records, emits the
    ``fault`` ledger event, and *executes* the process-level sites
    (exit/hang/signal) itself — data-level sites (nan_batch, ckpt_enospc,
    rendezvous_fail) return the Fault so the caller applies the effect.
    """

    faults: List[Fault] = field(default_factory=list)
    seen: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        entries = [e for e in (spec or "").split(";") if e.strip()]
        return cls(faults=[_parse_entry(e) for e in entries])

    def sites(self) -> set:
        return {f.site for f in self.faults}

    def fire(self, site: str, ledger=None, **ctx) -> Optional[Fault]:
        """Check ``site`` against the plan; fire at most one matching fault.

        Returns the fired Fault (data-level sites) or None. Process-level
        sites (hard_exit / hang / preempt_sigterm) act here and — except
        ``hang``, which eventually returns if ``secs`` elapses — do not."""
        nth = self.seen.get(site, 0) + 1
        self.seen[site] = nth
        for f in self.faults:
            if f.site == site and f.matches(nth, ctx):
                f.fired += 1
                self._record(f, ledger, ctx)
                self._act(f)
                return f
        return None

    def _record(self, f: Fault, ledger, ctx: Dict) -> None:
        print(f"[faults] INJECTING {f.spec!r} "
              f"(ctx {dict(ctx)}, firing {f.fired}/{f.times})",
              file=sys.stderr, flush=True)
        led = ledger if ledger is not None else _default_ledger
        if led is not None:
            try:
                led.emit("fault", site=f.site, step=ctx.get("step"),
                         spec=f.spec, attempt=ctx.get("attempt"))
            except Exception:
                pass  # injection must not depend on a healthy ledger

    def _act(self, f: Fault) -> None:
        if f.site == "hard_exit":
            # the SIGKILL-class death: no atexit hooks, no run_end, a
            # possibly-torn ledger line — exactly what a killed host leaves
            os._exit(int(f.args.get("code", 13)))
        elif f.site == "hang":
            time.sleep(float(f.args.get("secs", 3600.0)))
        elif f.site == "preempt_sigterm":
            import signal

            os.kill(os.getpid(), signal.SIGTERM)


# -- process-global plan (crosses the supervisor->child env boundary) -------

_lock = threading.RLock()
_plan: Optional[FaultPlan] = None
_env_loaded = False
_default_ledger = None
_context: Dict[str, int] = {}


def _seed_env_context() -> None:
    """Seed ``attempt`` from TPU_DIST_ATTEMPT (the supervisor exports it
    per child) so attempt-conditioned faults at sites that fire BEFORE
    RunObs exists — rendezvous in launch.initialize — still match.
    RunObs.set_context overwrites with the authoritative value later."""
    val = os.environ.get("TPU_DIST_ATTEMPT", "")
    if val and "attempt" not in _context:
        try:
            _context["attempt"] = int(val)
        except ValueError:
            pass


def install(spec, ledger=None) -> Optional[FaultPlan]:
    """Install a plan from a spec string (or FaultPlan; None/"" clears)."""
    global _plan, _env_loaded, _default_ledger
    with _lock:
        _plan = (spec if isinstance(spec, FaultPlan)
                 else FaultPlan.parse(spec) if spec else None)
        _env_loaded = True  # an explicit install wins over the env var
        if ledger is not None:
            _default_ledger = ledger
        _seed_env_context()
    return _plan


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, lazily parsed from ``TPU_DIST_FAULTS`` once."""
    global _plan, _env_loaded
    with _lock:
        if not _env_loaded:
            _env_loaded = True
            spec = os.environ.get(ENV_VAR, "")
            if spec:
                _plan = FaultPlan.parse(spec)
                _seed_env_context()
        return _plan


def set_ledger(ledger) -> None:
    """Register the run's ledger as the fault-event destination (RunObs
    calls this at run_start so sites without a ledger in hand — the
    checkpoint writer, launch — still record their injections)."""
    global _default_ledger
    _default_ledger = ledger


def set_context(**ctx) -> None:
    """Merge ambient match context (RunObs stamps ``attempt`` here)."""
    _context.update({k: v for k, v in ctx.items() if v is not None})


def fire(site: str, ledger=None, **ctx) -> Optional[Fault]:
    """Module-level convenience: no-op (and cheap) when no plan is set."""
    plan = active_plan()
    if plan is None:
        return None
    merged = {**_context, **ctx}
    return plan.fire(site, ledger=ledger, **merged)


def fire_step(step: int, ledger=None, **ctx) -> Dict[str, Fault]:
    """Check every step-scoped site for this step ordinal; returns the
    data-level effects the caller must apply as ``{site: Fault}``
    (``nan_batch`` and ``preempt_deadline`` — the Fault carries the
    site args, e.g. the injected deadline's ``secs``; the process-level
    sites act inside fire()). ``site in effects`` keeps working as it
    did when this returned a bare set."""
    plan = active_plan()
    if plan is None:
        return {}
    effects: Dict[str, Fault] = {}
    active = plan.sites()
    for site in STEP_SITES:
        fault = (plan.fire(site, ledger=ledger,
                           **{**_context, "step": step, **ctx})
                 if site in active else None)
        if fault is not None and site in ("nan_batch", "preempt_deadline"):
            effects[site] = fault
    return effects


def poison_params(params) -> None:
    """NaN-poison the first floating tensor of ``params`` in place (the
    ``nan_batch`` effect: this run's inputs are integer tokens / uint8
    pixels, so the numeric fault is injected where the floats live -- the
    step's grads and loss go non-finite exactly as a NaN input batch would
    make them). ``params`` is a ``TrainState``'s list of fp32 masters."""
    import torch

    with torch.no_grad():
        for p in params:
            if torch.is_tensor(p) and p.is_floating_point():
                p.mul_(float("nan"))
                return


def _reset_for_tests() -> None:
    """Clear all module state (test isolation only)."""
    global _plan, _env_loaded, _default_ledger
    with _lock:
        _plan = None
        _env_loaded = False
        _default_ledger = None
        _context.clear()
