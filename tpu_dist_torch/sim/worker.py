"""Fleet-sim worker: one virtual host = one supervised serve process (the
port's ``tpu_dist/sim/worker.py``).

``python -m tpu_dist_torch.sim.worker --scenario s.json --host 2`` replays
host 2's slice of the compiled scenario through a real
:class:`~tpu_dist_torch.engine.serve.ServeEngine` over
:func:`~tpu_dist_torch.models.transformer.tiny_lm` on ``--device``
(default ``cuda``; without CUDA that raises, the CPU is asked for with
``--device cpu``). Every host of a fleet runs on that one device: on a
one-card machine all hosts share the card. ``--devices`` (default: the
scenario's ``worker_devices``) selects nothing; as in the reference, the
count matters only to the runner's retune (``devices_per_host``), and the
worker stamps it into its ``run_start`` config.

Everything it emits is the NORMAL per-run observability surface —
``run_start`` / ``compile`` / windowed ``step`` records / ``admit`` /
``request`` / ``kv_cache`` / ``slo`` / ``goodput`` / ``run_end`` through
:class:`~tpu_dist_torch.obs.RunObs` — so the fleet stitcher aggregates
ordinary ledgers, and every fleet rollup (goodput, SLO breaches, restart
classes) is computed by the same code that serves single-host runs.
``run_end`` also carries the attempt's decode ``ticks`` and its
``launches`` (:data:`tpu_dist_torch.kernels.LAUNCHES`), which show
whether the serve path went through the card's kernels inside the worker.

Time is paced in scenario ticks (``tick_s`` per tick, stretched by the
host's slow-host ``skew`` factor): arrivals are submitted when the global
tick reaches their scheduled tick, so the admitted schedule is
machine-speed-independent — a slow box makes ticks late, never different.
The global tick survives restarts through a cursor sidecar
(``<ledger>.cursor.json``: resume tick + completed rids), so a preempted
host resumes where the fleet clock left it instead of replaying from
zero; a ``<ledger>.tick`` sidecar publishes the current tick for the
runner's fleet-clock gate.

Faults ride the standard machinery: the supervisor exports
``TPU_DIST_FAULTS`` from the scenario compile, and the tick loop checks
:meth:`~tpu_dist_torch.obs.RunObs.fire_step_faults` once per tick —
``hard_exit`` kills, ``hang`` wedges, ``preempt_sigterm`` lands on the
RunObs coordinated-preemption handler, which this loop honors by draining
the serve engine (finish in-flight, shed the queue, free pages), stamping
``run_end status=preempted`` and exiting ``PREEMPT_SNAPSHOT_RC`` so the
supervisor classifies ``preemption_snapshotted``.

A SIGTERM is a drain request from the first line of :func:`main`, before
torch's import and the CUDA context (seconds on a card): a plain handler
notes it, and once ``RunObs`` is up the noted request drains at the
resumed tick, before any tick runs. The package imports no torch on the
way to ``main`` (``tpu_dist_torch/__init__.py``), so what is left is the
interpreter's own start.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time
from dataclasses import dataclass, field

# ticks per step-record window (and per cursor/tick-file refresh)
WINDOW_TICKS = 8


@dataclass
class SimWorkerConfig:
    """The RunObs-facing config (run_start stamps it whole)."""

    ledger_path: str = ""
    attempt: int = 0
    job_id: str = ""
    scenario: str = ""
    host: int = 0
    skew: float = 1.0
    tick_s: float = 0.02
    resume: str = ""
    watchdog_factor: float = 0.0     # serve ticks are ms-scale; the
    skew_every: int = 0              # supervisor's ledger tail is liveness
    health: str = "record"
    goodput_every_s: float = 0.0     # final partition only
    metrics_port: int = 0
    faults: str = ""
    device: str = "cuda"
    devices: int = 1
    serve: dict = field(default_factory=dict)
    model: dict = field(default_factory=dict)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="fleet-sim serve worker (one virtual host)")
    ap.add_argument("--scenario", required=True,
                    help="scenario JSON/YAML (tpu_dist_torch.sim.scenario)")
    ap.add_argument("--host", type=int, required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device every host's engine runs on "
                    "(default cuda; cpu runs the plain path)")
    ap.add_argument("--ledger-path", default="",
                    help="base attempt-ledger path (the supervisor "
                    "forwards this)")
    ap.add_argument("--attempt", type=int, default=0,
                    help="-1 = auto next free index (supervisor lineage)")
    ap.add_argument("--devices", type=int, default=0,
                    help="devices per host for the runner's retune (0 = "
                    "the scenario's worker_devices); selects no device")
    ap.add_argument("--metrics-port", type=int, default=0)
    # tolerated supervisor forwardings (serving has no checkpoint/mesh)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--resume", default="")
    ap.add_argument("--mesh-shape", default="")
    ap.add_argument("--mesh-axes", default="")
    return ap


def _cursor_path(base: str) -> str:
    return base + ".cursor.json"


def _read_cursor(base: str):
    """(resume tick, completed rids, fresh): ``fresh`` marks a cursor the
    RUNNER seeded for an autoscale-admitted standby host — the host did
    not exist before its start tick, so pre-start arrivals are dropped
    outright (they were never admitted anywhere) instead of re-admitted."""
    try:
        with open(_cursor_path(base)) as f:
            doc = json.load(f)
        return (int(doc.get("tick", 0)), set(doc.get("done", [])),
                bool(doc.get("fresh")))
    except (OSError, ValueError):
        return 0, set(), False


def _write_cursor(base: str, tick: int, done, shed=None) -> None:
    """``shed`` (drain time only) publishes the descriptors of every
    request this host leaves unserved — rid/tenant/lengths/tick, all the
    schedule needs — so the runner can hand them to a SURVIVING host
    instead of dropping them."""
    tmp = _cursor_path(base) + ".tmp"
    try:
        doc = {"tick": tick, "done": sorted(done)}
        if shed is not None:
            doc["shed"] = shed
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, _cursor_path(base))
    except OSError:
        pass  # progress bookkeeping must never kill the host


def _write_tick(base: str, tick: int) -> None:
    try:
        with open(base + ".tick", "w") as f:
            f.write(f"{tick}\n")
    except OSError:
        pass


def main(argv=None) -> int:
    # before the heavy imports: until RunObs takes SIGTERM over, a SIGTERM
    # is noted here instead of killing the process
    early_sigterm: list = []
    try:
        prev = signal.signal(signal.SIGTERM,
                             lambda signum, frame: early_sigterm.append(1))
    except ValueError:          # not the main thread: nothing to take
        prev = None
    try:
        return _serve(build_parser().parse_args(argv), early_sigterm)
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)


def _serve(args, early_sigterm: list) -> int:

    from tpu_dist_torch.sim.scenario import compile_host_plans, load_scenario

    sc = load_scenario(args.scenario)
    plans, _actions = compile_host_plans(sc)
    if args.host not in plans:
        raise SystemExit(f"host {args.host} not in scenario "
                         f"(hosts: {sc.hosts})")
    plan = plans[args.host]

    import numpy as np
    import torch

    from tpu_dist_torch import kernels
    from tpu_dist_torch.device import resolve_device
    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)
    from tpu_dist_torch.models.transformer import tiny_lm
    from tpu_dist_torch.obs import RunObs
    from tpu_dist_torch.obs.autoscale import LedgerTailer
    from tpu_dist_torch.obs.reqtrace import RequestTracer
    from tpu_dist_torch.parallel.supervisor import PREEMPT_SNAPSHOT_RC

    device = resolve_device(args.device)   # cuda without CUDA raises
    if device.type == "cpu":
        # a fleet's virtual hosts share one box: a thread each keeps N
        # hosts from oversubscribing its cores
        torch.set_num_threads(1)
    model_kw = {"vocab_size": 64, "num_layers": 1, "d_model": 32,
                "num_heads": 2, "max_len": 64, **sc.model}
    serve_kw = {"max_slots": 2, "page_size": 8, "num_pages": 64,
                "kv_event_every": 32, **sc.serve}
    cfg = SimWorkerConfig(
        ledger_path=args.ledger_path, attempt=args.attempt,
        job_id=f"{sc.name}-h{args.host}", scenario=sc.name,
        host=args.host, skew=plan.skew, tick_s=sc.tick_s,
        metrics_port=args.metrics_port, device=str(device),
        devices=max(args.devices or sc.worker_devices, 1),
        serve=serve_kw, model=model_kw)

    obs = RunObs("fleet_sim", cfg, unit="tok/s", device=device)
    obs.enable_preempt_snapshot()   # SIGTERM = drain request, not death
    obs.run_start(mesh=None, process_count=1, devices=[
        torch.cuda.get_device_name(device) if device.type == "cuda"
        else "cpu"])
    if early_sigterm:   # taken before RunObs was up: drains before tick 1
        obs.request_preemption(source="SIGTERM")
    kernels.reset_launches()        # this attempt's kernel launches

    base = args.ledger_path or ""
    start_tick, done, fresh = (_read_cursor(base) if base
                               else (0, set(), False))
    arrivals = [a for a in plan.arrivals if a.rid not in done
                and not (fresh and a.tick < start_tick)]

    lm = tiny_lm(**model_kw, device=device, seed=sc.seed)
    # trace context (obs.reqtrace): the namespace is the SCENARIO name,
    # not this host's job_id — every host derives the same trace_id for
    # the same rid, so a request shed here and re-admitted elsewhere
    # stitches into one trace (sim.fleet.FleetLedger.traces)
    tracer = RequestTracer(obs.ledger, job_id=cfg.job_id,
                           attempt=obs.attempt, host=args.host,
                           trace_ns=sc.name)
    eng = ServeEngine(lm, ServeConfig(**serve_kw), ledger=obs.ledger,
                      tracer=tracer, device=device)
    arrival_rng = np.random.default_rng(sc.seed * 7919 + args.host)

    def _prompt(length):
        # content is irrelevant to the schedule; lengths are the load
        return arrival_rng.integers(1, model_kw["vocab_size"],
                                    length).astype(np.int32)

    def _attempt_extras() -> dict:
        return {"ticks": eng.ticks, "launches": dict(kernels.LAUNCHES)}

    def _drain_and_exit(reason: str, tick: int) -> int:
        comps = eng.drain(reason=reason, emit_run_end=False)
        for c in comps:
            done.add(c.rid)
        # publish every request this host leaves unserved (queued-then-
        # shed, not-yet-arrived, and any handed-off intake still pending):
        # the runner re-admits them on a surviving host when this host is
        # gone for good, or this host re-admits them itself on return
        shed = [{"rid": a.rid, "tick": a.tick, "tenant": a.tenant,
                 "prompt_len": a.prompt_len, "out_len": a.out_len}
                for a in arrivals if a.rid not in done]
        shed += [e for e in pending_handoff
                 if e.get("rid") is not None and e["rid"] not in done]
        if base:
            _write_cursor(base, tick, done, shed=shed)
            _write_tick(base, tick)
        obs.run_end(status="preempted", snapshot_tick=tick,
                    completed=eng.completed, rejected=eng.rejected,
                    **_attempt_extras())
        return PREEMPT_SNAPSHOT_RC

    def _readmit_span(rid, from_tick, tick, tenant, **extra) -> None:
        # the zero-duration readmit span binds the attempts (or hosts)
        # that touched one request into one trace (same derived trace_id)
        t_now = time.monotonic()
        tid, sid, par = tracer.ids(rid, "readmit")
        obs.ledger.emit(
            "span", trace_id=tid, span_id=sid, parent_id=par,
            name="readmit", rid=rid, start=round(t_now, 6),
            end=round(t_now, 6), from_tick=from_tick, at_tick=tick,
            tenant=tenant, **extra, **tracer.attrs())

    # cross-host shed handoff: the runner appends descriptors of a
    # permanently-gone host's unserved requests to this sidecar; the
    # survivor admits each at its scheduled tick with a `readmit` span,
    # so the request stays ONE trace across hosts (shared trace_ns)
    handoff_tail = LedgerTailer()
    handoff_path = base + ".handoff.jsonl" if base else ""
    pending_handoff: list = []

    tick = start_tick
    i = 0
    window_t0 = time.perf_counter()
    window_device_s = 0.0
    window_dispatch_s = 0.0
    window_tokens = 0
    window_start_tick = tick
    emitted_compile = False
    t_run0 = time.perf_counter()
    status_extra = {}
    try:
        while (tick < sc.ticks or i < len(arrivals) or pending_handoff
               or eng.queue or any(s is not None for s in eng.slots)):
            if tick > sc.ticks * 10 + 100_000:
                raise RuntimeError(f"worker did not drain by tick {tick}")
            # coordinated preemption (SIGTERM via RunObs, or an injected
            # preempt_deadline advance notice below)
            if obs.preempt_pending():
                return _drain_and_exit(obs.preempt_source or "sigterm",
                                       tick)
            effects = obs.fire_step_faults(tick)
            if "preempt_deadline" in effects:
                return _drain_and_exit("preempt_deadline", tick)
            t0 = time.perf_counter()
            while i < len(arrivals) and arrivals[i].tick <= tick:
                a = arrivals[i]
                if start_tick > 0 and a.tick < start_tick:
                    # scheduled before the resume point and never
                    # completed: a prior attempt shed it, and this attempt
                    # is the re-admission
                    _readmit_span(a.rid, a.tick, tick, a.tenant)
                eng.submit(DecodeRequest(a.rid, _prompt(a.prompt_len),
                                         a.out_len, tenant=a.tenant))
                i += 1
            if handoff_path:
                pending_handoff.extend(
                    e for e in handoff_tail.poll([handoff_path])
                    if e.get("rid") is not None)
            if pending_handoff:
                later = []
                for e in pending_handoff:
                    if int(e.get("tick", 0)) > tick:
                        later.append(e)
                        continue
                    rid = int(e["rid"])
                    if rid in done:
                        continue
                    # the handed-off request joins ITS OWN trace: the
                    # trace_ns is the scenario name, so this host derives
                    # the same trace_id the origin host shed under
                    _readmit_span(rid, e.get("tick"), tick, e.get("tenant"),
                                  handoff=True)
                    eng.submit(DecodeRequest(
                        rid, _prompt(max(int(e.get("prompt_len") or 4), 1)),
                        max(int(e.get("out_len") or 2), 1),
                        tenant=e.get("tenant")))
                pending_handoff = later
            window_dispatch_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            comps = eng.step()
            window_device_s += time.perf_counter() - t0
            for c in comps:
                done.add(c.rid)
                window_tokens += c.n_generated
            tick += 1
            # pacing: the global tick maps to wall time at tick_s x skew;
            # a slow machine just runs late (schedules never change)
            target = window_t0 + (tick - window_start_tick) \
                * sc.tick_s * plan.skew
            sleep = target - time.perf_counter()
            if sleep > 0:
                time.sleep(sleep)
            if tick % WINDOW_TICKS == 0 or tick >= sc.ticks:
                now = time.perf_counter()
                warm = not emitted_compile
                if warm:
                    # engines emit 'compile' right after the warm
                    # dispatch; the run_start->compile gap is the startup
                    # badput and the warm record below stays uncharged
                    obs.ledger.emit("compile", program="serve_tick",
                                    seconds=round(now - t_run0, 3))
                    emitted_compile = True
                wall = max(now - window_t0, 1e-9)
                obs.ledger.emit(
                    "step", step=tick, loss=None,
                    throughput=round(window_tokens / wall, 1),
                    unit=obs.unit, data_s=0.0,
                    dispatch_s=round(window_dispatch_s, 6),
                    device_s=round(window_device_s, 6), comm_s=None,
                    mfu=None, tflops=None,
                    steps_in_dispatch=max(tick - window_start_tick, 1),
                    warm=warm, items=window_tokens,
                    queue_depth=len(eng.queue),
                    active_seqs=sum(s is not None for s in eng.slots))
                obs.heartbeat()
                if base:
                    _write_cursor(base, tick, done)
                    _write_tick(base, tick)
                window_t0 = now
                window_start_tick = tick
                window_device_s = window_dispatch_s = 0.0
                window_tokens = 0
        eng._emit_kv_cache()  # final pool-pressure snapshot
        if base:
            _write_cursor(base, tick, done)
            _write_tick(base, tick)
        status_extra = {"completed": eng.completed,
                        "rejected": eng.rejected, "final_tick": tick,
                        **_attempt_extras()}
        return 0
    finally:
        obs.run_end(**status_extra)


if __name__ == "__main__":
    raise SystemExit(main())
