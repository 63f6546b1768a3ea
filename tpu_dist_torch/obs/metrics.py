"""Metrics registry and Prometheus scrape endpoint for the port
(``tpu_dist/obs/metrics.py``; stdlib only).

The port's own copy of the reference module: the port imports nothing of
the JAX package, not even this stdlib-only file. It keeps the series names
(``tpu_dist_*``), the text exposition format, the event-to-series map of
:func:`metrics_ledger_sink` and the daemon-thread :class:`MetricsServer`,
so a dashboard built on reference runs reads port runs unchanged:

* :class:`MetricsRegistry` — counters / gauges / histograms with optional
  labels, rendered in the Prometheus text exposition format
  (``render()``). Thread-safe (the watchdog and the HBM sampler feed it
  from daemon threads).
* :func:`metrics_ledger_sink` — a ledger sink that maps the typed event
  stream onto the registry, so everything that reaches the ledger (step
  records, watchdog stalls, skew samples, health trips, HBM samples,
  decode calls) feeds the scrape through one mechanism. The standard
  series are pre-registered so a scrape always carries the stall/health
  counters even at zero.
* :class:`MetricsServer` / :func:`serve_metrics` — a daemon-thread HTTP
  endpoint serving ``render()`` on every GET (``/metrics`` by
  convention, ``/healthz`` and ``/livez`` for probes). ``RunObs`` starts
  one per process when ``metrics_port`` is set, at ``metrics_port +
  process_index``. A bind failure warns and disables; an exporter never
  takes the run down.

``RunObs.run_end`` snapshots the registry into a ``metrics_snapshot``
ledger event, so the final values survive in the ledger after the
endpoint is gone.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict, Iterable, Optional, Tuple

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0)


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{str(v)}"' for k, v in labels)
    return "{" + body + "}"


class _Metric:
    """One named family; per-label-set children live in ``_series``."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._series: Dict[Tuple[Tuple[str, str], ...], object] = {}
        # RLock, not Lock: RunObs.run_end's SIGTERM path snapshots every
        # metric on the main thread — if the signal lands while that same
        # thread is inside labels()/render() (the ledger-sink fan-out), a
        # plain Lock would self-deadlock (distlint DL101)
        self._lock = threading.RLock()

    def labels(self, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            child = self._series.get(key)
            if child is None:
                child = self._new_child()
                self._series[key] = child
        return child

    def _default(self):
        return self.labels()

    def _new_child(self):
        raise NotImplementedError

    def _render_series(self, out, key, child):
        raise NotImplementedError

    def render(self, out: list) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            items = list(self._series.items())
        for key, child in sorted(items):
            self._render_series(out, key, child)

    def snapshot(self) -> dict:
        with self._lock:
            return {_label_str(k) or "": child.value_view()
                    for k, child in self._series.items()}


class _CounterChild:
    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v += amount

    @property
    def value(self) -> float:
        return self._v

    def value_view(self):
        return self._v


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value

    def _render_series(self, out, key, child):
        out.append(f"{self.name}{_label_str(key)} {_fmt(child.value)}")


class _GaugeChild(_CounterChild):
    def __init__(self):
        super().__init__()
        self._fn = None

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def set_fn(self, fn) -> None:
        """Computed gauge: ``fn()`` is evaluated at every read (render/
        snapshot) — for values that age between scrapes, like
        ``tpu_dist_last_step_age_s``. ``fn`` must be cheap and safe."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return self._v
        return self._v

    def value_view(self):
        return self.value


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._default().set(v)

    def set_fn(self, fn) -> None:
        self._default().set_fn(fn)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value

    def _render_series(self, out, key, child):
        out.append(f"{self.name}{_label_str(key)} {_fmt(child.value)}")


class _HistogramChild:
    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1 = +Inf
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.sum += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
            self.counts[-1] += 1

    def value_view(self):
        return {"sum": self.sum, "count": self.count}


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(buckets))

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def _render_series(self, out, key, child):
        for b, c in zip(child.buckets, child.counts):
            ls = _label_str(key + (("le", _fmt(b)),))
            out.append(f"{self.name}_bucket{ls} {c}")
        ls = _label_str(key + (("le", "+Inf"),))
        out.append(f"{self.name}_bucket{ls} {child.counts[-1]}")
        out.append(f"{self.name}_sum{_label_str(key)} {_fmt(child.sum)}")
        out.append(f"{self.name}_count{_label_str(key)} {child.count}")


class MetricsRegistry:
    """Get-or-create registry of named metrics; ``render()`` is the scrape
    payload, ``snapshot()`` the JSON-safe dump for ``metrics_snapshot``."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        # RLock for the same reason as _Metric._lock: snapshot() runs on
        # the SIGTERM handler path while _get() serves main-thread sinks
        self._lock = threading.RLock()

    def _get(self, cls, name, help_text, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_text, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{type(m).__name__}")
        return m

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get(Gauge, name, help_text)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_text, buckets=buckets)

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        out: list = []
        for m in metrics:
            m.render(out)
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: m.snapshot() for name, m in metrics}

    def read_value(self, name: str):
        """The unlabeled child's current value, or None when the family
        (or its default child) does not exist — a cheap single-series
        read that never renders the registry (the /healthz path)."""
        with self._lock:
            m = self._metrics.get(name)
        if m is None:
            return None
        with m._lock:
            child = m._series.get(())
        return None if child is None else child.value


# -- the ledger -> registry bridge ----------------------------------------

def metrics_ledger_sink(reg: MetricsRegistry):
    """Build the sink that maps ledger events onto the registry. The
    operator-facing series are pre-registered here so a scrape during a
    healthy run still exposes the zero-valued stall/health counters
    (absence and zero are different answers to "is it hung?")."""
    steps = reg.counter("tpu_dist_steps_total",
                        "optimizer steps recorded in the ledger")
    items = reg.counter("tpu_dist_items_total",
                        "items (images/tokens) trained, global batch")
    throughput = reg.gauge("tpu_dist_step_throughput",
                           "last step record's items/sec (unit label)")
    mfu = reg.gauge("tpu_dist_mfu", "last step record's model FLOP/s "
                    "utilization (0-1)")
    loss = reg.gauge("tpu_dist_loss", "last recorded train loss")
    phase = reg.counter("tpu_dist_phase_seconds_total",
                        "host-measured step phase seconds by phase label")
    step_hist = reg.histogram("tpu_dist_step_seconds",
                              "per-optimizer-step wall seconds")
    stalls = reg.counter("tpu_dist_stalls_total",
                         "watchdog stall dumps fired")
    stall_idle = reg.gauge("tpu_dist_stall_idle_seconds",
                           "idle seconds at the last watchdog stall")
    skew_spread = reg.gauge("tpu_dist_skew_spread_seconds",
                            "last cross-host step-time spread (max-min)")
    straggler = reg.gauge("tpu_dist_straggler_index",
                          "process index of the last skew straggler")
    health = reg.counter("tpu_dist_health_trips_total",
                         "numerical-health trips by kind")
    health.labels(kind="nonfinite")       # pre-register: scrape shows 0
    health.labels(kind="loss_spike")
    # goodput accounting + progress SLOs (obs.goodput): the ratio and the
    # per-category badput seconds track the last 'goodput' event (a
    # snapshot partition, hence gauges); breaches are a counter by kind
    goodput_ratio = reg.gauge("tpu_dist_goodput_ratio",
                              "goodput share of wall-clock (0-1), from "
                              "the last goodput event")
    badput = reg.gauge("tpu_dist_badput_seconds",
                       "badput seconds by category, from the last "
                       "goodput event")
    from tpu_dist_torch.obs.goodput import CATEGORIES
    for c in CATEGORIES:
        badput.labels(category=c)         # pre-register: scrape shows 0
    slo_breaches = reg.counter("tpu_dist_slo_breaches_total",
                               "progress-SLO breaches by kind")
    slo_breaches.labels(kind="steps_per_min")
    slo_breaches.labels(kind="throughput")
    # progress-aware liveness: seconds since the last step record,
    # computed at read time (-1 before the first step) — the /healthz
    # body carries it so an external probe can detect a stalled-but-alive
    # run without parsing the full scrape
    import time as _time

    last_step_ts = [None]
    age = reg.gauge("tpu_dist_last_step_age_s",
                    "seconds since the last step record (-1 before any)")
    age.labels().set_fn(
        lambda: (round(_time.time() - last_step_ts[0], 3)
                 if last_step_ts[0] else -1.0))
    # build_info-style identity gauge (value always 1; the labels are the
    # payload): scrapes from different runs/configs become joinable on
    # run_id/config_hash, Prometheus-standard style. The family is
    # pre-registered here; its one child materializes when run_start
    # carries the labels.
    build_info = reg.gauge("tpu_dist_build_info",
                           "run identity: join metrics across runs on "
                           "these labels (value is always 1)")
    epoch_g = reg.gauge("tpu_dist_epoch", "last completed epoch")
    eval_loss = reg.gauge("tpu_dist_eval_loss", "last held-out eval loss")
    hbm = reg.gauge("tpu_dist_hbm_bytes_in_use", "last HBM sampler reading")
    decode_toks = reg.counter("tpu_dist_decode_tokens_total",
                              "tokens produced by generate() calls")
    # serving (engine.serve): queue/occupancy/pool-pressure gauges track
    # the admit/kv_cache event stream; requests and admission rejections
    # are counters so a dashboard rates them
    serve_queue = reg.gauge("tpu_dist_serve_queue_depth",
                            "decode requests waiting for a slot")
    serve_active = reg.gauge("tpu_dist_serve_active_seqs",
                             "sequences occupying serve slots")
    kv_free = reg.gauge("tpu_dist_kv_pages_free",
                        "free pages in the paged KV pool")
    serve_reqs = reg.counter("tpu_dist_serve_requests_total",
                             "serving requests completed")
    serve_rejects = reg.counter("tpu_dist_serve_rejected_total",
                                "submissions rejected by admission control")
    serve_toks = reg.counter("tpu_dist_serve_tokens_total",
                             "tokens generated by the serving engine")
    # per-request tracing (obs.reqtrace): the root 'request' span carries
    # the measured TTFT, so the histogram is fed by the span stream — the
    # scrape-side face of the request observatory
    req_ttft = reg.histogram("tpu_dist_request_ttft_seconds",
                             "per-request time-to-first-token seconds, "
                             "from root request spans")
    # elastic capacity (parallel.consensus / supervisor `scale` events):
    # the live mesh size and the degraded flag, so a dashboard shows a
    # shrink/re-expansion cycle without parsing ledgers
    mesh_procs = reg.gauge("tpu_dist_mesh_processes",
                           "process count of the current mesh (consensus "
                           "view; from run_start and scale events)")
    degraded_g = reg.gauge("tpu_dist_degraded",
                           "1 while running on a shrunken (degraded) "
                           "mesh, 0 at the planned world size")
    # fleet plane (the reference's sim `fleet` events): the stitched goodput
    # ratio, live-host count and cumulative SLO-breach total of a whole
    # simulated (or real multi-supervisor) fleet — the dashboard view of
    # "handles heavy traffic" as one number per scrape
    fleet_ratio = reg.gauge("tpu_dist_fleet_goodput_ratio",
                            "stitched fleet goodput share of aggregate "
                            "wall (0-1), from the last fleet event")
    fleet_hosts = reg.gauge("tpu_dist_fleet_hosts_live",
                            "virtual hosts with a running child, from "
                            "the last fleet event")
    fleet_breaches = reg.counter("tpu_dist_fleet_slo_breaches_total",
                                 "fleet-wide SLO breaches (monotonic; "
                                 "fed by deltas of the fleet events' "
                                 "cumulative count)")
    # autoscaling (obs.autoscale `scale_decision` events): decisions by
    # direction plus the last decision's target capacity — the dashboard
    # face of the closed capacity loop. Directions pre-registered so a
    # steady fleet still scrapes explicit zeros
    autoscale_decisions = reg.counter(
        "tpu_dist_autoscale_decisions_total",
        "autoscaling decisions emitted, by direction")
    autoscale_decisions.labels(direction="up")
    autoscale_decisions.labels(direction="down")
    autoscale_target = reg.gauge(
        "tpu_dist_autoscale_target_hosts",
        "target host count of the last autoscaling decision")
    # program-audit findings (the reference's proglint 'audit' events)
    # by check id; pre-registered so a clean run still scrapes zeros
    audit_findings = reg.counter("tpu_dist_audit_findings_total",
                                 "unwaivered program-audit findings "
                                 "(analysis.proglint), by check")
    for c in ("PL001", "PL002", "PL003", "PL004", "PL005"):
        audit_findings.labels(check=c)
    # fleet events carry the CUMULATIVE count; a Prometheus counter must
    # only move forward, so the sink feeds it deltas
    fleet_breach_seen = [0.0]
    # materialize the unlabeled children too — a family with no child
    # renders no sample line, and "0" vs "absent" are different answers
    # to "is it hung?"
    for m in (steps, items, mfu, loss, stalls, stall_idle, skew_spread,
              straggler, epoch_g, eval_loss, hbm, decode_toks, step_hist,
              goodput_ratio, serve_queue, serve_active, kv_free, serve_reqs,
              serve_rejects, serve_toks, req_ttft, mesh_procs, degraded_g,
              fleet_ratio, fleet_hosts, fleet_breaches, autoscale_target):
        m.labels()

    def sink(rec: dict) -> None:
        ev = rec.get("event")
        if ev == "run_start":
            import hashlib
            import json as _json

            cfg = rec.get("config") or {}
            chash = hashlib.sha1(_json.dumps(
                cfg, sort_keys=True, default=str).encode()).hexdigest()[:12]
            build_info.labels(
                run_id=f"{int(rec.get('ts') or 0)}-p{rec.get('pid', 0)}",
                kind=str(rec.get("kind") or ""),
                config_hash=chash,
                jax=str(rec.get("jax_version") or ""),
                quant=str(cfg.get("quant") or "none"),
                tp_impl=str(cfg.get("tp_impl") or "gspmd")).set(1)
            if rec.get("process_count") is not None:
                mesh_procs.set(rec["process_count"])
            degraded_g.set(1.0 if rec.get("degraded") else 0.0)
        elif ev == "step":
            last_step_ts[0] = rec.get("ts") or _time.time()
            n = rec.get("steps_in_dispatch") or 1
            steps.inc(n)
            if rec.get("items"):
                items.inc(rec["items"])
            if rec.get("throughput") is not None:
                throughput.labels(unit=rec.get("unit") or "items/s").set(
                    rec["throughput"])
            if rec.get("mfu") is not None:
                mfu.set(rec["mfu"])
            if rec.get("loss") is not None:
                loss.set(rec["loss"])
            wall = 0.0
            for key, lbl in (("data_s", "data"), ("dispatch_s", "dispatch"),
                             ("device_s", "device"), ("comm_s", "comm")):
                v = rec.get(key)
                if v:
                    phase.labels(phase=lbl).inc(v)
                    if key != "comm_s":  # comm overlaps device_s
                        wall += v
            if wall:
                step_hist.observe(wall / n)
        elif ev == "stall":
            stalls.inc()
            if rec.get("idle_s") is not None:
                stall_idle.set(rec["idle_s"])
        elif ev == "skew":
            if rec.get("spread_s") is not None:
                skew_spread.set(rec["spread_s"])
            if rec.get("straggler") is not None:
                straggler.set(rec["straggler"])
        elif ev == "health":
            health.labels(kind=rec.get("kind") or "unknown").inc()
        elif ev == "epoch":
            if rec.get("epoch") is not None:
                epoch_g.set(rec["epoch"])
        elif ev == "eval":
            if rec.get("loss") is not None:
                eval_loss.set(rec["loss"])
        elif ev == "hbm":
            if rec.get("bytes_in_use") is not None:
                hbm.set(rec["bytes_in_use"])
        elif ev == "decode":
            if rec.get("tokens"):
                decode_toks.inc(rec["tokens"])
        elif ev == "admit":
            if rec.get("queue_depth") is not None:
                serve_queue.set(rec["queue_depth"])
            if rec.get("pages_free") is not None:
                kv_free.set(rec["pages_free"])
            if not rec.get("accepted"):
                serve_rejects.inc()
        elif ev == "request":
            serve_reqs.inc()
            if rec.get("tokens"):
                serve_toks.inc(rec["tokens"])
        elif ev == "span":
            # only the root span carries a request-level TTFT; child spans
            # (queue/prefill/decode windows) are trace detail, not samples
            if (rec.get("name") == "request"
                    and rec.get("ttft_s") is not None):
                req_ttft.observe(rec["ttft_s"])
        elif ev == "kv_cache":
            if rec.get("pages_free") is not None:
                kv_free.set(rec["pages_free"])
            if rec.get("active_seqs") is not None:
                serve_active.set(rec["active_seqs"])
        elif ev == "goodput":
            if rec.get("ratio") is not None:
                goodput_ratio.set(rec["ratio"])
            for c, secs in (rec.get("categories") or {}).items():
                if secs is not None:
                    badput.labels(category=c).set(secs)
        elif ev == "slo":
            slo_breaches.labels(kind=rec.get("kind") or "unknown").inc()
        elif ev == "scale":
            if rec.get("processes") is not None:
                mesh_procs.set(rec["processes"])
            act = rec.get("action")
            if act == "shrink":
                degraded_g.set(1.0)
            elif act == "expand":
                degraded_g.set(0.0)
        elif ev == "scale_decision":
            autoscale_decisions.labels(
                direction=rec.get("direction") or "unknown").inc()
            if rec.get("target_hosts") is not None:
                autoscale_target.set(rec["target_hosts"])
        elif ev == "audit":
            for d in (rec.get("detail") or ()):
                if not d.get("waived"):
                    audit_findings.labels(
                        check=d.get("check") or "unknown").inc()
        elif ev == "fleet":
            if rec.get("hosts_live") is not None:
                fleet_hosts.set(rec["hosts_live"])
            if rec.get("goodput_ratio") is not None:
                fleet_ratio.set(rec["goodput_ratio"])
            v = rec.get("slo_breaches")
            if v is not None and v > fleet_breach_seen[0]:
                fleet_breaches.inc(v - fleet_breach_seen[0])
                fleet_breach_seen[0] = v

    return sink


# -- the scrape endpoint ---------------------------------------------------

class MetricsServer:
    """Daemon-thread HTTP server rendering the registry on every GET."""

    def __init__(self, registry: MetricsRegistry, port: int,
                 host: str = "0.0.0.0"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                path = self.path.split("?")[0]
                if path in ("/healthz", "/livez"):
                    # trivial liveness: the process (and this daemon
                    # thread) is up — no registry render, so a wedged
                    # metrics pipeline can't fail the liveness probe.
                    # /healthz is additionally progress-aware: it carries
                    # seconds since the last step record (one cheap
                    # single-gauge read), so an external probe detects a
                    # stalled-but-alive run without parsing the scrape
                    body = b"ok\n"
                    if path == "/healthz":
                        v = reg.read_value("tpu_dist_last_step_age_s")
                        if isinstance(v, (int, float)):
                            body = f"ok last_step_age_s={v:.3f}\n".encode()
                    ctype = "text/plain; charset=utf-8"
                else:
                    body = reg.render().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="tpu-dist-metrics", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)


def serve_metrics(registry: MetricsRegistry, port: int,
                  host: str = "0.0.0.0") -> Optional[MetricsServer]:
    """Start the endpoint; on bind failure warn and return None — the
    exporter is an accessory, never a reason to lose a run."""
    try:
        return MetricsServer(registry, port, host)
    except OSError as e:
        print(f"tpu_dist metrics endpoint disabled: cannot bind port "
              f"{port} ({e})", file=sys.stderr)
        return None
