"""Per-request distributed tracing: deterministic spans over the ledger.

The port's own copy of ``tpu_dist/obs/reqtrace.py`` (stdlib only): same
derived ids and span names, so port and reference traces stitch alike.

Every telemetry layer so far — ledger, metrics, flight recorder, goodput,
fleet observatory — is *aggregate*: ``DecodeRequest.rid`` rides the
``admit``/``request`` events, yet nothing can answer "where did THIS
request's p99 TTFT go — queue, prefill bucket, spec-reject storm, CoW
fork, or shed-readmit?". This module is the missing span model: stdlib
only, jax-free, emitted as the ``span`` ledger event through the normal
sink fan-out (so the metrics bridge, flight recorder and fleet stitcher
all see spans for free).

Identity is DERIVED, never generated — no wall-clock, no randomness:

* ``trace_id = H(trace_ns | rid)``: host-INDEPENDENT on purpose. Two
  fleet hosts never exchange a byte, yet both mint the SAME trace id for
  the same request rid (the namespace is the scenario/job family, not the
  per-host job_id), so a request shed on one host and re-admitted on
  another — today's dropped case, tomorrow's migration — stitches into
  ONE trace by id equality alone (:meth:`sim.fleet.FleetLedger.traces`).
* root span, one per (job_id, attempt) that touched the request:
  ``H(trace_id | job_id | attempt | 'request')``. An attempt that only
  SHED the request never emits its root, but the id is still derivable,
  so orphan children always know their parent.
* child spans: ``H(parent_id | name | n)`` with a deterministic
  per-(parent, name) counter — the n-th decode window of a request has
  the same span id on every replay (the replay-diffable discipline the
  rest of the ledger already follows).

Span ``start``/``end`` are ENGINE-CLOCK seconds (real seconds under the
default clock, virtual units under an injected one) — comparable within
one process only. The ledger's wall ``ts``, stamped at emit time (== span
close), anchors cross-host placement: SLO-exemplar windows
(tools/request_report.py) and Perfetto lanes (tools/trace_merge.py) both
key on it.

Attribution contract (tools/request_report.py): the ``queue``, ``prefill``
and ``decode`` spans of one root TILE the request's admit->finish interval
contiguously, so ``sum(categories) + residue == latency`` holds by
construction (the goodput ``sum_check`` discipline, per request). Detail
spans (``prefix_hit``, ``cow_fork``, ``readmit``, ``shed``) NEST inside
those periods and are excluded from the category sum — they name causes,
they don't add seconds.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

# the root span's name; every other span of a trace is a child of a root
ROOT_NAME = "request"
# span names that sum into the attribution categories (tile the request)
CATEGORIES = ("queue", "prefill", "decode")
# span names that annotate a cause inside a category period (no seconds)
DETAIL_NAMES = ("prefix_hit", "cow_fork", "readmit", "shed")


def _h(text: str) -> str:
    return hashlib.sha1(text.encode()).hexdigest()[:16]


def trace_id(trace_ns: str, rid) -> str:
    """Host-independent request identity: every host of one fleet derives
    the same id from the shared namespace + rid, no coordination."""
    return _h(f"{trace_ns}|{rid}")


def root_span_id(tid: str, job_id: str, attempt: int) -> str:
    """The per-(job, attempt) root: one host-attempt's view of a request.
    Derivable without the root record existing (shed-only attempts)."""
    return _h(f"{tid}|{job_id}|{attempt}|{ROOT_NAME}")


def child_span_id(parent_id: str, name: str, n: int) -> str:
    """The n-th ``name`` child under ``parent_id`` (0-based)."""
    return _h(f"{parent_id}|{name}|{n}")


class RequestTracer:
    """Trace context carried through an engine: the ledger to emit into
    plus the (job_id, attempt, host, trace_ns) identity that pins every
    derived id. Emit sites stay in the instrumented modules (literal
    ``.emit("span", ...)`` calls — the DL006 discipline); the tracer only
    derives ids and the common extras."""

    def __init__(self, ledger, job_id: str, attempt: int = 0,
                 host: Optional[int] = None,
                 trace_ns: Optional[str] = None):
        self.ledger = ledger
        self.job_id = str(job_id)
        self.attempt = int(attempt)
        self.host = host
        # default namespace: the job id — correct for single-host serving;
        # the fleet worker passes the SCENARIO name so per-host job ids
        # (``{scenario}-h{host}``) don't split one request into N traces
        self.trace_ns = str(trace_ns if trace_ns is not None else job_id)
        self._counts: Dict[Tuple[str, str], int] = {}

    def trace_id(self, rid) -> str:
        return trace_id(self.trace_ns, rid)

    def root_id(self, rid) -> str:
        return root_span_id(self.trace_id(rid), self.job_id, self.attempt)

    def root_ids(self, rid) -> Tuple[str, str, None]:
        """(trace_id, span_id, parent_id) for the request root span."""
        return self.trace_id(rid), self.root_id(rid), None

    def ids(self, rid, name: str) -> Tuple[str, str, str]:
        """(trace_id, span_id, parent_id) for the next ``name`` child of
        the request's root, advancing the deterministic counter."""
        tid = self.trace_id(rid)
        parent = root_span_id(tid, self.job_id, self.attempt)
        key = (parent, name)
        n = self._counts.get(key, 0)
        self._counts[key] = n + 1
        return tid, child_span_id(parent, name, n), parent

    def attrs(self) -> dict:
        """The identity extras every span rides: which host-attempt saw
        this slice of the request (host omitted when not in a fleet)."""
        out = {"job_id": self.job_id, "attempt": self.attempt}
        if self.host is not None:
            out["host"] = self.host
        return out


# -- reading spans back ----------------------------------------------------

def spans(records) -> List[dict]:
    """The span records of a ledger, in emit order."""
    return [r for r in records if r.get("event") == "span"]


def traces(records) -> Dict[str, dict]:
    """Group span records into traces: trace_id -> {rid, spans, roots,
    hosts, names}. Deterministic: spans sort by (start, span_id) — engine
    clocks aren't comparable across hosts, but the tie-break id makes the
    order reproducible regardless."""
    out: Dict[str, dict] = {}
    for r in spans(records):
        t = out.setdefault(r["trace_id"], {
            "trace_id": r["trace_id"], "rid": r.get("rid"),
            "spans": [], "roots": [], "hosts": set(), "names": set()})
        t["spans"].append(r)
        t["names"].add(r.get("name"))
        if r.get("host") is not None:
            t["hosts"].add(r["host"])
        if r.get("name") == ROOT_NAME:
            t["roots"].append(r)
    for t in out.values():
        t["spans"].sort(key=lambda s: (float(s.get("start") or 0.0),
                                       str(s.get("span_id"))))
        t["roots"].sort(key=lambda s: (str(s.get("job_id")),
                                       int(s.get("attempt") or 0)))
        t["hosts"] = sorted(t["hosts"])
        t["names"] = sorted(n for n in t["names"] if n)
    return out


def children_of(trace: dict) -> Dict[Optional[str], List[dict]]:
    """parent span_id -> children, in the deterministic span order."""
    by_parent: Dict[Optional[str], List[dict]] = {}
    for s in trace["spans"]:
        by_parent.setdefault(s.get("parent_id"), []).append(s)
    return by_parent


def walk(trace: dict):
    """DFS over the span tree, yielding (depth, span). Roots first (by
    job/attempt), each root's children in span order; orphan children
    (their root was never emitted — shed-only attempts) surface at depth
    1 under a None parent so nothing silently disappears."""
    by_parent = children_of(trace)
    root_ids = {r["span_id"] for r in trace["roots"]}
    for root in trace["roots"]:
        yield 0, root
        for child in by_parent.get(root["span_id"], ()):
            yield 1, child
    for parent, kids in sorted(by_parent.items(),
                               key=lambda kv: str(kv[0])):
        if parent is None or parent in root_ids:
            continue
        for child in kids:
            yield 1, child
