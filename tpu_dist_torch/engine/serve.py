"""Continuous-batching decode engine over the paged KV cache, for the port
(``tpu_dist/engine/serve.py``).

Iteration-level scheduling (Orca, OSDI '22): admission decisions happen
at every decode tick, a finished sequence's slot and pages are reclaimed
and refilled the same tick. The pieces, as in the reference:

* :class:`~tpu_dist_torch.engine.kv_cache.PagedKVPool` backs every
  sequence with block-table pages (model dtype, or int8 + scales);
* two page programs serve all traffic: ``prefill`` (one admit's prompt,
  padded to a length bucket, writing its pages and sampling the first
  token; attention through the model's ``attn_fn`` -- the flash kernel
  under ``attn_fn=flash_attention_fn()``) and the decode ``tick`` (the
  packed slot set, one token per active sequence at its own position;
  inactive slots ride along on all-trash block tables). With
  ``kv_quant="int8", attn_read="flash"`` every tick reads its pages
  through the paged decode kernel;
* chunked prefill (``prefill_chunk``): long prompts run one fixed-size
  chunk per scheduler iteration, interleaved with the decode tick;
* sp-sharded serving (``ServeEngine(mesh=)``, a ``parallel.mesh.Mesh``
  with the ``sp`` axis, one process per device): the pool's arenas shard
  over the axis (``engine.kv_cache``), so a context can outgrow one
  device's pages; every rank runs the same scheduler on the same
  requests, and ticks, monolithic and chunked prefills and prefix forks
  read and write the sharded pages. Prompts at or past
  ``sp_prefill_threshold`` prefill sequence-parallel: each rank runs its
  contiguous shard of the padded prompt at its own global positions with
  ring attention over ``sp`` and writes its K/V into the pages it holds
  (the admission stripes the prompt's pages by shard);
* speculative decoding (``spec_k > 0``): a draft model (the base itself by
  default, or ``draft_model``) proposes ``spec_k`` greedy tokens per slot
  over its own page arenas (a second pool with the same page geometry and
  block tables, read exactly), then one (k+1)-wide base verify writes and
  reads every position at its own causal horizon; the longest agreeing
  prefix plus the base's correction is emitted, so the output equals
  non-speculative greedy decoding for any draft. The verify reads pages
  through the exact path (the paged decode kernel is one query per row);
* ``quant="int8"``: every dense layer through the fused int8 kernel
  (``ops.pallas_quant``);
* copy-on-write prefix caching (``prefix_cache``);
* SLO-aware admission: queue-depth and free-page watermarks at submit,
  and an EMA of queue wait that sheds new work while it breaches the
  floor (the ``slo`` ledger event);
* graceful drain (:meth:`ServeEngine.drain`, SIGTERM);
* ledger events ``admit`` / ``request`` / ``kv_cache`` / ``slo`` and the
  request-trace ``span`` s of ``obs.reqtrace``, with the reference's
  names and fields.

Refused with ``NotImplementedError``, as in the reference: MoE models
and speculative decoding over a sharded pool.

Under the program audit (``plan.compile.set_audit``) the page programs
are registered with its recompile sentry (``serve_prefill`` allowed one
input signature per bucket, ``serve_sp_prefill`` one per sp bucket, the
chunk, sample and tick programs one), each dispatch's signature is noted,
and the sentry is read at every ``kv_cache`` snapshot (PL005).

The scheduler is host-side and clock-agnostic (``now_fn``; tests and
trace replay pass a virtual clock). Page programs run under
``torch.inference_mode()`` on the engine's device. Under a mesh the one
host decision that reads the clock, SLO shedding, takes rank 0's queue
waits (and rank 0's SIGTERM flag), summed over ``sp`` once a step, so
every rank decides alike; a rank that decided otherwise would hang the
next collective. Only the main rank writes the ledger and spans.
"""

from __future__ import annotations

import signal
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np
import torch

from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.engine.generate import (_quantize_for_decode, _sample,
                                            prepare_draft)
from tpu_dist_torch.engine.kv_cache import PagedKVPool, PrefixMatch
from tpu_dist_torch.obs.reqtrace import RequestTracer
from tpu_dist_torch.ops.paged_attention import cow_fork_pages, sp_axis
from tpu_dist_torch.parallel.collectives import sum_bytes
from tpu_dist_torch.parallel.mesh import SP_AXIS
from tpu_dist_torch.plan.compile import (check_audit_sentry,
                                         note_audit_dispatch,
                                         register_audit_program)


@dataclass
class DecodeRequest:
    """One generation request: continue ``prompt`` by ``max_new_tokens``
    (or until ``ServeConfig.eos_id``). ``rid`` rides every ledger event of
    the request; ``tenant`` names its traffic class."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    tenant: Optional[str] = None


@dataclass
class Completion:
    """A finished request with its serving timeline (engine clock)."""

    rid: int
    tokens: np.ndarray           # (prompt + generated,) int32
    prompt_len: int
    n_generated: int
    admit_ts: float              # entered the queue (submit time)
    start_ts: float              # left the queue (prefill start)
    first_token_ts: float
    finish_ts: float

    @property
    def queue_wait_s(self) -> float:
        return self.start_ts - self.admit_ts

    @property
    def ttft_s(self) -> float:
        return self.first_token_ts - self.admit_ts


@dataclass
class ServeConfig:
    """Scheduler + paged-cache knobs (the reference's, same defaults)."""

    max_slots: int = 4           # concurrent sequences (the packed batch)
    page_size: int = 16          # tokens per KV page
    num_pages: int = 256         # pool capacity (per layer, +1 trash page)
    max_len: Optional[int] = None   # per-sequence cap (default model.max_len)
    quant: str = "none"          # weight quant (int8_wo pre-quantizes once)
    kv_quant: str = "none"       # page dtype: none (model dtype) | int8
    attn_read: str = "exact"     # exact | flash (int8-KV decode kernel)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: Optional[int] = None
    prefill_buckets: Tuple[int, ...] = ()   # () = powers of 2 up to max_len
    refill: str = "continuous"   # continuous | drain (static-batch baseline)
    queue_depth_max: int = 64    # hard admission cap
    free_page_watermark: float = 0.0   # reject below this free fraction
    slo_queue_wait_s: float = 0.0      # EMA floor; 0 disables shedding
    slo_alpha: float = 0.5
    slo_min_samples: int = 2
    kv_event_every: int = 0      # ticks between kv_cache events (0 = final)
    spec_k: int = 0              # draft tokens per tick (0 = plain decode)
    prefix_cache: bool = False   # CoW prefix sharing across requests
    prefill_chunk: int = 0       # chunked prefill size (0 = monolithic)
    # sequence-parallel prefill (needs ServeEngine(mesh=...)): prompts at
    # or past this length prefill under ring attention over 'sp', each
    # rank writing its shard's K/V into its own pages. 0 = never
    sp_prefill_threshold: int = 0
    trace_window_ticks: int = 8  # decode ticks per request-trace span


@dataclass
class _Slot:
    req: DecodeRequest
    pages: List[int]
    block_table: np.ndarray      # (max_pages_per_seq,) int32
    buf: np.ndarray              # (prompt + max_new,) int32
    prompt_len: int
    admit_ts: float
    start_ts: float
    position: int = 0            # next KV write position
    generated: int = 0
    first_token_ts: float = 0.0
    finish_ts: float = 0.0
    done: bool = False
    # copy-on-write: (bt_slot, src_page, dst_page) of a shared frontier
    # page, forked right before the first decode write; None once private
    cow_pending: Optional[Tuple[int, int, int]] = None
    # chunked prefill: next prompt offset to prefill (-1 once resident)
    chunk_next: int = -1
    shared_len: int = 0          # prefix-cache-resident prompt rows
    n_fresh: int = 0
    n_shared: int = 0
    # the open decode-window span (obs.reqtrace)
    win_start_ts: float = 0.0
    win_ticks: int = 0
    win_tokens: int = 0
    win_drafted: int = 0


def _default_buckets(max_len: int) -> Tuple[int, ...]:
    """Powers of two from 8 up to max_len, plus max_len itself."""
    out = []
    b = 8
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


class ServeEngine:
    """The continuous-batching scheduler (module docstring has the tour).

    ``model`` is a port ``TransformerLM`` on ``device`` (default CUDA, or
    the mesh's device; without CUDA the default raises, ``device="cpu"``
    runs the plain path). Drive it with :meth:`run` (submit everything,
    drain) or with ``submit()`` as requests arrive and ``step()`` once per
    iteration; under a mesh every rank drives it alike."""

    def __init__(self, model, config: Optional[ServeConfig] = None, *,
                 draft_model=None, ledger=None,
                 tracer: Optional[RequestTracer] = None,
                 now_fn: Callable[[], float] = time.monotonic,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 device=None):
        cfg = config if config is not None else ServeConfig()
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        if getattr(model, "num_experts", 0):
            raise NotImplementedError(
                "paged serving covers the dense TransformerLM family; the "
                "MoE capacity-factor dispatch needs its own scheduling story")
        # sp-sharded serving: the pool's arenas shard over the axis, so
        # KV capacity grows with it and a context larger than one
        # device's page budget serves
        self.sp_mesh = mesh
        self.sp_n = 1
        self.sp_axis = None
        if mesh is not None:
            if SP_AXIS not in getattr(mesh, "shape", {}):
                raise ValueError(
                    f"ServeEngine mesh needs the {SP_AXIS!r} axis (got "
                    f"axes {tuple(getattr(mesh, 'shape', ()))})")
            self.sp_axis = sp_axis(mesh)
            self.sp_n = self.sp_axis.size
            if cfg.spec_k > 0:
                raise NotImplementedError(
                    "speculative decoding over an sp-sharded pool is the "
                    "named residue: the draft scan's per-step sharded "
                    "writes need their own collective story")
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine device "
                             f"is {self.device}: build the model there")
        self.model = _quantize_for_decode(model, cfg.quant)
        self.cfg = cfg
        self.max_len = min(cfg.max_len or model.max_len, model.max_len)
        head_dim = model.d_model // model.num_heads
        self.pool = PagedKVPool(
            model.num_layers, cfg.num_pages, cfg.page_size,
            model.num_heads, head_dim, dtype=model.dtype,
            kv_quant=cfg.kv_quant, read=cfg.attn_read, mesh=mesh,
            device=self.device)
        self.max_pages_per_seq = self.pool.pages_needed(self.max_len)
        # speculative decoding: the draft's own arenas, same page geometry
        # and indices, so it rides the base's block tables and allocator
        self.draft_model = self.draft_pool = None
        if cfg.spec_k > 0:
            if cfg.temperature > 0.0:
                raise ValueError(
                    "speculative decoding serves greedy verification only "
                    "(spec_k > 0 needs temperature == 0): sampled "
                    "acceptance is a different estimator with different "
                    "output distribution guarantees")
            if draft_model is None:
                self.draft_model = self.model     # self-speculation
            else:
                if draft_model.device != self.device:
                    raise ValueError(f"draft model lives on "
                                     f"{draft_model.device}, engine device "
                                     f"is {self.device}")
                self.draft_model = prepare_draft(self.model, draft_model,
                                                 cfg.quant)
            dm = self.draft_model
            # the draft reads exactly, as in the reference: the paged
            # decode kernel serves the base's plain ticks
            self.draft_pool = PagedKVPool(
                dm.num_layers, cfg.num_pages, cfg.page_size, dm.num_heads,
                dm.d_model // dm.num_heads, dtype=dm.dtype,
                kv_quant=cfg.kv_quant, read="exact", device=self.device)
        elif draft_model is not None:
            raise ValueError("draft_model given but cfg.spec_k == 0: set "
                             "spec_k to the draft window size")
        # max_len always terminates the bucket ladder
        self.buckets = tuple(sorted({self.max_len, *(
            b for b in (cfg.prefill_buckets or _default_buckets(self.max_len))
            if b <= self.max_len)}))
        # sp prefill needs buckets whose shards hold whole pages: slot t
        # of the striped prompt lives on device (t * page_size) // shard
        self.sp_buckets: Tuple[int, ...] = ()
        if cfg.sp_prefill_threshold > 0:
            if mesh is None:
                raise ValueError("sp_prefill_threshold > 0 needs "
                                 "ServeEngine(mesh=...) with the "
                                 f"{SP_AXIS!r} axis")
            step = self.sp_n * cfg.page_size
            if self.max_len % step:
                raise ValueError(
                    f"sp prefill needs max_len ({self.max_len}) divisible "
                    f"by sp devices x page_size ({self.sp_n} x "
                    f"{cfg.page_size}) so every prompt has an sp bucket")
            self.sp_buckets = tuple(b for b in self.buckets if b % step == 0)
        self.slots: List[Optional[_Slot]] = [None] * cfg.max_slots
        self.queue: Deque[Tuple[DecodeRequest, float]] = deque()
        self._now = now_fn
        self._gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        if mesh is not None and not mesh.is_main:
            ledger = tracer = None    # the main rank writes the record
        self.ledger = ledger
        self.tracer = tracer
        if self.tracer is None and ledger is not None:
            self.tracer = RequestTracer(ledger, job_id="serve", attempt=0)
        self.pool.bind_trace(self.tracer, self._now)
        self.ticks = 0
        self.completed = 0
        self.rejected = 0
        self.prefills = 0
        self.sp_prefills = 0
        self.chunk_ticks = 0
        self.prefill_token_work = 0
        # speculative accounting: tokens emitted per active-slot tick
        # (accepted_per_tick = spec_emitted / spec_slot_ticks)
        self.spec_emitted = 0
        self.spec_slot_ticks = 0
        # host wall seconds in page programs, each up to its result's sync
        # (prefill and chunks incl. the first-token read; ticks incl. the
        # per-tick token read): the split of where a run's time went
        self.prefill_s = 0.0
        self.tick_s = 0.0
        self.prompt_pages = 0
        self.shared_prompt_pages = 0
        self._occupancy_sum = 0.0
        self._wait_ema: Optional[float] = None
        self._wait_samples = 0
        # under a mesh: this step's queue waits, observed once summed
        self._pending_waits: List[float] = []
        self._in_breach = False
        self.shedding = False
        self._last_kv_tick = 0
        self._t_start = self._now()
        self.draining = False
        self._drained = False
        self._preempt_event = threading.Event()
        self._preempt_synced = False
        self._prev_sigterm = None
        # the page programs under the audit's recompile sentry (no-ops
        # when it is off): prefill specializes per bucket
        register_audit_program("serve_prefill", allowed=len(self.buckets))
        register_audit_program("serve_sp_prefill",
                               allowed=max(len(self.sp_buckets), 1))
        for name in ("serve_chunk_prefill", "serve_chunk_sample",
                     "serve_tick", "serve_spec_tick"):
            register_audit_program(name)

    # -- admission --------------------------------------------------------
    def submit(self, req: DecodeRequest) -> bool:
        """Queue one request; False = rejected by admission control."""
        now = self._now()
        prompt_len = int(np.asarray(req.prompt).size)
        total = prompt_len + req.max_new_tokens
        if prompt_len < 1 or req.max_new_tokens < 1 or total > self.max_len:
            self._emit_admit(req, now, False, "too_long")
            return False
        if self.pool.pages_needed(total) > self.pool.num_pages:
            self._emit_admit(req, now, False, "exceeds_pool")
            return False
        if self.draining:
            self._emit_admit(req, now, False, "shed")
            return False
        if self.shedding:
            self._emit_admit(req, now, False, "slo_shedding")
            return False
        if len(self.queue) >= self.cfg.queue_depth_max:
            self._emit_admit(req, now, False, "queue_full")
            return False
        free_frac = self.pool.pages_free / max(self.pool.num_pages, 1)
        if free_frac < self.cfg.free_page_watermark:
            self._emit_admit(req, now, False, "page_watermark")
            return False
        self.queue.append((req, now))
        self._emit_admit(req, now, True, None)
        return True

    def _emit_admit(self, req, now, accepted, reason, enq_ts=None):
        if not accepted:
            self.rejected += 1
        if self.ledger is None:
            return
        self.ledger.emit("admit", rid=req.rid, accepted=accepted,
                         queue_depth=len(self.queue),
                         pages_free=self.pool.pages_free,
                         reason=reason, tenant=req.tenant,
                         ts_engine=round(now, 6))
        if accepted or self.tracer is None:
            return
        # every rejection is a 'shed' span: zero-length at the door,
        # enqueue->now for a queued request shed by drain
        tr = self.tracer
        tid, sid, par = tr.ids(req.rid, "shed")
        tr.ledger.emit("span", trace_id=tid, span_id=sid, parent_id=par,
                       name="shed", rid=req.rid,
                       start=round(now if enq_ts is None else enq_ts, 6),
                       end=round(now, 6), reason=reason,
                       tenant=req.tenant, **tr.attrs())

    def _observe_wait(self, wait: float) -> None:
        a = self.cfg.slo_alpha
        self._wait_ema = (wait if self._wait_ema is None
                          else a * wait + (1 - a) * self._wait_ema)
        self._wait_samples += 1
        floor = self.cfg.slo_queue_wait_s
        if floor <= 0 or self._wait_samples < self.cfg.slo_min_samples:
            return
        if self._wait_ema > floor and not self._in_breach:
            self._in_breach = True
            self.shedding = True
            if self.ledger is not None:
                self.ledger.emit("slo", step=self.ticks, kind="queue_wait",
                                 value=round(self._wait_ema, 6), floor=floor,
                                 unit="s")
        elif self._wait_ema <= floor and self._in_breach:
            self._in_breach = False   # re-arm; resume admitting
            self.shedding = False

    def _sync_host(self) -> None:
        """Under a mesh, once a step: rank 0's queue waits of this step's
        admissions and its SIGTERM flag, summed over ``sp`` (the other
        ranks send zeros), so SLO shedding and the drain decide alike on
        every rank. Without a mesh the waits were observed as they came."""
        if self.sp_n == 1:
            return
        vals = torch.tensor([float(self._preempt_event.is_set()),
                             *self._pending_waits], dtype=torch.float64,
                            device=self.device)
        if self.sp_axis.index != 0:
            vals.zero_()
        vals = sum_bytes([vals], self.sp_axis.group)[0].tolist()
        self._preempt_synced = bool(vals[0])
        self._pending_waits = []
        for wait in vals[1:]:
            self._observe_wait(wait)

    def _preempted(self) -> bool:
        """Whether a SIGTERM asked for a drain (rank 0's, under a mesh)."""
        if self.sp_n == 1:
            return self._preempt_event.is_set()
        return self._preempt_synced

    def _decay_wait_if_idle(self) -> None:
        """While shedding with an empty queue the wait evidence is stale:
        one alpha-decay toward zero per iteration re-arms the hysteresis
        (otherwise a transient overload would shed forever)."""
        if not self.shedding or self.queue or self._wait_ema is None:
            return
        self._wait_ema *= (1 - self.cfg.slo_alpha)
        if self._wait_ema <= self.cfg.slo_queue_wait_s:
            self._in_breach = False
            self.shedding = False

    # -- the scheduler iteration -----------------------------------------
    def step(self) -> List[Completion]:
        """One iteration: evict finished sequences, admit + prefill from
        the queue, run at most one prefill chunk, then one decode tick.
        Returns the completions evicted this iteration."""
        completions = self._evict()
        with torch.inference_mode():
            self._admit()
            self._sync_host()
            self._chunk_tick()
            self._tick()
        self._decay_wait_if_idle()
        every = self.cfg.kv_event_every
        if (every > 0 and self.ticks % every == 0
                and self.ticks != self._last_kv_tick):
            self._last_kv_tick = self.ticks
            self._emit_kv_cache()
        return completions

    def run(self, requests=(), max_ticks: int = 100_000) -> List[Completion]:
        """Submit everything, then step until drained. A SIGTERM
        (:meth:`install_sigterm_drain`) switches to :meth:`drain`."""
        for req in requests:
            self.submit(req)
        out: List[Completion] = []
        while self.queue or any(s is not None for s in self.slots):
            if self._preempted() and not self.draining:
                out.extend(self.drain(reason="sigterm"))
                return out
            out.extend(self.step())
            if self.ticks > max_ticks:
                raise RuntimeError(
                    f"serve drain exceeded {max_ticks} ticks "
                    f"({len(self.queue)} queued, "
                    f"{sum(s is not None for s in self.slots)} active)")
        self._emit_kv_cache()
        return out

    # -- graceful shutdown ------------------------------------------------
    def install_sigterm_drain(self):
        """Route SIGTERM into a graceful drain at the next tick boundary
        (the handler only sets a flag). Main thread only; returns an
        uninstall callable."""
        prev = signal.signal(signal.SIGTERM,
                             lambda signum, frame: self._preempt_event.set())
        self._prev_sigterm = prev

        def uninstall():
            signal.signal(signal.SIGTERM, prev)
            self._prev_sigterm = None

        return uninstall

    def drain(self, reason: str = "sigterm", max_ticks: int = 100_000,
              emit_run_end: bool = True) -> List[Completion]:
        """Finish every in-flight sequence, shed the whole queue (``shed``
        admission records), free all pages, emit ``scale``/``run_end``.
        Idempotent; returns the in-flight sequences' completions."""
        if self._drained:
            return []
        self.draining = True
        shed = list(self.queue)
        self.queue.clear()
        now = self._now()
        for req, enq_ts in shed:
            self._emit_admit(req, now, False, "shed", enq_ts=enq_ts)
        out: List[Completion] = []
        t0_ticks = self.ticks
        while any(s is not None for s in self.slots):
            out.extend(self.step())
            if self.ticks - t0_ticks > max_ticks:
                raise RuntimeError(
                    f"graceful drain exceeded {max_ticks} ticks with "
                    f"{sum(s is not None for s in self.slots)} still active")
        self._drained = True
        self._emit_kv_cache()
        if self.ledger is not None:
            self.ledger.emit(
                "scale", action="drain", processes=1, epoch=None,
                reason=reason, shed=len(shed), finished=len(out))
            if emit_run_end:
                self.ledger.emit(
                    "run_end", steps=self.ticks,
                    seconds=round(self._now() - self._t_start, 6),
                    status="preempted", reason=reason,
                    completed=self.completed, rejected=self.rejected,
                    shed=len(shed))
        return out

    # -- page programs ----------------------------------------------------
    def _tensor(self, x, dtype=torch.int32):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    def _flat_bt(self, bts):
        """Block tables of page ids as the pool's flat rows, on device."""
        return self._tensor(self.pool.flat_block_table(bts))

    def _prefill_program(self, bt, length, shared_len, padded):
        """One admit's padded prompt: pages written for the live rows at
        or past ``shared_len``, first token sampled from the last live
        row's logits."""
        note_audit_dispatch("serve_prefill", bt, padded)
        bucket = padded.shape[1]
        valid = (torch.arange(bucket, device=self.device)[None, :]
                 >= shared_len)
        paged = {"layers": self.pool.layers(),
                 "block_tables": self._flat_bt(bt[None]),
                 "positions": self._tensor([0]),
                 "lengths": self._tensor([length]), "valid": valid,
                 "sp_mesh": self.sp_mesh}
        logits, _ = self.model(self._tensor(padded), paged=paged,
                               paged_prefill=True)
        return self._sample(logits[:, length - 1])[0]

    def _sp_prefill_program(self, bt, length, shared_len, padded):
        """The sequence-parallel prefill: this rank runs its contiguous
        shard of the padded prompt at its global positions with ring
        attention over ``sp``, writing its rows' K/V into its own pages
        (foreign rows of the local block table go to the local trash).
        The last live row's logits live on one shard: summed over ``sp``
        (the others send zeros), then sampled on every rank alike."""
        from tpu_dist_torch.ops.paged_attention import _sp_local_bt
        from tpu_dist_torch.parallel.ring_attention import ring_attention_fn

        note_audit_dispatch("serve_sp_prefill", bt, padded)
        ax = self.sp_axis
        lsh = padded.shape[1] // self.sp_n     # bucket % (n * ps) == 0
        start = ax.index * lsh
        _, local_bt = _sp_local_bt(self._flat_bt(bt[None]),
                                   self.pool.layers()[0].k.shape[0],
                                   ax.index)
        rows = start + torch.arange(lsh, device=self.device)[None, :]
        paged = {"layers": self.pool.layers(), "block_tables": local_bt,
                 "positions": self._tensor([start]),
                 "lengths": self._tensor([length]),
                 "valid": rows >= shared_len,
                 "attn_fn": ring_attention_fn(ax)}
        logits, _ = self.model(self._tensor(padded[:, start:start + lsh]),
                               pos_offset=start, paged=paged,
                               paged_prefill=True)
        last = logits[:, min(max(length - 1 - start, 0), lsh - 1)]
        if not start <= length - 1 < start + lsh:
            last = torch.zeros_like(last)
        return self._sample(sum_bytes([last], ax.group)[0])[0]

    def _tick_program(self, bts, tokens, positions):
        """One token per slot at its own position."""
        note_audit_dispatch("serve_tick", bts, tokens, positions)
        pos = self._tensor(positions)
        paged = {"layers": self.pool.layers(),
                 "block_tables": self._flat_bt(bts),
                 "positions": pos, "lengths": pos + 1,
                 "sp_mesh": self.sp_mesh}
        logits, _ = self.model(self._tensor(tokens)[:, None],
                               pos_offset=pos, paged=paged)
        return self._sample(logits[:, 0])

    def _chunk_program(self, bt, start, length, shared_len, tokens):
        """Rows [start, start + chunk) of a prompt, written and attended
        through the tick's per-row-position path; returns the last live
        row's logits (meaningful on the final chunk)."""
        note_audit_dispatch("serve_chunk_prefill", bt, tokens)
        chunk = tokens.shape[1]
        pos = self._tensor([start])
        rows = pos[:, None] + torch.arange(chunk, device=self.device)[None]
        valid = (rows < length) & (rows >= shared_len)
        paged = {"layers": self.pool.layers(),
                 "block_tables": self._flat_bt(bt[None]),
                 "positions": pos, "lengths": pos + chunk, "valid": valid,
                 "sp_mesh": self.sp_mesh}
        logits, _ = self.model(self._tensor(tokens), pos_offset=pos,
                               paged=paged)
        return logits[:, min(max(length - 1 - start, 0), chunk - 1)]

    def _draft_prefill_program(self, bt, length, shared_len, padded):
        """The draft's prompt pass: writes the draft arenas' prompt rows
        through the same block table the base prefill used (the pools share
        page indices) and drops the logits -- the first emitted token is
        the base's."""
        bucket = padded.shape[1]
        valid = (torch.arange(bucket, device=self.device)[None, :]
                 >= shared_len)
        paged = {"layers": self.draft_pool.layers(),
                 "block_tables": self._tensor(bt[None]),
                 "positions": self._tensor([0]),
                 "lengths": self._tensor([length]), "valid": valid}
        self.draft_model(self._tensor(padded), paged=paged,
                         paged_prefill=True)

    def _spec_tick_program(self, bts, tokens, positions, caps):
        """The speculative tick: ``k`` greedy draft steps over the draft
        arenas, then one (k+1)-wide base verify over the main arenas, and
        the accept/reject on the device. Returns (emitted (B, k), emit_n
        (B,)).

        Greedy emission rule (the reference's): with drafts d_1..d_k and
        base argmaxes g_0..g_k, ``a`` is the longest prefix with d_i ==
        g_{i-1}; emit d_1..d_a and the correction g_a when a < k (a + 1
        tokens), exactly d_1..d_k when a == k (no bonus token: its KV row
        is not in the draft arenas yet). Every emitted token is the base's
        greedy continuation, for any draft. Rows written past the accepted
        frontier stay invisible (per-row causal horizon) and the next tick
        overwrites them before any read, so a rejection needs no rollback.
        The ``caps`` write mask sends rows past a request's allocation to
        the trash page (a draft window can overrun a nearly done request).
        """
        note_audit_dispatch("serve_spec_tick", bts, tokens, positions, caps)
        k = self.cfg.spec_k
        bt = self._tensor(bts)
        tok = self._tensor(tokens)
        pos = self._tensor(positions)
        cap = self._tensor(caps)
        layers = self.draft_pool.layers()
        drafts = []
        t, p = tok, pos
        for _ in range(k):
            paged = {"layers": layers, "block_tables": bt, "positions": p,
                     "lengths": p + 1, "valid": (p < cap)[:, None]}
            logits, _ = self.draft_model(t[:, None], pos_offset=p,
                                         paged=paged)
            t = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            drafts.append(t)
            p = p + 1
        drafts = torch.stack(drafts, dim=1)                       # (B, k)
        # one multi-position verify: row b carries [t0, d1..dk] at
        # positions pos..pos+k, each read at its own causal horizon
        ver = torch.cat([tok[:, None], drafts], dim=1)            # (B, k+1)
        write_pos = pos[:, None] + torch.arange(k + 1, device=self.device,
                                                dtype=torch.int32)[None, :]
        paged = {"layers": self.pool.layers(), "block_tables": bt,
                 "positions": pos, "lengths": pos + k + 1,
                 "valid": write_pos < cap[:, None]}
        logits, _ = self.model(ver, pos_offset=pos, paged=paged)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)     # (B, k+1)
        matches = (drafts == greedy[:, :k]).to(torch.int32)
        a = torch.cumprod(matches, dim=1).sum(dim=1)              # (B,)
        emit_n = torch.clamp(a + 1, max=k)
        corr = torch.gather(greedy, 1, a[:, None])                # (B, 1)
        idx = torch.arange(k, device=self.device)[None, :]
        emitted = torch.where(idx < a[:, None], drafts, corr)     # (B, k)
        return emitted, emit_n

    def _sample(self, logits):
        c = self.cfg
        return _sample(logits, c.temperature, self._gen, c.top_k, c.top_p)

    # -- internals --------------------------------------------------------
    def _evict(self) -> List[Completion]:
        out = []
        for i, slot in enumerate(self.slots):
            if slot is None or not slot.done:
                continue
            self.pool.free(slot.pages)
            self.slots[i] = None
            n = slot.prompt_len + slot.generated
            comp = Completion(
                rid=slot.req.rid, tokens=slot.buf[:n].copy(),
                prompt_len=slot.prompt_len, n_generated=slot.generated,
                admit_ts=slot.admit_ts, start_ts=slot.start_ts,
                first_token_ts=slot.first_token_ts,
                finish_ts=slot.finish_ts)
            self.completed += 1
            out.append(comp)
            if self.ledger is not None:
                self.ledger.emit(
                    "request", rid=comp.rid, tokens=comp.n_generated,
                    queue_wait_s=round(comp.queue_wait_s, 6),
                    admit_ts=round(comp.admit_ts, 6),
                    first_token_ts=round(comp.first_token_ts, 6),
                    finish_ts=round(comp.finish_ts, 6),
                    prompt_len=comp.prompt_len,
                    tenant=slot.req.tenant,
                    ttft_s=round(comp.ttft_s, 6))
            if self.tracer is not None:
                # the root span, admit -> finish, emitted after its children
                tr = self.tracer
                tid, sid, par = tr.root_ids(comp.rid)
                tr.ledger.emit("span", trace_id=tid, span_id=sid,
                               parent_id=par, name="request", rid=comp.rid,
                               start=round(comp.admit_ts, 6),
                               end=round(comp.finish_ts, 6),
                               ttft_s=round(comp.ttft_s, 6),
                               queue_wait_s=round(comp.queue_wait_s, 6),
                               tokens=comp.n_generated,
                               prompt_len=comp.prompt_len,
                               tenant=slot.req.tenant, **tr.attrs())
        return out

    def _admit(self) -> None:
        if self.cfg.refill == "drain" and any(
                s is not None for s in self.slots):
            return  # static batching: refill only once the batch drained
        for i in range(len(self.slots)):
            if not self.queue:
                break
            if self.slots[i] is not None:
                continue
            req, enq_ts = self.queue[0]
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            p = prompt.size
            total_slots = self.pool.pages_needed(p + req.max_new_tokens)
            use_sp = (self.cfg.sp_prefill_threshold > 0
                      and p >= self.cfg.sp_prefill_threshold)
            use_chunk = (not use_sp and self.cfg.prefill_chunk > 0
                         and p > self.cfg.prefill_chunk)
            match = (self.pool.share_prefix(prompt, rid=req.rid)
                     if self.cfg.prefix_cache else None)
            # fresh pages: everything past the full-page hits (a frontier
            # hit reserves one fresh page as its copy-on-write target)
            n_fresh = total_slots - (match.full if match is not None else 0)
            sp_bucket = None
            if use_sp:
                # striped prompt pages: slot t's rows are written by the
                # rank whose shard covers them, so its page lives there;
                # shared slots stay where their writer put them (reads are
                # location-free), decode pages and the CoW reserve anywhere
                sp_bucket = next(b for b in self.sp_buckets if b >= p)
                shard = sp_bucket // self.sp_n
                shared_slots = len(match.pages) if match is not None else 0
                fresh = self.pool.alloc_for_slots(
                    [(t * self.cfg.page_size) // shard
                     for t in range(shared_slots, self.pool.pages_needed(p))])
                if fresh is not None:
                    rest = self.pool.alloc(n_fresh - len(fresh))
                    if rest is None:
                        self.pool.free(fresh)
                    fresh = None if rest is None else fresh + rest
            else:
                fresh = self.pool.alloc(n_fresh)
            if fresh is None:
                if match is not None:
                    self.pool.unshare(match)
                break  # pool pressure: leave it queued, decode on
            self.queue.popleft()
            now = self._now()
            if self.sp_n == 1:
                self._observe_wait(now - enq_ts)
            else:
                self._pending_waits.append(now - enq_ts)   # _sync_host
            if self.tracer is not None:
                tr = self.tracer
                tid, sid, par = tr.ids(req.rid, "queue")
                tr.ledger.emit("span", trace_id=tid, span_id=sid,
                               parent_id=par, name="queue", rid=req.rid,
                               start=round(enq_ts, 6), end=round(now, 6),
                               queue_depth=len(self.queue),
                               tenant=req.tenant, **tr.attrs())
            if use_chunk:
                self._begin_chunked(i, req, prompt, fresh, enq_ts, now,
                                    match)
            else:
                self._prefill(i, req, prompt, fresh, enq_ts, now, match,
                              sp_bucket)

    def _block_table(self, fresh, match):
        """(block table, bt pages, shared pages, shared_len, cow) of an
        admission: shared pages first; with a frontier hit the last fresh
        page is its reserved CoW destination."""
        shared = list(match.pages) if match is not None else []
        shared_len = match.cov if match is not None else 0
        cow = None
        if match is not None and match.partial:
            cow = (match.full, shared[-1], fresh[-1])
            bt_pages = shared + fresh[:-1]
        else:
            bt_pages = shared + fresh
        bt = np.full((self.max_pages_per_seq,), self.pool.num_pages,
                     np.int32)                       # unassigned -> trash
        bt[:len(bt_pages)] = bt_pages
        return bt, bt_pages, shared, shared_len, cow

    def _prefill(self, slot_idx, req, prompt, fresh, enq_ts, start_ts,
                 match: Optional[PrefixMatch] = None,
                 sp_bucket: Optional[int] = None):
        """A monolithic prefill, or with ``sp_bucket`` the same admission
        run sequence-parallel over that bucket
        (:meth:`_sp_prefill_program`)."""
        p = prompt.size
        bucket = sp_bucket or next(b for b in self.buckets if b >= p)
        bt, bt_pages, shared, shared_len, cow = self._block_table(fresh,
                                                                  match)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :p] = prompt
        t0 = time.perf_counter()
        program = (self._prefill_program if sp_bucket is None
                   else self._sp_prefill_program)
        tok = program(bt, p, shared_len, padded)
        if self.draft_pool is not None:
            # shared rows were written by the prefix owner's draft prefill
            self._draft_prefill_program(bt, p, shared_len, padded)
        tok = int(tok.item())
        self.prefill_s += time.perf_counter() - t0
        sp = {}
        if sp_bucket is None:
            self.prefill_token_work += bucket
        else:
            self.sp_prefills += 1
            # each rank runs bucket / n rows: the wait the scheduler paid
            self.prefill_token_work += bucket // self.sp_n
            sp = {"mode": "sp", "sp_devices": self.sp_n}
        if self.cfg.prefix_cache:
            self.pool.register_prefix(prompt, bt_pages,
                                      skip_slots=len(shared))
            self.prompt_pages += self.pool.pages_needed(p)
            self.shared_prompt_pages += len(shared)
        self.prefills += 1
        now = self._now()
        slot = _Slot(req=req, pages=shared + fresh, block_table=bt,
                     buf=np.zeros((p + req.max_new_tokens,), np.int32),
                     prompt_len=p, admit_ts=enq_ts, start_ts=start_ts,
                     position=p, generated=1, first_token_ts=now,
                     cow_pending=cow, win_start_ts=now)
        slot.buf[:p] = prompt
        slot.buf[p] = tok
        if (slot.generated >= req.max_new_tokens
                or tok == self.cfg.eos_id):
            slot.done = True
            slot.finish_ts = now
        self.slots[slot_idx] = slot
        if self.tracer is not None:
            tr = self.tracer
            tid, sid, par = tr.ids(req.rid, "prefill")
            tr.ledger.emit("span", trace_id=tid, span_id=sid,
                           parent_id=par, name="prefill", rid=req.rid,
                           start=round(start_ts, 6), end=round(now, 6),
                           **sp, bucket=bucket, prompt_len=p,
                           pages_fresh=len(fresh),
                           pages_shared=len(shared),
                           shared_len=shared_len, cow=cow is not None,
                           tenant=req.tenant, **tr.attrs())

    # -- chunked prefill ---------------------------------------------------
    def _begin_chunked(self, slot_idx, req, prompt, fresh, enq_ts, start_ts,
                       match: Optional[PrefixMatch] = None):
        """Admit a long prompt without running its prefill: the slot parks
        with ``chunk_next >= 0`` (outside the tick's active set) and
        :meth:`_chunk_tick` feeds it one chunk per iteration; the first
        token, prefix registration and the prefill span land on the final
        chunk."""
        p = prompt.size
        chunk = self.cfg.prefill_chunk
        bt, _, shared, shared_len, cow = self._block_table(fresh, match)
        slot = _Slot(req=req, pages=shared + fresh, block_table=bt,
                     buf=np.zeros((p + req.max_new_tokens,), np.int32),
                     prompt_len=p, admit_ts=enq_ts, start_ts=start_ts,
                     position=p, generated=0, cow_pending=cow,
                     # start at the chunk holding the first non-shared row
                     chunk_next=min(shared_len, p - 1) // chunk * chunk,
                     shared_len=shared_len,
                     n_fresh=len(fresh), n_shared=len(shared))
        slot.buf[:p] = prompt
        self.slots[slot_idx] = slot

    def _chunk_tick(self) -> None:
        """At most one prefill chunk per iteration, lowest slot first."""
        for s in self.slots:
            if s is not None and not s.done and s.chunk_next >= 0:
                self._run_chunk(s)
                return

    def _run_chunk(self, s: _Slot) -> None:
        cfg = self.cfg
        chunk = cfg.prefill_chunk
        p = s.prompt_len
        start = s.chunk_next
        tokens = np.zeros((1, chunk), np.int32)
        seg = s.buf[start:min(start + chunk, p)]
        tokens[0, :seg.size] = seg
        t0 = time.perf_counter()
        last = self._chunk_program(s.block_table, start, p, s.shared_len,
                                   tokens)
        self.chunk_ticks += 1
        self.prefill_token_work += chunk
        if start + chunk < p:
            self.prefill_s += time.perf_counter() - t0
            s.chunk_next = start + chunk
            return
        # final chunk: the prompt is resident -- sample the first token
        s.chunk_next = -1
        note_audit_dispatch("serve_chunk_sample", last)
        tok = self._sample(last)[0]
        if self.draft_pool is not None:
            # the draft's prompt pass stays monolithic, as in the reference
            bucket = next(b for b in self.buckets if b >= p)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :p] = s.buf[:p]
            self._draft_prefill_program(s.block_table, p, s.shared_len,
                                        padded)
        tok = int(tok.item())
        self.prefill_s += time.perf_counter() - t0
        if cfg.prefix_cache:
            bt_pages = [int(x) for x in s.block_table
                        if int(x) < self.pool.num_pages]
            self.pool.register_prefix(s.buf[:p], bt_pages,
                                      skip_slots=s.n_shared)
            self.prompt_pages += self.pool.pages_needed(p)
            self.shared_prompt_pages += s.n_shared
        self.prefills += 1
        now = self._now()
        s.buf[p] = tok
        s.generated = 1
        s.first_token_ts = now
        s.win_start_ts = now
        if s.generated >= s.req.max_new_tokens or tok == cfg.eos_id:
            s.done = True
            s.finish_ts = now
        if self.tracer is not None:
            tr = self.tracer
            tid, sid, par = tr.ids(s.req.rid, "prefill")
            first = min(s.shared_len, p - 1) // chunk * chunk
            tr.ledger.emit("span", trace_id=tid, span_id=sid,
                           parent_id=par, name="prefill", rid=s.req.rid,
                           start=round(s.start_ts, 6), end=round(now, 6),
                           mode="chunked", chunk=chunk,
                           chunks=-(-(p - first) // chunk),
                           prompt_len=p, pages_fresh=s.n_fresh,
                           pages_shared=s.n_shared,
                           shared_len=s.shared_len,
                           cow=s.cow_pending is not None,
                           tenant=s.req.tenant, **tr.attrs())

    def _resolve_cow(self, active) -> None:
        """Fork every pending shared frontier page before this tick's
        writes (in both pools when speculating: their arenas mirror page
        indices); the forking sequence swaps its block-table entry."""
        for _i, s in active:
            if s.cow_pending is None:
                continue
            bt_slot, src, dst = s.cow_pending
            self.pool.fork_page(src, dst, rid=s.req.rid)
            if self.draft_pool is not None:
                cow_fork_pages(self.draft_pool.layers(), [src], [dst])
            s.block_table[bt_slot] = dst
            s.pages.remove(src)
            s.cow_pending = None

    def _tick(self) -> None:
        # a slot mid-chunked-prefill has no token to decode yet
        active = [(i, s) for i, s in enumerate(self.slots)
                  if s is not None and not s.done and s.chunk_next < 0]
        if not active:
            return
        self._resolve_cow(active)
        if self.cfg.spec_k > 0:
            return self._tick_spec(active)
        n = len(self.slots)
        tokens = np.zeros((n,), np.int32)
        positions = np.zeros((n,), np.int32)
        bts = np.full((n, self.max_pages_per_seq), self.pool.num_pages,
                      np.int32)
        for i, s in active:
            tokens[i] = s.buf[s.prompt_len + s.generated - 1]
            positions[i] = s.position
            bts[i] = s.block_table
        # one sync per tick: the scheduler's eviction/refill decision point
        t0 = time.perf_counter()
        nxt = self._tick_program(bts, tokens, positions).cpu().numpy()
        self.tick_s += time.perf_counter() - t0
        now = self._now()
        for i, s in active:
            tok = int(nxt[i])
            s.buf[s.prompt_len + s.generated] = tok
            s.generated += 1
            s.position += 1
            if (s.generated >= s.req.max_new_tokens
                    or tok == self.cfg.eos_id):
                s.done = True
                s.finish_ts = now
            self._note_decode(s, now, tokens=1)
        self.ticks += 1
        self._occupancy_sum += len(active) / max(len(self.slots), 1)

    def _tick_spec(self, active) -> None:
        """One speculative iteration: k draft proposals and one base verify
        per active slot (:meth:`_spec_tick_program`), then host-side
        emission with each slot's budget and eos truncation -- the same one
        sync per tick as the plain tick, now worth up to k tokens."""
        n = len(self.slots)
        k = self.cfg.spec_k
        tokens = np.zeros((n,), np.int32)
        positions = np.zeros((n,), np.int32)
        caps = np.zeros((n,), np.int32)
        bts = np.full((n, self.max_pages_per_seq), self.pool.num_pages,
                      np.int32)
        for i, s in active:
            tokens[i] = s.buf[s.prompt_len + s.generated - 1]
            positions[i] = s.position
            caps[i] = s.prompt_len + s.req.max_new_tokens
            bts[i] = s.block_table
        t0 = time.perf_counter()
        emitted, emit_n = self._spec_tick_program(bts, tokens, positions,
                                                  caps)
        emitted = emitted.cpu().numpy()
        emit_n = emit_n.cpu().numpy()
        self.tick_s += time.perf_counter() - t0
        now = self._now()
        for i, s in active:
            took = 0
            for j in range(int(emit_n[i])):
                tok = int(emitted[i, j])
                s.buf[s.prompt_len + s.generated] = tok
                s.generated += 1
                s.position += 1
                self.spec_emitted += 1
                took += 1
                if (s.generated >= s.req.max_new_tokens
                        or tok == self.cfg.eos_id):
                    s.done = True
                    s.finish_ts = now
                    break
            self.spec_slot_ticks += 1
            self._note_decode(s, now, tokens=took, drafted=k)
        self.ticks += 1
        self._occupancy_sum += len(active) / max(len(self.slots), 1)

    def _note_decode(self, s: _Slot, now: float, tokens: int,
                     drafted: int = 0) -> None:
        """Advance the slot's decode window; close it into a ``decode``
        span every ``trace_window_ticks`` ticks and at finish (windows
        share boundaries, so they tile first token -> finish)."""
        if self.tracer is None:
            return
        s.win_ticks += 1
        s.win_tokens += tokens
        s.win_drafted += drafted
        if not s.done and s.win_ticks < max(self.cfg.trace_window_ticks, 1):
            return
        tr = self.tracer
        tid, sid, par = tr.ids(s.req.rid, "decode")
        tr.ledger.emit("span", trace_id=tid, span_id=sid, parent_id=par,
                       name="decode", rid=s.req.rid,
                       start=round(s.win_start_ts, 6), end=round(now, 6),
                       ticks=s.win_ticks, tokens=s.win_tokens,
                       spec_drafted=s.win_drafted, **tr.attrs())
        s.win_start_ts = now
        s.win_ticks = s.win_tokens = s.win_drafted = 0

    def _emit_kv_cache(self) -> None:
        # serving's drain boundary: the recompile sentry's host-side read
        # rides the pressure snapshot (PL005)
        check_audit_sentry()
        if self.ledger is None:
            return
        st = self.pool.stats()
        self.ledger.emit("kv_cache", pages_free=st["pages_free"],
                         pages_used=st["pages_used"],
                         active_seqs=sum(s is not None for s in self.slots),
                         pages_total=st["pages_total"],
                         high_water_used=st["high_water_used"],
                         shared_pages=st["shared_pages"],
                         cow_copies=st["cow_copies"],
                         prefix_hits=st["prefix_hits"],
                         spec_emitted=self.spec_emitted,
                         spec_slot_ticks=self.spec_slot_ticks,
                         sharded_devices=st["sharded_devices"],
                         chunks_pending=self.chunks_pending,
                         chunk_ticks=self.chunk_ticks,
                         slots=len(self.slots), tick=self.ticks)

    # -- introspection ----------------------------------------------------
    @property
    def occupancy(self) -> float:
        """Mean active-slot share across decode ticks."""
        return self._occupancy_sum / self.ticks if self.ticks else 0.0

    @property
    def accepted_per_tick(self) -> Optional[float]:
        """Mean tokens emitted per active-slot tick under speculation
        (None for plain decode, where it is 1.0 by construction)."""
        if not self.spec_slot_ticks:
            return None
        return self.spec_emitted / self.spec_slot_ticks

    @property
    def chunks_pending(self) -> int:
        """Prefill chunks still owed to parked slots."""
        c = self.cfg.prefill_chunk
        if c <= 0:
            return 0
        return sum(-(-(s.prompt_len - s.chunk_next) // c)
                   for s in self.slots
                   if s is not None and s.chunk_next >= 0)

    @property
    def prefix_hit_rate(self) -> Optional[float]:
        """Share of prompt pages served from the prefix cache (None until
        a prefix-cached prompt is admitted)."""
        if not self.prompt_pages:
            return None
        return self.shared_prompt_pages / self.prompt_pages

    def stats(self) -> dict:
        apt = self.accepted_per_tick
        phr = self.prefix_hit_rate
        return {"ticks": self.ticks, "completed": self.completed,
                "rejected": self.rejected, "prefills": self.prefills,
                "sp_prefills": self.sp_prefills,
                "chunk_ticks": self.chunk_ticks,
                "chunks_pending": self.chunks_pending,
                "prefill_token_work": self.prefill_token_work,
                "prefill_s": round(self.prefill_s, 6),
                "tick_s": round(self.tick_s, 6),
                "occupancy": round(self.occupancy, 6),
                "spec_k": self.cfg.spec_k,
                "spec_emitted": self.spec_emitted,
                "spec_slot_ticks": self.spec_slot_ticks,
                "accepted_per_tick": (None if apt is None
                                      else round(apt, 6)),
                "prompt_pages": self.prompt_pages,
                "shared_prompt_pages": self.shared_prompt_pages,
                "prefix_hit_rate": (None if phr is None
                                    else round(phr, 6)),
                "pages_per_request": (
                    round(self.pool.alloc_total / self.completed, 6)
                    if self.completed else None),
                "queue_depth": len(self.queue),
                "active_seqs": sum(s is not None for s in self.slots),
                "wait_ema_s": self._wait_ema,
                "shedding": self.shedding,
                "draining": self.draining,
                **self.pool.stats()}
