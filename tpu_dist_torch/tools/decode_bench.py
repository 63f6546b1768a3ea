"""Decode throughput for the port: the one-shot ``generate`` bench and the
request-trace replay (the port of ``tools/decode_bench.py``).

One-shot mode (the default, ``--trace 0``; reference ``:475-501,
677-796``): a (``--batch``, ``--prompt-len``) random prompt is continued
by ``--steps`` tokens through ``engine.generate`` twice, with the KV cache
(one batched prefill, then one-token ticks that attend over the cache)
and by full recompute (the whole prefix re-run every tick;
``--skip-full`` leaves it out), each the best of ``--trials`` after a
warm call; then ``--requests`` sequential warm cached calls are timed as
requests, with nearest-rank p50/p99 latency. A line on stderr says
whether the two greedy outputs are identical (informational: with random
weights the 32k-way logits have near-ties). The last stdout line is one
JSON object with the reference's keys under the port's metric name
``torch_lm_decode_tokens_per_sec``, and the device it ran on. Completion
is forced with ``torch.cuda.synchronize()``. ``--attn flash`` runs the
full recompute's attention through the flash kernel; the cached decode
attends exactly over its cache in both packages.

Trace mode (``--trace N > 0``, the throughput-under-load benchmark): N
requests with seeded Poisson arrivals (in scheduler-tick units) and mixed
prompt/output lengths stream through the port's continuous-batching
``ServeEngine``, and the same trace replays through static batching
(drain refill) at equal slot capacity. The last stdout line is one JSON
object whose ``serving`` block has the reference's keys (requests/s and
tokens/s on the wall clock, requests per tick, TTFT and per-output-token
latency p50/p99, occupancy, ``accepted_per_tick``, the static baseline,
with ``--prefix-tenants`` the cache-off baseline, and the
``tail_attribution`` block of the request observatory over the continuous
replay's spans), plus the device it ran on. ``--waterfalls N`` prints the
N slowest requests' span trees to stderr.

``--attn flash`` serves with the flash prefill kernel, ``--kv-quant int8
--attn-read flash`` decodes through the int8-KV paged decode kernel,
``--serve-quant int8`` runs every dense layer through the fused int8
kernel, ``--spec-k K`` decodes speculatively (self-speculation: the base
drafts for itself). A warm replay (discarded) runs first.

Long-context mode (``--long-context PATH``, e.g.
``tools/traces/longcontext_mix.json``, or ``--prompt-len-dist
LEN:WEIGHT,...`` to draw one): mixed short and book-length traffic
replays through chunked prefill (``--prefill-chunk``) under a virtual
cost-model clock (each scheduler step costs ``tick_floor`` plus its
prefill tokens), then the same trace without its long prompts as the
interference baseline; ``--long-monolithic`` adds the unchunked contrast
and ``--sp-capacity N`` serves one context longer than a device's page
budget on N ranks of an ``sp`` mesh (spawned as ``--tp`` spawns its
ranks; geometry-tiny, as in the reference). The JSON's ``serving`` block
has the reference's keys (``ttft_long_p99``, ``tpot_interference_pct``
and the rest, in virtual token-equivalents) under the port's metric name
``torch_lm_longcontext_serving``, plus ``runs``: each replay's ticks,
prefills and wall seconds.

``--tp N`` / ``--dp N`` (one-shot mode) decode over a ``data=dp,
model=tp`` mesh through ``engine.generate(mesh=)``, one process per
device: the bench starts ``dp x tp`` copies of itself through
``parallel.launch`` (as the cookbook scripts start theirs) unless it is
one of them already; ``--backend gloo`` puts CUDA tensors on gloo (ranks
sharing one card). Every rank decodes; rank 0 prints the JSON line, with
``tp`` and ``dp`` in it. Usage::

    python -m tpu_dist_torch.tools.decode_bench --attn flash   # one-shot
    python -m tpu_dist_torch.tools.decode_bench --trace 64 \\
        --kv-quant int8 --attn-read flash --attn flash \\
        --serve-quant int8 --spec-k 4 --waterfalls 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _pctl(xs, q):
    """Nearest-rank percentile of a sorted list (``tools/ledger_report``'s
    convention, kept here so the port needs nothing of the reference)."""
    if not xs:
        return None
    return xs[min(int(round(q / 100.0 * (len(xs) - 1))), len(xs) - 1)]


def _pctl_ms(xs, q):
    v = _pctl(sorted(xs), q)
    return None if v is None else round(v * 1e3, 3)


def _drive_trace(eng, arrivals, prompts, outs):
    """Replay one arrival schedule: requests are submitted when the loop
    iteration reaches their arrival tick. Returns (completions, wall s)."""
    from tpu_dist_torch.engine.serve import DecodeRequest

    n = len(prompts)
    i = 0
    wall_tick = 0
    comps = []
    t0 = time.perf_counter()
    while i < n or eng.queue or any(s is not None for s in eng.slots):
        while i < n and arrivals[i] <= wall_tick:
            eng.submit(DecodeRequest(i, prompts[i], int(outs[i])))
            i += 1
        comps.extend(eng.step())
        wall_tick += 1
        if wall_tick > 1_000_000:
            raise RuntimeError("trace replay did not drain")
    return comps, time.perf_counter() - t0


class _VirtualClock:
    """The long-context replay's engine clock: one unit is one
    token-equivalent of scheduler-step cost. Each step costs the tick
    floor plus the prefill tokens it pushed (the engine's
    ``prefill_token_work`` delta), so the numbers are schedule arithmetic,
    the same on any machine."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive_longcontext(eng, clock, reqs, floor):
    """Replay a long-context trace under the virtual clock: arrivals in
    scheduler-iteration units, the clock advanced by ``floor`` plus the
    iteration's prefill-token work after every step."""
    from tpu_dist_torch.engine.serve import DecodeRequest

    n = len(reqs)
    i = 0
    it = 0
    comps = []
    while i < n or eng.queue or any(s is not None for s in eng.slots):
        while i < n and reqs[i]["arrival"] <= it:
            eng.submit(DecodeRequest(i, reqs[i]["prompt"],
                                     int(reqs[i]["out_len"])))
            i += 1
        work0 = eng.prefill_token_work
        comps.extend(eng.step())
        clock.t += floor + (eng.prefill_token_work - work0)
        it += 1
        if it > 1_000_000:
            raise RuntimeError("long-context replay did not drain")
    return comps


def long_context_trace(args, trace=None):
    """The long-context trace: ``trace`` as given, else the file of
    ``--long-context``, else drawn from ``--prompt-len-dist`` (weighted
    prompt lengths, seeded Poisson arrivals, ``--min-out``/``--max-out``),
    as the reference draws it."""
    import numpy as np

    if trace is None and args.long_context:
        with open(args.long_context) as f:
            trace = json.load(f)
    if trace is not None:
        return trace
    pairs = [p.split(":") for p in args.prompt_len_dist.split(",")]
    lens = np.array([int(n) for n, _ in pairs])
    weights = np.array([float(w) for _, w in pairs], dtype=float)
    weights = weights / weights.sum()
    count = args.trace or 32
    rng = np.random.default_rng(args.trace_seed)
    gaps = rng.exponential(1.0 / max(args.arrival_rate, 1e-9), count)
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    plens = rng.choice(lens, size=count, p=weights)
    outs = rng.integers(args.min_out, args.max_out + 1, count)
    return {"seed": args.trace_seed, "tick_floor": args.tick_floor,
            "long_threshold": args.long_threshold,
            "requests": [{"arrival": int(a), "prompt_len": int(p),
                          "out_len": int(o)}
                         for a, p, o in zip(arrivals, plens, outs)]}


def replay_long_context(args, model, trace=None):
    """The ``serving`` block of the long-context mode (module docstring),
    on one device: the trace through chunked prefill, the same trace
    without its long prompts (the baseline of ``tpot_interference_pct``)
    and, with ``--long-monolithic``, through monolithic prefill. The
    ``--sp-capacity`` proof is :func:`sp_capacity_proof`."""
    import numpy as np

    from tpu_dist_torch.engine.serve import ServeConfig, ServeEngine

    trace = long_context_trace(args, trace)
    floor = trace["tick_floor"]
    thr = trace["long_threshold"]
    rng = np.random.default_rng(trace["seed"])
    reqs = [dict(r) for r in trace["requests"]]
    for r in reqs:
        # token content drawn in trace order from the trace seed
        r["prompt"] = rng.integers(0, args.vocab_size,
                                   (r["prompt_len"],)).astype(np.int32)
    max_total = max(r["prompt_len"] + r["out_len"] for r in reqs)
    pages_per_seq = -(-max_total // args.page_size)
    num_pages = args.num_pages or args.serve_slots * pages_per_seq
    runs = {}

    def run(name, subset, chunk):
        clock = _VirtualClock()
        eng = ServeEngine(model, ServeConfig(
            max_slots=args.serve_slots, page_size=args.page_size,
            num_pages=num_pages, max_len=max_total,
            quant=args.serve_quant, kv_quant=args.kv_quant,
            attn_read=args.attn_read, prefill_chunk=chunk), now_fn=clock,
            device=model.device)
        t0 = time.perf_counter()
        comps = _drive_longcontext(eng, clock, subset, floor)
        if model.device.type == "cuda":
            import torch

            torch.cuda.synchronize(model.device)
        runs[name] = {"ticks": eng.ticks, "prefills": eng.prefills,
                      "chunk_ticks": eng.chunk_ticks,
                      "completed": len(comps),
                      "wall_s": time.perf_counter() - t0}
        return comps, eng

    def p99(xs):
        v = _pctl(sorted(xs), 99)
        return None if v is None else round(v, 3)

    def short_tpots(comps, subset):
        return [(c.finish_ts - c.first_token_ts) / (c.n_generated - 1)
                for c in comps if c.n_generated > 1
                and subset[c.rid]["prompt_len"] < thr]

    chunk = args.prefill_chunk
    comps, eng = run("chunked", reqs, chunk)
    ttft_long = [c.ttft_s for c in comps
                 if reqs[c.rid]["prompt_len"] >= thr]
    tpot_mixed = p99(short_tpots(comps, reqs))
    shorts_only = [r for r in reqs if r["prompt_len"] < thr]
    base_comps, _ = run("baseline", shorts_only, chunk)
    tpot_base = p99(short_tpots(base_comps, shorts_only))
    interference = (None if not tpot_base or tpot_mixed is None
                    else round((tpot_mixed - tpot_base) / tpot_base * 100,
                               2))
    serving = {
        "mode": "long_context",
        "requests": len(reqs),
        "long_requests": len(reqs) - len(shorts_only),
        "completed": len(comps),
        "ticks": eng.ticks, "chunk_ticks": eng.chunk_ticks,
        "requests_per_tick": round(len(comps) / max(eng.ticks, 1), 4),
        "prefill_token_work": eng.prefill_token_work,
        "prefill_chunk": chunk, "tick_floor": floor,
        "long_threshold": thr,
        "trace_seed": trace["seed"],
        "slots": args.serve_slots, "page_size": args.page_size,
        "num_pages": num_pages, "kv_quant": args.kv_quant,
        "attn_read": args.attn_read,
        "occupancy": round(eng.occupancy, 4),
        # virtual token-equivalents throughout (_VirtualClock)
        "ttft_long_p99": p99(ttft_long),
        "tpot_short_p99": tpot_mixed,
        "tpot_baseline_p99": tpot_base,
        "tpot_interference_pct": interference,
    }
    print(f"serve[long-context]: {len(comps)}/{len(reqs)} completed "
          f"({serving['long_requests']} long >= {thr} tok) in {eng.ticks} "
          f"ticks + {eng.chunk_ticks} chunk ticks; TTFT-long p99 "
          f"{serving['ttft_long_p99']}, short-TPOT interference "
          f"{interference}% (chunk {chunk}, floor {floor})",
          file=sys.stderr)
    if args.long_monolithic:
        # the unchunked contrast: the full-prompt stall lands in every
        # concurrent short request's TPOT
        mono_comps, mono_eng = run("monolithic", reqs, 0)
        mono_p99 = p99(short_tpots(mono_comps, reqs))
        serving["monolithic"] = {
            "tpot_short_p99": mono_p99,
            "tpot_interference_pct": (
                None if not tpot_base or mono_p99 is None
                else round((mono_p99 - tpot_base) / tpot_base * 100, 2)),
            "ticks": mono_eng.ticks,
        }
        print(f"serve[long-context]: monolithic contrast interference "
              f"{serving['monolithic']['tpot_interference_pct']}%",
              file=sys.stderr)
    serving["runs"] = runs
    return serving


def sp_capacity_proof(args, model, mesh, seed: int) -> dict:
    """``--sp-capacity N``: on an ``sp`` mesh of N ranks (every rank calls
    it), a per-device budget of 2 pages of 4 tokens and one prompt of 5N
    + 1 tokens with N + 2 to generate, sp-prefilled and served whole: a
    context longer than one device holds (the reference's tiny geometry).
    Returns the ``sp_capacity`` block."""
    import numpy as np

    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)

    n = mesh.shape["sp"]
    ps = 4
    eng = ServeEngine(model, ServeConfig(
        max_slots=1, page_size=ps, num_pages=2 * n, max_len=8 * n,
        quant=args.serve_quant, sp_prefill_threshold=ps + 1), mesh=mesh)
    plen, out_len = 5 * n + 1, n + 2
    prompt = np.random.default_rng(seed).integers(
        0, args.vocab_size, (plen,)).astype(np.int32)
    comps = eng.run([DecodeRequest(0, prompt, out_len)])
    budget = eng.pool.pages_per_device * ps
    block = {"devices": n, "page_size": ps,
             "pages_per_device": eng.pool.pages_per_device,
             "device_token_budget": budget,
             "context_tokens": plen + out_len,
             "exceeds_single_device": plen + out_len > budget,
             "completed": len(comps), "sp_prefills": eng.sp_prefills}
    print(f"serve[long-context]: sp capacity -- {plen + out_len}-token "
          f"context on {n} devices of {budget}-token budget each "
          f"({len(comps)} completed)", file=sys.stderr)
    return block


def replay_serving_trace(args, model, ledger=None):
    """The ``serving`` block: continuous vs static (and, with prefix
    tenants, cache-off) replays of one seeded trace."""
    import numpy as np

    from tpu_dist_torch.engine.serve import ServeConfig, ServeEngine
    from tpu_dist_torch.obs import reqtrace
    from tpu_dist_torch.obs.ledger import Ledger
    from tpu_dist_torch.tools.request_report import (requests_summary,
                                                     slowest_traces,
                                                     waterfall_lines)

    rng = np.random.default_rng(args.trace_seed)
    gaps = rng.exponential(1.0 / max(args.arrival_rate, 1e-9), args.trace)
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    prompts = [rng.integers(0, args.vocab_size,
                            (int(rng.integers(args.min_prompt,
                                              args.max_prompt + 1)),)
                            ).astype(np.int32)
               for _ in range(args.trace)]
    outs = rng.integers(args.min_out, args.max_out + 1, args.trace)
    prefix_on = args.prefix_tenants > 0
    prefix_len = args.prefix_len if prefix_on else 0
    if prefix_on:
        tenants = [rng.integers(0, args.vocab_size,
                                (args.prefix_len,)).astype(np.int32)
                   for _ in range(args.prefix_tenants)]
        tenant_of = rng.integers(0, args.prefix_tenants, args.trace)
        prompts = [np.concatenate([tenants[tenant_of[j]], prompts[j]])
                   for j in range(args.trace)]
    max_total = prefix_len + args.max_prompt + args.max_out
    pages_per_seq = -(-max_total // args.page_size)
    num_pages = args.num_pages or args.serve_slots * pages_per_seq

    def make(refill, led=None, prefix_cache=prefix_on):
        return ServeEngine(model, ServeConfig(
            max_slots=args.serve_slots, page_size=args.page_size,
            num_pages=num_pages, max_len=max_total,
            quant=args.serve_quant, kv_quant=args.kv_quant,
            attn_read=args.attn_read, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p, refill=refill,
            spec_k=args.spec_k, prefix_cache=prefix_cache,
            kv_event_every=32), ledger=led, device=model.device)

    _drive_trace(make("continuous"), arrivals, prompts, outs)  # warm
    # the continuous replay always captures its spans: they feed the
    # tail_attribution block and --waterfalls without needing --ledger
    span_cap = []
    cont_led = ledger if ledger is not None else Ledger(None)
    cont_led.add_sink(span_cap.append)
    results = {}
    modes = [("continuous", True), ("drain", True)]
    if prefix_on:
        modes.append(("no_prefix_cache", False))
    for refill, prefix_cache in modes:
        eng = make("continuous" if refill == "no_prefix_cache" else refill,
                   led=cont_led if refill == "continuous" else None,
                   prefix_cache=prefix_cache)
        comps, elapsed = _drive_trace(eng, arrivals, prompts, outs)
        ttft = [c.ttft_s for c in comps]
        tpot = [(c.finish_ts - c.first_token_ts) / (c.n_generated - 1)
                for c in comps if c.n_generated > 1]
        waits = [c.queue_wait_s for c in comps]
        toks = sum(c.n_generated for c in comps)
        apt = eng.accepted_per_tick
        results[refill] = {
            "completed": len(comps), "rejected": eng.rejected,
            "ticks": eng.ticks,
            "requests_per_tick": (round(len(comps) / eng.ticks, 4)
                                  if eng.ticks else None),
            "requests_per_sec": (round(len(comps) / elapsed, 2)
                                 if elapsed else None),
            "tokens_per_sec": (round(toks / elapsed, 1)
                               if elapsed else None),
            "occupancy": round(eng.occupancy, 4),
            # tokens per active-slot tick: 1.0 for the plain tick
            "accepted_per_tick": (round(apt, 4) if apt is not None
                                  else (1.0 if eng.ticks else None)),
            "pages_per_request": (round(eng.pool.alloc_total / len(comps),
                                        4) if comps else None),
            "prefix_hit_rate": (round(eng.prefix_hit_rate, 4)
                                if eng.prefix_hit_rate is not None
                                else None),
            "cow_copies": eng.pool.cow_copies,
            "ttft_ms": {"p50": _pctl_ms(ttft, 50),
                        "p99": _pctl_ms(ttft, 99)},
            "tpot_ms": {"p50": _pctl_ms(tpot, 50),
                        "p99": _pctl_ms(tpot, 99)},
            "queue_wait_ms": {"p50": _pctl_ms(waits, 50),
                              "p99": _pctl_ms(waits, 99)},
        }
        print(f"serve[{refill}]: {len(comps)}/{args.trace} completed in "
              f"{eng.ticks} ticks ({results[refill]['requests_per_tick']} "
              f"req/tick, {results[refill]['requests_per_sec']} req/s, "
              f"{results[refill]['accepted_per_tick']} accepted/tick, "
              f"{results[refill]['pages_per_request']} pages/req), "
              f"occupancy {eng.occupancy * 100:.0f}%, TTFT p50 "
              f"{results[refill]['ttft_ms']['p50']}ms", file=sys.stderr)
    serving = dict(results["continuous"])
    serving.update(requests=args.trace, slots=args.serve_slots,
                   page_size=args.page_size, num_pages=num_pages,
                   quant=args.serve_quant, kv_quant=args.kv_quant,
                   attn=args.attn,
                   attn_read=args.attn_read, arrival_rate=args.arrival_rate,
                   trace_seed=args.trace_seed, spec_k=args.spec_k,
                   prefix_tenants=args.prefix_tenants, prefix_len=prefix_len,
                   static=results["drain"])
    if prefix_on:
        serving["no_prefix_cache"] = results["no_prefix_cache"]
    summary = requests_summary(span_cap)
    ta = summary.get("tail_attribution")
    serving["tail_attribution"] = ta
    if ta:
        print(f"serve[traces]: {summary['completed_requests']} request "
              f"trace(s), coverage {ta['coverage']}, sum-check "
              f"{'OK' if ta['sum_check']['ok'] else 'FAILED'} "
              f"(max residue {ta['sum_check']['max_residue_s']:.6g}s)",
              file=sys.stderr)
    if args.waterfalls > 0:
        slow = slowest_traces(reqtrace.traces(span_cap), args.waterfalls)
        print(f"serve[traces]: {len(slow)} slowest request waterfall(s):",
              file=sys.stderr)
        for tr in slow:
            for line in waterfall_lines(tr):
                print("  " + line, file=sys.stderr)
    return serving


def one_shot(args, model, prompt, ledger=None, mesh=None) -> dict:
    """The one-shot sections: cached decode against full recompute, and
    the sequential requests (over ``mesh`` when given). Returns the JSON
    fields they fill."""
    import torch

    from tpu_dist_torch.engine.generate import generate

    def run(use_cache, led=None):
        gen = (torch.Generator(device=model.device).manual_seed(args.seed)
               if args.temperature > 0 else None)
        t0 = time.perf_counter()
        out = generate(model, prompt, args.steps,
                       temperature=args.temperature, generator=gen,
                       use_cache=use_cache, top_k=args.top_k,
                       top_p=args.top_p, ledger=led, mesh=mesh)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return out, time.perf_counter() - t0

    def timed(use_cache):
        # ticks: the cached path runs one batched prefill and steps - 1
        # one-token ticks; the full path runs steps full forwards
        run(use_cache)                                   # build + warm
        best, out = float("inf"), None
        for _ in range(args.trials):
            out, secs = run(use_cache)
            best = min(best, secs)
        return args.batch * args.steps / best, best / args.steps * 1e3, out

    total = args.prompt_len + args.steps
    cache_rate, cache_ms, out_c = timed(True)
    print(f"kv-cache decode: {cache_rate:,.0f} generated-tok/s incl. "
          f"batched prefill ({cache_ms:.2f} ms/generated token, batch "
          f"{args.batch}, {args.num_layers}L/d{args.d_model}, prompt "
          f"{args.prompt_len}, total {total})", file=sys.stderr)
    full_rate = None
    if not args.skip_full:
        full_rate, full_ms, out_f = timed(False)
        print(f"full-recompute decode: {full_rate:,.0f} tok/s "
              f"({full_ms:.2f} ms/token-tick)", file=sys.stderr)
        if args.temperature == 0.0:
            print(f"greedy outputs identical: "
                  f"{bool(torch.equal(out_c, out_f))} (random-weight "
                  "near-ties can break argmax differently between the two "
                  "attention orders; informational)", file=sys.stderr)
    latency = req_tok_s = None
    lat = []
    for _ in range(args.requests):
        lat.append(run(True, ledger)[1])
    if lat:
        latency = {"p50_ms": _pctl_ms(lat, 50), "p99_ms": _pctl_ms(lat, 99)}
        req_tok_s = round(args.batch * args.steps * len(lat) / sum(lat), 1)
        print(f"requests: {len(lat)} sequential kv-cache calls, "
              f"{req_tok_s:,.0f} tok/s; latency p50 {latency['p50_ms']:.1f}"
              f"ms / p99 {latency['p99_ms']:.1f}ms", file=sys.stderr)
    return {"kv_cache": round(cache_rate, 1),
            "full_recompute": (round(full_rate, 1)
                               if full_rate is not None else None),
            "latency_ms": latency, "request_tokens_per_sec": req_tok_s,
            "request_seconds": sum(lat)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain kernel versions)")
    ap.add_argument("--vocab-size", type=int, default=32000)
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--num-layers", type=int, default=8)
    ap.add_argument("--num-heads", type=int, default=8)
    ap.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    ap.add_argument("--seed", type=int, default=0,
                    help="random-weight seed")
    ap.add_argument("--attn", default="full", choices=["full", "flash"],
                    help="prefill attention: plain full attention or the "
                         "flash kernel (LMConfig.attn)")
    ap.add_argument("--attn-read", default="exact",
                    choices=["exact", "flash"],
                    help="decode read of int8 pages: exact dequant or the "
                         "paged decode kernel (ServeConfig.attn_read)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--batch", type=int, default=8,
                    help="one-shot: prompts decoded together")
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=384,
                    help="one-shot: tokens generated per prompt")
    ap.add_argument("--trials", type=int, default=3,
                    help="one-shot: timed calls per path (best kept)")
    ap.add_argument("--skip-full", action="store_true",
                    help="one-shot: skip the full-recompute reference")
    ap.add_argument("--requests", type=int, default=8,
                    help="one-shot: sequential warm kv-cache calls timed "
                         "as requests for the latency percentiles (0 = "
                         "skip)")
    ap.add_argument("--num-experts", type=int, default=0,
                    help="MoE feed-forward with N experts (0 = dense; the "
                         "one-shot mode only)")
    ap.add_argument("--capacity-factor", type=float, default=1.25)
    ap.add_argument("--tp", type=int, default=0,
                    help="decode over a 'model' mesh axis of this many "
                         "processes (one-shot mode; 0 = no mesh)")
    ap.add_argument("--dp", type=int, default=0,
                    help="decode over a 'data' mesh axis of this many "
                         "processes: the batch shards (one-shot mode)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the --tp/--dp group's backend (default: nccl on "
                         "cuda, gloo on cpu)")
    ap.add_argument("--trace", type=int, default=0,
                    help="requests in the replayed trace (0 = the one-shot "
                         "bench)")
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--arrival-rate", type=float, default=1.0,
                    help="mean request arrivals per decode tick (Poisson)")
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--min-out", type=int, default=4)
    ap.add_argument("--max-out", type=int, default=64)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens per tick "
                         "(self-speculation; 0 = plain decode)")
    ap.add_argument("--prefix-tenants", type=int, default=0,
                    help="per-tenant shared system prompts + CoW prefix "
                         "caching, plus a cache-off baseline (0 = off)")
    ap.add_argument("--prefix-len", type=int, default=32)
    ap.add_argument("--serve-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="pool size (0 = slots x worst-case pages)")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"])
    ap.add_argument("--serve-quant", default="none",
                    choices=["none", "int8", "int8_wo"])
    ap.add_argument("--long-context", default="",
                    help="long-context trace JSON (e.g. tools/traces/"
                         "longcontext_mix.json): mixed short and long "
                         "traffic through chunked prefill under the "
                         "virtual cost-model clock (replaces the one-shot "
                         "sections)")
    ap.add_argument("--prompt-len-dist", default="",
                    help="draw the long-context trace instead: "
                         "'LEN:WEIGHT,...' prompt lengths (--trace N "
                         "requests, --trace-seed, --arrival-rate, "
                         "--min-out/--max-out)")
    ap.add_argument("--prefill-chunk", type=int, default=128,
                    help="long-context chunk size (0 = monolithic)")
    ap.add_argument("--long-threshold", type=int, default=1024,
                    help="prompts at least this long are 'long' "
                         "(--prompt-len-dist; trace files carry theirs)")
    ap.add_argument("--tick-floor", type=int, default=1024,
                    help="virtual cost of a scheduler step before its "
                         "prefill work, in token-equivalents "
                         "(--prompt-len-dist; trace files carry theirs)")
    ap.add_argument("--long-monolithic", action="store_true",
                    help="also replay the long-context trace with "
                         "prefill_chunk=0 (the unchunked contrast)")
    ap.add_argument("--sp-capacity", type=int, default=0,
                    help="with the long-context replay: serve a context "
                         "longer than one device's page budget on N ranks "
                         "of an sp mesh (geometry-tiny)")
    ap.add_argument("--ledger", default="",
                    help="JSONL ledger: run_start, one 'decode' event per "
                         "one-shot request, run_end; or the continuous "
                         "replay's events")
    ap.add_argument("--waterfalls", type=int, default=0,
                    help="print the N slowest request span trees (stderr)")
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    long_mode = bool(args.long_context or args.prompt_len_dist)
    world = max(args.tp, 1) * max(args.dp, 1)
    if long_mode and args.sp_capacity > 1:
        world = args.sp_capacity
    if args.tp or args.dp:
        if args.trace or long_mode:
            raise SystemExit("--tp/--dp decode through engine.generate's "
                             "mesh path (the one-shot mode); the --trace "
                             "and long-context replays serve on one device")
        if args.dp and args.batch % args.dp:
            # generate() would leave the batch whole, and the JSON would
            # claim a dp run that never happened
            raise SystemExit(f"--dp {args.dp} needs --batch divisible by "
                             f"it (got {args.batch})")
    if world > 1:
        if "TPU_DIST_PROCESS_ID" not in os.environ:
            from tpu_dist_torch.parallel.launch import spawn

            spawn("tpu_dist_torch.tools.decode_bench", world, argv,
                  "127.0.0.1:0")
            return None
        from tpu_dist_torch.parallel import launch

        launch.initialize(device=args.device, backend=args.backend)
        try:
            return _bench(args)
        finally:
            launch.shutdown()
    return _bench(args)


def _bench(args):
    """The bench in this process (a rank of the group under a mesh);
    prints the JSON line on the main rank and returns its record."""
    import numpy as np
    import torch

    from tpu_dist_torch.device import resolve_device
    from tpu_dist_torch.models.transformer import TransformerLM, \
        full_attention
    from tpu_dist_torch.ops.flash_attention import flash_attention_fn

    long_mode = bool(args.long_context or args.prompt_len_dist)
    mesh = sp_mesh = None
    if args.tp or args.dp:
        from tpu_dist_torch.parallel.mesh import make_mesh

        mesh = make_mesh((max(args.dp, 1), max(args.tp, 1)),
                         ("data", "model"), device=args.device)
    elif long_mode and args.sp_capacity > 0:
        from tpu_dist_torch.parallel.mesh import make_mesh

        sp_mesh = make_mesh((args.sp_capacity,), ("sp",),
                            device=args.device)
    device = (mesh or sp_mesh).device if (mesh or sp_mesh) is not None \
        else resolve_device(args.device)
    main_rank = all(m is None or m.is_main for m in (mesh, sp_mesh))
    if long_mode:
        trace = long_context_trace(args)
        max_len = max(max(r["prompt_len"] + r["out_len"]
                          for r in trace["requests"]),
                      8 * args.sp_capacity)
    elif args.trace:
        max_len = (args.max_prompt + args.max_out
                   + (args.prefix_len if args.prefix_tenants else 0))
    else:
        max_len = args.prompt_len + args.steps
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if args.num_experts:
        from tpu_dist_torch.models.moe import MoETransformerLM
        if args.trace or long_mode:
            raise SystemExit("--trace serves the dense TransformerLM "
                             "(engine.serve has no MoE scheduling story "
                             "yet, ROADMAP item 4)")
        # as the reference's bench builds it: full attention
        model = MoETransformerLM(
            vocab_size=args.vocab_size, num_layers=args.num_layers,
            d_model=args.d_model, num_heads=args.num_heads, max_len=max_len,
            num_experts=args.num_experts,
            capacity_factor=args.capacity_factor, dtype=dtype,
            device=device, seed=args.seed)
    else:
        model = TransformerLM(
            vocab_size=args.vocab_size, num_layers=args.num_layers,
            d_model=args.d_model, num_heads=args.num_heads, max_len=max_len,
            dtype=dtype, attn_fn=flash_attention_fn() if args.attn == "flash"
            else full_attention, device=device, seed=args.seed)
    dev = ({"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count()} if device.type == "cuda"
           else {"platform": "cpu", "kind": "cpu", "count": 1})
    ledger = None
    if args.ledger and main_rank:
        from tpu_dist_torch.obs.ledger import Ledger
        ledger = Ledger(args.ledger)
    head = {"device": dev, "layers": args.num_layers,
            "d_model": args.d_model, "vocab": args.vocab_size,
            "heads": args.num_heads, "precision": args.precision,
            "temperature": args.temperature, "top_k": args.top_k,
            "top_p": args.top_p}
    if long_mode:
        # the replays run on the main rank; every rank of --sp-capacity's
        # mesh joins the capacity proof
        if ledger is not None:
            ledger.emit("run_start", kind="decode_bench", config=vars(args),
                        mesh=None, devices=[dev["kind"]],
                        process_count=args.sp_capacity or 1)
        serving = (replay_long_context(args, model, trace) if main_rank
                   else None)
        cap = (sp_capacity_proof(args, model, sp_mesh, trace["seed"])
               if sp_mesh is not None else None)
        if not main_rank:
            return None
        serving["sp_capacity"] = cap
        if ledger is not None:
            ledger.emit("run_end", steps=0, seconds=0.0)
            ledger.close()
        record = {"metric": "torch_lm_longcontext_serving", **head,
                  "attn": args.attn, "serving": serving}
        print(json.dumps(record))
        return record
    if args.trace:
        serving = replay_serving_trace(args, model, ledger=ledger)
        if ledger is not None:
            ledger.close()
        record = {"metric": "torch_lm_serving", **head, "serving": serving,
                  "ledger": args.ledger or None}
        print(json.dumps(record))
        return record
    if ledger is not None:
        ledger.emit("run_start", kind="decode_bench", config=vars(args),
                    mesh=({"tp": args.tp, "dp": args.dp} if mesh else None),
                    devices=[dev["kind"]],
                    process_count=1 if mesh is None else mesh.size)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, args.vocab_size,
                          (args.batch, args.prompt_len)).astype(np.int32)
    res = one_shot(args, model, prompt, ledger, mesh)
    if not main_rank:
        return None
    if ledger is not None:
        ledger.emit("run_end", steps=args.requests,
                    seconds=round(res["request_seconds"], 3))
        ledger.close()
    record = {
        "metric": "torch_lm_decode_tokens_per_sec",
        "kv_cache": res["kv_cache"], "full_recompute": res["full_recompute"],
        "batch": args.batch, "prompt_len": args.prompt_len,
        "steps": args.steps, **head, "attn": args.attn, "tp": args.tp,
        "dp": args.dp, "num_experts": args.num_experts,
        "requests": args.requests or None, "latency_ms": res["latency_ms"],
        "request_tokens_per_sec": res["request_tokens_per_sec"],
        "serving": None, "ledger": args.ledger or None}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
