"""The plan tuner for the port (``tpu_dist/plan/tune.py``): rank the
step-plan space for a device kind.

Enumerate a fixed plan space (:func:`default_space`), score each candidate
with the reference's roofline cost model at the device's peaks
(:func:`estimate_step_seconds`), fold in ``tools/comm_bench.py --json``
sweeps for the collective costs, and let measured trials (a ``trials`` list
in the measurement file, or ledger summaries of short plan-stamped runs)
override the estimate for the plans they match.

The cost model, the space, the search and the plan-file writer are the
reference's, constant for constant, so for equal peaks the two packages
rank alike and emit the same bytes. The peaks are the port's own tables
(``device.PEAK_FLOPS`` bf16 and ``device.PEAK_BYTES``: the H100 SXM data
sheet's 989 TFLOP/s and 3,350 GB/s), matched by lower-cased substring of
the device kind; a kind the tables lack gets nominal peaks of 1.0
(``nominal`` true), which keep it rankable.

Determinism is the contract: the space enumerates in one fixed order, the
scores are pure arithmetic rounded once at the end, and ties break on the
candidate's plan hash, so the same inputs give byte-identical output. The
device is a string: nothing here touches a device.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from tpu_dist_torch.plan.ir import (DEFAULT_OPT_BLOCK_ROWS,
                                    DEFAULT_QUANT_BLOCK, Plan, PlanError,
                                    plan_hash, plan_knob_summary)

TUNE_VERSION = 1

# The reference's cost-model constants, kept as they are so the rankings
# agree with it; they are its model's assumptions, not times taken on any
# card. The compute-peak factor of int8 is 2 only where the quantize and
# dequant stay inside the fused kernel:
_COMPUTE_FACTOR = {
    ("none", False): 1.0, ("none", True): 1.0,
    ("int8", False): 1.0, ("int8", True): 2.0,
    ("int8_wo", False): 1.0, ("int8_wo", True): 1.0,
}
# weight-bytes factors: weight-only int8 halves the weight traffic, full
# int8 the operand traffic only when fused
_WEIGHT_BYTES_FACTOR = {
    ("none", False): 1.0, ("none", True): 1.0,
    ("int8", False): 1.0, ("int8", True): 0.5,
    ("int8_wo", False): 0.5, ("int8_wo", True): 0.5,
}

# host latency a dispatch window amortizes, in seconds (the reference's
# model constant)
_DISPATCH_S = 2e-3
# the share of a bucketed gradient sync hidden behind compute (the
# reference's model constant; a monolithic sync hides nothing)
_BUCKET_OVERLAP = 0.7

_FALLBACK_TFLOPS = 1.0   # nominal peaks keep a kind the tables lack
_FALLBACK_GBPS = 1.0     # rankable


def _peak_tables():
    """((key, bf16 TFLOP/s), ...) and ((key, GB/s), ...) from the port's
    ``device`` tables."""
    import torch

    from tpu_dist_torch.device import PEAK_BYTES, PEAK_FLOPS

    flops = tuple((k.lower(), v[torch.bfloat16] / 1e12)
                  for k, v in PEAK_FLOPS.items() if torch.bfloat16 in v)
    return flops, tuple((k.lower(), v / 1e9) for k, v in PEAK_BYTES.items())


def _peak_for(kind: str, table) -> Optional[float]:
    kind = (kind or "").lower()
    for key, peak in table:
        if key in kind:
            return peak
    return None


def device_peaks(device_kind: str) -> dict:
    """{'tflops', 'gbps', 'nominal'} for a device-kind string."""
    flops, gbps = _peak_tables()
    tf = _peak_for(device_kind, flops)
    gb = _peak_for(device_kind, gbps)
    return {"tflops": tf or _FALLBACK_TFLOPS, "gbps": gb or _FALLBACK_GBPS,
            "nominal": tf is None or gb is None}


# ---- workload -------------------------------------------------------------

_WORKLOAD_DEFAULTS = {
    # the reference's default geometry (its LM bench: 8 layers, d1024,
    # seq 2048, vocab 32k); flops and bytes derived below
    "engine": "lm", "n_params": 113_000_000, "tokens_per_step": 16_384,
    "devices": 8, "seq_len": 2048,
}


def normalize_workload(workload: Optional[dict]) -> dict:
    """Fill a workload spec: n_params / tokens_per_step / devices (+
    optional flops_per_step / bytes_per_step overrides). Derivations are
    the repo's own accounting: 6*N fwd+bwd model FLOPs per token
    (utils.mfu), 3 passes of fp32 param traffic per step + one grad sync
    payload (param bytes)."""
    w = dict(_WORKLOAD_DEFAULTS)
    w.update(workload or {})
    n = float(w["n_params"])
    toks = float(w["tokens_per_step"])
    w.setdefault("flops_per_step", 6.0 * n * toks)
    w.setdefault("param_bytes", 4.0 * n)
    # fwd reads W, bwd reads W and writes dW, update reads+writes P/opt:
    # ~3 full weight passes per optimizer step — the memory-bound floor
    w.setdefault("bytes_per_step", 3.0 * w["param_bytes"])
    w.setdefault("grad_sync_bytes", w["param_bytes"])
    return w


# ---- measurements ---------------------------------------------------------

def _interp_seconds(rows: List[dict], key_s: str, nbytes: float,
                    size_key: str = "bytes") -> Optional[float]:
    """Seconds for ``nbytes`` from comm_bench rows: effective GB/s of the
    nearest-sized measurement, scaled linearly (collectives are bandwidth-
    bound at these sizes)."""
    usable = [r for r in rows if r.get(key_s) and r.get(size_key)]
    if not usable:
        return None
    near = min(usable, key=lambda r: (abs(r[size_key] - nbytes), r[size_key]))
    return near[key_s] * (nbytes / near[size_key])


def comm_estimates(measurements: Optional[dict], workload: dict) -> dict:
    """Per-plan-knob comm seconds from a comm_bench --json sweep:
    {'sync_monolithic_s', 'sync_bucketed_s', 'matmul_ring_ratio'}.
    Absent measurements -> empty dict (the analytic model abstains from
    comm rather than invent numbers)."""
    out: dict = {}
    rows = (measurements or {}).get("results") or []
    gbytes = workload["grad_sync_bytes"]
    grad = [r for r in rows if r.get("bench") == "grad_sync"]
    allr = [r for r in rows if r.get("bench") == "allreduce"]
    mono = _interp_seconds(grad, "monolithic_s", gbytes) \
        or _interp_seconds(allr, "psum_s", gbytes)
    buck = _interp_seconds(grad, "bucketed_s", gbytes)
    if mono is not None:
        out["sync_monolithic_s"] = mono
    if buck is not None:
        out["sync_bucketed_s"] = buck
    mm = [r for r in rows if r.get("bench") == "collective_matmul"
          and r.get("ring_s") and r.get("gspmd_s")]
    if mm:
        out["matmul_ring_ratio"] = (sum(r["ring_s"] for r in mm)
                                    / sum(r["gspmd_s"] for r in mm))
    return out


def _trial_matches(trial_knobs: dict, plan: Plan) -> bool:
    d = plan.to_dict()
    for k, v in trial_knobs.items():
        have = d.get(k)
        if isinstance(have, (list, tuple)):
            have, v = list(have), list(v)
        if have != v:
            return False
    return True


def trial_step_seconds(trials: List[dict], plan: Plan,
                       workload: dict) -> Optional[float]:
    """Measured step seconds for ``plan`` from refinement trials: entries
    are {'knobs': {...subset...}, 'step_s': float} or {'knobs', 'mfu'}
    (converted through the workload's flops at the device peak by the
    caller). The MOST SPECIFIC matching trial (largest knob subset) wins;
    ties break on list order."""
    best = None
    best_n = -1
    for t in trials or []:
        knobs = t.get("knobs") or {}
        if t.get("plan_hash") and t["plan_hash"] != plan_hash(plan):
            continue
        if not _trial_matches(knobs, plan):
            continue
        n = len(knobs) + (100 if t.get("plan_hash") else 0)
        if n > best_n and t.get("step_s"):
            best, best_n = float(t["step_s"]), n
    return best


def trials_from_ledger_summaries(summaries: List[dict],
                                 workload: dict,
                                 peaks: dict) -> List[dict]:
    """Convert ledger_report --json summaries of short measured runs into
    refinement trials: a summary whose run_start stamped a plan
    (``run.plan_knobs``/``run.plan_hash``) and reported a mean MFU
    becomes {'knobs'|'plan_hash', 'step_s'} through the workload's
    per-device flops at the device compute peak."""
    out = []
    flops_dev = workload["flops_per_step"] / max(workload["devices"], 1)
    for s in summaries or []:
        run = s.get("run") or {}
        mfu = (s.get("mfu") or {}).get("mean")
        if mfu is None or not (run.get("plan_knobs")
                               or run.get("plan_hash")):
            continue
        step_s = flops_dev / (mfu * peaks["tflops"] * 1e12)
        t = {"step_s": step_s}
        if run.get("plan_hash"):
            t["plan_hash"] = run["plan_hash"]
        t["knobs"] = run.get("plan_knobs") or {}
        out.append(t)
    return out


# ---- the cost model -------------------------------------------------------

def estimate_step_seconds(plan: Plan, workload: dict, peaks: dict,
                          comm: dict) -> dict:
    """Analytic roofline estimate of one optimizer step under ``plan``:
    {'compute_s', 'memory_s', 'comm_s', 'dispatch_s', 'total_s'}. The
    absolute numbers are crude by design — the tuner RANKS candidates, so
    only the knob-to-knob deltas must point the right way, and measured
    trials override whole candidates where they exist."""
    fused = (plan.quant == "int8"
             and plan.fused_quant in ("on", "auto"))  # auto = the kernel
    cf = _COMPUTE_FACTOR[(plan.quant, fused)]
    wf = _WEIGHT_BYTES_FACTOR[(plan.quant, fused)]
    ndev = max(workload["devices"], 1)
    flops = workload["flops_per_step"] / ndev
    nbytes = workload["bytes_per_step"] * wf   # per-device: params replicate
    compute_s = flops / (peaks["tflops"] * 1e12 * cf)
    memory_s = nbytes / (peaks["gbps"] * 1e9)
    # comm: the dp grad sync (per step), overlapped when bucketed
    comm_s = 0.0
    if ndev > 1:
        if plan.grad_bucket_mb > 0 and "sync_bucketed_s" in comm:
            comm_s = comm["sync_bucketed_s"] * (1.0 - _BUCKET_OVERLAP)
        elif "sync_monolithic_s" in comm:
            comm_s = comm["sync_monolithic_s"]
    device_s = max(compute_s, memory_s)
    if plan.layout == "tp" and plan.tp_impl == "ring" \
            and "matmul_ring_ratio" in comm:
        # ring overlap measured against GSPMD at the matmul geometry:
        # scale the whole device block by the measured ratio
        device_s *= comm["matmul_ring_ratio"]
    dispatch_s = _DISPATCH_S / max(plan.steps_per_dispatch, 1)
    total = device_s + comm_s + dispatch_s
    return {"compute_s": compute_s, "memory_s": memory_s,
            "comm_s": comm_s, "dispatch_s": dispatch_s, "total_s": total}


# ---- the search -----------------------------------------------------------

def default_space(engine: str = "lm", devices: int = 8) -> List[Plan]:
    """The enumerated candidate space, in ONE fixed order (determinism
    contract). Kept deliberately small — every dimension here is a knob a
    user used to hand-pick; the tuner's job is the cross product."""
    plans: List[Plan] = []
    quants = ("none", "int8")
    fused = ("auto", "off")
    buckets = (0.0, 25.0)
    windows = ((("none", 1),) if devices < 2 else
               (("none", 1), ("indexed", 16)))
    qblocks = (DEFAULT_QUANT_BLOCK, (256, 128, 0), (128, 256, 0),
               (128, 128, 512))
    oblocks = (DEFAULT_OPT_BLOCK_ROWS, 1024)
    for quant in quants:
        for fq in (fused if quant == "int8" else ("auto",)):
            for bucket in buckets:
                for window, k in windows:
                    for qb in (qblocks if quant == "int8"
                               else (DEFAULT_QUANT_BLOCK,)):
                        for ob in oblocks:
                            try:
                                plans.append(Plan(
                                    engine=engine,
                                    sync=("explicit" if bucket > 0
                                          else "gspmd"),
                                    quant=quant, fused_quant=fq,
                                    grad_bucket_mb=bucket,
                                    window=window, steps_per_dispatch=k,
                                    quant_block=qb, opt_block_rows=ob,
                                ).validate())
                            except PlanError:
                                continue   # illegal combination: pruned
    return plans


def search(workload: Optional[dict] = None,
           device_kind: str = "",
           measurements: Optional[dict] = None,
           trials: Optional[List[dict]] = None,
           space: Optional[List[Plan]] = None) -> dict:
    """Score the plan space and return the full deterministic result:
    {'device_kind', 'peaks', 'workload', 'candidates', 'best', 'ranked'}.
    ``measurements`` is a comm_bench --json object; ``trials`` the
    measured-refinement list (see :func:`trial_step_seconds`)."""
    workload = normalize_workload(workload)
    device_kind = device_kind or (measurements or {}).get(
        "device_kind") or "unknown"
    peaks = device_peaks(device_kind)
    comm = comm_estimates(measurements, workload)
    trials = list(trials or []) + list((measurements or {}).get(
        "trials") or [])
    space = space if space is not None else default_space(
        workload["engine"], int(workload["devices"]))
    scored = []
    for plan in space:
        est = estimate_step_seconds(plan, workload, peaks, comm)
        measured = trial_step_seconds(trials, plan, workload)
        total = measured if measured is not None else est["total_s"]
        scored.append({
            "plan": plan, "hash": plan_hash(plan),
            "step_s": round(total, 9), "measured": measured is not None,
            "estimate": {k: round(v, 9) for k, v in est.items()},
        })
    # deterministic order: score, then hash (pure tie-break)
    scored.sort(key=lambda c: (c["step_s"], c["hash"]))
    return {"device_kind": device_kind, "peaks": peaks,
            "workload": {k: workload[k] for k in sorted(workload)},
            "candidates": len(scored), "comm": {k: round(v, 9)
                                                for k, v in comm.items()},
            "best": scored[0] if scored else None, "ranked": scored}


def emit_plan_file(results: Dict[str, dict]) -> str:
    """Serialize {device_kind: search-result} as the best-plan-per-device
    JSON the config knob consumes — canonical bytes (sorted keys, fixed
    rounding), so two identical searches emit identical files."""
    plans = {}
    for kind in sorted(results):
        best = results[kind]["best"]
        if best is None:
            continue
        entry = best["plan"].to_dict()
        entry["hash"] = best["hash"]
        entry["score"] = {
            "step_s": best["step_s"], "measured": best["measured"],
            "candidates": results[kind]["candidates"],
            "peaks_nominal": results[kind]["peaks"]["nominal"],
        }
        plans[kind] = entry
    return json.dumps({"version": TUNE_VERSION, "plans": plans},
                      sort_keys=True, indent=1) + "\n"


def tune(measurement_files: Optional[List[str]] = None,
         ledger_summary_files: Optional[List[str]] = None,
         device_kinds: Optional[List[str]] = None,
         workload: Optional[dict] = None) -> Tuple[str, Dict[str, dict]]:
    """The ``tools/tune.py`` entry: load measurement/summary files, search
    per device kind, return (plan-file text, {kind: full result})."""
    measurements = None
    for path in measurement_files or []:
        with open(path) as f:
            doc = json.load(f)
        if measurements is None:
            measurements = doc
        else:  # later files extend the sweep + trials
            measurements.setdefault("results", []).extend(
                doc.get("results") or [])
            measurements.setdefault("trials", []).extend(
                doc.get("trials") or [])
    summaries = []
    for path in ledger_summary_files or []:
        with open(path) as f:
            summaries.append(json.load(f))
    kinds = device_kinds or [(measurements or {}).get("device_kind")
                             or "unknown"]
    results = {}
    for kind in kinds:
        w = normalize_workload(workload)
        peaks = device_peaks(kind)
        trials = trials_from_ledger_summaries(summaries, w, peaks)
        results[kind] = search(workload=w, device_kind=kind,
                               measurements=measurements, trials=trials)
    return emit_plan_file(results), results
