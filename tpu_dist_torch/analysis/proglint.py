"""proglint for the port (``tpu_dist/analysis/proglint.py``): the
program-level SPMD audit over an eager step.

The reference audits the jaxpr its step compiler traced and the HLO XLA
compiled. The port's steps are eager, so it audits one dispatch of the
program as it runs: :class:`ProgramRecorder` is a ``TorchDispatchMode``
over that dispatch (forward, backward and update) that records what each
check reads, and the checks hold the recording to the same hazards:

=====  ========  =========================================================
id     surface   hazard
=====  ========  =========================================================
PL001  dispatch  a collective runs over a process group whose axis names
                 (``parallel.mesh.axis_names_of``) are not all in the
                 ``parallel/mesh.py`` authority, or over a group no mesh
                 axis owns
PL002  dispatch  ranks issue different ordered collective sequences: each
                 rank's sequence, as a fixed-size digest, is all-gathered
                 once over the world group after the dispatch, and every
                 rank names the first position where they diverge (equal
                 sequences are clean: a symmetric branch, or a loop with
                 the same trip count on every rank)
PL003  state     under a plan with ``donate=True``, the step rebinds a
                 parameter or an optimizer moment to new storage (the
                 port's claim: its steps update the train state in place,
                 which is what donation buys XLA)
PL004  dispatch  a matmul or convolution whose floating operands are all
                 fp32, or any float64 result, inside a program declared
                 bf16/int8
PL005  runtime   a program dispatched with more distinct input signatures
                 (shape, dtype, device of each tensor) than it is allowed
                 (checked at drain boundaries only)
PL000  meta      a waiver without a written reason
=====  ========  =========================================================

The recorder leaves out the operators of a kernel's plain version
(``kernels.in_plain_version``): they are not the program's compute. On
the card the kernels are ctypes launches it never sees; on the CPU their
plain versions run instead (the fused int8 product multiplies in float64,
the flash pair in fp32), so without the skip a bf16 or int8 program would
flag on the CPU and not on the card. A product with an fp32 result that
this PyTorch computes by upcasting (``ops.f32_product``) is recorded with
the operand dtypes it stands for (``product_operands``), as the
reference's ``preferred_element_type=float32`` dot is.

Waiver grammar (default file ``proglint_waivers.txt`` beside this
module), as the reference's::

    PLNNN <program-glob> -- reason text

:func:`audit_tune_space` audits every structurally distinct program of
the tuner's candidate space (``plan.tune.default_space("lm", devices)``):
each runs one tiny CPU step at every rank of a fake process group of
``devices`` ranks in this process, and the ranks' digests are compared
for PL002. ``python -m tpu_dist_torch.analysis.proglint`` is its CLI.
"""

from __future__ import annotations

import fnmatch
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from tpu_dist_torch import kernels
from tpu_dist_torch.ops.f32_product import product_operands

CHECKS = {
    "PL000": ("waiver hygiene",
              "a waiver with no written reason hides debt instead of "
              "naming it"),
    "PL001": ("unknown collective axis",
              "a collective equation uses an axis name outside the "
              "parallel/mesh.py authority"),
    "PL002": ("divergent branch collective order",
              "cond branches issue different ordered collective sequences "
              "— an SPMD deadlock, provable statically"),
    "PL003": ("dropped buffer donation",
              "declared donate_argnums not aliased in the compiled module "
              "(XLA drops donation silently on sharding/layout mismatch)"),
    "PL004": ("precision promotion leak",
              "f32/f64 dot/conv compute inside a program declared "
              "bf16/int8"),
    "PL005": ("hot-path recompilation",
              "the program's trace cache grew past its allowed shape "
              "count — a shape/dtype varies per dispatch"),
}

#: aten operators PL004 holds to the declared precision: the matmuls and
#: convolutions (and their backward), and the library's attention
_COMPUTE_OPS = frozenset({
    "mm", "addmm", "bmm", "baddbmm", "matmul", "linear", "convolution",
    "_convolution", "convolution_backward", "cudnn_convolution",
    "convolution_overrideable", "mkldnn_convolution",
    "_slow_conv2d_forward", "_scaled_mm",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_flash_attention_for_cpu",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention"})

#: c10d operators that are not collectives
_NOT_COLLECTIVES = frozenset({"wait"})
#: collectives whose element counts may differ by rank (uneven splits,
#: peers): their counts stay out of the signature
_RANK_SHAPED = ("alltoall", "all_to_all", "send", "recv")

#: config precisions that declare a low-precision compute program
#: ("bf16_params" keeps fp32 compute on purpose, so it is NOT in the set)
LOW_PRECISION = frozenset({"bf16", "int8"})

#: positions of a sequence the PL002 digest holds one by one
DIGEST_POSITIONS = 64

DEFAULT_WAIVERS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "proglint_waivers.txt")


class AuditError(RuntimeError):
    """Raised under ``audit=halt`` when a program carries unwaivered
    findings or trips the recompile sentry."""


@dataclass
class Finding:
    """One audit finding against one program."""

    check: str
    program: str
    message: str
    waived: bool = False
    reason: str = ""

    def render(self) -> str:
        tag = f" [waived: {self.reason}]" if self.waived else ""
        return (f"{self.program}: {self.check} "
                f"{CHECKS[self.check][0]}: {self.message}{tag}")

    def to_json(self) -> dict:
        return {"check": self.check, "program": self.program,
                "message": self.message, "waived": self.waived,
                "reason": self.reason}


# ---- waivers ---------------------------------------------------------------

@dataclass(frozen=True)
class Waiver:
    check: str
    pattern: str      # fnmatch glob over the program name
    reason: str
    line: int = 0


def parse_waivers(text: str,
                  origin: str = "<waivers>") -> Tuple[List[Waiver],
                                                      List[Finding]]:
    """Parse the waiver grammar. A valid waiver missing its ``-- reason``
    is returned as a PL000 finding, not honored."""
    waivers: List[Waiver] = []
    meta: List[Finding] = []
    for i, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        head, sep, reason = line.partition("--")
        parts = head.split()
        if len(parts) != 2 or parts[0] not in CHECKS:
            meta.append(Finding("PL000", origin,
                                f"line {i}: unparseable waiver {raw!r} "
                                "(grammar: 'PLNNN <program-glob> -- "
                                "reason')"))
            continue
        reason = reason.strip()
        if not sep or not reason:
            meta.append(Finding("PL000", origin,
                                f"line {i}: waiver for {parts[0]} on "
                                f"{parts[1]!r} has no reason"))
            continue
        waivers.append(Waiver(parts[0], parts[1], reason, i))
    return waivers, meta


def load_waivers(path: Optional[str] = None
                 ) -> Tuple[List[Waiver], List[Finding]]:
    path = DEFAULT_WAIVERS if path is None else path
    if not os.path.exists(path):
        return [], []
    with open(path) as f:
        return parse_waivers(f.read(), origin=os.path.basename(path))


def apply_waivers(findings: Iterable[Finding],
                  waivers: Sequence[Waiver]) -> List[Finding]:
    """Mark each finding waived when a (check, program-glob) waiver
    matches; returns the same objects."""
    out = list(findings)
    for f in out:
        for w in waivers:
            if w.check == f.check and fnmatch.fnmatch(f.program, w.pattern):
                f.waived, f.reason = True, w.reason
                break
    return out


def unwaivered(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if not f.waived]


def mesh_axis_authority() -> frozenset:
    """The declared axis names, by reflection over ``parallel/mesh.py``'s
    ``*_AXIS`` constants."""
    from tpu_dist_torch.parallel import mesh as mesh_mod

    return frozenset(v for k, v in vars(mesh_mod).items()
                     if k.endswith("_AXIS") and isinstance(v, str))


# ---- the recorder ----------------------------------------------------------

def _state_tensors(state) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of the parameters and optimizer moments of a
    ``TrainState`` (none without one)."""
    if state is None:
        return []
    names = list(getattr(state, "param_names", None) or ())
    out = [(names[i] if i < len(names) else f"params[{i}]", p)
           for i, p in enumerate(state.params)]
    opt = state.opt_state
    fields = getattr(opt, "_fields", None) or [str(i)
                                               for i in range(len(opt))]
    for field, v in zip(fields, opt):
        if torch.is_tensor(v):
            out.append((f"opt_state.{field}", v))
        else:
            out.extend((f"opt_state.{field}[{i}]", t)
                       for i, t in enumerate(v))
    return out


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _group_of(args):
    """The process group a c10d operator runs over (its ScriptObject
    argument, unboxed to the group object)."""
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith("ProcessGroup"):
            return dist.ProcessGroup.unbox(a)
    return None


def _reduce_op(args) -> str:
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith("ReduceOp"):
            return dist.ReduceOp.RedOpType(int(a.op())).name
    return ""


class ProgramRecorder(TorchDispatchMode):
    """Record one dispatch of a program: ``with ProgramRecorder(state) as
    rec: fn()``. Reads:

    * ``collectives``: each c10d operator in issue order as ``{"op",
      "axes", "reduce", "dtype", "numel"}``, ``axes`` the axis names its
      group was registered with (None: a group no mesh axis owns);
    * ``compute``: each matmul/convolution/attention operator's name and
      floating operand dtypes; ``f64``: each operator with a float64
      result (neither inside a kernel's plain version);
    * ``storage_before``/``storage_after``: the parameters' and optimizer
      moments' (name, storage pointer) at entry and exit.
    """

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # as obs.attr.CostModelMode: never under torch.compile, and no
        # torch._dynamo import for the mode
        return False

    def __init__(self, state=None):
        super().__init__()
        self.state = state
        self.collectives: List[dict] = []
        self.compute: List[Tuple[str, Tuple[str, ...]]] = []
        self.f64: List[str] = []
        self.storage_before: List[Tuple[str, int]] = []
        self.storage_after: List[Tuple[str, int]] = []

    def __enter__(self):
        self.storage_before = [(n, _storage(t))
                               for n, t in _state_tensors(self.state)]
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self.storage_after = [(n, _storage(t))
                                  for n, t in _state_tensors(self.state)]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "c10d":
            if name not in _NOT_COLLECTIVES:
                self._collective(name, args)
            return out
        if kernels.in_plain_version():
            return out
        if name in _COMPUTE_OPS:
            leaves, _ = tree_flatten((args, kwargs))
            operands = product_operands() or [
                t.dtype for t in leaves if isinstance(t, torch.Tensor)
                and t.dtype.is_floating_point]
            self.compute.append((name, tuple(
                str(dt).replace("torch.", "") for dt in operands)))
        outs, _ = tree_flatten(out)
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.float64
               for t in outs):
            self.f64.append(name)
        return out

    def _collective(self, name, args):
        from tpu_dist_torch.parallel.mesh import axis_names_of

        leaves, _ = tree_flatten(args)
        ts = [t for t in leaves if isinstance(t, torch.Tensor)]
        self.collectives.append({
            "op": name.rstrip("_"),
            "axes": axis_names_of(_group_of(args)),
            "reduce": _reduce_op(args),
            "dtype": str(ts[0].dtype).replace("torch.", "") if ts else "",
            "numel": sum(t.numel() for t in ts)})

    # -- what the checks compare ------------------------------------------
    def signature(self) -> List[tuple]:
        """The ordered collective signature PL002 compares across ranks."""
        out = []
        for c in self.collectives:
            shaped = c["op"].startswith(_RANK_SHAPED)
            out.append((c["op"], tuple(c["axes"] or ()), c["reduce"],
                        c["dtype"], None if shaped else c["numel"]))
        return out

    def digest(self) -> List[int]:
        """The signature as a fixed-size digest: [count, hash of the whole
        sequence, hash of each of its first DIGEST_POSITIONS entries (0
        past its end)], each an int64."""
        sig = self.signature()
        row = [len(sig), _hash(sig)]
        row += [_hash(s) for s in sig[:DIGEST_POSITIONS]]
        return row + [0] * (DIGEST_POSITIONS + 2 - len(row))


def _hash(obj) -> int:
    h = hashlib.sha256(repr(obj).encode()).digest()
    return int.from_bytes(h[:8], "little", signed=True)


def _render_collective(entry) -> str:
    op, axes, reduce, dtype, numel = entry
    red = f"[{reduce}]" if reduce else ""
    n = "" if numel is None else f" x {numel}"
    return f"{op}{red} over {list(axes)} ({dtype}{n})"


def exchange_digests(rec: ProgramRecorder, device=None
                     ) -> Optional[List[List[int]]]:
    """Every rank's :meth:`ProgramRecorder.digest`, all-gathered once over
    the world group (a collective: every rank calls it after the recorded
    dispatch), or None without a group of more than one process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return None
    from tpu_dist_torch.parallel.collectives import all_gather

    mine = torch.tensor(rec.digest(), dtype=torch.int64,
                        device=device if device is not None else "cpu")
    return all_gather(mine).cpu().tolist()


# ---- the checks ------------------------------------------------------------

def _check_axes(program: str, rec: ProgramRecorder,
                authority) -> List[Finding]:
    unknown: Dict[str, str] = {}
    for c in rec.collectives:
        if c["axes"] is None:
            unknown.setdefault("<unregistered group>", c["op"])
            continue
        for ax in c["axes"]:
            if ax not in authority:
                unknown.setdefault(ax, c["op"])
    return [Finding("PL001", program,
                    (f"collective {op} over a process group no mesh axis "
                     "owns" if ax == "<unregistered group>" else
                     f"collective {op} over axis {ax!r} not in the mesh "
                     f"authority {sorted(authority)}"))
            for ax, op in sorted(unknown.items())]


def _check_divergence(program: str, rec: ProgramRecorder,
                      digests: Optional[Sequence[Sequence[int]]],
                      rank: int = 0) -> List[Finding]:
    if not digests or all(list(d) == list(digests[0]) for d in digests):
        return []
    sig = rec.signature()
    n = max(d[0] for d in digests)
    pos = next((i for i in range(min(n, DIGEST_POSITIONS))
                if len({d[2 + i] for d in digests}) > 1), None)
    others = [r for r, d in enumerate(digests)
              if list(d) != list(digests[rank])]
    if pos is None:
        where = (f"past position {DIGEST_POSITIONS - 1} (the counts are "
                 f"{[d[0] for d in digests]})")
    else:
        mine = (_render_collective(sig[pos]) if pos < len(sig)
                else "(none)")
        where = f"at position {pos}: this rank (rank {rank}) issues {mine}"
    return [Finding(
        "PL002", program,
        "ranks issue divergent collective sequences: the first divergence "
        f"is {where}; ranks {others} differ from this rank's sequence")]


def _check_donation(program: str, rec: ProgramRecorder,
                    donate: bool) -> List[Finding]:
    if not donate or not rec.storage_before:
        return []
    before = dict(rec.storage_before)
    moved = [n for n, ptr in rec.storage_after if before.get(n) != ptr]
    if not moved:
        return []
    shown = ", ".join(moved[:4]) + (", ..." if len(moved) > 4 else "")
    return [Finding(
        "PL003", program,
        f"the step rebinds {len(moved)} of {len(before)} state tensors to "
        f"new storage ({shown}) under donate=True -- the port's steps "
        "update the train state in place, and a rebinding step holds the "
        "old and the new state at once")]


def _check_precision(program: str, rec: ProgramRecorder,
                     precision: Optional[str]) -> List[Finding]:
    if precision not in LOW_PRECISION:
        return []
    leaks: Dict[str, int] = {}
    for name in rec.f64:
        leaks[f"{name}:f64"] = leaks.get(f"{name}:f64", 0) + 1
    for name, dts in rec.compute:
        if dts and all(d == "float32" for d in dts):
            leaks[f"{name}:f32"] = leaks.get(f"{name}:f32", 0) + 1
    return [Finding("PL004", program,
                    f"{n} {op.split(':')[0]} op(s) compute in "
                    f"{op.split(':')[1]} inside a {precision} program")
            for op, n in sorted(leaks.items())]


def audit_recording(program: str, rec: ProgramRecorder, *, authority=None,
                    precision: Optional[str] = None, donate: bool = True,
                    digests: Optional[Sequence[Sequence[int]]] = None,
                    rank: int = 0) -> List[Finding]:
    """The checks over one recorded dispatch: PL001 and PL004 on the
    recording, PL003 on its storage snapshots (under ``donate``), PL002
    against every rank's digest (``digests``, indexed by rank; this rank
    is ``rank``)."""
    authority = mesh_axis_authority() if authority is None else authority
    findings = _check_axes(program, rec, authority)
    findings += _check_divergence(program, rec, digests, rank)
    findings += _check_donation(program, rec, donate)
    findings += _check_precision(program, rec, precision)
    return findings


# ---- the runtime sentry (PL005) -------------------------------------------

def input_signature(args) -> tuple:
    """(shape, dtype, device) of each tensor or array among ``args`` (a
    host array's device is ``host``); nothing else counts."""
    leaves, _ = tree_flatten(list(args))
    sig = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            sig.append((tuple(x.shape), str(x.dtype), str(x.device)))
        elif hasattr(x, "shape") and hasattr(x, "dtype"):
            sig.append((tuple(x.shape), str(x.dtype), "host"))
    return tuple(sig)


class RecompileSentry:
    """Per-program watch over the distinct input signatures it is
    dispatched with. ``register`` is idempotent (``allowed`` only grows);
    ``note`` records a dispatch's signature on the host (no device sync);
    ``check`` compares the counts, sized for drain boundaries, and
    latches one finding per program."""

    def __init__(self):
        self._programs: Dict[str, dict] = {}

    def register(self, program: str, allowed: int = 1) -> None:
        rec = self._programs.setdefault(
            program, {"allowed": allowed, "seen": set(), "flagged": False})
        rec["allowed"] = max(rec["allowed"], allowed)

    def note(self, program: str, args) -> None:
        self.register(program)
        self._programs[program]["seen"].add(input_signature(args))

    def signatures(self, program: str) -> int:
        rec = self._programs.get(program)
        return len(rec["seen"]) if rec else 0

    def check(self) -> List[Finding]:
        out = []
        for name in sorted(self._programs):
            rec = self._programs[name]
            n = len(rec["seen"])
            if rec["flagged"] or n <= rec["allowed"]:
                continue
            rec["flagged"] = True
            out.append(Finding(
                "PL005", name,
                f"dispatched with {n} distinct input signatures (allowed "
                f"{rec['allowed']}): a shape/dtype is varying per dispatch "
                "and every variation re-plans the program's kernels and "
                "allocator blocks on the hot path"))
        return out


# ---- tune-space audit ------------------------------------------------------

def _structural_key(plan) -> tuple:
    """Plans that run the SAME program: quant_block/opt_block_rows/
    fused_quant only move the kernels' tiles, so one representative per
    key covers the whole space."""
    return (plan.engine, plan.sync, plan.layout, plan.tp_impl, plan.quant,
            plan.window, plan.steps_per_dispatch, plan.grad_bucket_mb > 0,
            plan.grad_accum_steps, plan.donate)


def _program_name(plan) -> str:
    return (f"{plan.engine}/{plan.sync}/quant={plan.quant}"
            f"/window={plan.window}"
            + (f"x{plan.steps_per_dispatch}"
               if plan.window != "none" else "")
            + ("/bucketed" if plan.grad_bucket_mb > 0 else ""))


def _tiny_lm_fixture(quant: str):
    """The reference's 1-layer/32-dim fixture: (model, tx, rows), the
    rows (8, L+1) int64 tokens from a seed."""
    import numpy as np

    from tpu_dist_torch.models.transformer import tiny_lm
    from tpu_dist_torch.ops.optim import make_optimizer

    V, L, D = 32, 16, 32
    model = tiny_lm(vocab_size=V, num_layers=1, d_model=D, num_heads=4,
                    max_len=L, quant=quant, device="cpu", seed=0)
    model.requires_grad_(True)
    tx = make_optimizer(0.01, 0.9, 0.0)
    rows = torch.from_numpy(np.random.RandomState(0).randint(
        0, V, (8, L + 1)).astype(np.int64))
    return model, tx, rows


def _rank_digests(plans, devices: int, rank: int) -> Dict[str, tuple]:
    """One tiny CPU step of each plan at ``rank`` of a fake process group
    of ``devices`` ranks: {program name: (recorder, digest)}."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from tpu_dist_torch.engine.state import TrainState
    from tpu_dist_torch.engine.steps import DataParallel
    from tpu_dist_torch.parallel.mesh import DATA_AXIS, make_mesh
    from tpu_dist_torch.plan.compile import (Bindings, activate_plan,
                                             compile_plan)

    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=devices)
    try:
        mesh = make_mesh((devices,), (DATA_AXIS,), device="cpu")
        for plan in plans:
            model, tx, rows = _tiny_lm_fixture(plan.quant)
            activate_plan(plan)
            dp = DataParallel(mesh.group(DATA_AXIS), devices,
                              bucket_mb=plan.grad_bucket_mb)
            step = compile_plan(plan, Bindings(mesh=mesh, model=model,
                                               tx=tx, dp=dp)).train_step
            state = TrainState.create(model, tx)
            local = rows[rank % len(rows):][:1]      # this rank's row
            if plan.window == "none":
                args = (state, local[:, :-1], local[:, 1:])
            else:
                k = plan.steps_per_dispatch
                idx = torch.arange(k * len(local)).reshape(k, len(local))
                args = (state, local.repeat(k, 1), idx)
            with ProgramRecorder(state) as rec:
                step(*args)
            out[_program_name(plan)] = (rec, rec.digest())
    finally:
        dist.destroy_process_group()
    return out


def audit_tune_space(space=None, *, waivers_path: Optional[str] = None,
                     devices: int = 8) -> dict:
    """Run and audit every structurally distinct program of the tuner's
    candidate space on the CPU (module docstring) and return a canonical,
    byte-deterministic report dict: ``plans`` counts the space,
    ``programs`` the distinct set. Needs no process group of its own (it
    makes and destroys fake ones)."""
    import torch.distributed as dist

    from tpu_dist_torch.plan.tune import default_space

    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("audit_tune_space runs its programs on fake "
                           "process groups of its own: call it with no "
                           "process group up")
    if space is None:
        space = default_space("lm", devices)
    groups: Dict[tuple, list] = {}
    for plan in space:
        groups.setdefault(_structural_key(plan), []).append(plan)
    plans = [groups[key][0] for key in sorted(groups, key=repr)]
    programs = [_program_name(p) for p in plans]
    try:
        with torch.random.fork_rng(devices=[]):
            runs = [_rank_digests(plans, devices, r)
                    for r in range(devices)]
    finally:
        # restore the plan-owned process-wide switches
        from tpu_dist_torch.ops import pallas_quant, pallas_sgd
        from tpu_dist_torch.ops.quant import set_fused_quant

        set_fused_quant(None)
        pallas_quant.set_quant_blocks()
        pallas_sgd.set_block_rows()
    findings: List[Finding] = []
    for name in programs:
        digests = [run[name][1] for run in runs]
        for r, run in enumerate(runs):
            fs = audit_recording(name, run[name][0], digests=digests,
                                 rank=r)
            # a rank-independent finding is reported once
            findings += [f for f in fs if r == 0 or f.check == "PL002"]
    waivers, meta = load_waivers(waivers_path)
    findings = apply_waivers(findings, waivers) + meta
    findings.sort(key=lambda f: (f.program, f.check, f.message))
    return {
        "plans": len(space),
        "programs": len(programs),
        "program_names": programs,
        "findings": [f.to_json() for f in findings],
        "unwaivered": len(unwaivered(findings)),
    }


# ---- report side -----------------------------------------------------------

SARIF_SCHEMA = "https://json.schemastore.org/sarif-2.1.0.json"
SARIF_VERSION = "2.1.0"


def to_sarif(findings: Sequence[Finding]) -> dict:
    """SARIF 2.1.0 document, the reference's shape."""
    rules_meta = [{
        "id": cid,
        "shortDescription": {"text": CHECKS[cid][0]},
        "fullDescription": {"text": CHECKS[cid][1]},
        "defaultConfiguration": {"level": "error"},
    } for cid in sorted(CHECKS)]
    results = [{
        "ruleId": f.check,
        "level": "note" if f.waived else "error",
        "message": {"text": f.message
                    + (f" [waived: {f.reason}]" if f.waived else "")},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {
                    "uri": f"programs/{f.program}",
                    "uriBaseId": "SRCROOT",
                },
                "region": {"startLine": 1, "startColumn": 1},
            },
        }],
    } for f in findings]
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {"name": "proglint",
                                "rules": rules_meta}},
            "results": results,
        }],
    }


def _main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.analysis.proglint",
        description="audit every program in the tuner's candidate space")
    parser.add_argument("--tune-space", default=None, metavar="FILE",
                        help="comm_bench measurement JSON naming the "
                        "device kind; the audited space is the tuner's "
                        "enumeration for it")
    parser.add_argument("--devices", type=int, default=8,
                        help="ranks of the fake process group each program "
                        "runs on")
    parser.add_argument("--waivers", default=None,
                        help=f"waiver file (default {DEFAULT_WAIVERS})")
    parser.add_argument("--json", default=None, metavar="FILE",
                        help="write the canonical report JSON here "
                        "('-' for stdout)")
    parser.add_argument("--sarif-out", default=None, metavar="FILE",
                        help="write a SARIF 2.1.0 artifact here")
    args = parser.parse_args(argv)

    from tpu_dist_torch.plan.tune import default_space

    if args.tune_space:
        with open(args.tune_space) as f:
            json.load(f)     # existence + shape check only
    devices = max(args.devices, 1)
    report = audit_tune_space(default_space("lm", devices),
                              waivers_path=args.waivers, devices=devices)
    text = json.dumps(report, indent=1, sort_keys=True) + "\n"
    if args.json == "-":
        print(text, end="")
    elif args.json:
        with open(args.json, "w") as f:
            f.write(text)
    if args.sarif_out:
        findings = [Finding(**d) for d in report["findings"]]
        with open(args.sarif_out, "w") as f:
            json.dump(to_sarif(findings), f, indent=2, sort_keys=True)
            f.write("\n")
    for d in report["findings"]:
        print(Finding(**d).render())
    print(f"proglint: {report['plans']} plan(s) -> {report['programs']} "
          f"distinct program(s), {len(report['findings'])} finding(s), "
          f"{report['unwaivered']} unwaivered")
    return 1 if report["unwaivered"] else 0


if __name__ == "__main__":
    raise SystemExit(_main())
