"""Plan lowering for the port (``tpu_dist/plan/compile.py``): a
:class:`~tpu_dist_torch.plan.ir.Plan` to the trainers' step callables.

The reference lowers a plan in four passes (validate, template, window,
partition) to jitted XLA programs. The port's steps are eager, one process
a device, so the partition pass is the bindings the trainer already built
for its mode: an ``engine.lm_steps.ModelParallel`` (dp, fsdp, tp, tp-ring,
sp-ring, ep) or a ``parallel.pp.Pipeline`` for the LM, an
``engine.steps.DataParallel`` (the ``jit`` or ``shard_map`` sync) for
images. :func:`compile_plan` validates the plan against the mesh, picks the
engine's one step template (``engine.lm_steps.lm_train_step`` /
``lm_eval_metrics``, ``engine.steps.image_train_step`` /
``image_eval_metrics``; gradient accumulation is their ``accum``, i.e.
``engine.steps.accumulate``) and wraps it in the plan's dispatch window:
``indexed`` runs K steps back to back over device-resident rows gathered by
an index window, ``stacked`` over K host-fed batches, with the metric sums
added up on the device. It adds no second copy of step logic; both
trainers take their steps from here.

``donate``: the port's steps update the train state in place, which is
what buffer donation buys XLA (the audit's PL003 holds them to it under
``donate=True``). Under ``donate=False`` a dispatch runs on a new train
state that copies every tensor of the caller's (parameters, optimizer
moments, batch stats, the loss scale) and its step counter
(:func:`_undonated`): the bound model is rebound onto the copies, the
step writes only them, and the dispatch returns (the new state, the
metric sums), as the reference's jitted step returns its new state. The
caller's state object, its tensors and its ``step`` keep what they had,
as XLA keeps an undonated input buffer; the new state is bit-equal to the
donated step's. :meth:`CompiledPlan.advance` runs either flag's dispatch
and gives the state after it.

:func:`activate_plan` sets the plan's process-wide switches (the fused
int8 dispatch, ``fused_quant.cu``'s tile, the optimizer kernels' rows) and
:func:`resolve_config_plan` implements the configs' ``plan`` knob:
``""``/``"none"``, a plan file from ``tools/tune.py`` (per device kind), or
``"auto"``, the tuner's search over the candidates this config can run.

The program audit (``analysis.proglint``) is a process-wide switch in the
:func:`activate_plan` mold: the trainers arm it from ``cfg.audit``
(:func:`set_audit`), record their program's first dispatch
(:func:`audit_recorder`, then :func:`finish_audit`: one ``audit`` event a
program) and read the recompile sentry at their drain boundaries
(:func:`check_audit_sentry`); the serving engine registers its page
programs and notes each dispatch's input signature
(:func:`register_audit_program`, :func:`note_audit_dispatch`).
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass
from typing import Any, Callable, Optional

from tpu_dist_torch.plan.ir import (Plan, PlanError, apply_plan_to_config,
                                    plan_hash, plan_knob_summary)

@dataclass
class Bindings:
    """What a plan lowers against: the run's own objects. ``model`` must
    already embody the plan's quant and layout (the trainers build it from
    the config the plan was applied to)."""

    mesh: Any = None               # parallel.mesh.Mesh (None: one process)
    model: Any = None
    tx: Any = None                 # optimizer (fused apply() or optax-like)
    par: Any = None                # lm: engine.lm_steps.ModelParallel
    pipe: Any = None               # lm pp: parallel.pp.Pipeline
    dp: Any = None                 # engine.steps.DataParallel
    transform: Optional[Callable] = None        # image train transform
    eval_transform: Optional[Callable] = None   # image eval transform
    gen: Optional[Callable] = None  # image: global step -> torch.Generator
    # image: global step -> the step's dropout torch.Generator (or None)
    dropout_gen: Optional[Callable] = None


class CompiledPlan:
    """The lowered callables of one (plan, bindings), built on first use:
    ``step`` is the one-step template the window runs, ``train_step`` the
    plan's dispatch (``step`` itself without a window), ``eval_step`` the
    forward-only metric sums.

    LM: ``step(state, inputs, targets)``; ``train_step(state, rows_all,
    idx_window)`` under ``window="indexed"``; ``eval_step(state, inputs,
    targets, valid)``. Image: ``step(state, images, labels, gstep)``;
    ``train_step(state, images_k, labels_k, gstep)`` under ``stacked``,
    ``(state, images_all, labels_all, idx_window, gstep)`` under
    ``indexed``; ``eval_step(images, labels, valid)``. Each returns the
    metric sums (train: summed over the window); under ``donate=False``
    ``step`` and ``train_step`` return (the new state, the sums)."""

    def __init__(self, plan: Plan, binds: Bindings):
        _pass_validate(plan, binds)
        self.plan = plan
        self.binds = binds
        self._tmpl = self._step = self._train = self._eval = None

    def _template(self) -> Callable:
        if self._tmpl is None:
            self._tmpl = (_image_step if self.plan.engine == "image"
                          else _lm_step)(self.plan, self.binds)
        return self._tmpl

    @property
    def step(self) -> Callable:
        if self._step is None:
            self._step = _donation(self.plan, self.binds, self._template())
        return self._step

    @property
    def train_step(self) -> Callable:
        if self._train is None:
            self._train = _donation(self.plan, self.binds,
                                    _window(self.plan, self._template()))
        return self._train

    @property
    def eval_step(self) -> Callable:
        if self._eval is None:
            self._eval = (_image_eval if self.plan.engine == "image"
                          else _lm_eval)(self.plan, self.binds)
        return self._eval

    def advance(self, fn: Callable, state, *args):
        """``fn`` (``step`` or ``train_step``) dispatched from ``state``:
        (the state after it, the metric sums). Under ``donate`` that is
        ``state`` itself, updated in place; else a new state, and
        ``state`` is left as it was."""
        if self.plan.donate:
            return state, fn(state, *args)
        return fn(state, *args)


def compile_plan(plan: Plan, binds: Bindings) -> CompiledPlan:
    """Validate ``plan`` against ``binds`` and return its lazy callables."""
    return CompiledPlan(plan, binds)


# ---- pass 1: validate -----------------------------------------------------

def _pass_validate(plan: Plan, binds: Bindings) -> None:
    plan.validate()
    # a mesh axis the port's mesh lacks has size 1 (parallel.mesh)
    shape = {plan.data_axis: 1, **(dict(binds.mesh.shape)
                                   if binds.mesh is not None else {})}
    plan.validate_against_mesh(shape)
    if plan.engine == "image" and binds.model is not None \
            and binds.transform is None and binds.tx is not None:
        raise PlanError("the image templates need a transform binding")


# ---- pass 2: the one step template per engine -----------------------------

def _lm_step(plan: Plan, b: Bindings) -> Callable:
    """One LM optimizer step: ``lm_train_step`` under the mode's
    ``ModelParallel`` (``grad_accum_steps`` microbatches), or the
    pipeline's step."""
    from tpu_dist_torch.engine.lm_steps import lm_train_step

    health, chunk, accum = (plan.health, plan.loss_chunk,
                            plan.grad_accum_steps)
    if b.pipe is not None:
        def pipe_step(state, inputs, targets):
            return b.pipe.train_step(state, inputs, targets, b.tx, health)
        return pipe_step
    par = _lm_par(plan, b)

    def step(state, inputs, targets):
        return lm_train_step(b.model, b.tx, state, inputs, targets, health,
                             chunk, accum, par.dp, par)
    return step


def _lm_par(plan: Plan, b: Bindings):
    """The binding's ``ModelParallel``, or the data-parallel one over its
    ``dp`` with the plan's ``aux_weight``."""
    from tpu_dist_torch.engine.lm_steps import ModelParallel
    from tpu_dist_torch.engine.steps import ONE_PROCESS

    if b.par is not None:
        return b.par
    return ModelParallel(dp=b.dp or ONE_PROCESS, aux_weight=plan.aux_weight)


def _image_step(plan: Plan, b: Bindings) -> Callable:
    """One image optimizer step: ``image_train_step`` with the step's
    augmentation and dropout generators (each from that step's global
    step, inside a window too), ``grad_accum_steps`` microbatches and the
    ``DataParallel`` sync."""
    from tpu_dist_torch.engine.steps import ONE_PROCESS, image_train_step

    health, accum = plan.health, plan.grad_accum_steps
    dp = b.dp or ONE_PROCESS

    def step(state, images, labels, gstep):
        gen = b.gen(gstep) if b.gen is not None else None
        drop = b.dropout_gen(gstep) if b.dropout_gen is not None else None
        return image_train_step(b.model, b.tx, state, images, labels,
                                b.transform, health, gen, accum, dp, drop)
    return step


def _state_tensors(state) -> list:
    """Every tensor of a train state: parameters, optimizer moments (and
    counts), batch stats, the loss scale."""
    scale = list(state.loss_scale) if state.loss_scale is not None else []
    return [*state.params, *state.opt_tensors(), *state.batch_stats, *scale]


def _copied(v):
    """``v`` with every tensor in it copied to new storage (a Parameter
    to a new Parameter), through lists and (named) tuples."""
    import torch

    if isinstance(v, torch.nn.Parameter):
        return torch.nn.Parameter(v.detach().clone(), v.requires_grad)
    if torch.is_tensor(v):
        return v.detach().clone().requires_grad_(v.requires_grad)
    if isinstance(v, list):
        return [_copied(x) for x in v]
    if isinstance(v, tuple):
        items = [_copied(x) for x in v]
        return type(v)(*items) if hasattr(v, "_fields") else tuple(items)
    return v


def _rebind(modules, old: list, new: list) -> None:
    """Register ``new[i]`` wherever one of ``modules`` holds ``old[i]`` as
    a parameter or buffer (every holder of a tied leaf). A leaf no module
    holds (the fsdp shards, which the step gathers itself) is skipped."""
    swap = {id(o): n for o, n in zip(old, new)}
    for model in modules:
        for mod in model.modules():
            for table in (mod._parameters, mod._buffers):
                for k, v in table.items():
                    if v is not None and id(v) in swap:
                        table[k] = swap[id(v)]


def _undonated(b: Bindings, step: Callable) -> Callable:
    """``step`` on a copy of the train state (``donate=False``): a new
    ``TrainState`` with a copy of every tensor and its own step counter,
    the bound model (and the pipeline's stage model) rebound onto the
    copies, which the step then updates. Returns (the new state, the
    step's metric sums); the caller's state is not touched."""
    import torch

    modules = [m for m in (b.model, getattr(b.pipe, "model", None))
               if m is not None]
    modules = [m for i, m in enumerate(modules) if m not in modules[:i]]

    def run(state, *args):
        with torch.no_grad():
            new = dataclasses.replace(
                state, params=_copied(state.params),
                opt_state=_copied(state.opt_state),
                batch_stats=_copied(state.batch_stats),
                param_names=list(state.param_names),
                stat_names=list(state.stat_names),
                loss_scale=_copied(state.loss_scale))
            _rebind(modules, _state_tensors(state), _state_tensors(new))
        return new, step(new, *args)
    return run


def _donation(plan: Plan, b: Bindings, step: Callable) -> Callable:
    """The plan's dispatch under its ``donate`` flag: ``step`` itself (in
    place, the donated buffers reused), or :func:`_undonated` once a
    dispatch (a window copies once, as XLA's program does)."""
    return step if plan.donate else _undonated(b, step)


# ---- pass 3: the dispatch window ------------------------------------------

def _add(sums, m):
    return m if sums is None else {k: sums[k] + m[k] for k in m}


def _window(plan: Plan, step: Callable) -> Callable:
    """``step`` itself (``window="none"``), or K steps back to back with no
    host sync, their metric sums added on the device: ``indexed`` gathers
    each step's rows from the resident data by its row of the index
    window (the LM shifts (B, L+1) token rows into inputs and targets),
    ``stacked`` takes each from K host-fed batches."""
    if plan.window == "none":
        return step
    if plan.engine == "lm":
        from tpu_dist_torch.engine.lm_steps import shift_rows

        def lm_window(state, rows_all, idx_window):
            sums = None
            for j in range(len(idx_window)):
                inputs, targets = shift_rows(
                    rows_all.index_select(0, idx_window[j]))
                sums = _add(sums, step(state, inputs, targets))
            return sums
        return lm_window
    if plan.window == "stacked":
        def stacked(state, images_k, labels_k, gstep):
            sums = None
            for j in range(len(images_k)):
                sums = _add(sums, step(state, images_k[j], labels_k[j],
                                       gstep + j))
            return sums
        return stacked

    def indexed(state, images_all, labels_all, idx_window, gstep):
        sums = None
        for j in range(len(idx_window)):
            sums = _add(sums, step(
                state, images_all.index_select(0, idx_window[j]),
                labels_all.index_select(0, idx_window[j]), gstep + j))
        return sums
    return indexed


# ---- eval -----------------------------------------------------------------

def _lm_eval(plan: Plan, b: Bindings) -> Callable:
    from tpu_dist_torch.engine.lm_steps import lm_eval_metrics

    chunk = plan.loss_chunk
    if b.pipe is not None:
        def pipe_eval(state, inputs, targets, valid):
            return b.pipe.eval_metrics(inputs, targets, valid)
        return pipe_eval

    par = _lm_par(plan, b)

    def eval_step(state, inputs, targets, valid):
        return lm_eval_metrics(b.model, inputs, targets, valid, chunk, par,
                               state)
    return eval_step


def _image_eval(plan: Plan, b: Bindings) -> Callable:
    from tpu_dist_torch.engine.steps import image_eval_metrics

    transform = b.eval_transform or b.transform

    def eval_step(images, labels, valid):
        return image_eval_metrics(b.model, transform, images, labels, valid)
    return eval_step


# ---- program audit (analysis.proglint) -----------------------------------

AUDIT_MODES = ("none", "record", "halt")

_AUDIT = {"mode": "none", "ledger": None, "sentry": None}


def validate_audit(mode: str, profile_dir: str = "") -> str:
    """``mode`` if it is one of :data:`AUDIT_MODES` (``""`` is ``none``),
    else ValueError; an audit with a ``profile_dir`` session is refused
    too (the audited dispatch would run inside the profiler's trace)."""
    mode = mode or "none"
    if mode not in AUDIT_MODES:
        raise ValueError(f"audit={mode!r}: pick one of {AUDIT_MODES}")
    if mode != "none" and profile_dir:
        raise ValueError(f"audit={mode!r} with profile_dir: the program "
                         "audit does not record under a profiler session")
    return mode


def set_audit(mode: str, ledger=None) -> None:
    """Arm (or disarm) the program audit for this process. ``record``
    emits ``audit`` ledger events; ``halt`` also raises
    :class:`~tpu_dist_torch.analysis.proglint.AuditError` on any
    unwaivered finding. A fresh sentry per call: each run watches its own
    programs."""
    mode = validate_audit(mode)
    _AUDIT["mode"], _AUDIT["ledger"] = mode, ledger
    if mode == "none":
        _AUDIT["sentry"] = None
    else:
        from tpu_dist_torch.analysis.proglint import RecompileSentry

        _AUDIT["sentry"] = RecompileSentry()


def audit_mode() -> str:
    return _AUDIT["mode"]


def register_audit_program(program: str, allowed: int = 1) -> None:
    """Put a program under the recompile sentry (PL005). ``allowed`` is
    its legal count of distinct input signatures: 1 for fixed-shape step
    programs, the bucket count for serve prefill. No-op when the audit is
    off."""
    if _AUDIT["sentry"] is not None:
        _AUDIT["sentry"].register(program, allowed)


def note_audit_dispatch(program: str, *args) -> None:
    """Note one dispatch's input signature for the sentry (host only, no
    device sync). No-op when the audit is off."""
    if _AUDIT["sentry"] is not None:
        _AUDIT["sentry"].note(program, args)


def _emit_audit(program: str, findings) -> None:
    led = _AUDIT["ledger"]
    if led is not None:
        led.emit("audit", program=program, mode=_AUDIT["mode"],
                 findings=len([f for f in findings if not f.waived]),
                 waived=len([f for f in findings if f.waived]),
                 detail=[f.to_json() for f in findings] or None)


def _verdict(findings) -> None:
    from tpu_dist_torch.analysis import proglint

    bad = proglint.unwaivered(findings)
    if bad and _AUDIT["mode"] == "halt":
        raise proglint.AuditError(
            "audit=halt: " + "; ".join(f.render() for f in bad))


def audit_recorder(program: str, state=None, allowed: int = 1):
    """The recorder of ``program``'s audited dispatch (a
    ``proglint.ProgramRecorder`` to run the dispatch under, snapshotting
    ``state``'s storage), with the program registered for the sentry; None
    when the audit is off. The recorder costs Python time per operator:
    it never runs under CUDA graph capture or a profiler session."""
    if _AUDIT["mode"] == "none":
        return None
    import torch

    if (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()) \
            or torch.autograd._profiler_enabled():
        raise RuntimeError(f"audit of {program!r}: the program audit does "
                           "not record under CUDA graph capture or a "
                           "profiler session")
    from tpu_dist_torch.analysis.proglint import ProgramRecorder

    register_audit_program(program, allowed)
    return ProgramRecorder(state)


def finish_audit(program: str, rec, *, precision: Optional[str] = None,
                 donate: bool = True, device=None):
    """The audit of one recorded dispatch: every rank's collective digest
    all-gathered once over the world group (a collective: every rank
    calls it), the checks, the waivers, exactly one ``audit`` event.
    Returns the (waiver-applied) findings; raises AuditError under
    ``halt`` when any survive."""
    if rec is None:
        return []
    import torch.distributed as dist

    from tpu_dist_torch.analysis import proglint

    digests = proglint.exchange_digests(rec, device)
    rank = dist.get_rank() if digests is not None else 0
    findings = proglint.audit_recording(program, rec, precision=precision,
                                        donate=donate, digests=digests,
                                        rank=rank)
    waivers, meta = proglint.load_waivers()
    findings = proglint.apply_waivers(findings, waivers) + meta
    _emit_audit(program, findings)
    _verdict(findings)
    return findings


def audit_program(program: str, fn, *args, precision: Optional[str] = None,
                  allowed: int = 1, state=None, donate: bool = True,
                  device=None):
    """Run ``fn(*args)`` once under the audit and audit that dispatch
    (:func:`audit_recorder` + :func:`finish_audit`); its signature is
    noted for the sentry. Returns the findings ([] when the audit is off:
    ``fn`` does not run then)."""
    rec = audit_recorder(program, state, allowed)
    if rec is None:
        return []
    note_audit_dispatch(program, *args)
    with rec:
        fn(*args)
    return finish_audit(program, rec, precision=precision, donate=donate,
                        device=device)


def check_audit_sentry() -> None:
    """The drain-boundary PL005 check: one host-side count per
    registered program. Findings latch per program, so ``record`` emits
    exactly one ``audit`` event per offender; ``halt`` raises on
    unwaivered ones."""
    sentry = _AUDIT["sentry"]
    if sentry is None:
        return
    findings = sentry.check()
    if not findings:
        return
    from tpu_dist_torch.analysis import proglint

    waivers, _ = proglint.load_waivers()
    findings = proglint.apply_waivers(findings, waivers)
    for f in findings:
        _emit_audit(f.program, [f])
    _verdict(findings)


# ---- plan activation and the config knob ----------------------------------

def activate_plan(plan: Plan) -> None:
    """Set the plan's process-wide switches: the fused int8 dispatch
    (``ops.quant.set_fused_quant``), ``fused_quant.cu``'s GEMM tile
    (``ops.pallas_quant.set_quant_blocks``) and the optimizer kernels' rows
    a CTA (``ops.pallas_sgd.set_block_rows``, shared with
    ``ops.pallas_adamw``). Call before the steps run."""
    from tpu_dist_torch.ops import pallas_quant, pallas_sgd
    from tpu_dist_torch.ops.quant import set_fused_quant

    set_fused_quant({"auto": None, "on": True, "off": False}[
        plan.fused_quant])
    pallas_quant.set_quant_blocks(*plan.quant_block)
    pallas_sgd.set_block_rows(plan.opt_block_rows)


def current_switches() -> dict:
    """The plan-owned switches as they stand: ``fused_quant``,
    ``quant_block`` and ``opt_block_rows``, in the IR's terms."""
    from tpu_dist_torch.ops import pallas_quant, pallas_sgd, quant

    fq = {None: "auto", True: "on", False: "off"}[quant._FUSED_QUANT]
    return {"fused_quant": fq, "quant_block": pallas_quant.quant_blocks(),
            "opt_block_rows": pallas_sgd.block_rows()}


def _devices() -> int:
    """The ``torch.distributed`` world size, or 1 without a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _auto_workload(cfg, engine: str) -> dict:
    """A tuner workload from a config (``:774-788``): crude param counts
    are fine, the search ranks knobs."""
    if engine == "lm":
        n = (cfg.vocab_size * cfg.d_model
             + cfg.num_layers * 12 * cfg.d_model * cfg.d_model)
        toks = cfg.batch_size * cfg.seq_len
    else:
        n = 25_000_000                       # resnet50-scale placeholder
        toks = cfg.batch_size
    return {"engine": engine, "n_params": float(n),
            "tokens_per_step": float(toks), "devices": _devices()}


def _auto_filter(cfg, engine: str):
    """Prune ``auto`` candidates to what this config can run
    (``:790-821``): a plan file is applied as it is and may fail loudly;
    ``auto`` must never break a working config."""
    mesh_shape = getattr(cfg, "mesh_shape", None) or ()
    mesh_axes = tuple(getattr(cfg, "mesh_axes", ("data",)))
    multi = {a for a, s in zip(mesh_axes, mesh_shape) if a != "data"
             and (s is None or s > 1)}
    pure_dp = not multi and not getattr(cfg, "fsdp", False)
    accum = getattr(cfg, "grad_accum_steps", 1) > 1
    host_data = getattr(cfg, "data_placement", "auto") == "host"
    quant_ok = (engine == "lm"
                or getattr(cfg, "arch", "").startswith("vit"))

    def keep(plan: Plan) -> bool:
        if plan.quant != "none" and not quant_ok:
            return False
        if plan.grad_bucket_mb > 0 and not (pure_dp and not accum):
            return False
        if plan.sync == "explicit" and not pure_dp:
            return False
        if plan.window != "none" and (host_data or accum):
            return False
        if plan.window != "none" and engine == "image" \
                and getattr(cfg, "dataset", "") == "imagenet":
            # an ImageFolder set is not resident: the indexed window
            # would refuse at Trainer init
            return False
        return True

    return keep


def device_kind(device=None) -> str:
    """The device-kind string plans are selected by: the card's name
    (``torch.cuda.get_device_name``) for a CUDA trainer, ``"cpu"``
    otherwise."""
    from tpu_dist_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        return torch.cuda.get_device_name(dev)
    return "cpu"


def resolve_config_plan(cfg, device=None):
    """The configs' ``plan`` knob (``:823-889``): ``""``/``"none"`` is a
    no-op; a path loads a plan file and picks the entry for this device
    kind; ``"auto"`` runs the tuner's analytic search for this device kind
    over the candidates the config can run, carrying the knobs the search
    does not explore from the config. Returns ``(new_cfg, plan_info or
    None)``, ``plan_info`` the {'source', 'hash', 'knobs', 'plan',
    'device_kind'} record the trainers stamp into ``run_start`` and the
    ``plan`` event; applies the plan's switches (:func:`activate_plan`)."""
    spec = getattr(cfg, "plan", "") or ""
    if spec in ("", "none"):
        return cfg, None
    from tpu_dist_torch.plan import ir

    engine = "image" if any(f.name == "variant"
                            for f in dataclasses.fields(type(cfg))) \
        else "lm"
    kind = device_kind(device)
    if spec == "auto":
        from tpu_dist_torch.plan import tune as tune_mod

        keep = _auto_filter(cfg, engine)
        # knobs the auto space does not search stay the config's
        carried = {k: getattr(cfg, k) for k in
                   ("precision", "grad_accum_steps", "health", "tp_impl")
                   if hasattr(cfg, k)}
        if engine == "lm":
            carried["loss_chunk"] = getattr(cfg, "loss_chunk", 0)
        space = []
        for p in tune_mod.default_space(engine, _devices()):
            try:
                p = dataclasses.replace(p, **carried).validate()
            except PlanError:
                continue   # the carried knobs make this candidate illegal
            if keep(p):
                space.append(p)
        if not space:
            # abstaining is loud: the tuner found nothing legal for this
            # config, which is not the same as never running
            print("plan=auto: no legal candidate plans for this config "
                  "(its knobs fall outside the searched space); running "
                  "with the hand-set knobs", file=sys.stderr)
            return cfg, None
        result = tune_mod.search(workload=_auto_workload(cfg, engine),
                                 device_kind=kind, space=space)
        if result["best"] is None:
            return cfg, None
        plan = result["best"]["plan"]
        source = "auto"
    else:
        plans = ir.load_plan_file(spec)
        plan = ir.plan_for_device(plans, kind)
        source = spec
    if plan.engine != engine:
        raise PlanError(f"plan engine {plan.engine!r} does not drive the "
                        f"{engine} engine (plan source: {source})")
    new_cfg = apply_plan_to_config(cfg, plan)
    activate_plan(plan)
    info = {"source": source, "hash": plan_hash(plan),
            "knobs": plan_knob_summary(plan), "plan": plan,
            "device_kind": kind}
    return new_cfg, info
