"""Step-plan IR for the port (``tpu_dist/plan/ir.py``): one declarative
record for the knobs that pick a training step's variant.

:class:`Plan` names the parallelism layout (``layout`` dp | tp | sp and
``sync`` gspmd | explicit), precision and quantization (``precision``,
``quant``, ``fused_quant``: the ``ops.quant`` dispatch switch), the overlap
knobs (``tp_impl``, ``grad_bucket_mb``, the dispatch ``window`` and
``steps_per_dispatch``), the ``health`` policy, and the tiles of the
hand-written kernels: ``quant_block`` (bm, bn, bk), the output tile and K
split of ``csrc/fused_quant.cu``'s GEMM, and ``opt_block_rows``, whose
eight elements a row make the chunk one CTA of ``csrc/sgd.cu`` and
``csrc/adamw.cu`` updates.

This module is the reference's, field for field and rule for rule, so a
plan file is interchangeable between the two packages: the same plan has
the same canonical JSON (:meth:`Plan.to_json`) and the same
:func:`plan_hash` in both. A Plan is frozen, JSON-round-trippable and
content-addressed (sha256 over the canonical JSON). ``plan/compile.py``
lowers it to the trainers' step callables; ``plan/tune.py`` ranks the
plan space for a device kind.

Stdlib only: the tuner's CLI and the supervisor import it without a
device. The mesh-axis vocabulary is declared here as :data:`KNOWN_AXES`
and pinned against ``parallel/mesh.py`` by AST in the tests, not imported
from it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Tuple

PLAN_VERSION = 1

# the mesh-axis vocabulary (parallel/mesh.py's *_AXIS names, mirrored;
# the tests AST-extract mesh.py and hold this tuple to them)
KNOWN_AXES = ("data", "fsdp", "model", "seq", "stage", "expert", "sp")

ENGINES = ("image", "lm")
LAYOUTS = ("dp", "tp", "sp")
SYNCS = ("gspmd", "explicit")
WINDOWS = ("none", "stacked", "indexed")
PRECISIONS = ("fp32", "bf16", "bf16_params")
QUANTS = ("none", "int8", "int8_wo")
FUSED_QUANT = ("auto", "on", "off")
TP_IMPLS = ("gspmd", "ring")
HEALTH = ("record", "skip", "halt")
COMPRESSIONS = ("none", "bf16")

# the default tiles: fused_quant.cu's 128 x 128 GEMM tile over the whole
# of K (bk = 0), and 512 rows of 8 elements, the 4096-element chunk of one
# CTA of sgd.cu and adamw.cu
DEFAULT_QUANT_BLOCK = (128, 128, 0)
DEFAULT_OPT_BLOCK_ROWS = 512


class PlanError(ValueError):
    """A plan that names an invalid or inconsistent knob combination."""


def validate_quant_block(bm: int, bn: int, bk: int) -> None:
    """The (bm, bn, bk) tile legality for the fused int8 kernel, shared
    by :meth:`Plan.validate` and ``ops.pallas_quant.set_quant_blocks``
    (its env seed included); the reference's rule and messages. The CUDA
    kernel (``csrc/fused_quant.cu``) runs every tile this accepts: its
    compiled tiles on their own warp grids, every other one on its general
    instance, so the IR and the kernel agree on what a legal tile is.
    Raises :class:`PlanError`."""
    if bm < 8 or bm % 8:
        raise PlanError(f"quant_block bm={bm}: Mosaic needs a positive "
                        "multiple of the fp32 sublane (8)")
    if bn < 128 or bn % 128:
        raise PlanError(f"quant_block bn={bn}: a positive multiple of "
                        "the lane width (128)")
    if bk != 0 and (bk < 128 or bk % 128):
        raise PlanError(f"quant_block bk={bk}: 0 (whole contracting "
                        "dim) or a positive multiple of 128")


def validate_opt_block_rows(rows: int) -> None:
    """The fused optimizers' row-tile legality, shared by
    :meth:`Plan.validate` and ``ops.pallas_sgd.set_block_rows``."""
    if rows < 8 or rows % 8:
        raise PlanError(f"opt_block_rows={rows}: a positive multiple "
                        "of 8 (fp32 sublane)")


@dataclass(frozen=True)
class Plan:
    """One declarative step plan. Every field is a trace-time-static knob
    of the step compiler; cross-field legality lives in :meth:`validate`
    (the same exclusion rules the engines enforced by hand, in one place).
    """

    engine: str = "lm"                  # image | lm
    # -- parallelism layout
    layout: str = "dp"                  # dp | tp | sp
    sync: str = "gspmd"                 # gspmd (jit/GSPMD) | explicit (shard_map)
    data_axis: str = "data"
    model_axis: str = "model"           # rides with layout='tp'
    seq_axis: str = "seq"               # rides with layout='sp'
    # -- precision / quantization
    precision: str = "fp32"             # fp32 | bf16 | bf16_params (image)
    quant: str = "none"                 # none | int8 | int8_wo (ops.quant)
    fused_quant: str = "auto"           # ops.pallas_quant dispatch: auto|on|off
    # -- comm/compute overlap
    tp_impl: str = "gspmd"              # gspmd | ring (parallel.overlap)
    grad_bucket_mb: float = 0.0         # >0: DDP-style bucketed grad sync
    grad_compression: str = "none"      # none | bf16 (image explicit step)
    predivide_factor: float = 1.0       # horovod predivide (image explicit)
    adasum: bool = False                # Adasum reduction (image explicit)
    # -- dispatch / window
    window: str = "none"                # none | stacked | indexed
    steps_per_dispatch: int = 1         # K steps per dispatch (window != none)
    grad_accum_steps: int = 1           # microbatches per optimizer step
    loss_chunk: int = 0                 # chunked head+CE (lm, ops.fused_xent)
    # -- probes / health
    health: str = "record"              # obs.health policy fused into the step
    # -- objective / memory
    aux_weight: float = 0.01            # MoE aux-loss weight (lm)
    donate: bool = True                 # in place; False: on copies
    # -- kernel tiles (fused_quant.cu; sgd.cu and adamw.cu)
    quant_block: Tuple[int, int, int] = DEFAULT_QUANT_BLOCK  # (bm, bn, bk)
    opt_block_rows: int = DEFAULT_OPT_BLOCK_ROWS

    # ------------------------------------------------------------------
    def validate(self) -> "Plan":
        """Raise :class:`PlanError` on any invalid field or combination;
        returns self so call sites can chain. These are exactly the
        exclusion rules engine/loop.py + engine/lm_loop.py enforce (one
        home now, so a new mode cannot drift between them)."""
        def _enum(name, value, allowed):
            if value not in allowed:
                raise PlanError(f"plan.{name}={value!r} "
                                f"({'|'.join(map(str, allowed))})")

        _enum("engine", self.engine, ENGINES)
        _enum("layout", self.layout, LAYOUTS)
        _enum("sync", self.sync, SYNCS)
        _enum("window", self.window, WINDOWS)
        _enum("precision", self.precision, PRECISIONS)
        _enum("quant", self.quant, QUANTS)
        _enum("fused_quant", self.fused_quant, FUSED_QUANT)
        _enum("tp_impl", self.tp_impl, TP_IMPLS)
        _enum("health", self.health, HEALTH)
        _enum("grad_compression", self.grad_compression, COMPRESSIONS)
        for name in ("data_axis", "model_axis", "seq_axis"):
            _enum(name, getattr(self, name), KNOWN_AXES)
        if self.engine == "image":
            if self.layout == "sp":
                raise PlanError("layout='sp' (ring attention) is an LM "
                                "layout; the image engine has no sequence "
                                "axis")
            if self.loss_chunk:
                raise PlanError("loss_chunk is an LM knob (chunked head+CE)")
        else:
            if self.adasum or self.grad_compression != "none" \
                    or self.predivide_factor != 1.0:
                raise PlanError("adasum/grad_compression/predivide are "
                                "image explicit-step knobs (the horovod "
                                "surface); the LM explicit step carries "
                                "grad_bucket_mb only")
            if self.precision == "bf16_params":
                raise PlanError("precision='bf16_params' is image-only")
            if self.window == "stacked":
                raise PlanError("window='stacked' is the image engine's "
                                "host-fed K-step window; the LM windowed "
                                "path is 'indexed' (HBM-resident rows)")
        if self.tp_impl == "ring" and not (self.layout == "tp"
                                           and self.sync == "explicit"):
            raise PlanError("tp_impl='ring' is the explicit collective "
                            "matmul: it needs layout='tp' + "
                            "sync='explicit' (a 'model' axis for the "
                            "ppermute rings to ride)")
        if self.layout == "tp" and self.sync == "explicit" \
                and self.tp_impl != "ring":
            raise PlanError("layout='tp' + sync='explicit' IS the ring "
                            "path (tp_impl='ring'); GSPMD TP lowers "
                            "through sync='gspmd'")
        if self.layout == "sp" and self.sync != "explicit":
            raise PlanError("layout='sp' runs ring attention inside "
                            "shard_map; it requires sync='explicit'")
        if self.grad_bucket_mb < 0:
            raise PlanError("grad_bucket_mb must be >= 0")
        if self.grad_bucket_mb > 0:
            if self.sync != "explicit":
                raise PlanError("grad_bucket_mb decomposes the EXPLICIT "
                                "gradient allreduce; it requires "
                                "sync='explicit' (the gspmd flavor's sync "
                                "is GSPMD-scheduled)")
            if self.layout == "sp" or (self.layout == "tp"
                                       and self.engine == "lm"):
                raise PlanError("grad_bucket_mb decomposes the data-axis "
                                "gradient allreduce of replicated params; "
                                "lm tp/sp layouts keep their own sync "
                                "(the image explicit step may bucket over "
                                "'data' while ring-pmean'ing over 'model')")
        if self.adasum and self.grad_bucket_mb > 0:
            raise PlanError("grad_bucket_mb decomposes the mean allreduce; "
                            "adasum replaces it — the two are exclusive")
        if self.adasum and self.grad_compression != "none":
            raise PlanError("adasum replaces the compressed-mean "
                            "allreduce; use grad_compression='none'")
        if self.steps_per_dispatch < 1:
            raise PlanError("steps_per_dispatch must be >= 1")
        if self.grad_accum_steps < 1:
            raise PlanError("grad_accum_steps must be >= 1")
        if self.grad_accum_steps > 1:
            if self.steps_per_dispatch > 1 or self.window != "none":
                raise PlanError("grad_accum_steps and windowed dispatch "
                                "(steps_per_dispatch/window) are mutually "
                                "exclusive")
            if self.sync != "gspmd" or self.layout == "sp":
                raise PlanError("grad_accum_steps > 1 rides the gspmd "
                                "(jit) modes only")
        if self.window != "none" and self.steps_per_dispatch < 1:
            raise PlanError("a windowed plan needs steps_per_dispatch >= 1")
        if self.window == "stacked" and self.sync != "gspmd":
            raise PlanError("window='stacked' is compiler-partitioned "
                            "(sync='gspmd')")
        if self.window == "indexed" and self.engine == "image" \
                and self.sync != "gspmd":
            raise PlanError("the image indexed window is compiler-"
                            "partitioned (sync='gspmd'); routing an "
                            "explicit config through it would drop grad "
                            "compression/predivide semantics")
        if self.loss_chunk < 0:
            raise PlanError("loss_chunk must be >= 0")
        validate_quant_block(*self.quant_block)
        validate_opt_block_rows(self.opt_block_rows)
        return self

    def validate_against_mesh(self, axis_sizes: dict) -> "Plan":
        """Check the plan's layout against a mesh's {axis: size} dict
        (``plan.compile`` passes the trainer's mesh shape)."""
        self.validate()
        for name in set(axis_sizes) - set(KNOWN_AXES):
            raise PlanError(f"mesh axis {name!r} is not in the "
                            f"parallel/mesh.py vocabulary {KNOWN_AXES}")
        if self.data_axis not in axis_sizes:
            raise PlanError(f"plan data_axis {self.data_axis!r} not in "
                            f"mesh axes {tuple(axis_sizes)}")
        if self.layout == "tp" and axis_sizes.get(self.model_axis, 1) < 2:
            raise PlanError(f"layout='tp' needs mesh axis "
                            f"{self.model_axis!r} of size >= 2 "
                            f"(mesh: {axis_sizes})")
        if self.layout == "sp" and axis_sizes.get(self.seq_axis, 1) < 2:
            raise PlanError(f"layout='sp' needs mesh axis "
                            f"{self.seq_axis!r} of size >= 2 "
                            f"(mesh: {axis_sizes})")
        return self

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["quant_block"] = list(self.quant_block)
        d["version"] = PLAN_VERSION
        return d

    def to_json(self) -> str:
        """Canonical JSON: sorted keys, no whitespace variance — the byte
        stream :func:`plan_hash` digests and the tuner emits."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        d = dict(d)
        version = d.pop("version", PLAN_VERSION)
        if version != PLAN_VERSION:
            raise PlanError(f"plan version {version} != {PLAN_VERSION} "
                            "(re-emit with this tree's tools/tune.py)")
        d.pop("hash", None)    # tuner outputs carry the stamp; recomputed
        d.pop("score", None)   # tuner diagnostics ride beside the knobs
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise PlanError(f"unknown plan field(s) {sorted(unknown)} "
                            f"(known: {sorted(known)})")
        if "quant_block" in d:
            qb = d["quant_block"]
            if not (isinstance(qb, (list, tuple)) and len(qb) == 3):
                raise PlanError(f"quant_block must be [bm, bn, bk], got "
                                f"{qb!r}")
            d["quant_block"] = tuple(int(v) for v in qb)
        return cls(**d).validate()

    @classmethod
    def from_json(cls, s: str) -> "Plan":
        return cls.from_dict(json.loads(s))


def plan_hash(plan: Plan) -> str:
    """Content address of a plan: sha256 over the canonical JSON (12 hex
    chars — enough to tag benches/ledgers, short enough to read)."""
    return hashlib.sha256(plan.to_json().encode()).hexdigest()[:12]


# ---- plan files -----------------------------------------------------------
# The tuner emits {"version", "plans": {"<device_kind>": {...plan...}}};
# a bare single-plan object {"engine": ...} is accepted too (hand-written
# plans). select-by-device-kind falls back to a "default" entry.

def load_plan_file(path: str) -> dict:
    """Parse a plan JSON file into {device_kind: Plan}. Accepts the tuner
    output shape or one bare plan object (keyed as 'default')."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise PlanError(f"{path}: not a JSON object")
    if "plans" in doc:
        plans = doc["plans"]
        if not isinstance(plans, dict) or not plans:
            raise PlanError(f"{path}: 'plans' must be a non-empty object "
                            "of device_kind -> plan")
        return {k: Plan.from_dict(v) for k, v in plans.items()}
    return {"default": Plan.from_dict(doc)}


def plan_for_device(plans: dict, device_kind: str) -> Plan:
    """Pick the plan for ``device_kind``: exact key, then substring match
    (the peak tables' convention: 'H100' matches 'NVIDIA H100 80GB
    HBM3'), then the 'default' entry."""
    if device_kind in plans:
        return plans[device_kind]
    kind = (device_kind or "").lower()
    for key, plan in sorted(plans.items()):
        if key != "default" and key.lower() in kind:
            return plan
    if "default" in plans:
        return plans["default"]
    raise PlanError(f"no plan for device kind {device_kind!r} and no "
                    f"'default' entry (have: {sorted(plans)})")


# ---- plan -> config -------------------------------------------------------

# config fields a plan owns, by engine; everything else in the config
# (data paths, schedules, observability) is run-level, not plan-level
_SHARED_FIELDS = ("quant", "tp_impl", "grad_bucket_mb", "steps_per_dispatch",
                  "grad_accum_steps", "health", "precision")
_LM_FIELDS = _SHARED_FIELDS + ("loss_chunk",)
_IMAGE_FIELDS = _SHARED_FIELDS + ("grad_compression", "adasum")


def apply_plan_to_config(cfg, plan: Plan):
    """dataclasses.replace the plan-owned knobs into a TrainConfig/LMConfig
    (pure: no global state; switching the kernels' dispatch and tiles is
    ``plan.compile.activate_plan``'s job). Returns the new config."""
    plan.validate()
    fields = {f.name for f in dataclasses.fields(type(cfg))}
    is_image = "variant" in fields      # TrainConfig carries the jit/
    #                                     shard_map flavor tag; LMConfig
    #                                     picks the mode from the mesh
    want = _IMAGE_FIELDS if is_image else _LM_FIELDS
    if is_image and plan.engine != "image":
        raise PlanError(f"plan engine {plan.engine!r} applied to a "
                        "TrainConfig (image engine)")
    if not is_image and plan.engine != "lm":
        raise PlanError(f"plan engine {plan.engine!r} applied to an "
                        "LMConfig")
    updates = {k: getattr(plan, k) for k in want if k in fields}
    if is_image:
        updates["variant"] = ("shard_map" if plan.sync == "explicit"
                              else "jit")
        updates["gradient_predivide_factor"] = plan.predivide_factor
    if plan.window == "indexed":
        updates["data_placement"] = "device"
    return dataclasses.replace(cfg, **updates)


def plan_knob_summary(plan: Plan) -> dict:
    """The compact non-default knob view stamped into ledgers and bench
    headlines (full plans live in the plan file; records carry the diff)."""
    base = Plan(engine=plan.engine)
    return {k: v for k, v in plan.to_dict().items()
            if k != "version" and v != getattr(
                base, k, None) and not (k == "quant_block"
                                        and tuple(v) == base.quant_block)}
