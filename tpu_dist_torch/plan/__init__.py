"""tpu_dist_torch.plan: the step-plan IR, its lowering to the trainers'
steps, and the tuner (``tpu_dist/plan``).

Lazy (PEP 562), with the reference's exported names: ``plan.ir`` and
``plan.tune`` touch no device (the supervisor and ``tools/tune.py`` import
them), and ``plan.compile`` (the lowering, which imports the trainers'
step modules) resolves only when asked for.
"""

from __future__ import annotations

import importlib

# the submodules resolve first (``from tpu_dist_torch.plan import tune``
# must give the module, not the re-exported tune() function)
_SUBMODULES = ("ir", "tune", "compile")

_IR = ("Plan", "PlanError", "plan_hash", "load_plan_file",
       "plan_for_device", "apply_plan_to_config", "plan_knob_summary",
       "KNOWN_AXES")
_TUNE = ("search", "default_space", "device_peaks",
         "estimate_step_seconds", "emit_plan_file")
_COMPILE = ("compile_plan", "Bindings", "CompiledPlan", "activate_plan",
            "resolve_config_plan")

__all__ = list(_IR + _TUNE + _COMPILE)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"tpu_dist_torch.plan.{name}")
    if name in _IR:
        return getattr(importlib.import_module("tpu_dist_torch.plan.ir"),
                       name)
    if name in _TUNE:
        return getattr(importlib.import_module("tpu_dist_torch.plan.tune"),
                       name)
    if name in _COMPILE:
        return getattr(importlib.import_module(
            "tpu_dist_torch.plan.compile"), name)
    raise AttributeError(
        f"module 'tpu_dist_torch.plan' has no attribute {name!r}")
