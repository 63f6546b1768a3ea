"""tpu_dist_torch.sim — trace-driven fleet simulation (the port's
``tpu_dist/sim``).

N supervised serve-engine processes under one declarative **scenario
schedule** (diurnal Poisson traffic, preemption waves, slow-host skew,
host returns, bursts, an autoscaler that parks and admits standby hosts),
each writing its normal attempt ledger plus the supervisor ``.sup.jsonl``
sibling. Every piece it composes exists one process at a time: fault
injection (:mod:`tpu_dist_torch.obs.faults`), goodput and SLO accounting
(:mod:`tpu_dist_torch.obs.goodput`), the serve engine
(:mod:`tpu_dist_torch.engine.serve`), the elastic supervisor and
consensus (:mod:`tpu_dist_torch.parallel.supervisor`).

Modules (attribute access is lazy, PEP 562: the scenario grammar and the
fleet stitcher load without the serve stack):

* :mod:`~tpu_dist_torch.sim.scenario` — the schedule grammar + its
  deterministic compiler (stdlib-only; the reference's draw order, so the
  same schedule + seed give the same admitted requests and faults);
* :mod:`~tpu_dist_torch.sim.fleet` — the :class:`FleetLedger` stitcher:
  cross-host discovery, clock normalization and the fleet rollups;
* :mod:`~tpu_dist_torch.sim.runner` — :class:`FleetSim`, the runner that
  launches one :class:`~tpu_dist_torch.parallel.supervisor.Supervisor`
  per virtual host and executes the scenario's consensus actions (it
  opens no device; only the worker children do);
* :mod:`~tpu_dist_torch.sim.worker` — the child process entry
  (``python -m tpu_dist_torch.sim.worker``): a ``tiny_lm`` behind a
  :class:`~tpu_dist_torch.engine.serve.ServeEngine` on ``--device``
  (default ``cuda``), replaying its host's arrival slice in paced tick
  time.

``python -m tpu_dist_torch.tools.fleet_report`` renders the stitched
fleet.
"""

import importlib

_LAZY = {
    "scenario": None,
    "fleet": None,
    "runner": None,
    "worker": None,
    # scenario grammar
    "Scenario": "scenario", "HostPlan": "scenario", "Arrival": "scenario",
    "load_scenario": "scenario",
    # fleet stitcher
    "FleetLedger": "fleet",
    # runner
    "FleetSim": "runner",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    target = _LAZY.get(name)
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    if target is None:
        return importlib.import_module(f"{__name__}.{name}")
    module = importlib.import_module(f"{__name__}.{target}")
    return getattr(module, name)


def __dir__():
    return __all__
