"""Numerical-health probes and sentry for the port
(``tpu_dist/obs/health.py``: the probes ``:44-110`` and ``HealthSentry
:111``).

* **Device-side probes** (:func:`probe_update_metrics`): global grad norm,
  count of grad leaves whose squared sum is non-finite, and the norm of
  the applied parameter update, as 0-d fp32 tensors on the device. They
  join every train step's metric sums (``engine.steps.apply_update``) and
  ride the loop's one fetch per print window: no extra host sync. With
  ``health='skip'`` the step gates itself on them (:func:`probes_ok`): a
  non-finite gradient or update leaves params and optimizer state as they
  were, while the step counter still advances.
* **Host-side sentry** (:class:`HealthSentry`, a copy of the reference's):
  consumes the fetched probes and loss at each drain; a non-finite trip
  emits a ``health`` ledger event (and raises :class:`HealthError` under
  ``halt``); a trailing EMA/z-score detector flags loss spikes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

HEALTH_POLICIES = ("record", "skip", "halt")

PROBE_KEYS = ("grad_norm", "nonfinite_count", "update_norm")


def validate_health(policy: str) -> str:
    if policy not in HEALTH_POLICIES:
        raise ValueError(f"unknown health policy {policy!r} "
                         f"({'|'.join(HEALTH_POLICIES)})")
    return policy


class HealthError(RuntimeError):
    """Raised by the sentry under ``health='halt'`` when a trip fires."""


# -- device side ------------------------------------------------------------

def _float_leaves(tensors):
    return [t for t in tensors if t.is_floating_point()]


def probe_update_metrics(grads, old_params, new_params,
                         sq_norm=None) -> dict:
    """The probes as 0-d fp32 tensors: global grad L2 norm, count of grad
    leaves whose squared sum is non-finite (any Inf/NaN value, or a norm
    overflow), and the L2 norm of ``new - old`` params (fp32). One
    sum-of-squares pass over the grads and one over the update.
    ``sq_norm`` (leaves -> global sum of squares) takes the norms over
    sharded leaves, every leaf a float one."""
    g_sq = [t.float().square().sum() for t in _float_leaves(grads)]
    dev = grads[0].device if len(grads) else torch.device("cpu")
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    nonfinite = (sum((~torch.isfinite(s)).float() for s in g_sq)
                 if g_sq else zero)
    if sq_norm is not None:
        diff = [n.float() - o.float() for n, o in zip(new_params,
                                                      old_params)]
        return {"grad_norm": torch.sqrt(sq_norm(list(grads))),
                "nonfinite_count": nonfinite,
                "update_norm": torch.sqrt(sq_norm(diff))}
    u_sq = [(n.float() - o.float()).square().sum()
            for n, o in zip(_float_leaves(new_params),
                            _float_leaves(old_params))]
    return {
        "grad_norm": torch.sqrt(sum(g_sq)) if g_sq else zero,
        "nonfinite_count": nonfinite,
        "update_norm": torch.sqrt(sum(u_sq)) if u_sq else zero,
    }


def probes_ok(probes: dict) -> torch.Tensor:
    """Device-side gate for ``health='skip'``: True iff no grad leaf is
    non-finite and both norms are finite."""
    return ((probes["nonfinite_count"] == 0)
            & torch.isfinite(probes["grad_norm"])
            & torch.isfinite(probes["update_norm"]))


# -- host side (a copy of the reference's sentry) ---------------------------

class HealthSentry:
    """Drain-boundary consumer of the fetched probes + loss.

    ``observe()`` is called by both engines' ``_drain`` once per step
    record (numbers already on host — no sync). Trips:

    * ``nonfinite`` — the record's non-finite-leaf count is > 0, a probe
      norm came back non-finite, or the loss itself is NaN/Inf. Under
      ``skip`` the device already zeroed the update; the event records
      that. Under ``halt`` the sentry raises :class:`HealthError`.
    * ``loss_spike`` — the loss is finite but more than ``spike_z``
      trailing standard deviations above the EMA mean (EMA over the last
      ~``2/alpha`` records, armed after ``warmup`` observations so early
      fast-dropping losses never false-fire). A spike cannot be un-applied,
      so its action is ``record`` unless the policy is ``halt``.

    Every trip emits a ``health`` ledger event (EVENT_SCHEMA), which the
    metrics registry's ledger sink turns into the
    ``tpu_dist_health_trips_total`` counter.
    """

    def __init__(self, policy: str = "record", spike_z: float = 8.0,
                 ledger=None, alpha: float = 0.05, warmup: int = 20):
        self.policy = validate_health(policy)
        self.spike_z = float(spike_z)
        self.ledger = ledger
        self.alpha = alpha
        self.warmup = warmup
        self._mean: Optional[float] = None
        self._var = 0.0
        self._n = 0
        self.trips = 0
        self.trips_by_kind: dict = {}

    def _trip(self, step, kind: str, action: str, value, loss, grad_norm):
        self.trips += 1
        self.trips_by_kind[kind] = self.trips_by_kind.get(kind, 0) + 1
        if self.ledger is not None:
            self.ledger.emit("health", step=step, kind=kind,
                             policy=self.policy, action=action, value=value,
                             loss=loss, grad_norm=grad_norm)
        if action == "halt":
            raise HealthError(
                f"health=halt: {kind} at step {step} (value={value!r}, "
                f"loss={loss!r}, grad_norm={grad_norm!r}) — see the "
                "'health' ledger event")

    def observe(self, step: int, loss, nonfinite=None, grad_norm=None,
                update_norm=None, n_steps: int = 1) -> None:
        """One step record's worth of health signals (window records pass
        their per-step means and the summed non-finite count)."""
        loss = None if loss is None else float(loss)
        loss_bad = loss is not None and not math.isfinite(loss)
        probe_bad = any(v is not None and not math.isfinite(float(v))
                        for v in (grad_norm, update_norm))
        if (nonfinite and float(nonfinite) > 0) or probe_bad or loss_bad:
            self._trip(step, "nonfinite", self.policy,
                       float(nonfinite or 0), loss, grad_norm)
            return  # a non-finite loss must not poison the spike EMA
        if loss is None:
            return
        if self._mean is not None and self._n >= self.warmup \
                and self.spike_z > 0:
            std = math.sqrt(max(self._var, 1e-24))
            z = (loss - self._mean) / std
            if z > self.spike_z:
                self._trip(step, "loss_spike",
                           "halt" if self.policy == "halt" else "record",
                           round(z, 3), loss, grad_norm)
                return  # do not absorb the spike into the baseline
        if self._mean is None:
            self._mean = loss
        else:
            d = loss - self._mean
            self._mean += self.alpha * d
            self._var = (1 - self.alpha) * (self._var + self.alpha * d * d)
        self._n += 1
