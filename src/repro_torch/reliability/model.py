"""Closed-form failure-aware goodput: the Young–Daly checkpoint model.

The port's copy of the JAX package's ``reliability/model.py``. The cost
primitives are the fleet's own (:mod:`repro_torch.fleet.resize`):
one checkpoint write is ``instance_state_bytes / ckpt_bw`` — exactly
what a preemption already pays in the timeline — and a restart reads it
back at ``restore_bw`` after the ``mttr_hours`` repair.

With per-node MTBF ``m`` hours on an ``N``-node synchronous job, the
job-level failure rate is ``lam = N / (m * 3600)`` per second.  Writing
a checkpoint costs ``C`` seconds every ``tau`` seconds; each failure
loses half an interval plus the restart cost ``R`` on average.  The
overhead per useful second is

    h(tau) = C / tau + lam * (tau / 2 + R)

minimized at the Young–Daly interval ``tau* = sqrt(2 C / lam)``, and

    goodput_frac = 1 / (1 + h(tau))

is the fraction of wall-clock that is useful training.  ``lam == 0``
(MTBF = inf) gives ``h = 0`` and ``goodput_frac = 1.0`` exactly — the
degenerate equivalence every pre-reliability record relies on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

from repro_torch.fleet.resize import checkpoint_delay
from repro_torch.reliability.trace import BLAST_RADII, FailureTrace


def daly_interval(write_cost_s: float, failure_rate: float) -> float:
    """The Young–Daly optimal checkpoint interval ``sqrt(2 C / lam)``
    (exact minimizer of ``C/tau + lam*tau/2``); ``inf`` when failures
    never happen — checkpointing then costs pure overhead."""
    if write_cost_s < 0:
        raise ValueError(f"write cost must be >= 0, got {write_cost_s}")
    if failure_rate < 0:
        raise ValueError(f"failure rate must be >= 0, got {failure_rate}")
    if failure_rate == 0.0:
        return math.inf
    if write_cost_s == 0.0:
        return 0.0
    return math.sqrt(2.0 * write_cost_s / failure_rate)


def overhead(interval_s: float, write_cost_s: float, failure_rate: float,
             restart_cost_s: float = 0.0) -> float:
    """Expected non-useful seconds per useful second at checkpoint
    cadence ``interval_s``: the write amortized over the interval, plus
    the failure-rate-weighted half-interval rework and restart cost."""
    if failure_rate == 0.0:
        return 0.0
    if interval_s <= 0:
        return math.inf
    return (write_cost_s / interval_s
            + failure_rate * (interval_s / 2.0 + restart_cost_s))


def goodput_frac(interval_s: float, write_cost_s: float,
                 failure_rate: float,
                 restart_cost_s: float = 0.0) -> float:
    """Useful fraction of wall-clock: ``1 / (1 + h(tau))`` in (0, 1]."""
    h = overhead(interval_s, write_cost_s, failure_rate, restart_cost_s)
    if math.isinf(h):
        return 0.0
    return 1.0 / (1.0 + h)


@dataclasses.dataclass(frozen=True)
class FailureModel:
    """The sweepable reliability knobs (``reliability.*`` dotted paths).

    * ``mtbf_hours`` — per-node mean time between failures (``inf``
      disables failure modeling: every column degenerates exactly);
    * ``mttr_hours`` — repair time per failure;
    * ``ckpt_bw`` — checkpoint-storage write bandwidth (the write cost
      ``C`` through :func:`repro_torch.fleet.resize.checkpoint_delay`);
    * ``restore_bw`` — restart read bandwidth (0 = same as ``ckpt_bw``);
    * ``interval_s`` — fixed checkpoint cadence; 0 picks the Young–Daly
      optimum per cell (the naive-vs-optimal headline axis);
    * ``run_hours`` — the nominal run length ``expected_restarts``
      prices (and the Y102 sanity bound for fixed intervals);
    * ``blast`` — correlated radius for the generated trace.
    """

    mtbf_hours: float = 50_000.0
    mttr_hours: float = 0.5
    ckpt_bw: float = 40e9
    restore_bw: float = 0.0
    interval_s: float = 0.0
    run_hours: float = 168.0
    blast: str = "node"

    def __post_init__(self) -> None:
        if not self.mtbf_hours > 0:
            raise ValueError(
                f"mtbf_hours must be > 0 (inf disables failures), "
                f"got {self.mtbf_hours}")
        if not (self.mttr_hours >= 0 and math.isfinite(self.mttr_hours)):
            raise ValueError(
                f"mttr_hours must be finite and >= 0, got {self.mttr_hours}")
        if not (self.ckpt_bw > 0 and math.isfinite(self.ckpt_bw)):
            raise ValueError(
                f"ckpt_bw must be finite and > 0, got {self.ckpt_bw}")
        if not (self.restore_bw >= 0 and math.isfinite(self.restore_bw)):
            raise ValueError(
                f"restore_bw must be >= 0 (0 = ckpt_bw), "
                f"got {self.restore_bw}")
        if not self.interval_s >= 0:
            raise ValueError(
                f"interval_s must be >= 0 (0 = Young–Daly optimum), "
                f"got {self.interval_s}")
        if not self.run_hours > 0:
            raise ValueError(f"run_hours must be > 0, got {self.run_hours}")
        if self.blast not in BLAST_RADII:
            raise ValueError(f"blast must be one of {BLAST_RADII}, "
                             f"got {self.blast!r}")

    @property
    def enabled(self) -> bool:
        return math.isfinite(self.mtbf_hours)

    def failure_rate(self, num_nodes: int) -> float:
        """Job-level failures per second at cluster scale ``N``."""
        if not self.enabled or num_nodes <= 0:
            return 0.0
        return num_nodes / (self.mtbf_hours * 3600.0)

    def write_cost_s(self, state_bytes: float) -> float:
        """One checkpoint write through storage (the preemption cost)."""
        return checkpoint_delay(state_bytes, self.ckpt_bw)

    def restart_cost_s(self, state_bytes: float) -> float:
        """Repair plus the restore read of the checkpoint payload."""
        bw = self.restore_bw if self.restore_bw > 0 else self.ckpt_bw
        return self.mttr_hours * 3600.0 + checkpoint_delay(state_bytes, bw)

    def interval_for(self, state_bytes: float, num_nodes: int) -> float:
        """The effective cadence: the fixed ``interval_s`` when set,
        else the Young–Daly optimum for this (payload, scale)."""
        if self.interval_s > 0:
            return self.interval_s
        return daly_interval(self.write_cost_s(state_bytes),
                             self.failure_rate(num_nodes))

    def trace(self, seed: int = 0,
              horizon_hours: Optional[float] = None) -> FailureTrace:
        """A deterministic :class:`FailureTrace` with this model's
        MTBF/MTTR/blast knobs (the fleet-simulator hand-off)."""
        return FailureTrace(
            kind="poisson" if self.enabled else "none",
            mtbf_hours=self.mtbf_hours, mttr_hours=self.mttr_hours,
            blast=self.blast,
            horizon_hours=(horizon_hours if horizon_hours is not None
                           else self.run_hours),
            seed=seed)


def reliability_columns(model: FailureModel, state_bytes: float,
                        num_nodes: int) -> Dict[str, Any]:
    """The closed-form record columns for one study cell: checkpoint
    cadence, its overhead, expected restarts over ``run_hours``, and the
    goodput fraction.  With ``mtbf_hours = inf`` the columns are exactly
    ``{interval: inf, overhead: 0, restarts: 0, goodput: 1.0}`` — a
    pre-reliability record scaled by 1.0."""
    lam = model.failure_rate(num_nodes)
    write = model.write_cost_s(state_bytes)
    restart = model.restart_cost_s(state_bytes)
    tau = model.interval_for(state_bytes, num_nodes)
    good = 1.0 if lam == 0.0 else goodput_frac(tau, write, lam, restart)
    # fraction of wall-clock spent writing checkpoints: (C/tau) useful-
    # seconds-worth per useful second, scaled back to wall by goodput
    ckpt_frac = 0.0 if lam == 0.0 or tau <= 0 or math.isinf(tau) \
        else (write / tau) * good
    run_s = model.run_hours * 3600.0
    restarts = 0.0 if good <= 0 else lam * (run_s / good)
    return {
        "ckpt_interval_s": tau,
        "ckpt_overhead_frac": ckpt_frac,
        "expected_restarts": restarts,
        "goodput_frac": good,
    }


__all__ = ["FailureModel", "daly_interval", "goodput_frac", "overhead",
           "reliability_columns"]
