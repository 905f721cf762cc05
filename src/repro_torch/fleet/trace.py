"""Deterministic fleet arrival/duration traces.

The port's copy of the JAX package's ``fleet/trace.py``, held to it by
``tests/test_torch_fleet.py``. The draws stay on numpy's
``default_rng(seed)`` (arrivals) and ``default_rng(seed + 1)`` (iteration
counts): host code that touches no tensor, so the arrivals are the
reference's to the bit. :class:`FleetTrace` is the training twin of
:class:`repro_torch.serving.traffic.TrafficTrace`: a frozen knob bundle whose
job stream regenerates from the seed, so a dotted-path axis
(``Axis("rate", (...), path="ftrace.rate")``) rewrites the trace like
any other study knob — ``dataclasses.replace`` + re-materialize.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Sequence, Tuple

import numpy as np

from repro_torch.fleet.jobs import FleetJobSpec

FLEET_TRACE_KINDS: Tuple[str, ...] = ("static", "poisson", "uniform")


@dataclasses.dataclass(frozen=True)
class FleetTrace:
    """A job-arrival process over a template mix.

    * ``static`` — the templates ARE the trace: each template's own
      ``arrival`` / ``iterations`` are kept verbatim (the degenerate,
      no-churn fleet — a single static template reproduces
      ``ScheduleModel`` exactly);
    * ``poisson`` — ``num_jobs`` arrivals with exponential interarrivals
      at ``rate`` jobs/s, cycling the template mix;
    * ``uniform`` — deterministic ``1/rate`` spacing (closed-form
      sanity).

    ``mean_iterations > 0`` additionally redraws each job's iteration
    count from a geometric-like exponential around the mean (min 1);
    ``0`` keeps every template's own ``iterations``.
    """

    kind: str = "poisson"
    rate: float = 1.0 / 300.0
    num_jobs: int = 8
    seed: int = 0
    mean_iterations: int = 0

    def __post_init__(self) -> None:
        if self.kind not in FLEET_TRACE_KINDS:
            raise ValueError(f"kind must be one of {FLEET_TRACE_KINDS}, "
                             f"got {self.kind!r}")

    @cached_property
    def arrivals(self) -> Tuple[float, ...]:
        """Arrival times in seconds from t=0 (empty for ``static`` — the
        templates carry their own)."""
        if self.kind == "static":
            return ()
        if self.rate <= 0 or self.num_jobs <= 0:
            raise ValueError(
                f"trace needs rate > 0 and num_jobs > 0, got "
                f"rate={self.rate}, num_jobs={self.num_jobs}")
        n = self.num_jobs
        if self.kind == "uniform":
            step = 1.0 / self.rate
            return tuple(i * step for i in range(n))
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(1.0 / self.rate, size=n)
        gaps[0] = 0.0
        return tuple(np.cumsum(gaps).tolist())

    def materialize(self, templates: Sequence[FleetJobSpec]
                    ) -> Tuple[FleetJobSpec, ...]:
        """Stamp the trace onto the template mix: one spec per arrival
        (templates cycled), with ``arrival`` — and, when
        ``mean_iterations`` is set, ``iterations`` — rewritten.  The
        ``static`` kind returns the templates untouched."""
        if not templates:
            raise ValueError("fleet trace needs at least one job template")
        if self.kind == "static":
            return tuple(templates)
        arrivals = self.arrivals
        iters: Tuple[int, ...] = ()
        if self.mean_iterations > 0:
            rng = np.random.default_rng(self.seed + 1)
            draws = rng.exponential(float(self.mean_iterations),
                                    size=len(arrivals))
            iters = tuple(max(1, int(round(d))) for d in draws)
        out = []
        for i, t in enumerate(arrivals):
            tpl = templates[i % len(templates)]
            spec = dataclasses.replace(
                tpl, name=f"{tpl.name}#{i}", arrival=float(t))
            if iters:
                spec = dataclasses.replace(spec, iterations=iters[i])
            out.append(spec)
        return tuple(out)

    @property
    def duration(self) -> float:
        return self.arrivals[-1] if self.arrivals else 0.0


__all__ = ["FLEET_TRACE_KINDS", "FleetTrace"]
