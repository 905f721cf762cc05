"""Deterministic failure traces.

The port's copy of the JAX package's ``reliability/trace.py``, held to it
event for event by ``tests/test_torch_reliability.py``. :class:`FailureTrace`
is the reliability twin of the serving ``TrafficTrace``: a frozen knob bundle
whose event stream regenerates from the seed, so a dotted-path axis rewrites
the trace like any other study knob (``dataclasses.replace`` plus
re-materialize). The Poisson draws stay on numpy's ``default_rng([seed,
group])``, so the events are bitwise the reference's.

The default ``kind="none"`` trace is the degenerate, failure-free fleet:
``materialize`` returns no events and every consumer takes the exact
pre-reliability code path (the bit-for-bit equivalence golden).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

FAILURE_TRACE_KINDS: Tuple[str, ...] = ("none", "poisson", "explicit")
BLAST_RADII: Tuple[str, ...] = ("node", "pod")


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One node-group failure: ``nodes`` nodes of ``group`` go down at
    ``time`` and come back ``repair_s`` seconds later."""

    time: float
    group: int
    nodes: int = 1
    repair_s: float = 900.0

    def __post_init__(self) -> None:
        if self.time < 0:
            raise ValueError(f"failure time must be >= 0, got {self.time}")
        if self.group < 0:
            raise ValueError(f"group must be >= 0, got {self.group}")
        if self.nodes < 1:
            raise ValueError(f"nodes must be >= 1, got {self.nodes}")
        if not (self.repair_s >= 0 and math.isfinite(self.repair_s)):
            raise ValueError(
                f"repair_s must be finite and >= 0, got {self.repair_s}")


@dataclasses.dataclass(frozen=True)
class FailureTrace:
    """A failure process over a cluster's node groups.

    * ``none`` — the degenerate failure-free trace (the default; every
      consumer behaves exactly as before this trace existed);
    * ``poisson`` — per-group exponential failure gaps at the per-node
      rate ``1 / mtbf_hours``, regenerated deterministically from
      ``seed`` until ``horizon_hours``;
    * ``explicit`` — replay ``events`` verbatim (deterministic tests and
      the headline study).

    ``blast`` picks the correlated radius: ``"node"`` downs one node per
    failure; ``"pod"`` downs the failing node's whole pod (switch-level
    blast — resolved against the cluster's ``Topology.pod_size`` at
    materialize time).
    """

    kind: str = "none"
    mtbf_hours: float = math.inf
    mttr_hours: float = 0.25
    blast: str = "node"
    horizon_hours: float = 24.0
    seed: int = 0
    events: Tuple[FailureEvent, ...] = ()

    def __post_init__(self) -> None:
        if self.kind not in FAILURE_TRACE_KINDS:
            raise ValueError(f"kind must be one of {FAILURE_TRACE_KINDS}, "
                             f"got {self.kind!r}")
        if self.blast not in BLAST_RADII:
            raise ValueError(f"blast must be one of {BLAST_RADII}, "
                             f"got {self.blast!r}")

    @property
    def enabled(self) -> bool:
        """True when materialize can produce events — the one gate every
        consumer checks before leaving the failure-free fast path."""
        if self.kind == "none":
            return False
        if self.kind == "explicit":
            return bool(self.events)
        return self.mtbf_hours > 0 and math.isfinite(self.mtbf_hours)

    @property
    def rate_per_node(self) -> float:
        """Failures per node-second (0.0 when disabled)."""
        if not self.enabled or self.kind == "explicit":
            return 0.0
        return 1.0 / (self.mtbf_hours * 3600.0)

    def materialize(self, group_sizes: Sequence[int],
                    pod_sizes: Optional[Sequence[int]] = None,
                    ) -> Tuple[FailureEvent, ...]:
        """The event stream over a cluster with ``group_sizes`` nodes per
        group.  ``pod_sizes`` (same order) sizes the ``blast="pod"``
        radius; absent, a pod is the whole group, clamped to it."""
        if not self.enabled:
            return ()
        if self.kind == "explicit":
            for ev in self.events:
                if ev.group >= len(group_sizes):
                    raise ValueError(
                        f"failure event names group {ev.group} but the "
                        f"cluster has {len(group_sizes)} group(s)")
            return tuple(sorted(self.events, key=lambda e: (e.time, e.group)))
        horizon = self.horizon_hours * 3600.0
        repair = self.mttr_hours * 3600.0
        out: List[FailureEvent] = []
        for g, n in enumerate(group_sizes):
            if n < 1:
                continue
            blast = 1
            if self.blast == "pod":
                pod = pod_sizes[g] if pod_sizes is not None else n
                blast = max(1, min(int(pod), int(n)))
            # the group fails at n * per-node rate; each draw downs
            # ``blast`` nodes (a pod blast takes its switch down with it)
            rng = np.random.default_rng([self.seed, g])
            scale = self.mtbf_hours * 3600.0 / n
            t = 0.0
            while True:
                t += float(rng.exponential(scale))
                if t >= horizon:
                    break
                out.append(FailureEvent(time=t, group=g, nodes=blast,
                                        repair_s=repair))
        return tuple(sorted(out, key=lambda e: (e.time, e.group)))


__all__ = ["BLAST_RADII", "FAILURE_TRACE_KINDS", "FailureEvent",
           "FailureTrace"]
