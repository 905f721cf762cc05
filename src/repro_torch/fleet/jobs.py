"""Heterogeneous fleet jobs.

The port's copy of the JAX package's ``fleet/jobs.py``, held to it by
``tests/test_torch_fleet.py``. :class:`FleetJobSpec` extends the static
:class:`repro_torch.core.placement.JobSpec` with the per-job knobs a timeline
needs — model identity, arrival time, iteration count, priority, the
elastic width menu, and the burst-parallel phase length.

A :class:`FleetJob` is the runtime pairing of a spec with its
:class:`WidthProfile` table — per-group iteration times (re-queried from
the study engines at every allowed width) plus the checkpoint payload
the resize/preemption cost model charges for.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

from repro_torch.core.placement import JobSpec


@dataclasses.dataclass(frozen=True)
class FleetJobSpec(JobSpec):
    """One fleet tenant.

    Extends ``JobSpec`` (``instances`` / ``nodes_per_instance`` /
    ``max_nodes`` / ``name``) with:

    * ``model`` — registry model identity (``"dlrm"`` lowers through
      :func:`repro_torch.core.workload.decompose_dlrm`, anything else through
      :func:`repro_torch.core.workload.decompose` with ``mp`` fixed and
      DP = width / mp — the elastic-DP convention);
    * ``arrival`` / ``iterations`` — when the job enters the queue and
      how many iterations each instance must run (the trace rewrites
      both);
    * ``priority`` — larger preempts smaller;
    * ``widths`` — the elastic DP width menu in nodes per instance
      (empty = static at ``nodes_per_instance``);
    * ``burst_iters`` — > 0 marks the first ``burst_iters`` iterations
      as a burst-parallel phase that may borrow the fleet;
    * ``preemptible`` — whether higher-priority tenants may checkpoint
      this job off its nodes;
    * ``on_failure`` — per-job degradation policy when a node failure
      kills an instance: ``"wait"`` re-queues at the base width,
      ``"shrink"`` at the narrowest menu width; ``""`` (default)
      inherits ``FleetModel.degradation``.
    """

    model: str = ""
    mp: int = 1
    global_batch: int = 4096
    arrival: float = 0.0
    iterations: int = 1
    priority: int = 0
    widths: Tuple[int, ...] = ()
    burst_iters: int = 0
    preemptible: bool = True
    on_failure: str = ""

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.mp < 1:
            raise ValueError(f"mp must be >= 1, got {self.mp}")
        if self.nodes_per_instance < 1:
            raise ValueError("a fleet job needs an explicit "
                             "nodes_per_instance >= 1, got "
                             f"{self.nodes_per_instance}")
        if self.arrival < 0:
            raise ValueError(f"arrival must be >= 0, got {self.arrival}")
        if self.iterations < 1:
            raise ValueError(
                f"iterations must be >= 1, got {self.iterations}")
        if self.burst_iters < 0:
            raise ValueError(
                f"burst_iters must be >= 0, got {self.burst_iters}")
        for w in self.widths:
            if w < 1:
                raise ValueError(f"widths must be >= 1, got {self.widths}")
        if self.on_failure not in ("", "wait", "shrink"):
            raise ValueError(
                f"on_failure must be '', 'wait' or 'shrink', "
                f"got {self.on_failure!r}")

    @property
    def base_width(self) -> int:
        return self.nodes_per_instance

    @property
    def width_menu(self) -> Tuple[int, ...]:
        """The allowed instance widths, ascending, always containing the
        base width."""
        return tuple(sorted(set(self.widths) | {self.nodes_per_instance}))

    @property
    def elastic(self) -> bool:
        return len(self.width_menu) > 1


@dataclasses.dataclass(frozen=True)
class WidthProfile:
    """How one instance of a job behaves at one width: per-node-group
    iteration time and memory fit (``iter_times[g]`` / ``fits[g]`` in
    ``cluster.node_groups`` order), plus the instance's checkpoint
    payload in bytes — what preemption writes out and what an elastic
    resize must move through storage and lay out again."""

    iter_times: Tuple[float, ...]
    fits: Tuple[bool, ...]
    state_bytes: float = 0.0

    def __post_init__(self) -> None:
        if len(self.iter_times) != len(self.fits):
            raise ValueError("one fit flag per node group required")
        for t in self.iter_times:
            # inf marks an unsimulatable group (paired with fits=False);
            # nan would silently poison every downstream finish time.
            if t != t or t < 0:
                raise ValueError(
                    f"iteration times must be >= 0 and not NaN, got "
                    f"{self.iter_times}")


@dataclasses.dataclass(frozen=True)
class FleetJob:
    """A spec bound to its measured width profiles, ready to simulate.
    ``profiles`` must cover every width in ``spec.width_menu``."""

    spec: FleetJobSpec
    profiles: Mapping[int, WidthProfile]
    uid: int = 0

    def __post_init__(self) -> None:
        missing = [w for w in self.spec.width_menu if w not in self.profiles]
        if missing:
            raise ValueError(
                f"job {self.spec.name!r}: no WidthProfile for widths "
                f"{missing}")

    def profile(self, width: int) -> WidthProfile:
        return self.profiles[width]

    @property
    def state_bytes(self) -> float:
        return self.profiles[self.spec.base_width].state_bytes


__all__ = ["FleetJob", "FleetJobSpec", "WidthProfile"]
