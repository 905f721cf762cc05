"""Placement and scheduling: how jobs map onto a cluster.

The port's copy of the JAX package's ``core/placement.py``, held to it by
``tests/test_torch_placement.py``. COMET fixes two mapping decisions that
§V-C/§V-D study; this module makes both pluggable:

  * :class:`Placement` — the protocol for mesh-axis → node-group
    assignment: per-rank-group hop resolution (``group_placement`` /
    ``p2p_crosses_pod``, consumed by the topology families and
    :func:`repro_torch.core.torch_engine.comm_matrix`), pipeline-stage →
    node-group assignment on heterogeneous clusters (``assign_stages``,
    consumed by :mod:`repro_torch.core.simulator`) and instance → group
    eligibility (``instance_groups``, consumed by :class:`ScheduleModel`);
  * :class:`PaperPlacement` — the paper's fixed mapping: MP→EP→DP→PP rank
    order, synchronous replicate-everywhere gating (every group must fit
    the shard);
  * :class:`EMAwarePlacement` — the same rank order, but memory-hungry
    pipeline stages / instances go to the pod groups with the most
    (expanded) memory, so a partial-EM fleet can win;
  * :class:`ExplicitPlacement` — a pinned stage → group mapping for
    what-if studies;
  * :class:`JobSpec` / :class:`ScheduleModel` / :class:`Schedule` — the
    multi-tenant layer: N identical instances x per-group capacities →
    concurrent placement, waves, turnaround/makespan (the Fig. 13b and
    Fig. 15 metrics).

Every placement is a frozen dataclass that hashes by value: the study
runner keys its caches on them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence, Tuple, Union, runtime_checkable

from repro_torch.core.topology import _PAPER_ORDER, GroupPlacement


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# --------------------------------------------------------------------- #
# The protocol
# --------------------------------------------------------------------- #

@runtime_checkable
class Placement(Protocol):
    """How a job's mesh axes and instances map onto a cluster.

    ``group_placement``/``p2p_crosses_pod`` resolve which network hops a
    communication group crosses (the topology families dispatch through
    them); ``assign_stages`` maps pipeline stages to heterogeneous node
    groups (``None`` = the paper's replicate-everywhere gating);
    ``instance_groups`` filters which groups may host a training instance
    in a multi-tenant schedule.
    """

    @property
    def label(self) -> str: ...

    def group_placement(self, scope: str, mp: int, dp: int, pod_size: int,
                        pp: int = 1, ep: int = 1) -> GroupPlacement: ...

    def p2p_crosses_pod(self, mp: int, dp: int, pod_size: int,
                        pp: int = 1, ep: int = 1) -> bool: ...

    def assign_stages(self, stage_bytes: Sequence[float], groups: Sequence,
                      nodes_per_stage: int) -> Optional[Tuple[int, ...]]: ...

    def instance_groups(self, fits: Sequence[bool]) -> Tuple[int, ...]: ...


class _PaperOrderMixin:
    """The paper's MP→EP→DP→PP rank order (hop resolution shared by every
    concrete placement; only the *group assignment* policies differ).
    Delegates to the single topology-side implementation so the rule
    cannot drift between the placement-passed and placement=None paths."""

    def group_placement(self, scope: str, mp: int, dp: int, pod_size: int,
                        pp: int = 1, ep: int = 1) -> GroupPlacement:
        return _PAPER_ORDER.group_placement(scope, mp, dp, pod_size, pp, ep)

    def p2p_crosses_pod(self, mp: int, dp: int, pod_size: int,
                        pp: int = 1, ep: int = 1) -> bool:
        return _PAPER_ORDER.p2p_crosses_pod(mp, dp, pod_size, pp, ep)


@dataclasses.dataclass(frozen=True)
class PaperPlacement(_PaperOrderMixin):
    """COMET's fixed mapping, bit-for-bit (the default everywhere).

    Stages are not assigned to groups: a heterogeneous cluster simulates
    every group and the slowest / least-capable one gates the iteration
    (synchronous training).  Instances schedule onto any group regardless
    of fit — infeasibility surfaces as ``feasible=False``.
    """

    @property
    def label(self) -> str:
        return "paper"

    def assign_stages(self, stage_bytes: Sequence[float], groups: Sequence,
                      nodes_per_stage: int) -> Optional[Tuple[int, ...]]:
        return None

    def instance_groups(self, fits: Sequence[bool]) -> Tuple[int, ...]:
        return tuple(range(len(fits)))


@dataclasses.dataclass(frozen=True)
class EMAwarePlacement(_PaperOrderMixin):
    """Memory-aware assignment: hungry shards go where the memory is.

    Same rank order as the paper (collective costs stay comparable), but
    on a heterogeneous cluster the memory-hungriest pipeline stages are
    assigned to the node groups with the largest per-node capacity (the
    EM pods), each stage gated by *its* group only — so a partial-EM
    fleet is feasible whenever the EM pods can hold the hungry stages,
    instead of being gated by the plain pods.  Multi-tenant instances
    only schedule onto groups they fit.
    """

    @property
    def label(self) -> str:
        return "em-aware"

    def assign_stages(self, stage_bytes: Sequence[float], groups: Sequence,
                      nodes_per_stage: int) -> Optional[Tuple[int, ...]]:
        pp = len(stage_bytes)
        if pp <= 1 or len(groups) <= 1 or nodes_per_stage < 1:
            return None
        caps = [g.num_nodes // nodes_per_stage for g in groups]
        if sum(caps) < pp:
            return None              # fleet can't hold the pipeline: gate
        # Biggest stages to the roomiest groups, greedily.
        group_order = sorted(range(len(groups)),
                             key=lambda i: (groups[i].node.total_cap,
                                            groups[i].num_nodes),
                             reverse=True)
        assign = [0] * pp
        gi = 0
        for s in sorted(range(pp), key=lambda s: stage_bytes[s],
                        reverse=True):
            while caps[group_order[gi]] == 0:
                gi += 1
            assign[s] = group_order[gi]
            caps[group_order[gi]] -= 1
        return tuple(assign)

    def instance_groups(self, fits: Sequence[bool]) -> Tuple[int, ...]:
        ok = tuple(i for i, f in enumerate(fits) if f)
        # Nothing fits anywhere: fall back to every group so the schedule
        # is still computed (and reported infeasible) rather than empty.
        return ok or tuple(range(len(fits)))


@dataclasses.dataclass(frozen=True)
class ExplicitPlacement(_PaperOrderMixin):
    """A pinned stage → node-group mapping (what-if studies).

    ``stage_groups[s]`` is the node-group index hosting pipeline stage
    ``s``; length must equal the workload's ``pp``.  Hop resolution and
    instance scheduling follow the paper defaults.
    """

    stage_groups: Tuple[int, ...] = ()

    @property
    def label(self) -> str:
        return "explicit[" + ",".join(map(str, self.stage_groups)) + "]"

    def assign_stages(self, stage_bytes: Sequence[float], groups: Sequence,
                      nodes_per_stage: int) -> Optional[Tuple[int, ...]]:
        if not self.stage_groups:
            return None
        if len(self.stage_groups) != len(stage_bytes):
            raise ValueError(
                f"ExplicitPlacement maps {len(self.stage_groups)} stages "
                f"but the workload has {len(stage_bytes)}")
        bad = [g for g in self.stage_groups if not 0 <= g < len(groups)]
        if bad:
            raise ValueError(
                f"ExplicitPlacement names node groups {sorted(set(bad))} "
                f"but the cluster has {len(groups)}")
        for i, g in enumerate(groups):
            need = self.stage_groups.count(i) * nodes_per_stage
            if need > g.num_nodes:
                raise ValueError(
                    f"ExplicitPlacement puts {self.stage_groups.count(i)} "
                    f"stages x {nodes_per_stage} nodes on group {i} "
                    f"({g.num_nodes} nodes)")
        return tuple(self.stage_groups)

    def instance_groups(self, fits: Sequence[bool]) -> Tuple[int, ...]:
        return tuple(range(len(fits)))


PAPER_PLACEMENT = PaperPlacement()
EM_AWARE_PLACEMENT = EMAwarePlacement()

_REGISTRY = {
    "paper": PAPER_PLACEMENT,
    "em-aware": EM_AWARE_PLACEMENT,
}

PlacementLike = Union[Placement, str, None]


def list_placements() -> Tuple[str, ...]:
    """Names accepted by :func:`get_placement` (and placement axes)."""
    return tuple(sorted(_REGISTRY))


def get_placement(obj: PlacementLike) -> Optional[Placement]:
    """Coerce a placement name / instance / None to a Placement."""
    if obj is None or isinstance(obj, Placement):
        return obj
    if isinstance(obj, str):
        if obj not in _REGISTRY:
            raise KeyError(f"unknown placement {obj!r} "
                           f"(available: {list(list_placements())})")
        return _REGISTRY[obj]
    raise TypeError(f"expected a Placement, its name, or None; "
                    f"got {type(obj).__name__}")


# --------------------------------------------------------------------- #
# Multi-tenant scheduling: N instances onto per-group capacities
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class JobSpec:
    """``instances`` identical training instances, each occupying
    ``nodes_per_instance`` nodes (0 = the strategy's node count).
    ``max_nodes`` caps how many fleet nodes the job may use (0 = all) —
    the Fig. 15 "64-node DLRM fleet" constraint."""

    instances: int = 1
    nodes_per_instance: int = 0
    max_nodes: int = 0
    name: str = "job"

    def __post_init__(self):
        if self.instances < 1:
            raise ValueError(f"instances must be >= 1, got {self.instances}")
        for f in ("nodes_per_instance", "max_nodes"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0, got {getattr(self, f)}")


@dataclasses.dataclass(frozen=True)
class GroupSchedule:
    """One node group's share of a schedule."""

    group: int           # node-group index
    concurrent: int      # instances running side by side on this group
    instances: int       # instances assigned to this group in total
    iter_time: float     # one instance-iteration on this group, seconds

    @property
    def waves(self) -> int:
        return _ceil_div(self.instances, max(1, self.concurrent))

    @property
    def finish_time(self) -> float:
        return self.waves * self.iter_time


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A concrete multi-tenant placement of a :class:`JobSpec`.

    ``turnaround`` is the makespan — when the last instance finishes —
    which on a homogeneous fleet reduces to the paper's
    ``waves * iteration_time`` (Fig. 13b / Fig. 15).
    """

    job: JobSpec
    groups: Tuple[GroupSchedule, ...]
    feasible: bool

    @property
    def concurrent(self) -> int:
        return sum(g.concurrent for g in self.groups)

    @property
    def waves(self) -> int:
        return max((g.waves for g in self.groups if g.instances), default=0)

    @property
    def makespan(self) -> float:
        return max((g.finish_time for g in self.groups if g.instances),
                   default=0.0)

    @property
    def turnaround(self) -> float:
        return self.makespan


@dataclasses.dataclass(frozen=True)
class ScheduleModel:
    """Greedy earliest-finish scheduling of identical instances.

    Per-group concurrency = usable nodes // nodes-per-instance (usable is
    capped by ``JobSpec.max_nodes`` across groups, in group order); each
    instance then goes to the eligible group — ``placement.instance_groups``
    decides eligibility from the per-group fit flags — whose finish time
    grows least.  If no group can hold even one instance, the largest
    group runs them one at a time (the legacy ``max(1, fleet // n)``
    convention, so oversubscribed what-ifs still produce a number).
    """

    def schedule(self, job: JobSpec, groups: Sequence,
                 iter_times: Sequence[float],
                 fits: Optional[Sequence[bool]] = None,
                 nodes_per_instance: Optional[Sequence[int]] = None,
                 placement: Optional[Placement] = None) -> Schedule:
        if len(groups) != len(iter_times):
            raise ValueError("one iteration time per node group required")
        fits = list(fits) if fits is not None else [True] * len(groups)
        npis = (list(nodes_per_instance) if nodes_per_instance is not None
                else [job.nodes_per_instance] * len(groups))
        if any(n < 1 for n in npis):
            raise ValueError("nodes_per_instance must be >= 1 per group "
                             "(set JobSpec.nodes_per_instance or pass "
                             "per-group values)")
        placement = placement or PAPER_PLACEMENT

        def concurrency(idxs) -> list:
            """Per-group concurrency with the ``max_nodes`` budget handed
            out (in group order) only to the groups in ``idxs`` — an
            ineligible group must not eat the fleet cap, and neither must
            a group too small to hold even one instance (its ``usable``
            share would starve later groups that could have hosted
            instances within the cap)."""
            remaining = job.max_nodes or sum(g.num_nodes for g in groups)
            out = [0] * len(groups)
            for i in idxs:
                usable = min(groups[i].num_nodes, remaining)
                if usable // npis[i] == 0:
                    continue
                remaining -= usable
                out[i] = usable // npis[i]
            return out

        chosen = placement.instance_groups(fits)
        conc = concurrency(chosen)
        eligible = [i for i in chosen if conc[i] > 0]
        forced = not eligible
        if forced and len(chosen) < len(groups):
            # No eligible group can hold an instance: fall back to the
            # whole fleet (reported infeasible via the fits check below).
            conc = concurrency(range(len(groups)))
            eligible = [i for i in range(len(groups)) if conc[i] > 0]
        if not eligible:
            # Oversubscribed: run one at a time on the largest group (the
            # legacy ``max(1, fleet // n)`` convention keeps a number
            # flowing, but an instance wider than every group — or than
            # the ``max_nodes`` cap — cannot actually be placed, so the
            # schedule is marked infeasible below).
            big = max(range(len(groups)), key=lambda i: groups[i].num_nodes)
            conc = [0] * len(groups)
            conc[big] = 1
            eligible = [big]
        counts = [0] * len(groups)
        for _ in range(job.instances):
            best = min(eligible,
                       key=lambda i: (_ceil_div(counts[i] + 1, conc[i])
                                      * iter_times[i], i))
            counts[best] += 1
        assigned = tuple(GroupSchedule(i, conc[i], counts[i], iter_times[i])
                         for i in range(len(groups)) if counts[i])
        feasible = all(fits[g.group] for g in assigned)
        for g in assigned:
            cap = min(groups[g.group].num_nodes,
                      job.max_nodes or groups[g.group].num_nodes)
            feasible = feasible and npis[g.group] <= cap
        return Schedule(job=job, groups=assigned, feasible=feasible)
