"""Study-native fleet wiring: ``FleetSpec`` -> ``run_study``.

The port's copy of the JAX package's ``fleet/spec.py``; its records are
held to the reference's by ``tests/test_torch_fleet.py``.

A :class:`FleetSpec` is the multi-tenant twin of
:class:`repro_torch.serving.ServingSpec`: a job mix + cluster + fleet-policy
knobs + arrival trace, swept over axes.  ``run_study`` accepts it
directly (via :meth:`FleetSpec.to_study`) and emits the timeline-native
columns ``fleet_util / turnaround_p50 / turnaround_p99 / preemptions /
resize_events / burst_events / jobs_completed`` next to the usual cost
columns (``total`` is the timeline makespan, so ``perf_per_dollar``
prices the whole fleet's throughput per TCO dollar).

Axes whose dotted path starts with ``fleet.`` / ``ftrace.`` / ``fail.``
rewrite the fleet point (``Axis("policy", ("static", "elastic+burst"),
path="fleet.policy")``, ``Axis("rate", (...), path="ftrace.rate")``,
``Axis("mtbf", (...), path="fail.mtbf_hours")``) through the same
:func:`repro_torch.core.study.set_by_path` machinery cluster axes use.  The
``failures`` trace (default: disabled) injects node failures into the
timeline and populates the ``failures / lost_work_frac / goodput``
columns.  Per-iteration times are re-queried from the port's compiled
evaluator at every width on a job's elastic menu
(:func:`repro_torch.core.simulator.group_breakdowns_compiled`), on the
device ``run_study`` resolved for the cell (``StudyContext.device``), and
memoized per (job identity, width, cluster, placement, device): the event
timeline itself runs on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core.cluster import ClusterLike
from repro_torch.core.simulator import group_breakdowns_compiled
from repro_torch.core.study import (Axis, StudyContext, StudySpec,
                                    check_path, set_by_path)
from repro_torch.core.workload import Workload, decompose, decompose_dlrm
from repro_torch.fleet.jobs import FleetJob, FleetJobSpec, WidthProfile
from repro_torch.fleet.resize import instance_state_bytes
from repro_torch.fleet.simulator import (FleetModel, FleetResult,
                                         FleetSimulator)
from repro_torch.fleet.trace import FleetTrace
from repro_torch.reliability.trace import FailureTrace

FLEET_COLUMNS: Tuple[str, ...] = (
    "fleet_util", "turnaround_p50", "turnaround_p99", "preemptions",
    "resize_events", "burst_events", "jobs_completed", "failures",
    "lost_work_frac", "goodput")

_POINT_FIELDS: Tuple[str, ...] = ("fleet", "ftrace", "fail")


@dataclasses.dataclass(frozen=True)
class FleetPoint:
    """The per-cell fleet state dotted-path axes rewrite."""

    fleet: FleetModel
    ftrace: FleetTrace
    fail: FailureTrace = dataclasses.field(default_factory=FailureTrace)


def is_fleet_axis(axis: Axis) -> bool:
    """True when the axis path rewrites the fleet point, not the
    cluster (``fleet.* / ftrace.*``)."""
    return (axis.kind == "cluster" and axis.path is not None
            and axis.path.partition(".")[0] in _POINT_FIELDS)


def build_workload(spec: FleetJobSpec, width: int) -> Workload:
    """Lower one job at one width: DLRM jobs shard over all ``width``
    nodes (the §V-C hybrid strategy); anything else decomposes with
    ``mp`` fixed and DP = width / mp — the elastic-DP convention the
    resize events re-query."""
    from repro_torch.configs import get_config, get_dlrm_config
    from repro_torch.configs.base import ShapeConfig
    if spec.model.startswith("dlrm"):
        return decompose_dlrm(get_dlrm_config(), spec.global_batch, width)
    if width % spec.mp != 0:
        raise ValueError(
            f"job {spec.name!r}: width {width} not divisible by mp={spec.mp}")
    shape = ShapeConfig(f"fleet-{spec.name}", 4096, spec.global_batch,
                        "train")
    return decompose(get_config(spec.model), shape, mp=spec.mp,
                     dp=width // spec.mp)


@dataclasses.dataclass
class FleetSpec:
    """A declarative fleet study: templates + trace + policy knobs.

    ``jobs`` are the template mix the trace stamps arrivals onto
    (``ftrace.kind == "static"`` replays them verbatim).  ``placement``
    resolves through the core registry (``"paper"`` / ``"em-aware"``);
    ``metrics`` adds derived columns exactly as on ``StudySpec``."""

    name: str
    jobs: Tuple[FleetJobSpec, ...]
    cluster: Optional[ClusterLike] = None
    fleet: FleetModel = dataclasses.field(default_factory=FleetModel)
    ftrace: FleetTrace = dataclasses.field(
        default_factory=lambda: FleetTrace(kind="static"))
    failures: FailureTrace = dataclasses.field(default_factory=FailureTrace)
    axes: Sequence[Axis] = ()
    placement: Any = "paper"
    zero_stage: int = 2
    metrics: Dict[str, Callable[[StudyContext], Any]] = \
        dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.jobs:
            raise ValueError("a fleet study needs at least one job template")
        point = self.point()
        for axis in self.axes:
            if is_fleet_axis(axis):
                check_path(point, axis.path or "")

    def point(self) -> FleetPoint:
        return FleetPoint(self.fleet, self.ftrace, self.failures)

    def to_study(self) -> "FleetStudy":
        """Lower to a StudySpec the study engine runs unchanged: fleet
        axes become label axes the evaluator folds back into the fleet
        point; everything else passes through."""
        fleet_axes = [a for a in self.axes if is_fleet_axis(a)]
        study_axes = [dataclasses.replace(a, path=None)
                      if is_fleet_axis(a) else a for a in self.axes]
        spec = self
        profile_memo: Dict[Any, WidthProfile] = {}

        def evaluate(ctx: StudyContext) -> Dict[str, Any]:
            point = spec.point()
            for axis in fleet_axes:
                point = set_by_path(point, axis.path or "",
                                    ctx.point[axis.name],
                                    scale=(axis.mode == "scale"))
            placement = ctx.placement if ctx.placement is not None \
                else spec.placement
            return fleet_record(ctx.cluster, spec, point, placement,
                                profile_memo, device=ctx.device)

        return FleetStudy(
            name=self.name, cluster=self.cluster, axes=tuple(study_axes),
            placement=self.placement, metrics=dict(self.metrics),
            evaluate=evaluate, fleet=self)


@dataclasses.dataclass
class FleetStudy(StudySpec):
    """The lowered StudySpec, carrying its source :class:`FleetSpec` so
    ``run_study(validate=)`` can run the F1xx fleet rules on it."""

    fleet: Optional[FleetSpec] = None


# --------------------------------------------------------------------- #
# The per-cell evaluator
# --------------------------------------------------------------------- #

def _infeasible(reason: str) -> Dict[str, Any]:
    return {"fleet_util": 0.0, "turnaround_p50": float("inf"),
            "turnaround_p99": float("inf"), "preemptions": 0,
            "resize_events": 0, "burst_events": 0, "jobs_completed": 0,
            "failures": 0, "lost_work_frac": 0.0, "goodput": 0.0,
            "makespan": float("inf"), "total": float("inf"),
            "feasible": False, "n_events": 0,
            "infeasible_reason": reason}


def _profiles(job: FleetJobSpec, cluster: ClusterLike, zero_stage: int,
              placement: Any, memo: Dict[Any, WidthProfile],
              device=None) -> Dict[int, WidthProfile]:
    """Per-width profiles for one job on one cluster, timed by the
    compiled evaluator on ``device`` (re-queried at every width on the
    elastic menu, memoized across cells). The memo key holds the device,
    so profiles timed on one device never stand in for another's."""
    out: Dict[int, WidthProfile] = {}
    for width in job.width_menu:
        try:
            ckey = (job.model, job.mp, job.global_batch, width, zero_stage,
                    cluster, getattr(placement, "label", placement),
                    str(device))
            hash(ckey)
        except TypeError:
            ckey = None
        if ckey is not None and ckey in memo:
            out[width] = memo[ckey]
            continue
        wl = build_workload(job, width)
        per = group_breakdowns_compiled(
            wl.compiled(), cluster, zero_stage=zero_stage,
            placement=placement, env_cache={}, device=device)
        prof = WidthProfile(
            iter_times=tuple(b.total for b in per),
            fits=tuple(b.feasible for b in per),
            state_bytes=instance_state_bytes(wl))
        if ckey is not None:
            memo[ckey] = prof
        out[width] = prof
    return out


def fleet_record(cluster: Optional[ClusterLike], spec: FleetSpec,
                 point: FleetPoint, placement: Any,
                 profile_memo: Optional[Dict[Any, WidthProfile]] = None,
                 device=None) -> Dict[str, Any]:
    """Evaluate one fleet cell: materialize the trace over the template
    mix, profile every (job, width) on the cell's cluster on ``device``,
    replay the timeline, attach the fleet columns."""
    if cluster is None:
        return _infeasible("fleet study needs a cluster")
    from repro_torch.core.placement import get_placement
    placement = get_placement(placement)
    memo = profile_memo if profile_memo is not None else {}
    try:
        specs = point.ftrace.materialize(spec.jobs)
    except ValueError as exc:
        return _infeasible(str(exc))
    jobs = []
    for uid, js in enumerate(specs):
        try:
            profiles = _profiles(js, cluster, spec.zero_stage, placement,
                                 memo, device)
        except ValueError as exc:
            return _infeasible(str(exc))
        jobs.append(FleetJob(spec=js, profiles=profiles, uid=uid))
    groups = cluster.node_groups
    sim = FleetSimulator(
        capacities=[g.num_nodes for g in groups],
        model=point.fleet, placement=placement,
        failures=point.fail,
        pod_sizes=[min(getattr(g.topology, "pod_size", g.num_nodes),
                       g.num_nodes) for g in groups])
    res: FleetResult = sim.run(jobs)
    return {
        "fleet_util": res.fleet_util,
        "turnaround_p50": res.turnaround_p50,
        "turnaround_p99": res.turnaround_p99,
        "preemptions": res.preemptions,
        "resize_events": res.resize_events,
        "burst_events": res.burst_events,
        "jobs_completed": res.jobs_completed,
        "failures": res.failures,
        "lost_work_frac": res.lost_work_frac,
        "goodput": res.goodput,
        "makespan": res.makespan,
        # "total" prices the cell: 1 / (makespan * tco) becomes the
        # fleet's perf_per_dollar through the standard cost columns.
        "total": res.makespan if res.makespan > 0 else float("inf"),
        "feasible": res.feasible,
        "n_events": len(res.events),
    }


__all__ = ["FLEET_COLUMNS", "FleetPoint", "FleetSpec", "FleetStudy",
           "build_workload", "fleet_record", "is_fleet_axis"]
