"""Study-native serving wiring: ``ServingSpec`` -> ``run_study``.

The port's copy of the JAX package's ``serving/spec.py``; its records are
held to the reference's key for key by ``tests/test_torch_serving.py``.

A :class:`ServingSpec` is the serving twin of
:class:`repro_torch.core.study.StudySpec`: a model + cluster + serving knobs +
traffic trace + SLO, swept over axes.  ``run_study`` accepts it directly
(via :meth:`ServingSpec.to_study`) and emits the SLO-native record
columns ``ttft_p50 / ttft_p99 / tpot / goodput / goodput_per_dollar``
next to the usual ``cost_usd`` / ``tco`` cost columns.

Axes whose dotted path starts with ``serving.`` / ``trace.`` / ``slo.``
rewrite the serving point (``Axis("rate", (4, 16), path="trace.rate")``,
``Axis("max_batch", (8, 32), path="serving.max_batch")``) through the
same :func:`repro_torch.core.study.set_by_path` machinery cluster axes use;
every other axis (cluster apply/path axes, ``placement_axis``) behaves
exactly as in a training study.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cluster import ClusterLike, NodeGroup
from repro_torch.core.memory import effective_memory_bw
from repro_torch.core.study import (Axis, StudyContext, StudySpec, check_path,
                              placement_axis, set_by_path)
from repro_torch.serving.placement import (ColocatedPlacement,
                                     DisaggregatedPlacement, PhasePlan,
                                     get_serving_placement, kv_transfer_time)
from repro_torch.serving.traffic import (FleetMetrics, ReplicaProfile, SLOSpec,
                                   TrafficTrace, simulate_colocated,
                                   simulate_disaggregated)
from repro_torch.serving.workload import ServingModel, ServingWorkload

SERVING_COLUMNS: Tuple[str, ...] = (
    "ttft_p50", "ttft_p99", "tpot", "goodput", "goodput_per_dollar")

_POINT_FIELDS: Tuple[str, ...] = ("serving", "trace", "slo")


@dataclasses.dataclass(frozen=True)
class ServingPoint:
    """The per-cell serving state dotted-path axes rewrite."""

    serving: ServingModel
    trace: TrafficTrace
    slo: SLOSpec


def is_serving_axis(axis: Axis) -> bool:
    """True when the axis path rewrites the serving point, not the
    cluster (``serving.* / trace.* / slo.*``)."""
    return (axis.kind == "cluster" and axis.path is not None
            and axis.path.partition(".")[0] in _POINT_FIELDS)


def serving_placement_axis(
        values: Sequence[object] = ("colocated", "disaggregated"),
        name: str = "placement") -> Axis:
    """A placement axis over serving placements; names resolve through
    :func:`repro_torch.serving.placement.get_serving_placement` (the core
    registry only knows the training placements)."""
    return placement_axis(tuple(get_serving_placement(v) for v in values),
                          name=name)


@dataclasses.dataclass
class ServingSpec:
    """A declarative serving-fleet study.

    ``placement`` is a serving placement (``"colocated"`` /
    ``"disaggregated"`` / an instance); sweep it per cell with
    :func:`serving_placement_axis`.  ``metrics`` adds derived columns
    exactly as on :class:`StudySpec`."""

    name: str
    model: ModelConfig
    cluster: Optional[ClusterLike] = None
    serving: ServingModel = dataclasses.field(default_factory=ServingModel)
    trace: TrafficTrace = dataclasses.field(default_factory=TrafficTrace)
    slo: SLOSpec = dataclasses.field(default_factory=SLOSpec)
    axes: Sequence[Axis] = ()
    placement: Any = "colocated"
    metrics: Dict[str, Callable[[StudyContext], Any]] = \
        dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        get_serving_placement(self.placement)    # fail fast on bad names
        point = self.point()
        for axis in self.axes:
            if is_serving_axis(axis):
                check_path(point, axis.path or "")

    def point(self) -> ServingPoint:
        return ServingPoint(self.serving, self.trace, self.slo)

    def to_study(self) -> "ServingStudy":
        """Lower to a StudySpec the study engine runs unchanged: serving
        axes become label axes the evaluator folds back into the serving
        point; everything else passes through."""
        serving_axes = [a for a in self.axes if is_serving_axis(a)]
        study_axes = [dataclasses.replace(a, path=None)
                      if is_serving_axis(a) else a for a in self.axes]
        base_placement = get_serving_placement(self.placement)
        spec = self

        def evaluate(ctx: StudyContext) -> Dict[str, Any]:
            point = spec.point()
            for axis in serving_axes:
                point = set_by_path(point, axis.path or "",
                                    ctx.point[axis.name],
                                    scale=(axis.mode == "scale"))
            placement = ctx.placement if ctx.placement is not None \
                else base_placement
            return serving_record(ctx.cluster, spec.model, point, placement)

        return ServingStudy(
            name=self.name, cluster=self.cluster, model=self.model,
            axes=tuple(study_axes), placement=base_placement,
            metrics=dict(self.metrics), evaluate=evaluate, serving=self)


@dataclasses.dataclass
class ServingStudy(StudySpec):
    """The lowered StudySpec, carrying its source :class:`ServingSpec`
    so ``run_study(validate=)`` can run the V1xx serving rules on it."""

    serving: Optional[ServingSpec] = None


# --------------------------------------------------------------------- #
# The per-cell evaluator
# --------------------------------------------------------------------- #

def _infeasible(reason: str) -> Dict[str, Any]:
    return {"ttft_p50": float("inf"), "ttft_p99": float("inf"),
            "tpot": float("inf"), "goodput": 0.0,
            "goodput_per_dollar": 0.0, "throughput": 0.0,
            "num_replicas": 0, "feasible": False,
            "footprint_bytes": float("inf"), "mem_bw": 0.0,
            "infeasible_reason": reason}


def _colocated_profiles(wl: ServingWorkload, groups: Sequence[NodeGroup],
                        plan: PhasePlan) -> List[ReplicaProfile]:
    npr = wl.serving.nodes_per_replica
    out: List[ReplicaProfile] = []
    for gi in plan.decode:
        g = groups[gi]
        slots = wl.slots_that_fit(g.node)
        count = g.num_nodes // npr
        if slots < 1 or count < 1:
            continue
        out.append(ReplicaProfile(
            prefill_time=wl.prefill_time(g.node),
            decode_curve=wl.decode_curve(g.node, max_batch=slots),
            max_batch=slots, count=count))
    return out


def _prefill_fits(wl: ServingWorkload, g: NodeGroup) -> bool:
    """A prefill server holds the weights plus one prompt's KV."""
    npr = wl.serving.nodes_per_replica
    free = g.node.total_cap * npr - wl.weight_bytes
    return free >= wl.kv_bytes_for(wl.serving.prompt_len)


def serving_record(cluster: Optional[ClusterLike], cfg: ModelConfig,
                   point: ServingPoint, placement: object) -> Dict[str, Any]:
    """Evaluate one serving cell: build the fleet the placement implies,
    replay the trace through the fleet queue, attach the SLO columns."""
    if cluster is None:
        return _infeasible("serving study needs a cluster")
    wl = ServingWorkload(cfg, point.serving)
    try:
        n_arrivals = len(point.trace.arrivals)
    except ValueError as exc:
        return _infeasible(str(exc))
    if n_arrivals == 0:
        return _infeasible("empty traffic trace")
    pl = get_serving_placement(placement)
    groups = cluster.node_groups
    plan = pl.phase_plan(groups)
    npr = point.serving.nodes_per_replica
    decode_steps = wl.decode_steps
    pre: List[ReplicaProfile]
    dec: List[ReplicaProfile]

    if isinstance(pl, DisaggregatedPlacement) and not plan.disaggregated:
        # Homogeneous cluster: split the single group's nodes by
        # prefill_frac instead of partitioning groups.
        g = groups[plan.decode[0]]
        total = g.num_nodes // npr
        n_pre = max(1, int(round(pl.prefill_frac * total)))
        n_dec = total - n_pre
        slots = wl.slots_that_fit(g.node)
        if n_dec < 1 or slots < 1 or not _prefill_fits(wl, g):
            return _infeasible("disaggregated split does not fit the fleet")
        pre = [ReplicaProfile(wl.prefill_time(g.node), (0.0,), 1,
                              count=n_pre)]
        dec = [ReplicaProfile(0.0, wl.decode_curve(g.node, max_batch=slots),
                              slots, count=n_dec)]
        kv_delay = kv_transfer_time(wl.kv_bytes_for(point.serving.prompt_len),
                                    cluster.topology)
        metrics = simulate_disaggregated(pre, dec, decode_steps, point.trace,
                                         point.slo, kv_delay=kv_delay)
        hot = g.node
        n_replicas = n_dec
    elif isinstance(pl, DisaggregatedPlacement):
        pre = []
        for gi in plan.prefill:
            g = groups[gi]
            count = g.num_nodes // npr
            if count < 1 or not _prefill_fits(wl, g):
                continue
            pre.append(ReplicaProfile(wl.prefill_time(g.node), (0.0,), 1,
                                      count=count))
        dec = []
        for gi in plan.decode:
            g = groups[gi]
            slots = wl.slots_that_fit(g.node)
            count = g.num_nodes // npr
            if slots < 1 or count < 1:
                continue
            dec.append(ReplicaProfile(
                0.0, wl.decode_curve(g.node, max_batch=slots), slots,
                count=count))
        if not pre or not dec:
            return _infeasible(
                "disaggregated plan has no feasible "
                + ("prefill" if not pre else "decode") + " replicas")
        kv_delay = kv_transfer_time(wl.kv_bytes_for(point.serving.prompt_len),
                                    cluster.topology)
        metrics = simulate_disaggregated(pre, dec, decode_steps, point.trace,
                                         point.slo, kv_delay=kv_delay)
        hot = groups[plan.decode[0]].node
        n_replicas = sum(r.count for r in dec)
    else:
        replicas = _colocated_profiles(wl, groups, plan)
        if not replicas:
            return _infeasible("no node group fits a single KV slot "
                               "next to the weights")
        metrics = simulate_colocated(replicas, decode_steps, point.trace,
                                     point.slo)
        hot = max((groups[gi].node for gi in plan.decode
                   if wl.fits(groups[gi].node)),
                  key=lambda n: wl.slots_that_fit(n))
        n_replicas = sum(r.count for r in replicas)

    footprint = wl.replica_bytes(wl.slots_that_fit(hot))
    record: Dict[str, Any] = {
        "ttft_p50": metrics.ttft_p50, "ttft_p99": metrics.ttft_p99,
        "tpot": metrics.tpot, "goodput": metrics.goodput,
        "throughput": metrics.throughput, "num_replicas": n_replicas,
        "feasible": True, "footprint_bytes": footprint,
        "mem_bw": effective_memory_bw(hot, footprint),
    }
    cost = getattr(cluster, "cost", None)
    tco = cost.tco(cluster) if cost is not None else 0.0
    record["goodput_per_dollar"] = \
        metrics.goodput / tco if tco > 0 else 0.0
    return record


__all__ = [
    "SERVING_COLUMNS", "ServingPoint", "ServingSpec", "ServingStudy",
    "FleetMetrics", "is_serving_axis", "serving_placement_axis",
    "serving_record", "ColocatedPlacement", "DisaggregatedPlacement",
]
