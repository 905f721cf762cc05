"""COMET's study runner on the port's evaluator: one engine for every case
study.

The port of the JAX package's ``core/study.py`` (held to it record for
record by ``tests/test_torch_study.py``). COMET's methodology (§V) is a
joint sweep over parallelization strategies and cluster resource knobs;
this module makes that data:

  * :class:`ParallelSpec` — a strategy point (MP, DP, PP, EP, ZeRO stage,
    microbatch count, pipeline schedule);
  * :class:`StrategySpace` — strategy enumerators
    (:class:`PowerOfTwoSpace` is the paper sweep, :class:`FactorizationSpace`,
    :class:`GridSpace`, :class:`ExplicitSpace`);
  * :class:`Axis` — one swept cluster knob, by dotted path into the frozen
    config tree (``"node.exp_bw"``) or by an ``apply(cluster, value)``
    transform; ``kind="placement"`` sweeps the cell's placement;
  * :class:`StudySpec` — base cluster + axes x strategies, an optional
    workload builder, derived metrics, an optional multi-tenant job;
  * :func:`run_study` — enumerates the cells, lowers each strategy once,
    times every (placement, environment) the strategy's cells touch in one
    :func:`repro_torch.core.simulator.time_compiled` batch on the device,
    and assembles the records through :func:`_eval_cell`, cell by cell,
    as the reference does; :class:`StudyResult` holds them. ``run_study``
    also takes anything with a ``to_study()`` lowering (a
    :class:`repro_torch.serving.ServingSpec`, a
    :class:`repro_torch.fleet.FleetSpec`).

``repro_torch.core.dse`` expresses the paper's case studies (Figs. 8-15) as
StudySpecs over this runner, and ``repro_torch.core.search`` searches it
(``StudyResult.pareto_front`` delegates there). There is one engine, the
port's compiled one, on the caller's ``device``, else the GPU. Before any
cell runs, ``validate`` gates the static pre-flight of
:mod:`repro_torch.analysis` (S1xx on the spec, K1xx on its base cluster,
V1xx on a lowered serving spec, F1xx on a lowered fleet spec, Y1xx on a
failure model or a fleet's failure trace). A spec with a
``reliability`` failure model grows the closed-form Young–Daly columns
(:mod:`repro_torch.reliability`), and anything with a ``to_study()``
lowering (a :class:`repro_torch.serving.ServingSpec`, a
:class:`repro_torch.fleet.FleetSpec`) runs directly; every cell's
:class:`StudyContext` carries the run's ``device``. A
process pool is not ported: ``processes > 1`` raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import csv
import dataclasses
import io
import itertools
import json
import math
import warnings
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cluster import ClusterLike
from repro_torch.core.memory import FootprintReport
from repro_torch.core.placement import (
    JobSpec,
    Placement,
    PlacementLike,
    Schedule,
    ScheduleModel,
    get_placement,
)
from repro_torch.core.simulator import (
    IterationBreakdown,
    PhaseBreakdown,
    compiled_stage_assignment,
    group_breakdowns_compiled,
    simulate_iteration_compiled,
    time_compiled,
)
from repro_torch.core.workload import InfeasibleStrategyError, Workload, decompose

GB = 1e9

DEFAULT_ZERO_STAGE = 2  # paper default (§IV-B): ZeRO-2 (os + g sharded)


# ===================================================================== #
# Strategy points and strategy spaces
# ===================================================================== #

@dataclasses.dataclass(frozen=True, order=True)
class ParallelSpec:
    """One parallelization-strategy point.

    Generalizes the paper's (MP, DP) pairs to the four-axis product
    (MP, DP, PP, EP) plus the ZeRO stage — all modeled natively by the
    default analytical ``decompose``.  ``num_microbatches`` sets the
    pipeline microbatch count (0 = auto: the shape's knob, else ``4 * pp``).
    """

    mp: int = 1
    dp: int = 1
    pp: int = 1
    ep: int = 1
    zero_stage: int = DEFAULT_ZERO_STAGE
    num_microbatches: int = 0          # 0 = auto (shape knob or 4 * pp)
    schedule: str = "1f1b"             # "gpipe" | "1f1b" | "interleaved"
    virtual_stages: int = 0            # 0 = auto (2 when interleaved)

    def __post_init__(self):
        for f in ("mp", "dp", "pp", "ep"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1, got {getattr(self, f)}")
        if not 0 <= self.zero_stage <= 3:
            raise ValueError(f"zero_stage must be 0..3, got {self.zero_stage}")
        if self.num_microbatches < 0:
            raise ValueError(
                f"num_microbatches must be >= 0, got {self.num_microbatches}")
        if self.schedule not in ("gpipe", "1f1b", "interleaved"):
            raise ValueError(f"schedule must be 'gpipe', '1f1b' or "
                             f"'interleaved', got {self.schedule!r}")
        if self.virtual_stages < 0:
            raise ValueError(
                f"virtual_stages must be >= 0, got {self.virtual_stages}")
        # Pipeline-only knobs normalize away off the pipeline so distinct
        # specs mean distinct physics (labels, memo keys, grid dedupe):
        # microbatches/schedule do nothing at pp == 1, virtual stages do
        # nothing off the interleaved schedule.
        if self.pp == 1:
            object.__setattr__(self, "num_microbatches", 0)
            object.__setattr__(self, "schedule", "1f1b")
        if self.schedule != "interleaved" and self.virtual_stages:
            object.__setattr__(self, "virtual_stages", 0)

    @property
    def num_nodes(self) -> int:
        return self.mp * self.dp * self.pp * self.ep

    @property
    def label(self) -> str:
        parts = [f"MP{self.mp}", f"DP{self.dp}"]
        if self.pp > 1:
            parts.append(f"PP{self.pp}")
        if self.ep > 1:
            parts.append(f"EP{self.ep}")
        if self.zero_stage != DEFAULT_ZERO_STAGE:
            parts.append(f"Z{self.zero_stage}")
        if self.num_microbatches:
            parts.append(f"MB{self.num_microbatches}")
        if self.schedule == "gpipe":
            parts.append("GPIPE")
        elif self.schedule == "interleaved":
            parts.append(f"INT{self.virtual_stages or 2}")
        return "_".join(parts)


class StrategySpace:
    """Enumerates the :class:`ParallelSpec` points to evaluate on a cluster."""

    def specs(self, num_nodes: int) -> List[ParallelSpec]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PowerOfTwoSpace(StrategySpace):
    """The paper's sweep: all (MP, DP) with MP * DP = N, MP a power of two,
    MP descending (Fig. 8 ordering).

    ``pp`` / ``ep`` extend the sweep to the four-axis product: for every
    (pp, ep) pair dividing the cluster, MP powers of two enumerate over the
    remaining N / (pp * ep) nodes.  Defaults reproduce the paper sweep."""

    zero_stage: int = DEFAULT_ZERO_STAGE
    min_mp: int = 1
    max_mp: Optional[int] = None
    pp: Sequence[int] = (1,)
    ep: Sequence[int] = (1,)
    num_microbatches: int = 0

    def specs(self, num_nodes: int) -> List[ParallelSpec]:
        out = []
        for pp, ep in itertools.product(self.pp, self.ep):
            if num_nodes % (pp * ep):
                continue
            rem = num_nodes // (pp * ep)
            mp = rem
            while mp >= 1:
                if mp >= self.min_mp and (self.max_mp is None
                                          or mp <= self.max_mp):
                    out.append(ParallelSpec(
                        mp=mp, dp=rem // mp, pp=pp, ep=ep,
                        zero_stage=self.zero_stage,
                        num_microbatches=self.num_microbatches))
                mp //= 2
        return out


@dataclasses.dataclass(frozen=True)
class FactorizationSpace(StrategySpace):
    """All exact factorizations MP * DP = N (non-power-of-two included),
    MP descending — e.g. 12 nodes yields MP in (12, 6, 4, 3, 2, 1)."""

    zero_stage: int = DEFAULT_ZERO_STAGE
    min_mp: int = 1
    max_mp: Optional[int] = None

    def specs(self, num_nodes: int) -> List[ParallelSpec]:
        out = []
        for mp in range(num_nodes, 0, -1):
            if num_nodes % mp:
                continue
            if mp < self.min_mp or (self.max_mp is not None
                                    and mp > self.max_mp):
                continue
            out.append(ParallelSpec(mp=mp, dp=num_nodes // mp,
                                    zero_stage=self.zero_stage))
        return out


@dataclasses.dataclass(frozen=True)
class GridSpace(StrategySpace):
    """Cartesian product over (mp, dp, pp, ep, zero_stage, microbatch)
    value sets.

    With ``fill_cluster`` (default) only points whose total degree equals
    the cluster size survive — the paper's "use every node" constraint;
    switch it off to study partial-cluster placements."""

    mp: Sequence[int] = (1,)
    dp: Sequence[int] = (1,)
    pp: Sequence[int] = (1,)
    ep: Sequence[int] = (1,)
    zero_stages: Sequence[int] = (DEFAULT_ZERO_STAGE,)
    num_microbatches: Sequence[int] = (0,)
    schedules: Sequence[str] = ("1f1b",)
    virtual_stages: Sequence[int] = (0,)
    fill_cluster: bool = True

    def specs(self, num_nodes: int) -> List[ParallelSpec]:
        out = []
        seen = set()
        for mp, dp, pp, ep, z, mb, sched, v in itertools.product(
                self.mp, self.dp, self.pp, self.ep, self.zero_stages,
                self.num_microbatches, self.schedules, self.virtual_stages):
            s = ParallelSpec(mp=mp, dp=dp, pp=pp, ep=ep, zero_stage=z,
                             num_microbatches=mb, schedule=sched,
                             virtual_stages=v)
            if self.fill_cluster and s.num_nodes != num_nodes:
                continue
            if s in seen:   # pp=1 normalizes the pipeline knobs away
                continue
            seen.add(s)
            out.append(s)
        return out


@dataclasses.dataclass(frozen=True)
class ExplicitSpace(StrategySpace):
    """A fixed, ordered list of strategies (cluster size is not checked, so
    partial-cluster what-ifs are allowed)."""

    strategies: Tuple[ParallelSpec, ...]

    def specs(self, num_nodes: int) -> List[ParallelSpec]:
        return list(self.strategies)


StrategiesLike = Union[StrategySpace, ParallelSpec, Iterable, None]


def as_strategy_space(obj: StrategiesLike) -> Optional[StrategySpace]:
    """Coerce user input to a StrategySpace: a space passes through, a
    ParallelSpec or (mp, dp) tuple becomes a one-point ExplicitSpace, an
    iterable of either becomes an ExplicitSpace, None stays None."""
    if obj is None or isinstance(obj, StrategySpace):
        return obj
    if isinstance(obj, ParallelSpec):
        return ExplicitSpace((obj,))
    if isinstance(obj, tuple) and len(obj) == 2 \
            and all(isinstance(x, int) for x in obj):
        return ExplicitSpace((ParallelSpec(mp=obj[0], dp=obj[1]),))
    specs = []
    for item in obj:
        if isinstance(item, ParallelSpec):
            specs.append(item)
        else:
            mp, dp = item
            specs.append(ParallelSpec(mp=mp, dp=dp))
    return ExplicitSpace(tuple(specs))


# ===================================================================== #
# Dotted-path overrides over the frozen config tree
# ===================================================================== #

def get_by_path(obj: Any, path: str) -> Any:
    """Read ``obj.a.b.c`` given ``"a.b.c"``."""
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _check_field(obj: Any, head: str, path: str) -> None:
    """The field check ``set_by_path`` applies at each path segment."""
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"cannot override {path!r} on non-dataclass "
                        f"{type(obj).__name__}")
    if head not in {f.name for f in dataclasses.fields(obj)}:
        raise AttributeError(
            f"{type(obj).__name__} has no field {head!r} "
            f"(available: {sorted(f.name for f in dataclasses.fields(obj))})")


def check_path(obj: Any, path: str) -> None:
    """Walk a dotted path through nested dataclasses without mutating
    anything, raising exactly what :func:`set_by_path` would raise on a
    typo'd segment — lets StudySpec (and the S101 analysis rule) reject a
    bad ``Axis.path`` at construction instead of mid-run in a worker."""
    head, _, rest = path.partition(".")
    _check_field(obj, head, path)
    if rest:
        check_path(getattr(obj, head), rest)


def set_by_path(obj: Any, path: str, value: Any, scale: bool = False) -> Any:
    """Functionally update a nested frozen-dataclass field by dotted path.

    ``set_by_path(cluster, "node.exp_bw", 1e12)`` returns a new cluster;
    with ``scale=True`` the leaf is multiplied by ``value`` instead of
    replaced (the paper's "2x intra-pod bandwidth" style knob)."""
    head, _, rest = path.partition(".")
    _check_field(obj, head, path)
    if rest:
        new_child = set_by_path(getattr(obj, head), rest, value, scale)
        return dataclasses.replace(obj, **{head: new_child})
    leaf = getattr(obj, head) * value if scale else value
    return dataclasses.replace(obj, **{head: leaf})


@dataclasses.dataclass(frozen=True)
class Axis:
    """One swept knob: a name, its values, and how a value rewrites the
    cluster — a dotted ``path`` (optionally ``mode="scale"``) or a custom
    ``apply(cluster, value) -> cluster``. An axis with neither is a pure
    label axis (it only parameterizes the workload builder or metrics).

    ``kind="placement"`` sweeps the cell's
    :class:`~repro.core.placement.Placement` instead of the cluster: the
    values are placement names (``"paper"``, ``"em-aware"``) or Placement
    instances, and the record column holds the placement label.  The
    helper :func:`placement_axis` builds one."""

    name: str
    values: Sequence[Any]
    path: Optional[str] = None
    mode: str = "set"                                  # "set" | "scale"
    apply: Optional[Callable[[ClusterLike, Any], ClusterLike]] = None
    kind: str = "cluster"                              # "cluster" | "placement"

    def __post_init__(self):
        if self.mode not in ("set", "scale"):
            raise ValueError(f"mode must be 'set' or 'scale', got {self.mode!r}")
        if self.kind not in ("cluster", "placement"):
            raise ValueError(
                f"kind must be 'cluster' or 'placement', got {self.kind!r}")
        if self.path is not None and self.apply is not None:
            raise ValueError("give either path or apply, not both")
        if self.kind == "placement" and (self.path or self.apply):
            raise ValueError("a placement axis takes neither path nor apply")

    def override(self, cluster: ClusterLike, value: Any) -> ClusterLike:
        if self.kind == "placement" or self.apply is None and self.path is None:
            return cluster
        if self.apply is not None:
            return self.apply(cluster, value)
        return set_by_path(cluster, self.path, value,
                           scale=(self.mode == "scale"))


def placement_axis(values: Sequence[PlacementLike] = ("paper", "em-aware"),
                   name: str = "placement") -> Axis:
    """A sweepable placement axis; values are names from
    :func:`repro.core.placement.list_placements` or Placement instances."""
    return Axis(name, tuple(values), kind="placement")


_RELIABILITY_PREFIX = "reliability."


def is_reliability_axis(axis: Axis) -> bool:
    """True when the axis path rewrites the spec's FailureModel instead
    of the cluster (``reliability.*`` — mirrors the fleet's ``fleet.*``
    convention)."""
    return (axis.kind == "cluster" and axis.path is not None
            and axis.path.startswith(_RELIABILITY_PREFIX))


# ===================================================================== #
# Study specification
# ===================================================================== #

@dataclasses.dataclass
class StudyContext:
    """Everything a workload builder / metric / evaluator can see for one
    cell. ``workload``/``breakdown``/``footprint`` are populated as the
    engine progresses through the cell. ``device`` is the one
    :func:`run_study` resolved: an evaluator that times anything (a fleet
    study's width profiles) times it there."""

    spec: "StudySpec"
    strategy: Optional[ParallelSpec]
    point: Dict[str, Any]                      # axis name -> swept value
    cluster: Optional[ClusterLike]             # None only in evaluate studies
    placement: Optional[Placement] = None
    workload: Optional[Workload] = None
    breakdown: Optional[IterationBreakdown] = None
    footprint: Optional[FootprintReport] = None
    schedule: Optional[Schedule] = None        # set when the spec has a job
    device: Any = None                         # run_study's device


@dataclasses.dataclass
class StudySpec:
    """A declarative COMET study: strategies x axes on a base cluster.

    ``workload`` (default: ``decompose(model, shape, mp, dp, pp, ep)`` —
    the full four-axis analytical decomposition) may read
    anything on the context; list the axis names it depends on in
    ``workload_deps`` so the engine's memoizer keys decompositions
    correctly. ``metrics`` adds derived record columns. ``evaluate``
    replaces the simulator entirely (for studies over measured frontends).

    ``placement`` (a :class:`~repro.core.placement.Placement` or its
    registry name) fixes how cells map onto the cluster; a
    ``kind="placement"`` axis sweeps it per cell instead.  ``job`` (a
    :class:`~repro.core.placement.JobSpec`, or ``ctx -> JobSpec`` when it
    depends on the swept point) turns every cell multi-tenant: the engine
    schedules ``job.instances`` concurrent instances over the cluster's
    node groups through ``schedule_model`` (default
    :class:`~repro.core.placement.ScheduleModel`) and writes native
    ``concurrent_instances`` / ``waves`` / ``turnaround`` / ``makespan``
    record columns (the Fig. 13b / Fig. 15 metrics)."""

    name: str
    cluster: Optional[ClusterLike] = None
    model: Optional[ModelConfig] = None
    shape: Optional[ShapeConfig] = None
    axes: Sequence[Axis] = ()
    strategies: StrategiesLike = None
    workload: Optional[Callable[[StudyContext], Workload]] = None
    workload_deps: Sequence[str] = ()
    mem_bw_override: Union[float, str, None] = None    # float | "local" | None
    require_fit: bool = False
    placement: PlacementLike = None
    job: Union[JobSpec, Callable[[StudyContext], JobSpec], None] = None
    schedule_model: Optional[ScheduleModel] = None
    metrics: Dict[str, Callable[[StudyContext], Any]] = \
        dataclasses.field(default_factory=dict)
    evaluate: Optional[Callable[[StudyContext], Dict[str, Any]]] = None
    # A repro_torch.reliability.FailureModel: every simulated cell then
    # grows the closed-form Young–Daly columns (ckpt_interval_s /
    # ckpt_overhead_frac / expected_restarts / goodput_frac and, with a
    # cost model, goodput_per_dollar).  ``reliability.*`` dotted-path
    # axes rewrite it per cell.  None (default) adds nothing — records
    # are bit-for-bit the pre-reliability output.
    reliability: Optional[Any] = None

    # Record columns the engine itself writes; an axis shadowing one would
    # silently corrupt select()/pivot()/best().  (A kind="placement" axis
    # *owns* the "placement" column, so it is exempt from the check.)
    RESERVED_COLUMNS = frozenset({
        "study", "strategy", "mp", "dp", "pp", "ep", "zero_stage",
        "num_microbatches", "schedule", "virtual_stages", "placement",
        "bubble_fraction", "infeasible_reason",
        "fp_compute", "fp_exposed_comm", "ig_compute", "ig_exposed_comm",
        "wg_compute", "wg_exposed_comm", "optimizer", "total",
        "feasible", "footprint_bytes", "mem_bw",
        "cost_usd", "energy_usd", "tco", "perf_per_dollar",
        "pareto_rank", "pareto_optimal",
        "search_round", "search_fidelity", "search_score",
        "concurrent_instances", "waves", "turnaround", "makespan",
        "ttft_p50", "ttft_p99", "tpot", "goodput", "goodput_per_dollar",
        "fleet_util", "turnaround_p50", "turnaround_p99", "preemptions",
        "resize_events", "burst_events", "jobs_completed", "n_events",
        "ckpt_interval_s", "ckpt_overhead_frac", "expected_restarts",
        "goodput_frac", "failures", "lost_work_frac",
    })

    def __post_init__(self):
        axis_names = [a.name for a in self.axes]
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate axis names: {axis_names}")
        reserved = {a.name for a in self.axes
                    if not (a.kind == "placement" and a.name == "placement")} \
            & self.RESERVED_COLUMNS
        if reserved:
            raise ValueError(
                f"axis names shadow engine record columns: {sorted(reserved)}")
        unknown = set(self.workload_deps) - set(axis_names)
        if unknown:
            raise ValueError(f"workload_deps name unknown axes: {unknown}")
        if isinstance(self.mem_bw_override, str) \
                and self.mem_bw_override != "local":
            raise ValueError("mem_bw_override must be a float, None, "
                             "or the string 'local'")
        get_placement(self.placement)   # fail fast on unknown names
        # Fail fast on typo'd dotted paths too: resolve every path axis
        # against the base cluster's schema now, instead of erroring on the
        # first cell.  An apply axis may
        # rewrite the cluster arbitrarily (even change its type), so paths
        # behind one can only be checked at run time.
        for axis in self.axes:
            if is_reliability_axis(axis):
                if self.reliability is None:
                    raise ValueError(
                        f"axis {axis.name!r} sweeps {axis.path!r} but the "
                        "study has no FailureModel — set "
                        "StudySpec.reliability")
                check_path(self.reliability,
                           (axis.path or "")[len(_RELIABILITY_PREFIX):])
        if self.cluster is not None:
            transformed = False
            for axis in self.axes:
                if axis.kind != "cluster" or is_reliability_axis(axis):
                    continue
                if axis.apply is not None:
                    transformed = True
                elif axis.path is not None and not transformed:
                    check_path(self.cluster, axis.path)


@dataclasses.dataclass
class CellResult:
    """One evaluated cell: its identity plus the raw model objects (for
    programmatic consumers) and the flat ``record`` (for tidy output)."""

    strategy: Optional[ParallelSpec]
    point: Dict[str, Any]
    cluster: Optional[ClusterLike]
    breakdown: Optional[IterationBreakdown]
    footprint: Optional[FootprintReport]
    record: Dict[str, Any]


# ===================================================================== #
# Engine
# ===================================================================== #

def _cells(spec: StudySpec) -> List[Tuple[Optional[ParallelSpec],
                                          Dict[str, Any], ClusterLike,
                                          Optional[Placement]]]:
    """Axis-product-major enumeration; strategies are resolved against each
    cell's *overridden* cluster so a cluster-valued axis (Fig. 15) gets the
    right per-cluster strategy list.  A ``kind="placement"`` axis rewrites
    the cell's placement instead of the cluster (the point keeps the
    placement's label so records stay tidy)."""
    space = as_strategy_space(spec.strategies)
    names = [a.name for a in spec.axes]
    out = []
    for combo in itertools.product(*(a.values for a in spec.axes)):
        point = dict(zip(names, combo))
        cluster = spec.cluster
        pl = get_placement(spec.placement)
        for axis, value in zip(spec.axes, combo):
            if axis.kind == "placement":
                pl = get_placement(value)
                point[axis.name] = pl.label if pl is not None else None
            elif is_reliability_axis(axis):
                pass   # folded into the FailureModel per cell (_eval_cell)
            else:
                cluster = axis.override(cluster, value)
        if cluster is None and spec.evaluate is None:
            raise ValueError(
                f"study {spec.name!r}: no cluster — set StudySpec.cluster "
                "or provide it via an axis apply() (only evaluate-based "
                "studies may run clusterless)")
        if space is None:
            out.append((None, point, cluster, pl))
        else:
            n = cluster.num_nodes if cluster is not None else 0
            for strategy in space.specs(n):
                out.append((strategy, point, cluster, pl))
    return out


def _default_workload(ctx: StudyContext) -> Workload:
    s = ctx.strategy or ParallelSpec()
    if ctx.spec.model is None or ctx.spec.shape is None:
        raise ValueError(f"study {ctx.spec.name!r}: set model+shape or "
                         "provide a workload builder")
    return decompose(ctx.spec.model, ctx.spec.shape, mp=s.mp, dp=s.dp,
                     pp=s.pp, ep=s.ep,
                     num_microbatches=s.num_microbatches or None,
                     schedule=s.schedule,
                     virtual_stages=s.virtual_stages or None)


def _workload_key(spec: StudySpec, strategy: Optional[ParallelSpec],
                  point: Dict[str, Any]) -> tuple:
    return (strategy,
            tuple((n, point[n]) for n in spec.workload_deps))


def _cost_columns(record: Dict[str, Any], cluster: ClusterLike) -> None:
    """Attach cost_usd / tco / perf_per_dollar when the cluster carries a
    CostModel.  perf_per_dollar is iterations-per-second per TCO dollar:
    1 / (iteration_time * tco) — the paper §V-D ranking metric.  Infeasible
    cells get 0.0 so ``best("perf_per_dollar", maximize=True)`` never
    recommends a strategy that does not fit in memory."""
    cost = getattr(cluster, "cost", None)
    if cost is None:
        return
    capex = cost.capex(cluster)
    record["cost_usd"] = capex
    energy = cost.energy_usd(cluster)
    record["energy_usd"] = energy
    tco = capex + energy
    record["tco"] = tco
    total = record.get("total")
    if record.get("feasible", True) and isinstance(total, (int, float)) \
            and total > 0 and tco > 0:
        record["perf_per_dollar"] = 1.0 / (total * tco)
    else:
        record["perf_per_dollar"] = 0.0


_DEFAULT_SCHEDULER = ScheduleModel()


def _reliability_columns(spec: StudySpec, ctx: StudyContext,
                         record: Dict[str, Any]) -> None:
    """Attach the closed-form Young–Daly columns when the spec carries a
    FailureModel.  ``reliability.*`` axes fold into the model here (the
    cluster never sees them).  Infeasible cells get zeroed columns so
    ``best("goodput_per_dollar", maximize=True)`` never recommends a
    strategy that does not fit."""
    model = spec.reliability
    if model is None:
        return
    from repro_torch.fleet.resize import instance_state_bytes
    from repro_torch.reliability.model import reliability_columns
    for axis in spec.axes:
        if is_reliability_axis(axis):
            model = set_by_path(model,
                                (axis.path or "")[len(_RELIABILITY_PREFIX):],
                                ctx.point[axis.name],
                                scale=(axis.mode == "scale"))
    if not record.get("feasible", True) or ctx.workload is None:
        record.update(ckpt_interval_s=0.0, ckpt_overhead_frac=0.0,
                      expected_restarts=0.0, goodput_frac=0.0)
        if "perf_per_dollar" in record:
            record["goodput_per_dollar"] = 0.0
        return
    num_nodes = (ctx.strategy.num_nodes if ctx.strategy is not None
                 else ctx.cluster.num_nodes if ctx.cluster is not None
                 else 0)
    record.update(reliability_columns(
        model, instance_state_bytes(ctx.workload), num_nodes))
    if "perf_per_dollar" in record:
        # iterations of *useful* work per second per TCO dollar — the
        # failure-aware §V-D ranking metric.
        record["goodput_per_dollar"] = \
            record["goodput_frac"] * record["perf_per_dollar"]


def _job_columns(spec: StudySpec, ctx: StudyContext,
                 record: Dict[str, Any], sim_memo: dict,
                 skey: tuple, group_sim) -> None:
    """Schedule ``spec.job``'s instances over the cell's node groups and
    attach the multi-tenant columns (Fig. 13b / Fig. 15 metrics).  The
    per-group breakdowns are memoized alongside the simulator calls (the
    same physics repeats across placement/job-only axis values).
    ``group_sim`` is the per-group evaluator (the runner's closure over
    :func:`~repro_torch.core.simulator.group_breakdowns_compiled`)."""
    job = spec.job(ctx) if callable(spec.job) else spec.job
    if job.nodes_per_instance == 0:
        if ctx.strategy is None:
            raise ValueError(
                f"study {spec.name!r}: JobSpec.nodes_per_instance is 0 and "
                "the study has no strategy to derive it from")
        job = dataclasses.replace(job,
                                  nodes_per_instance=ctx.strategy.num_nodes)
    gkey = ("groups",) + skey
    if gkey not in sim_memo:
        sim_memo[gkey] = group_sim(
            ctx.workload, ctx.cluster,
            zero_stage=(ctx.strategy.zero_stage
                        if ctx.strategy is not None else DEFAULT_ZERO_STAGE),
            mem_bw_override=spec.mem_bw_override,
            placement=ctx.placement)
    per = sim_memo[gkey]
    sched = (spec.schedule_model or _DEFAULT_SCHEDULER).schedule(
        job, ctx.cluster.node_groups, [b.total for b in per],
        fits=[b.feasible for b in per], placement=ctx.placement)
    ctx.schedule = sched
    record.update(concurrent_instances=sched.concurrent, waves=sched.waves,
                  turnaround=sched.turnaround, makespan=sched.makespan)
    # Multi-tenant semantics supersede the synchronous single-job gate:
    # the cell is feasible iff every *hosting* group fits its instances
    # (identical on a homogeneous fleet; on a mixed fleet an EM-aware
    # schedule confined to the EM pods is feasible even though the
    # replicate-everywhere gate is not).
    record["feasible"] = sched.feasible



def _eval_cell(spec: StudySpec, strategy: Optional[ParallelSpec],
               point: Dict[str, Any], cluster: ClusterLike,
               placement: Optional[Placement],
               wl_memo: dict, sim_memo: dict,
               simulate=None, group_sim=None, device=None) -> CellResult:
    """One cell's record. ``simulate`` / ``group_sim`` are the runner's
    closures over the compiled simulator for this cell's strategy; a cell
    without a workload (an ``evaluate`` study, an infeasible strategy)
    calls neither. ``device`` goes on the cell's context."""
    ctx = StudyContext(spec=spec, strategy=strategy, point=dict(point),
                       cluster=cluster, placement=placement, device=device)
    base: Dict[str, Any] = {"study": spec.name}
    if strategy is not None:
        base.update(strategy=strategy.label, mp=strategy.mp, dp=strategy.dp,
                    pp=strategy.pp, ep=strategy.ep,
                    zero_stage=strategy.zero_stage,
                    num_microbatches=strategy.num_microbatches)
    if placement is not None and "placement" not in point:
        base["placement"] = placement.label
    base.update(point)

    if spec.evaluate is not None:
        record = {**base, **spec.evaluate(ctx)}
        if cluster is not None:
            _cost_columns(record, cluster)
        for mname, fn in spec.metrics.items():
            record[mname] = fn(ctx)
        return CellResult(strategy, ctx.point, cluster, None, None, record)

    wkey = _workload_key(spec, strategy, point)
    if wkey not in wl_memo:
        try:
            wl_memo[wkey] = (spec.workload or _default_workload)(ctx)
        except InfeasibleStrategyError as err:
            wl_memo[wkey] = err
    wl = wl_memo[wkey]
    if isinstance(wl, InfeasibleStrategyError):
        # A swept degree this model cannot realize (ep not dividing the
        # experts, pp past the layer count): an infeasible record, not an
        # aborted sweep.  Derives the standard column set from a zeroed
        # IterationBreakdown (one schema for both record shapes) plus every
        # custom metric column (NaN when the metric needs the absent
        # workload) so pivot()/normalize()/best() keep working on mixed
        # results.
        zeroed = IterationBreakdown(
            PhaseBreakdown(), PhaseBreakdown(), PhaseBreakdown(),
            0.0, None, 0.0, False).as_dict()
        record = {**base, **zeroed, "total": float("inf"),
                  "feasible": False, "footprint_bytes": float("inf"),
                  "mem_bw": 0.0, "bubble_fraction": 0.0,
                  "infeasible_reason": str(wl)}
        if spec.job is not None:
            record.update(concurrent_instances=0, waves=0,
                          turnaround=float("inf"), makespan=float("inf"))
        if cluster is not None:
            _cost_columns(record, cluster)
        _reliability_columns(spec, ctx, record)
        for mname, fn in spec.metrics.items():
            try:
                record[mname] = fn(ctx)
            except Exception:
                record[mname] = float("nan")
        return CellResult(strategy, ctx.point, cluster, None, None, record)
    ctx.workload = wl
    if strategy is not None and hasattr(ctx.workload, "num_microbatches"):
        # Surface the workload's *resolved* pipeline knobs (the strategy
        # may have asked for 0 = auto; pp == 1 resolves to 1).
        base["num_microbatches"] = ctx.workload.num_microbatches
        base["schedule"] = getattr(ctx.workload, "schedule",
                                   strategy.schedule)
        base["virtual_stages"] = getattr(ctx.workload, "virtual_stages",
                                         strategy.virtual_stages)

    # "local" resolves per node group inside the simulator, so it works on
    # heterogeneous ClusterSpecs too (each group's own node.local_bw).
    override = spec.mem_bw_override
    zero = strategy.zero_stage if strategy is not None else DEFAULT_ZERO_STAGE
    # The simulator never reads the CostModel, so strip it from the memo
    # key: a pure cost-axis sweep (path="cost.usd_per_gb_em") simulates
    # each physical configuration once, not once per price point.
    sim_cluster = cluster
    if dataclasses.is_dataclass(cluster) \
            and getattr(cluster, "cost", None) is not None:
        sim_cluster = dataclasses.replace(cluster, cost=None)
    skey = (wkey, sim_cluster, zero, override, spec.require_fit, placement)
    if skey not in sim_memo:
        sim_memo[skey] = simulate(
            ctx.workload, cluster, zero_stage=zero,
            mem_bw_override=override, require_fit=spec.require_fit,
            placement=placement)
    br = sim_memo[skey]
    ctx.breakdown = br
    ctx.footprint = br.footprint

    record = {**base, **br.as_dict(),
              "feasible": br.feasible,
              "footprint_bytes": br.footprint.total,
              "mem_bw": br.mem_bw,
              "bubble_fraction": br.bubble_fraction}
    if spec.job is not None:
        _job_columns(spec, ctx, record, sim_memo, skey, group_sim=group_sim)
    _cost_columns(record, cluster)
    _reliability_columns(spec, ctx, record)
    for mname, fn in spec.metrics.items():
        record[mname] = fn(ctx)
    return CellResult(strategy, ctx.point, cluster, br, br.footprint, record)


# --- the engine -------------------------------------------------------- #

def _run_cells_compiled(spec: StudySpec, cells: List[tuple],
                        wl_memo: dict, sim_memo: dict,
                        device) -> List[CellResult]:
    """Strategy-major compiled evaluation.

    Cells are grouped by workload key; each group resolves and lowers its
    decomposition exactly once (``Workload.compiled()``), prefetches every
    (placement, environment) this group's cells will need through one
    batched :func:`~repro_torch.core.simulator.time_compiled` call per
    (placement, require_fit) on ``device``, then assembles records through
    :func:`_eval_cell`, cell by cell, as the reference does."""
    results: List[Optional[CellResult]] = [None] * len(cells)
    groups: Dict[tuple, List[int]] = {}
    for i, (s, p, _, _) in enumerate(cells):
        groups.setdefault(_workload_key(spec, s, p), []).append(i)
    for wkey, idxs in groups.items():
        s0, p0, cl0, pl0 = cells[idxs[0]]
        simulate = group_sim = None          # no workload: never called
        if spec.evaluate is None:
            if wkey not in wl_memo:
                ctx0 = StudyContext(spec=spec, strategy=s0,
                                    point=dict(p0), cluster=cl0,
                                    placement=pl0, device=device)
                try:
                    wl_memo[wkey] = (spec.workload
                                     or _default_workload)(ctx0)
                except InfeasibleStrategyError as err:
                    wl_memo[wkey] = err
            wl = wl_memo[wkey]
            if not isinstance(wl, InfeasibleStrategyError):
                cw = wl.compiled()
                zero = (s0.zero_stage if s0 is not None
                        else DEFAULT_ZERO_STAGE)
                env_cache: dict = {}
                # Prefetch: one batched evaluation per (placement,
                # require_fit) over every environment the group's cells
                # touch.  Cells on the assigned-pipeline path (mixed
                # fleet + pp>1 + a placement that stages the fleet) skip
                # the prefetch: simulate_iteration_compiled times those
                # per-stage (_time_compiled_assigned), not per-group, so
                # they never read the env cache.
                want: Dict[tuple, List[tuple]] = {}
                for i in idxs:
                    _, _, cl, pl = cells[i]
                    if cl is None:
                        continue
                    if compiled_stage_assignment(wl, cl, pl,
                                                 zero) is not None:
                        continue
                    for g in cl.node_groups:
                        env = (g.node, g.topology)
                        want.setdefault((pl, spec.require_fit),
                                        []).append(env)
                        if spec.job is not None and spec.require_fit:
                            want.setdefault((pl, False), []).append(env)
                for (pl, rf), envs in want.items():
                    batch = [env for env in dict.fromkeys(envs)
                             if (pl, env, rf) not in env_cache]
                    for env, br in zip(batch,
                                       time_compiled(cw, batch, zero,
                                                     spec.mem_bw_override,
                                                     rf, pl, device)):
                        env_cache[(pl, env, rf)] = br

                def simulate(workload, cluster, zero_stage=2,
                             mem_bw_override=None, require_fit=False,
                             placement=None, _cw=cw, _cache=env_cache):
                    return simulate_iteration_compiled(
                        _cw, cluster, zero_stage, mem_bw_override,
                        require_fit, placement, env_cache=_cache,
                        device=device)

                def group_sim(workload, cluster, zero_stage=2,
                              mem_bw_override=None, placement=None,
                              _cw=cw, _cache=env_cache):
                    return group_breakdowns_compiled(
                        _cw, cluster, zero_stage, mem_bw_override,
                        placement, env_cache=_cache, device=device)
        for i in idxs:
            s, p, cl, pl = cells[i]
            results[i] = _eval_cell(spec, s, p, cl, pl, wl_memo, sim_memo,
                                    simulate=simulate, group_sim=group_sim,
                                    device=device)
    return results


# --- what the runner does not do, and where it is planned --------------- #

PROCESSES_DEFERRED = (
    "run_study(processes > 1) is not ported: a fork pool after CUDA is "
    "initialised is unsafe, and the device batch takes the pool's place "
    "(ROADMAP Queue 1 item 22)")

VALIDATE_MODES = ("off", "warn", "error")


def _validate_spec(spec: StudySpec, mode: str) -> None:
    """Static pre-flight (:mod:`repro_torch.analysis`): S1xx rules on the
    spec plus K1xx rules on the base cluster, V1xx on a lowered serving
    spec's source, F1xx on a lowered fleet spec's source and Y1xx on a
    failure model (or a fleet's enabled failure trace).  Pure inspection —
    it never touches the cells or records, so results are identical across
    modes."""
    from repro_torch.analysis import (AnalysisError, analyze_cluster,
                                      analyze_study, format_report,
                                      has_errors)
    diags = analyze_study(spec)
    if spec.cluster is not None:
        diags += analyze_cluster(spec.cluster)
    if getattr(spec, "serving", None) is not None:
        from repro_torch.analysis import analyze_serving
        diags += analyze_serving(spec.serving)
    fleet = getattr(spec, "fleet", None)
    if fleet is not None:
        from repro_torch.analysis import analyze_fleet
        diags += analyze_fleet(fleet)
    if getattr(spec, "reliability", None) is not None:
        from repro_torch.analysis import analyze_reliability
        diags += analyze_reliability(spec)
    elif fleet is not None and fleet.failures.enabled:
        from repro_torch.analysis import analyze_reliability
        diags += analyze_reliability(fleet)
    # Advisory (info) findings don't warrant interrupting a run; they stay
    # visible through the analyze_* helpers.
    diags = [d for d in diags if d.severity != "info"]
    if not diags:
        return
    if mode == "error" and has_errors(diags):
        raise AnalysisError(diags)
    warnings.warn(f"study {spec.name!r} pre-flight:\n{format_report(diags)}",
                  stacklevel=3)


def run_study(spec: StudySpec, processes: Optional[int] = None,
              validate: str = "warn", device=None) -> "StudyResult":
    """Evaluate every cell of ``spec`` on the port's compiled engine.

    Workload decompositions are memoized by strategy + ``workload_deps``
    and simulator calls by workload + the cell's cluster (its cost model
    stripped) + ZeRO stage + bandwidth override + placement; each strategy
    is lowered once and its cells' environments timed in one batch on
    ``device`` (the caller's, else the GPU; with no GPU and no ``device``
    this raises). Records have the reference's keys, in its order, with
    the same non-float values; floats agree with its ``engine="compiled"``
    within 1e-9 relative.

    ``validate`` gates a static pre-flight over the spec (S1xx rules), its
    base cluster (K1xx rules), a lowered serving spec's source (V1xx), a
    lowered fleet spec's source (F1xx) and a failure model or a fleet's
    enabled failure trace (Y1xx) from :mod:`repro_torch.analysis`:
    ``"warn"`` (default) reports findings as a warning, ``"error"`` raises
    :class:`repro_torch.analysis.AnalysisError` on error-severity findings,
    ``"off"`` skips the pass.  Validation only inspects — records are
    identical across all three modes.

    ``spec`` may also be anything with a ``to_study()`` lowering — a
    :class:`repro_torch.serving.ServingSpec` runs here directly, with the
    V1xx serving rules joining the pre-flight.  Such a study evaluates on
    the host and touches no tensor, but ``device`` resolves all the same.
    A :class:`repro_torch.fleet.FleetSpec` runs the same way with the F1xx
    rules; its width profiles are timed on ``device`` (each cell's
    ``StudyContext.device``) and its event timeline runs on the host.
    ``processes > 1`` raises ``NotImplementedError`` naming its ROADMAP
    item."""
    device = resolve_device(device)
    if not isinstance(spec, StudySpec):
        to_study = getattr(spec, "to_study", None)
        if to_study is None:
            raise TypeError(
                f"run_study wants a StudySpec or an object with "
                f"to_study(); got {type(spec).__name__}")
        spec = to_study()
    if validate not in VALIDATE_MODES:
        raise ValueError(f"validate must be one of {VALIDATE_MODES}, "
                         f"got {validate!r}")
    if processes is not None and processes > 1:
        raise NotImplementedError(PROCESSES_DEFERRED)
    if validate != "off":
        _validate_spec(spec, validate)
    # The memos live here, never in module globals, so an exception
    # anywhere (a raising metric, an infeasible builder) leaves nothing
    # behind that could poison a later run.
    return StudyResult(spec=spec, cells=_run_cells_compiled(
        spec, _cells(spec), {}, {}, device))


# ===================================================================== #
# Results
# ===================================================================== #

@dataclasses.dataclass
class StudyResult:
    """Tidy study output: one record per evaluated cell."""

    spec: StudySpec
    cells: List[CellResult]

    # -- container protocol -------------------------------------------- #
    def __len__(self) -> int:
        return len(self.cells)

    def __iter__(self):
        return iter(self.cells)

    @property
    def records(self) -> List[Dict[str, Any]]:
        return [c.record for c in self.cells]

    # -- selection / reduction ----------------------------------------- #
    def select(self, **where: Any) -> "StudyResult":
        """Cells whose record matches every ``column=value`` filter."""
        kept = [c for c in self.cells
                if all(c.record.get(k) == v for k, v in where.items())]
        return StudyResult(spec=self.spec, cells=kept)

    def column(self, name: str) -> List[Any]:
        return [c.record.get(name) for c in self.cells]

    def best(self, metric: str = "total",
             require_fit_bytes: Optional[float] = None,
             maximize: bool = False) -> CellResult:
        """Cell minimizing ``metric`` (or maximizing it, e.g. for
        ``perf_per_dollar``), optionally capacity-constrained.  Cells whose
        metric is missing or NaN (infeasible-strategy records) are
        skipped."""
        pool = [c for c in self.cells
                if not (c.record.get(metric) is None
                        or (isinstance(c.record.get(metric), float)
                            and math.isnan(c.record[metric])))]
        if require_fit_bytes is not None:
            pool = [c for c in pool
                    if c.record.get("footprint_bytes", 0) <= require_fit_bytes]
        if not pool:
            raise ValueError("no cell satisfies the constraint")
        pick = max if maximize else min
        return pick(pool, key=lambda c: c.record[metric])

    # -- derived columns ------------------------------------------------ #
    def normalize(self, metric: str = "total",
                  value: Optional[float] = None,
                  **where: Any) -> "StudyResult":
        """Add ``<metric>_norm`` = metric / baseline to every record.

        The baseline is ``value`` if given, else the ``metric`` of the
        single cell selected by the ``where`` filters."""
        if value is None:
            base_cells = self.select(**where).cells
            if len(base_cells) != 1:
                raise ValueError(
                    f"normalize baseline filter matched "
                    f"{len(base_cells)} cells, need exactly 1")
            value = base_cells[0].record[metric]
        for c in self.cells:
            c.record[f"{metric}_norm"] = c.record[metric] / value
        return self

    def pareto_front(self, objectives=None) -> "StudyResult":
        """Frontier cells over ``objectives`` (default: the paper's
        time/TCO/energy triple).  Annotates every record with
        ``pareto_rank`` / ``pareto_optimal`` in place — a thin delegate
        to :func:`repro_torch.core.search.pareto_front`."""
        from repro_torch.core import search
        return search.pareto_front(
            self, objectives if objectives is not None
            else search.DEFAULT_OBJECTIVES)

    # -- reshaping / export --------------------------------------------- #
    def pivot(self, index: str, columns: str,
              values: str = "total") -> Dict[Any, Dict[Any, Any]]:
        """records -> nested dict ``out[record[index]][record[columns]]``.

        Raises if (index, columns) does not uniquely identify a cell —
        ``select()`` the result down to a unique slice first."""
        out: Dict[Any, Dict[Any, Any]] = {}
        for c in self.cells:
            r = c.record
            row = out.setdefault(r[index], {})
            if r[columns] in row:
                raise ValueError(
                    f"pivot({index!r}, {columns!r}) is ambiguous: multiple "
                    f"cells at ({r[index]!r}, {r[columns]!r}) — select() a "
                    "unique slice before pivoting")
            row[r[columns]] = r[values]
        return out

    def _columns(self) -> List[str]:
        cols: List[str] = []
        for c in self.cells:
            for k in c.record:
                if k not in cols:
                    cols.append(k)
        return cols

    def to_csv(self, path: Optional[str] = None) -> str:
        buf = io.StringIO()
        cols = self._columns()
        w = csv.DictWriter(buf, fieldnames=cols)
        w.writeheader()
        for c in self.cells:
            w.writerow({k: c.record.get(k, "") for k in cols})
        text = buf.getvalue()
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def to_json(self, path: Optional[str] = None) -> str:
        # inf/nan (infeasible-strategy records) are not valid JSON tokens;
        # serialize them as null so strict RFC 8259 parsers accept the file.
        records = [{k: (None if isinstance(v, float) and not math.isfinite(v)
                        else v) for k, v in r.items()}
                   for r in self.records]
        text = json.dumps({"study": self.spec.name, "records": records},
                          indent=1, default=str)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text
