"""COMET §V case studies as the port's :mod:`repro_torch.core.study` specs.

The port of the JAX package's ``core/dse.py``, held to it record for record
by ``tests/test_torch_study.py`` (the builders) and
``tests/test_torch_paper_claims.py`` (the wrappers): each paper figure is a
``<fig>_study(...) -> StudySpec`` (axes x strategies over one runner) plus
a thin wrapper keeping the seed function's signature and return shape
(``mpdp_sweep``, ``memory_expansion_heatmap``, ``compute_scaling``,
``network_scaling``, ``bandwidth_rebalance``, ``dlrm_cluster_size_sweep``,
``dlrm_memory_expansion``, ``cluster_comparison``). The beyond-paper
studies over mixed fleets (``hetero_cost_study``, ``placement_study``,
``multi_tenant_study``) and the four-axis ``pp_ep_study`` come with their
rankings, and ``pareto_frontier`` searches ``hetero_cost_study``. Beyond
the paper's training studies, ``serving_study`` (prefill/decode
disaggregation on a mixed plain/EM fleet, a
:class:`repro_torch.serving.ServingSpec`) and ``reliability_study`` (the
closed-form Young–Daly columns over two cluster shapes) come with their
rankings and ``reliability_headline``, held to the reference's by
``tests/test_torch_serving.py`` and ``tests/test_torch_reliability.py``.
The fleet studies (``fleet_study``: static vs elastic vs elastic+burst
over a Poisson job trace on the mixed EM/plain fleet;
``reliability_fleet_study``: wait-for-repair vs shrink-to-survive under an
injected failure, both :class:`repro_torch.fleet.FleetSpec`) come with
``fleet_ranking`` / ``fleet_headline`` and ``reliability_fleet_ranking`` /
``reliability_fleet_headline``, held to the reference's by
``tests/test_torch_fleet.py`` and ``tests/test_torch_reliability.py``.
Every wrapper runs on the caller's ``device``, else the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cluster import (
    ClusterConfig,
    ClusterLike,
    ClusterSpec,
    HierarchicalSwitch,
    NodeConfig,
    PodSpec,
    TABLE_III_CLUSTERS,
)
from repro_torch.core.placement import JobSpec
from repro_torch.core.strategy import StrategyResult
from repro_torch.core.study import (
    Axis,
    GridSpace,
    ParallelSpec,
    PowerOfTwoSpace,
    StudyResult,
    StudySpec,
    as_strategy_space,
    placement_axis,
    run_study,
)
from repro_torch.core.workload import decompose_dlrm

GB = 1e9


def _expand_axis(values_gbs: Sequence[float]) -> Axis:
    """EM-bandwidth axis: infinite expanded capacity at the swept bandwidth
    (capacity is sized to whatever the strategy needs — paper Fig. 9)."""
    return Axis("bw_em_gbs", tuple(values_gbs),
                apply=lambda cl, bw: cl.with_node(
                    cl.node.with_expansion(cap=1e15, bw=bw * GB)))

# --------------------------------------------------------------------- #
# §V-B1 / Fig. 8: MP-DP sweep at fixed memory bandwidth
# --------------------------------------------------------------------- #

def mpdp_study(cfg: ModelConfig, shape: ShapeConfig, cluster: ClusterConfig,
               assume_infinite_capacity: bool = True,
               min_mp: int = 1) -> StudySpec:
    return StudySpec(
        name="fig8-mpdp-sweep", model=cfg, shape=shape, cluster=cluster,
        strategies=PowerOfTwoSpace(min_mp=min_mp),
        mem_bw_override="local" if assume_infinite_capacity else None)


def mpdp_sweep(cfg: ModelConfig, shape: ShapeConfig, cluster: ClusterConfig,
               assume_infinite_capacity: bool = True,
               min_mp: int = 1, device=None) -> List[StrategyResult]:
    """Training-time breakdown for each (MP, DP); §V-B1 assumes infinite
    per-node capacity at baseline bandwidth."""
    res = run_study(mpdp_study(cfg, shape, cluster,
                               assume_infinite_capacity, min_mp),
                    device=device)
    return [StrategyResult(c.strategy.mp, c.strategy.dp, c.breakdown,
                           c.footprint.total) for c in res]

# --------------------------------------------------------------------- #
# §V-B2 / Fig. 9: expanded-memory bandwidth heatmap
# --------------------------------------------------------------------- #

def memory_expansion_study(
    cfg: ModelConfig, shape: ShapeConfig, cluster: ClusterConfig,
    em_bandwidths_gbs: Sequence[float] = (100, 250, 500, 750, 1000, 1500, 2000),
    strategies: Optional[Sequence] = None,
) -> StudySpec:
    return StudySpec(
        name="fig9-memory-expansion", model=cfg, shape=shape, cluster=cluster,
        strategies=as_strategy_space(strategies) or PowerOfTwoSpace(),
        axes=[_expand_axis(em_bandwidths_gbs)])


def memory_expansion_heatmap(
    cfg: ModelConfig,
    shape: ShapeConfig,
    cluster: ClusterConfig,
    em_bandwidths_gbs: Sequence[float] = (100, 250, 500, 750, 1000, 1500, 2000),
    strategies: Optional[Sequence[tuple]] = None,
    device=None,
) -> Dict[str, Dict[float, float]]:
    """runtime[strategy_label][bw_EM_GBs], normalized by the caller."""
    res = run_study(memory_expansion_study(cfg, shape, cluster,
                                           em_bandwidths_gbs, strategies),
                    device=device)
    return res.pivot(index="strategy", columns="bw_em_gbs")

# --------------------------------------------------------------------- #
# §V-B3 / Fig. 10: per-node compute-capability scaling
# --------------------------------------------------------------------- #

def compute_scaling_study(
    cfg: ModelConfig, shape: ShapeConfig, cluster: ClusterConfig,
    mp: int, dp: int,
    compute_factors: Sequence[float] = (0.5, 1.0, 2.0, 4.0, 8.0),
    em_bandwidths_gbs: Sequence[float] = (500, 1000, 2000),
) -> StudySpec:
    return StudySpec(
        name="fig10-compute-scaling", model=cfg, shape=shape, cluster=cluster,
        strategies=ParallelSpec(mp=mp, dp=dp),
        axes=[Axis("compute_x", tuple(compute_factors),
                   path="node.peak_flops", mode="scale"),
              _expand_axis(em_bandwidths_gbs)])


def compute_scaling(
    cfg: ModelConfig,
    shape: ShapeConfig,
    cluster: ClusterConfig,
    mp: int,
    dp: int,
    compute_factors: Sequence[float] = (0.5, 1.0, 2.0, 4.0, 8.0),
    em_bandwidths_gbs: Sequence[float] = (500, 1000, 2000),
    device=None,
) -> Dict[float, Dict[float, float]]:
    """runtime[compute_factor][bw_EM_GBs] for a fixed strategy."""
    res = run_study(compute_scaling_study(cfg, shape, cluster, mp, dp,
                                          compute_factors, em_bandwidths_gbs),
                    device=device)
    return res.pivot(index="compute_x", columns="bw_em_gbs")

# --------------------------------------------------------------------- #
# §V-B4 / Fig. 11: intra-/inter-pod bandwidth scaling
# --------------------------------------------------------------------- #

def network_scaling_study(
    cfg: ModelConfig, shape: ShapeConfig, cluster: ClusterConfig,
    mp: int, dp: int,
    intra_factors: Sequence[float] = (0.5, 1.0, 2.0, 4.0),
    inter_factors: Sequence[float] = (0.5, 1.0, 2.0, 4.0),
) -> StudySpec:
    assert isinstance(cluster.topology, HierarchicalSwitch)
    return StudySpec(
        name="fig11-network-scaling", model=cfg, shape=shape, cluster=cluster,
        strategies=ParallelSpec(mp=mp, dp=dp), mem_bw_override="local",
        axes=[Axis("intra_x", tuple(intra_factors),
                   path="topology.intra_bw", mode="scale"),
              Axis("inter_x", tuple(inter_factors),
                   path="topology.inter_bw", mode="scale")])


def network_scaling(
    cfg: ModelConfig,
    shape: ShapeConfig,
    cluster: ClusterConfig,
    mp: int,
    dp: int,
    intra_factors: Sequence[float] = (0.5, 1.0, 2.0, 4.0),
    inter_factors: Sequence[float] = (0.5, 1.0, 2.0, 4.0),
    device=None,
) -> Dict[tuple, float]:
    """runtime[(intra_factor, inter_factor)] at baseline compute/memory."""
    res = run_study(network_scaling_study(cfg, shape, cluster, mp, dp,
                                          intra_factors, inter_factors),
                    device=device)
    return {(c.point["intra_x"], c.point["inter_x"]): c.breakdown.total
            for c in res}

# --------------------------------------------------------------------- #
# §V-B4 / Fig. 12: fixed-aggregate bandwidth re-balancing
# --------------------------------------------------------------------- #

def bandwidth_rebalance_study(
    cfg: ModelConfig, shape: ShapeConfig, cluster: ClusterConfig,
    mp: int, dp: int,
    ratios: Sequence[float] = (1, 2, 3, 4, 5, 6, 7, 8, 9.6, 12, 16),
) -> StudySpec:
    assert isinstance(cluster.topology, HierarchicalSwitch)
    agg = cluster.topology.intra_bw + cluster.topology.inter_bw

    def rebalance(cl: ClusterConfig, r: float) -> ClusterConfig:
        inter = agg / (1 + r)
        return cl.with_topology(dataclasses.replace(
            cl.topology, intra_bw=agg - inter, inter_bw=inter))

    return StudySpec(
        name="fig12-bandwidth-rebalance", model=cfg, shape=shape,
        cluster=cluster, strategies=ParallelSpec(mp=mp, dp=dp),
        mem_bw_override="local",
        axes=[Axis("ratio", tuple(ratios), apply=rebalance)])


def bandwidth_rebalance(
    cfg: ModelConfig,
    shape: ShapeConfig,
    cluster: ClusterConfig,
    mp: int,
    dp: int,
    ratios: Sequence[float] = (1, 2, 3, 4, 5, 6, 7, 8, 9.6, 12, 16),
    device=None,
) -> Dict[float, float]:
    """runtime[inter:intra ratio 1:r] with intra+inter = aggregate constant.

    Baseline DGX: 300 + 31.25 = 331.25 GB/s aggregate; ratio 1:9.6."""
    res = run_study(bandwidth_rebalance_study(cfg, shape, cluster, mp, dp,
                                              ratios), device=device)
    return {c.point["ratio"]: c.breakdown.total for c in res}

# --------------------------------------------------------------------- #
# §V-C / Fig. 13: DLRM cluster-size sweep + memory-expansion study
# --------------------------------------------------------------------- #

def dlrm_cluster_size_study(dlrm_cfg, cluster: ClusterConfig,
                            global_batch: int = 4096,
                            node_counts: Sequence[int] = (64, 32, 16, 8),
                            ) -> StudySpec:
    from repro_torch.core.memory import per_node_footprint
    base = cluster
    return StudySpec(
        name="fig13a-dlrm-cluster-size", cluster=cluster,
        axes=[Axis("nodes", tuple(node_counts),
                   apply=lambda cl, n: dataclasses.replace(cl, num_nodes=n)
                   .with_node(base.node.with_expansion(
                       cap=1e15, bw=base.node.local_bw)))],
        workload=lambda ctx: decompose_dlrm(dlrm_cfg, global_batch,
                                            ctx.point["nodes"]),
        workload_deps=("nodes",),
        metrics={"footprint_gb":
                 lambda ctx: per_node_footprint(ctx.workload,
                                                base.node).total / GB})


def dlrm_cluster_size_sweep(
    dlrm_cfg,
    cluster: ClusterConfig,
    global_batch: int = 4096,
    node_counts: Sequence[int] = (64, 32, 16, 8),
    device=None,
) -> Dict[int, dict]:
    """Single-instance DLRM training breakdown vs cluster size (Fig. 13a)."""
    res = run_study(dlrm_cluster_size_study(dlrm_cfg, cluster, global_batch,
                                            node_counts), device=device)
    return {c.point["nodes"]: {**c.breakdown.as_dict(),
                               "footprint_gb": c.record["footprint_gb"]}
            for c in res}


def dlrm_memory_expansion_study(
    dlrm_cfg, cluster: ClusterConfig, global_batch: int = 4096,
    total_nodes: int = 64, num_instances: int = 8,
    em_bandwidths_gbs: Sequence[float] = (250, 500, 800, 1000, 1500, 2000),
    nodes_per_instance_opts: Sequence[int] = (64, 32, 16, 8),
) -> StudySpec:
    """N concurrent DLRM instances on a ``total_nodes`` fleet: the waves /
    turnaround bookkeeping is the study-native :class:`JobSpec` layer (the
    engine schedules instances over the fleet's node groups and writes the
    ``turnaround``/``waves`` columns the legacy lambdas used to compute)."""
    fleet = dataclasses.replace(cluster, num_nodes=total_nodes)
    return StudySpec(
        name="fig13b-dlrm-memory-expansion", cluster=fleet,
        axes=[Axis("nodes_per_inst", tuple(nodes_per_instance_opts)),
              _expand_axis(em_bandwidths_gbs)],
        workload=lambda ctx: decompose_dlrm(dlrm_cfg, global_batch,
                                            ctx.point["nodes_per_inst"]),
        workload_deps=("nodes_per_inst",),
        job=lambda ctx: JobSpec(
            instances=num_instances,
            nodes_per_instance=ctx.point["nodes_per_inst"]))


def dlrm_memory_expansion(
    dlrm_cfg,
    cluster: ClusterConfig,
    global_batch: int = 4096,
    total_nodes: int = 64,
    num_instances: int = 8,
    em_bandwidths_gbs: Sequence[float] = (250, 500, 800, 1000, 1500, 2000),
    nodes_per_instance_opts: Sequence[int] = (64, 32, 16, 8),
    device=None,
) -> Dict[int, Dict[float, float]]:
    """Fig. 13b: turnaround of ``num_instances`` DLRMs on 64 nodes.

    Using fewer nodes per instance needs expanded memory but runs
    ceil(64/n) instances concurrently: turnaround = iter_time * n_waves."""
    res = run_study(dlrm_memory_expansion_study(
        dlrm_cfg, cluster, global_batch, total_nodes, num_instances,
        em_bandwidths_gbs, nodes_per_instance_opts), device=device)
    return res.pivot(index="nodes_per_inst", columns="bw_em_gbs",
                     values="turnaround")

# --------------------------------------------------------------------- #
# Beyond Fig. 13: heterogeneous pod mix ranked by perf-per-dollar
# --------------------------------------------------------------------- #

def _em_pod_mix(plain: str = "B0", expanded: str = "B1"):
    """``apply(cluster, frac) -> ClusterSpec`` mixing the ``plain``
    cluster's pods with the ``expanded`` cluster's memory-expanded pods
    (same interconnect / pod size / fleet size), priced by the expanded
    cluster's cost model so the EM pods carry their $/GB premium."""
    base, em = TABLE_III_CLUSTERS[plain], TABLE_III_CLUSTERS[expanded]
    pod = base.topology.pod_size
    num_pods = base.num_nodes // pod

    def mix(_, frac: float) -> ClusterSpec:
        if not 0.0 <= frac <= 1.0:
            raise ValueError(f"em_pod_frac must be in [0, 1], got {frac}")
        n_em = int(round(frac * num_pods))
        pods = tuple(
            p for p in (PodSpec(base.node, count=num_pods - n_em,
                                nodes_per_pod=pod),
                        PodSpec(em.node, count=n_em, nodes_per_pod=pod))
            if p.count > 0)
        return ClusterSpec(
            name=f"{plain}+{expanded}-em{n_em}of{num_pods}",
            pods=pods, interconnect=base.topology, cost=em.cost,
            notes=f"{num_pods - n_em} plain + {n_em} memory-expanded pods.")

    return mix


def hetero_cost_study(
    cfg: ModelConfig, shape: ShapeConfig,
    em_pod_fractions: Sequence[float] = (0.0, 0.25, 0.5, 1.0),
    plain: str = "B0", expanded: str = "B1",
    strategies=None,
) -> StudySpec:
    """Fig.-8-style sweep over clusters mixing plain and memory-expanded
    pods, with ``cost_usd``/``tco``/``perf_per_dollar`` columns.

    Each ``em_pod_frac`` value builds a :class:`ClusterSpec` whose pods mix
    the ``plain`` cluster's node with the ``expanded`` cluster's node (same
    interconnect and pod size).  Synchronous-training semantics apply: a
    strategy is feasible only if its shard fits the *plain* pods too, so
    the ranking quantifies when partial EM deployment is money wasted and
    when full EM wins perf-per-dollar (Fig. 15's B0-vs-B1 story)."""
    mix = _em_pod_mix(plain, expanded)
    return StudySpec(
        name="hetero-em-tco", model=cfg, shape=shape,
        strategies=as_strategy_space(strategies) or PowerOfTwoSpace(min_mp=8),
        axes=[Axis("em_pod_frac", tuple(em_pod_fractions), apply=mix)])


def hetero_cost_ranking(cfg: ModelConfig, shape: ShapeConfig,
                        processes: Optional[int] = None,
                        device=None,
                        **kwargs) -> List[Dict[str, float]]:
    """Feasible (em_pod_frac, strategy) cells, best perf-per-dollar first."""
    res: StudyResult = run_study(hetero_cost_study(cfg, shape, **kwargs),
                                 processes=processes, device=device)
    feasible = [c.record for c in res if c.record["feasible"]]
    return sorted(feasible, key=lambda r: r["perf_per_dollar"], reverse=True)


def pareto_frontier(cfg: Optional[ModelConfig] = None,
                    shape: Optional[ShapeConfig] = None,
                    objectives=None,
                    processes: Optional[int] = None,
                    device=None,
                    **kwargs) -> List[Dict[str, float]]:
    """Demo search study: the (time, TCO, energy) Pareto frontier of the
    mixed plain/EM fleet design space (``hetero_cost_study``).

    A single perf-per-dollar scalar hides the trade surface; the frontier
    keeps every fleet fraction x strategy cell no other cell beats on all
    three axes at once — typically the all-plain fleet (cheap, slow), the
    all-EM fleet (fast, expensive) and the EM-aware mixes between them.
    Every record is annotated with ``pareto_rank`` / ``pareto_optimal``
    (:mod:`repro_torch.core.search`); returns the frontier records,
    fastest first."""
    from repro_torch.core.search import DEFAULT_OBJECTIVES, pareto_front
    cfg = cfg or _default_transformer()
    shape = shape or ShapeConfig("pareto", 2048, 1024, "train")
    res = run_study(hetero_cost_study(cfg, shape, **kwargs),
                    processes=processes, device=device)
    front = pareto_front(res, objectives if objectives is not None
                         else DEFAULT_OBJECTIVES)
    return sorted((c.record for c in front),
                  key=lambda r: r["total"])

# --------------------------------------------------------------------- #
# Beyond Fig. 8: the full MP x DP x PP x EP joint sweep
# --------------------------------------------------------------------- #

def pp_ep_study(
    cfg: Optional[ModelConfig] = None,
    shape: Optional[ShapeConfig] = None,
    clusters: Sequence[str] = ("A0", "B1"),
    mp: Sequence[int] = (4, 8, 16, 32, 64),
    dp: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128, 256),
    pp: Sequence[int] = (1, 2, 4),
    ep: Sequence[int] = (1, 2),
    num_microbatches: Sequence[int] = (0,),
) -> StudySpec:
    """MoE transformer over the four-axis MP x DP x PP x EP product on the
    registry clusters (default: bandwidth-starved A0 vs memory-expanded B1).

    Every cell runs the default workload builder — PP stages with their
    p2p boundary transfers and microbatch bubble, EP expert sharding with
    all-to-all dispatch/combine — so the ranking shows where pipeline or
    expert degrees beat the paper's pure MP x DP slice."""
    from repro_torch.configs import get_config
    from repro_torch.core.cluster import get_cluster

    cfg = cfg or get_config("llama4-maverick-400b-a17b")
    shape = shape or ShapeConfig("pp_ep", 4096, 256, "train")
    names = tuple(clusters)
    return StudySpec(
        name="pp-ep-four-axis", model=cfg, shape=shape,
        axes=[Axis("cluster", names,
                   apply=lambda _, name: get_cluster(name))],
        strategies=GridSpace(mp=tuple(mp), dp=tuple(dp), pp=tuple(pp),
                             ep=tuple(ep),
                             num_microbatches=tuple(num_microbatches)))


def pp_ep_ranking(processes: Optional[int] = None,
                  device=None,
                  **kwargs) -> List[Dict[str, float]]:
    """Feasible four-axis cells, fastest first (per-cluster ranking is a
    ``select(cluster=...)`` away)."""
    res = run_study(pp_ep_study(**kwargs), processes=processes,
                    device=device)
    feasible = [c.record for c in res if c.record["feasible"]]
    return sorted(feasible, key=lambda r: r["total"])

# --------------------------------------------------------------------- #
# §V-D / Fig. 15: comparative training across 11 clusters
# --------------------------------------------------------------------- #

def _dlrm_group_nodes_per_instance(node: NodeConfig, fleet_nodes: int) -> int:
    """Paper §V-D placement rule for one node type:
    mem0 -> 64, mem1 -> 16, mem2 -> 8."""
    if node.exp_cap > 0.75 * node.local_cap:
        return 16 if node.exp_bw <= 500 * GB else 8
    return min(64, fleet_nodes)


def _dlrm_nodes_per_instance(cl: ClusterLike) -> int:
    """§V-D rule routed through ``node_groups`` so heterogeneous
    ``ClusterSpec`` inputs work (``cl.node`` raises on >1 node types):
    the largest group's node type sizes the instance."""
    g = max(cl.node_groups, key=lambda g: g.num_nodes)
    return _dlrm_group_nodes_per_instance(g.node, cl.num_nodes)


def cluster_comparison_studies(
    transformer_cfg: ModelConfig, transformer_shape: ShapeConfig,
    dlrm_cfg, dlrm_batch: int = 4096,
    clusters: Optional[Dict[str, ClusterLike]] = None,
):
    """(transformer study, dlrm study) over a cluster-valued axis."""
    clusters = clusters or TABLE_III_CLUSTERS
    # Workload depends only on the strategy, so decompositions are shared
    # across same-size clusters (workload_deps stays empty).
    transformer = StudySpec(
        name="fig15-transformer", model=transformer_cfg,
        shape=transformer_shape,
        axes=[Axis("cluster", tuple(clusters),
                   apply=lambda _, name: clusters[name])],
        strategies=PowerOfTwoSpace())

    # 8 DLRM instances on (at most) 64 fleet nodes: the waves/turnaround
    # bookkeeping is the study-native JobSpec layer now.
    dlrm = StudySpec(
        name="fig15-dlrm",
        axes=[Axis("cluster", tuple(clusters),
                   apply=lambda _, name: clusters[name])],
        workload=lambda ctx: decompose_dlrm(
            dlrm_cfg, dlrm_batch,
            _dlrm_nodes_per_instance(clusters[ctx.point["cluster"]])),
        workload_deps=("cluster",),
        job=lambda ctx: JobSpec(
            instances=8, max_nodes=64,
            nodes_per_instance=_dlrm_nodes_per_instance(ctx.cluster)))
    return transformer, dlrm


def cluster_comparison(
    transformer_cfg: ModelConfig,
    transformer_shape: ShapeConfig,
    dlrm_cfg,
    dlrm_batch: int = 4096,
    clusters: Optional[Dict[str, ClusterLike]] = None,
    processes: Optional[int] = None,
    device=None,
) -> Dict[str, Dict[str, float]]:
    """runtime[cluster][workload] for Transformer-1T + 8 DLRM instances.

    Transformer: best feasible (MP, DP) per cluster (capacity-constrained;
    heterogeneous specs gate on the least-capable group).
    DLRM: nodes-per-instance per the paper (mem0: 64, mem1: 16, mem2: 8)."""
    clusters = clusters or TABLE_III_CLUSTERS
    t_study, d_study = cluster_comparison_studies(
        transformer_cfg, transformer_shape, dlrm_cfg, dlrm_batch, clusters)
    t_res = run_study(t_study, processes=processes, device=device)
    d_res = run_study(d_study, processes=processes, device=device)
    out: Dict[str, Dict[str, float]] = {}
    for name, cl in clusters.items():
        per = t_res.select(cluster=name)
        fit = [c for c in per
               if c.record["footprint_bytes"] <= cl.min_node_cap
               and c.breakdown.feasible]
        out[name] = {
            "transformer-1t": (min(c.record["total"] for c in fit) if fit
                               else float("inf")),
            "dlrm": d_res.select(cluster=name).cells[0].record["turnaround"],
        }
    return out

# --------------------------------------------------------------------- #
# Placement as a swept study axis; multi-tenant scheduling
# --------------------------------------------------------------------- #

PLACEMENT_SHAPE = ShapeConfig("placement", 4096, 2048, "train")


def placement_study(
    cfg: Optional[ModelConfig] = None,
    shape: Optional[ShapeConfig] = None,
    em_pod_fractions: Sequence[float] = (0.0, 0.25, 0.5, 1.0),
    plain: str = "B0", expanded: str = "B1",
    strategies=None,
    placements: Sequence[str] = ("paper", "em-aware"),
) -> StudySpec:
    """Transformer-1T pipeline-stage placement over (EM-pod fraction) x
    (placement) x pipeline strategies.

    The placement lever exists only for ``pp > 1`` — a flat job has one
    stage and nothing to place (``hetero_cost_study`` covers that slice:
    all-or-nothing EM) — so the default strategy grid sweeps the pipeline
    cells.  Under the default ``PaperPlacement`` every pod group must
    hold every stage, so a partial-EM fleet is gated by its plain pods
    and the EM money is wasted.  ``EMAwarePlacement``
    assigns the memory-hungry stages to the EM pods (1F1B stashes
    ``pp - s`` microbatches at stage ``s``, so early stages are the fat
    ones): a half-EM fleet then runs ZeRO-heavy low-MP pipelines the
    plain fleet cannot fit at nearly the all-EM iteration time but well
    below the all-EM TCO — and tops ``perf_per_dollar`` over both
    all-plain and all-EM."""
    cfg = cfg or _default_transformer()
    shape = shape or PLACEMENT_SHAPE
    strategies = as_strategy_space(strategies) or GridSpace(
        mp=(4, 8, 16, 32), dp=(4, 8, 16, 32, 64, 128), pp=(2, 4, 8))
    return StudySpec(
        name="placement-em-aware", model=cfg, shape=shape,
        strategies=strategies,
        axes=[Axis("em_pod_frac", tuple(em_pod_fractions),
                   apply=_em_pod_mix(plain, expanded)),
              placement_axis(tuple(placements))])


def placement_ranking(processes: Optional[int] = None,
                      device=None,
                      **kwargs) -> List[Dict[str, float]]:
    """Feasible (em_pod_frac, placement, strategy) cells, best
    perf-per-dollar first."""
    res = run_study(placement_study(**kwargs), processes=processes,
                    device=device)
    feasible = [c.record for c in res if c.record["feasible"]]
    return sorted(feasible, key=lambda r: r["perf_per_dollar"],
                  reverse=True)


def _default_transformer() -> ModelConfig:
    from repro_torch.configs import get_config
    return get_config("transformer-1t")


def mixed_dlrm_fleet(plain: str = "B0", expanded: str = "B1",
                     pods_each: int = 2) -> ClusterSpec:
    """A small two-type fleet for multi-tenant studies: ``pods_each``
    plain pods + ``pods_each`` memory-expanded pods (16-node Table III
    pods; the default is the Fig. 13b 64-node fleet, half-expanded)."""
    base, em = TABLE_III_CLUSTERS[plain], TABLE_III_CLUSTERS[expanded]
    pod = base.topology.pod_size
    return ClusterSpec(
        name=f"{plain}+{expanded}-fleet",
        pods=(PodSpec(base.node, count=pods_each, nodes_per_pod=pod),
              PodSpec(em.node, count=pods_each, nodes_per_pod=pod)),
        interconnect=base.topology, cost=em.cost,
        notes=f"{pods_each} plain + {pods_each} EM pods x {pod} nodes.")


def multi_tenant_study(
    dlrm_cfg=None,
    fleet: Optional[ClusterLike] = None,
    global_batch: int = 4096,
    num_instances: int = 8,
    nodes_per_instance_opts: Sequence[int] = (64, 32, 16, 8),
    placements: Sequence[str] = ("paper", "em-aware"),
) -> StudySpec:
    """Fig. 13b generalized: N DLRM instances on a (possibly mixed) fleet.

    Each cell sweeps the per-instance node count and the placement; the
    engine's JobSpec/ScheduleModel layer places the instances over the
    fleet's pod groups and emits native ``concurrent_instances`` /
    ``waves`` / ``turnaround`` / ``makespan`` columns.  On the default
    half-EM fleet, small (memory-hungry) instances only fit the EM pods:
    ``EMAwarePlacement`` schedules them there (more waves, but feasible),
    while the paper placement spreads them fleet-wide and reports the
    cell infeasible — the §V-C turnaround story, now placement-aware."""
    if dlrm_cfg is None:
        from repro_torch.configs import get_dlrm_config
        dlrm_cfg = get_dlrm_config()
    fleet = fleet if fleet is not None else mixed_dlrm_fleet()
    return StudySpec(
        name="multi-tenant-dlrm", cluster=fleet,
        axes=[Axis("nodes_per_inst", tuple(nodes_per_instance_opts)),
              placement_axis(tuple(placements))],
        workload=lambda ctx: decompose_dlrm(dlrm_cfg, global_batch,
                                            ctx.point["nodes_per_inst"]),
        workload_deps=("nodes_per_inst",),
        job=lambda ctx: JobSpec(
            instances=num_instances,
            nodes_per_instance=ctx.point["nodes_per_inst"]))


def multi_tenant_ranking(processes: Optional[int] = None,
                         device=None,
                         **kwargs) -> List[Dict[str, float]]:
    """Feasible (nodes_per_inst, placement) cells, best turnaround first."""
    res = run_study(multi_tenant_study(**kwargs), processes=processes,
                    device=device)
    feasible = [c.record for c in res if c.record["feasible"]]
    return sorted(feasible, key=lambda r: r["turnaround"])


# --------------------------------------------------------------------- #
# Beyond the paper's training studies: serving-fleet DSE.
# Prefill/decode rooflines + an SLO-gated traffic simulation decide when
# disaggregating the two phases onto separate pods beats colocated
# replicas on goodput-per-dollar.
# --------------------------------------------------------------------- #

def _serving_pod_mix(plain: str = "B0", expanded: str = "B1",
                     num_pods: int = 4):
    """``apply(cluster, frac) -> ClusterSpec`` building a small serving
    fleet: ``num_pods`` Table III pods, ``frac`` of them memory-expanded
    (same interconnect; priced by the expanded cluster's cost model)."""
    base, em = TABLE_III_CLUSTERS[plain], TABLE_III_CLUSTERS[expanded]
    pod = base.topology.pod_size

    def mix(_, frac: float) -> ClusterSpec:
        if not 0.0 <= frac <= 1.0:
            raise ValueError(f"em_pod_frac must be in [0, 1], got {frac}")
        n_em = int(round(frac * num_pods))
        pods = tuple(
            p for p in (PodSpec(base.node, count=num_pods - n_em,
                                nodes_per_pod=pod),
                        PodSpec(em.node, count=n_em, nodes_per_pod=pod))
            if p.count > 0)
        return ClusterSpec(
            name=f"serve-{plain}+{expanded}-em{n_em}of{num_pods}",
            pods=pods, interconnect=base.topology, cost=em.cost,
            notes=f"serving fleet: {num_pods - n_em} plain + {n_em} EM "
                  f"pods x {pod} nodes.")

    return mix


def serving_study(
    cfg: Optional[ModelConfig] = None,
    em_pod_fractions: Sequence[float] = (0.0, 0.25, 0.5),
    rates: Sequence[float] = (120.0, 280.0, 440.0),
    placements: Sequence[str] = ("colocated", "disaggregated"),
    num_requests: int = 3000,
    plain: str = "B0", expanded: str = "B1", num_pods: int = 4,
):
    """Serving DSE over an ``em_pod_frac x rate x placement`` grid.

    Each cell builds a mixed plain/EM fleet, prices one replica's
    prefill and decode phases on the roofline, then pushes a Poisson
    trace through the fleet queue to get SLO-gated ``goodput`` (and
    ``goodput_per_dollar`` via the fleet's TCO).  Colocated replicas
    stall their whole batch for every admission's prefill (the
    ``repro_torch.serve.engine`` semantics), so past a traffic knee their
    TPOT blows through the SLO; disaggregated fleets keep decode pods
    at pure-decode cadence at the price of dedicating pods (and a KV
    hand-off per request) to prefill.  Returns a
    :class:`repro_torch.serving.ServingSpec` — pass it straight to
    :func:`run_study`."""
    from repro_torch.configs import get_config
    from repro_torch.serving import (ServingModel, ServingSpec, SLOSpec,
                                     TrafficTrace, serving_placement_axis)
    cfg = cfg or get_config("internlm2-20b")
    mix = _serving_pod_mix(plain, expanded, num_pods)
    return ServingSpec(
        name="serving-disagg-dse", model=cfg,
        serving=ServingModel(max_batch=32, max_seq=8192,
                             prompt_len=1024, max_new_tokens=64),
        trace=TrafficTrace(kind="poisson", rate=float(rates[0]),
                           num_requests=num_requests),
        slo=SLOSpec(ttft=1.0, tpot=0.035),
        axes=[Axis("em_pod_frac", tuple(em_pod_fractions), apply=mix),
              Axis("rate", tuple(float(r) for r in rates),
                   path="trace.rate"),
              serving_placement_axis(tuple(placements))])


def serving_ranking(processes: Optional[int] = None,
                    device=None,
                    **kwargs) -> List[Dict[str, float]]:
    """Feasible (em_pod_frac, rate, placement) cells, best
    goodput-per-dollar first."""
    res: StudyResult = run_study(serving_study(**kwargs),
                                 processes=processes, device=device)
    feasible = [c.record for c in res if c.record["feasible"]]
    return sorted(feasible, key=lambda r: r["goodput_per_dollar"],
                  reverse=True)

# --------------------------------------------------------------------- #
# Beyond the paper's static allocation: elastic-fleet DSE.
# A discrete-event timeline over the mixed EM/plain fleet decides when
# priority preemption + elastic DP resize + burst parallelism beat the
# static ScheduleModel allocation on turnaround and perf-per-dollar.
# --------------------------------------------------------------------- #

def _fleet_job_mix(num_iters_scale: float = 1.0):
    """The mixed-tenant template tuple ``fleet_study`` stamps arrivals
    onto: a DLRM batch job pinned (by memory) to the EM pods, elastic
    chat fine-tunes, a wide tenant, and a high-priority burst job."""
    from repro_torch.fleet import FleetJobSpec

    def n(iters: int) -> int:
        return max(1, int(round(iters * num_iters_scale)))

    return (
        FleetJobSpec(name="dlrm-batch", model="dlrm", global_batch=4096,
                     nodes_per_instance=16, widths=(16, 32),
                     iterations=n(120_000), priority=0),
        FleetJobSpec(name="chat-ft", model="chatglm3-6b", mp=2,
                     global_batch=256, nodes_per_instance=8,
                     widths=(8, 16, 32), iterations=n(60), priority=0),
        FleetJobSpec(name="tenant", model="internlm2-20b", mp=4,
                     global_batch=512, nodes_per_instance=16,
                     widths=(16, 32), iterations=n(12), priority=1),
        FleetJobSpec(name="burst", model="internlm2-20b", mp=4,
                     global_batch=256, nodes_per_instance=8,
                     widths=(8, 32), iterations=n(24), burst_iters=n(20),
                     priority=2, preemptible=False),
    )


def fleet_study(
    fleet: Optional[ClusterLike] = None,
    policies: Sequence[str] = ("static", "elastic", "elastic+burst"),
    rate: float = 1 / 600.0,
    num_jobs: int = 12,
    seed: int = 0,
    num_iters_scale: float = 1.0,
    placement: str = "em-aware",
):
    """Elastic-fleet DSE: a mixed job trace replayed under each fleet
    policy on the half-EM Fig. 13b fleet.

    Each cell materializes a Poisson arrival trace over the
    ``_fleet_job_mix`` templates, prices every (job, width) with the
    port's compiled evaluator on ``run_study``'s device, and replays the
    timeline under the cell's ``fleet.policy``.  Static cells hold the
    ``ScheduleModel`` allocation for a job's whole life; elastic cells
    grow/shrink DP width (priced as checkpoint + reshard via
    ``remesh_delay``) and preempt by priority; ``elastic+burst``
    additionally lends the fleet to the high-priority burst job for its
    bounded window.  Returns a :class:`repro_torch.fleet.FleetSpec` — pass
    it straight to :func:`run_study`."""
    from repro_torch.fleet import FleetSpec, FleetTrace
    return FleetSpec(
        name="fleet-elastic-dse",
        jobs=_fleet_job_mix(num_iters_scale),
        cluster=fleet if fleet is not None else mixed_dlrm_fleet(),
        ftrace=FleetTrace(kind="poisson", rate=rate, num_jobs=num_jobs,
                          seed=seed),
        placement=placement,
        axes=[Axis("policy", tuple(policies), path="fleet.policy")])


def fleet_ranking(processes: Optional[int] = None,
                  device=None,
                  **kwargs) -> List[Dict[str, float]]:
    """Feasible policy cells, best turnaround-p99 first.  The headline
    claim — elastic+burst beats the static ScheduleModel allocation by
    >= 1.3x on turnaround-p99 or perf-per-dollar — reads straight off
    this table (see ``fleet_headline``)."""
    res: StudyResult = run_study(fleet_study(**kwargs),
                                 processes=processes, device=device)
    feasible = [c.record for c in res if c.record["feasible"]]
    return sorted(feasible, key=lambda r: r["turnaround_p99"])


def fleet_headline(records: Sequence[Dict[str, float]]
                   ) -> Dict[str, float]:
    """The elastic+burst-vs-static win ratios from a ``fleet_ranking``
    table: ``{"turnaround_p99_ratio", "perf_per_dollar_ratio"}``
    (both >1 means the timeline policies beat the static allocation)."""
    by_policy = {r["policy"]: r for r in records}
    static, eb = by_policy["static"], by_policy["elastic+burst"]
    return {
        "turnaround_p99_ratio":
            static["turnaround_p99"] / eb["turnaround_p99"],
        "perf_per_dollar_ratio":
            eb["perf_per_dollar"] / static["perf_per_dollar"],
    }


# --------------------------------------------------------------------- #
# Failure-aware DSE in closed form: Young–Daly goodput columns over a
# cluster-shape axis engineered so the §V-D perf-per-dollar ranking flips
# once failures are priced in (goodput_per_dollar).
# --------------------------------------------------------------------- #

def _reliability_clusters() -> Dict[str, ClusterConfig]:
    """Two same-aggregate-compute cluster shapes: many cheap half-speed
    nodes vs a quarter as many double-speed ones.  Failure-free, the
    many-weak shape wins perf-per-dollar (cheaper capex per FLOP); at
    finite MTBF its 4x node count quadruples the job-level failure rate
    and the few-strong shape wins goodput-per-dollar — the ranking-flip
    headline."""
    from repro_torch.core.cluster import BASELINE_DGX_A100
    base = BASELINE_DGX_A100
    assert base.cost is not None
    weak = base.node.scaled_compute(0.5).with_expansion(
        cap=1e15, bw=1000 * GB)
    strong = base.node.scaled_compute(2.0).with_expansion(
        cap=1e15, bw=1000 * GB)
    many = dataclasses.replace(
        base, name="many-weak", num_nodes=2048, node=weak,
        cost=dataclasses.replace(base.cost, usd_per_node=7_500))
    few = dataclasses.replace(
        base, name="few-strong", num_nodes=512, node=strong,
        cost=dataclasses.replace(base.cost, usd_per_node=29_000))
    return {"many-weak": many, "few-strong": few}


RELIABILITY_SHAPE = ShapeConfig("reliability", 2048, 1024, "train")


def reliability_study(
    cfg: Optional[ModelConfig] = None,
    shape: Optional[ShapeConfig] = None,
    clusters: Optional[Dict[str, ClusterLike]] = None,
    mtbf_hours: Sequence[float] = (float("inf"), 10_000.0),
    intervals: Sequence[float] = (0.0, 120.0),
    mttr_hours: float = 2.0,
    ckpt_bw: float = 400e9,
    run_hours: float = 168.0,
) -> StudySpec:
    """Transformer-1T failure-aware cluster DSE (closed form).

    Sweeps (cluster shape) x (per-node MTBF, inf = failure-free) x
    (checkpoint cadence: 0 = the Young–Daly optimum, else a naive fixed
    interval) with each shape's fill-the-cluster strategy, and attaches
    the ``ckpt_interval_s / ckpt_overhead_frac / expected_restarts /
    goodput_frac / goodput_per_dollar`` columns through
    ``StudySpec.reliability``.  ``reliability_headline`` reads the two
    claims off the result: the Daly interval beats the naive cadence on
    goodput, and the perf-per-dollar ranking flips once failures are
    priced in."""
    from repro_torch.reliability import FailureModel
    cfg = cfg or _default_transformer()
    shape = shape or RELIABILITY_SHAPE
    cl = dict(clusters) if clusters is not None else _reliability_clusters()
    return StudySpec(
        name="reliability-goodput-dse", model=cfg, shape=shape,
        strategies=GridSpace(mp=(8,), dp=(64, 256)),
        axes=[Axis("cluster", tuple(cl), apply=lambda _, n: cl[n]),
              Axis("mtbf_hours", tuple(mtbf_hours),
                   path="reliability.mtbf_hours"),
              Axis("ckpt_interval", tuple(intervals),
                   path="reliability.interval_s")],
        reliability=FailureModel(mtbf_hours=50_000.0,
                                 mttr_hours=mttr_hours, ckpt_bw=ckpt_bw,
                                 run_hours=run_hours))


def reliability_ranking(processes: Optional[int] = None,
                        device=None,
                        **kwargs) -> List[Dict[str, float]]:
    """Feasible (cluster, mtbf, cadence) cells, best failure-aware
    goodput-per-dollar first."""
    res = run_study(reliability_study(**kwargs), processes=processes,
                    device=device)
    feasible = [c.record for c in res if c.record["feasible"]]
    return sorted(feasible, key=lambda r: r["goodput_per_dollar"],
                  reverse=True)


def reliability_headline(records: Sequence[Dict[str, float]]
                         ) -> Dict[str, object]:
    """The two closed-form claims from a ``reliability_ranking`` table:
    ``daly_vs_naive`` (>= 1: the Young–Daly cadence never loses goodput
    to the naive fixed one) and ``ranking_flips`` (the failure-free
    perf-per-dollar winner is not the failure-aware goodput-per-dollar
    winner)."""
    import math
    fin = [r for r in records if math.isfinite(r["mtbf_hours"])]
    free = [r for r in records if math.isinf(r["mtbf_hours"])]
    best_aware = max(fin, key=lambda r: r["goodput_per_dollar"])
    best_free = max(free, key=lambda r: r["perf_per_dollar"])
    same = [r for r in fin if r["cluster"] == best_aware["cluster"]]
    daly = max(r["goodput_frac"] for r in same if r["ckpt_interval"] == 0.0)
    naive = max(r["goodput_frac"] for r in same if r["ckpt_interval"] > 0.0)
    return {
        "daly_goodput": daly,
        "naive_goodput": naive,
        "daly_vs_naive": daly / naive,
        "best_failure_free": best_free["cluster"],
        "best_failure_aware": best_aware["cluster"],
        "ranking_flips": best_free["cluster"] != best_aware["cluster"],
    }


def _reliability_pod(kind: str = "B1") -> ClusterSpec:
    """A single 16-node Table III pod: with only one group, a killed
    wide instance cannot relocate — wait-for-repair genuinely waits."""
    base = TABLE_III_CLUSTERS[kind]
    pod = base.topology.pod_size
    return ClusterSpec(
        name=f"{kind}-pod",
        pods=(PodSpec(base.node, count=1, nodes_per_pod=pod),),
        interconnect=base.topology, cost=base.cost,
        notes=f"One {kind} pod x {pod} nodes for fault-injection studies.")


def _reliability_fleet_mix(num_iters_scale: float = 1.0):
    """Two elastic trainers whose width menu reaches below the base
    width — the lever shrink-to-survive pulls when a failure leaves
    fewer than base-width nodes up."""
    from repro_torch.fleet import FleetJobSpec

    def n(iters: int) -> int:
        return max(1, int(round(iters * num_iters_scale)))

    return (
        FleetJobSpec(name="pretrain", model="chatglm3-6b", mp=2,
                     global_batch=256, nodes_per_instance=8,
                     widths=(2, 8), iterations=n(40), priority=0),
        FleetJobSpec(name="finetune", model="chatglm3-6b", mp=2,
                     global_batch=256, nodes_per_instance=8,
                     widths=(2, 8), iterations=n(40), arrival=10.0,
                     priority=0),
    )


def reliability_fleet_study(
    fleet: Optional[ClusterLike] = None,
    policies: Sequence[str] = ("wait", "shrink"),
    fail_time: float = 300.0,
    fail_nodes: int = 12,
    repair_s: float = 30_000.0,
    ckpt_interval_s: float = 120.0,
    num_iters_scale: float = 1.0,
    placement: str = "em-aware",
):
    """Fault injection in the fleet timeline: an explicit failure downs
    ``fail_nodes`` of a single 16-node pod mid-run with a long repair,
    and the ``fleet.degradation`` axis replays the same timeline under
    wait-for-repair vs shrink-to-survive.  With one group there is
    nowhere to relocate: the wait cells stall until the repair; the
    shrink cells restart narrow on what is left —
    ``reliability_fleet_headline`` reads the turnaround-p99 win off the
    table.  Returns a :class:`repro_torch.fleet.FleetSpec`."""
    from repro_torch.fleet import FleetModel, FleetSpec, FleetTrace
    from repro_torch.reliability import FailureEvent, FailureTrace
    return FleetSpec(
        name="fleet-reliability-dse",
        jobs=_reliability_fleet_mix(num_iters_scale),
        cluster=fleet if fleet is not None else _reliability_pod(),
        fleet=FleetModel(policy="elastic",
                         ckpt_interval_s=ckpt_interval_s),
        ftrace=FleetTrace(kind="static"),
        failures=FailureTrace(
            kind="explicit",
            events=(FailureEvent(time=fail_time, group=0,
                                 nodes=fail_nodes, repair_s=repair_s),)),
        placement=placement,
        axes=[Axis("degradation", tuple(policies),
                   path="fleet.degradation")])


def reliability_fleet_ranking(processes: Optional[int] = None,
                              device=None,
                              **kwargs) -> List[Dict[str, float]]:
    """Feasible degradation-policy cells, best turnaround-p99 first."""
    res: StudyResult = run_study(reliability_fleet_study(**kwargs),
                                 processes=processes, device=device)
    feasible = [c.record for c in res if c.record["feasible"]]
    return sorted(feasible, key=lambda r: r["turnaround_p99"])


def reliability_fleet_headline(records: Sequence[Dict[str, float]]
                               ) -> Dict[str, float]:
    """The fault-injection claim from a ``reliability_fleet_ranking``
    table: shrink-to-survive beats wait-for-repair on turnaround-p99
    (``p99_ratio`` > 1)."""
    by_policy = {r["degradation"]: r for r in records}
    wait, shrink = by_policy["wait"], by_policy["shrink"]
    return {
        "wait_p99": wait["turnaround_p99"],
        "shrink_p99": shrink["turnaround_p99"],
        "p99_ratio": wait["turnaround_p99"] / shrink["turnaround_p99"],
        "wait_goodput": wait["goodput"],
        "shrink_goodput": shrink["goodput"],
    }


# --------------------------------------------------------------------- #
# Figure-study registry
# --------------------------------------------------------------------- #

def figure_studies(cfg: Optional[ModelConfig] = None,
                   shape: Optional[ShapeConfig] = None,
                   dlrm_cfg=None,
                   cluster: Optional[ClusterConfig] = None,
                   ) -> Dict[str, StudySpec]:
    """The seven paper-figure studies as StudySpecs with their defaults,
    keyed ``fig8`` .. ``fig13b``, each to be run through
    :func:`repro_torch.core.study.run_study`."""
    from repro_torch.core.cluster import BASELINE_DGX_A100
    cfg = cfg if cfg is not None else _default_transformer()
    shape = shape if shape is not None else ShapeConfig(
        "paper", seq_len=2048, global_batch=1024, kind="train")
    if dlrm_cfg is None:
        from repro_torch.configs import get_dlrm_config
        dlrm_cfg = get_dlrm_config()
    cluster = cluster if cluster is not None else BASELINE_DGX_A100
    return {
        "fig8": mpdp_study(cfg, shape, cluster),
        "fig9": memory_expansion_study(cfg, shape, cluster),
        "fig10": compute_scaling_study(cfg, shape, cluster, mp=8, dp=128),
        "fig11": network_scaling_study(cfg, shape, cluster, mp=64, dp=16),
        "fig12": bandwidth_rebalance_study(cfg, shape, cluster, mp=64, dp=16),
        "fig13a": dlrm_cluster_size_study(dlrm_cfg, cluster),
        "fig13b": dlrm_memory_expansion_study(dlrm_cfg, cluster),
    }
