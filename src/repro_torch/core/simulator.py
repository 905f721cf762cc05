"""COMET §III-C3/4: the ASTRA-lite iteration timeline over a lowered workload.

The port of the compiled half of the JAX package's ``core/simulator.py``:
:func:`time_compiled` times one
:class:`~repro_torch.core.compiled.CompiledWorkload` against a batch of
(node, topology) environments, the per-stage hot path a float64 device call
(:func:`repro_torch.core.torch_engine.stage_compute_exposed`);
:func:`simulate_iteration_compiled` times a cluster of one or several node
groups. Semantics are the reference's:

  * FP and IG blocking MP collectives serialize with compute on the
    critical path;
  * WG DP collectives are non-blocking: they run on the network stream and
    overlap later backward compute; only the residue past the end of
    compute is exposed;
  * every scope has its own network stream;
  * pipeline workloads (``pp > 1``) are gated by the slowest stage, scaled
    by the schedule's factor ``(m + pp - 1) / m`` (``v * m`` slots for
    Megatron-LM's interleaved schedule), and feasible only if every stage
    fits its nodes;
  * heterogeneous clusters (several node groups) follow the
    :class:`~repro_torch.core.placement.Placement`: by default every group
    holds the same shard and the slowest / least-capable group gates the
    iteration; a placement whose ``assign_stages`` maps pipeline stages to
    groups (``EMAwarePlacement``, ``ExplicitPlacement``) times each stage
    on its own group's environment (:func:`_time_compiled_assigned`).

The reference's event loop and NumPy engine are not copied: the tests hold
this module to them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import torch_engine
from repro_torch.core.cluster import ClusterLike, NodeConfig
from repro_torch.core.memory import (
    FootprintReport,
    effective_memory_bw,
    per_node_footprint,
    stage_footprints,
    worst_report,
)
from repro_torch.core.topology import Topology
from repro_torch.core.workload import Workload

OPTIM_BYTES_PER_PARAM = 28  # grad read + fp32 m/v/master read+write


@dataclasses.dataclass
class PhaseBreakdown:
    compute: float = 0.0
    exposed_comm: float = 0.0

    @property
    def total(self) -> float:
        return self.compute + self.exposed_comm

    def scaled(self, factor: float) -> "PhaseBreakdown":
        return PhaseBreakdown(self.compute * factor,
                              self.exposed_comm * factor)


@dataclasses.dataclass
class IterationBreakdown:
    fp: PhaseBreakdown
    ig: PhaseBreakdown
    wg: PhaseBreakdown
    optimizer: float
    footprint: FootprintReport
    mem_bw: float
    feasible: bool
    # Pipeline-schedule idle fraction (pp - 1) / (m + pp - 1); 0.0 when the
    # workload has no pipeline dimension.  Kept out of as_dict() so the
    # time components still sum to ``total``.
    bubble_fraction: float = 0.0

    @property
    def total(self) -> float:
        return (self.fp.total + self.ig.total + self.wg.total + self.optimizer)

    def as_dict(self) -> Dict[str, float]:
        return {
            "fp_compute": self.fp.compute,
            "fp_exposed_comm": self.fp.exposed_comm,
            "ig_compute": self.ig.compute,
            "ig_exposed_comm": self.ig.exposed_comm,
            "wg_compute": self.wg.compute,
            "wg_exposed_comm": self.wg.exposed_comm,
            "optimizer": self.optimizer,
            "total": self.total,
        }


def _infeasible(rep: FootprintReport, mem_bw: float,
                bubble_fraction: float = 0.0) -> IterationBreakdown:
    return IterationBreakdown(PhaseBreakdown(), PhaseBreakdown(),
                              PhaseBreakdown(), 0.0, rep, mem_bw, False,
                              bubble_fraction=bubble_fraction)


def _schedule_factors(schedule: str, pp: int, m: int,
                      v: int) -> Tuple[float, float]:
    """(iteration scale over the gating stage, bubble fraction) for a
    pipeline schedule.  GPipe / 1F1B: (m + pp - 1)/m; Megatron-LM
    interleaved 1F1B with ``v`` virtual stages per node: the bubble
    shrinks v-fold to (pp - 1)/(v*m + pp - 1)."""
    slots = v * m if schedule == "interleaved" else m
    return (slots + pp - 1) / slots, (pp - 1) / (slots + pp - 1)


def _optimizer_numer(dense_w: float, expert_w: float, sparse: float,
                     dense_ways: int, expert_ways: int,
                     zero_stage: int) -> float:
    """Optimizer-update bytes before the ``/ mem_bw`` division.  Dense
    params ZeRO-shard across the DP x EP data group; expert params are
    EP-sharded already and shard across DP only."""
    params = dense_w / 2
    shard = params / max(1, dense_ways) if zero_stage >= 1 else params
    if expert_w:
        ep_params = expert_w / 2
        shard += (ep_params / max(1, expert_ways) if zero_stage >= 1
                  else ep_params)
    return shard * OPTIM_BYTES_PER_PARAM + sparse


def _compiled_mem_bws(nodes, total: float, mem_bw_override) -> np.ndarray:
    return np.array([n.local_bw if mem_bw_override == "local"
                     else mem_bw_override if mem_bw_override is not None
                     else effective_memory_bw(n, total) for n in nodes])


def _time_compiled_flat(cw, envs, zero_stage, mem_bw_override, require_fit,
                        placement, device) -> List[IterationBreakdown]:
    wl = cw.workload
    stage = cw.stages[0]
    nodes = [n for n, _ in envs]
    rep0 = per_node_footprint(wl, None, zero_stage)
    total = rep0.total
    reps = [dataclasses.replace(rep0,
                                fits_local=total <= n.local_cap,
                                fits_total=total <= n.total_cap)
            for n in nodes]
    mem_bw = _compiled_mem_bws(nodes, total, mem_bw_override)
    ep = getattr(wl, "ep", 1)
    compute, exposed = torch_engine.stage_compute_exposed(
        stage, envs, nodes, mem_bw, wl.mp, wl.dp, 1, ep, placement, device)
    numer = _optimizer_numer(stage.dense_w, stage.expert_w, stage.sparse,
                             wl.dp * ep, wl.dp, zero_stage)
    out = []
    for e in range(len(nodes)):
        if require_fit and not reps[e].fits_total:
            out.append(_infeasible(reps[e], float(mem_bw[e])))
            continue
        out.append(IterationBreakdown(
            PhaseBreakdown(float(compute[0, e]), float(exposed[0, e])),
            PhaseBreakdown(float(compute[1, e]), float(exposed[1, e])),
            PhaseBreakdown(float(compute[2, e]), float(exposed[2, e])),
            numer / float(mem_bw[e]), reps[e], float(mem_bw[e]),
            reps[e].fits_total))
    return out


def _time_compiled_pipeline(cw, envs, zero_stage, mem_bw_override,
                            require_fit, placement,
                            device) -> List[IterationBreakdown]:
    wl = cw.workload
    pp = wl.pp
    m = max(1, wl.num_microbatches)
    v = max(1, getattr(wl, "virtual_stages", 1))
    nodes = [n for n, _ in envs]
    nenv = len(envs)
    reps0 = stage_footprints(wl, None, zero_stage)
    # worst_report picks the first maximal total; totals are
    # environment-independent, so the gating report row is too.
    k0 = max(range(pp), key=lambda s: reps0[s].total)
    fits_local = [all(r.total <= n.local_cap for r in reps0) for n in nodes]
    fits_total = [all(r.total <= n.total_cap for r in reps0) for n in nodes]
    mem_bws = np.stack([_compiled_mem_bws(nodes, r.total, mem_bw_override)
                        for r in reps0])                      # (pp, nenv)
    scale, bubble = _schedule_factors(wl.schedule, pp, m, v)
    data_ways = wl.dp * wl.ep
    computes, exposeds = [], []
    totals = np.zeros((pp, nenv))
    numers = np.zeros(pp)
    for s, stage in enumerate(cw.stages):
        compute, exposed = torch_engine.stage_compute_exposed(
            stage, envs, nodes, mem_bws[s], wl.mp, wl.dp, pp, wl.ep,
            placement, device)
        computes.append(compute)
        exposeds.append(exposed)
        totals[s] = compute.sum(axis=0) + exposed.sum(axis=0)
        numers[s] = _optimizer_numer(stage.dense_w, stage.expert_w,
                                     stage.sparse, data_ways, wl.dp,
                                     zero_stage)
    gating = np.argmax(totals, axis=0)           # first max, like max(key=)
    optim = np.max(numers[:, None] / mem_bws, axis=0)
    out = []
    for e in range(nenv):
        rep = dataclasses.replace(reps0[k0], fits_local=fits_local[e],
                                  fits_total=fits_total[e])
        if require_fit and not fits_total[e]:
            out.append(_infeasible(rep, float(mem_bws[:, e].min()),
                                   bubble_fraction=bubble))
            continue
        k = int(gating[e])
        fp = PhaseBreakdown(float(computes[k][0, e]),
                            float(exposeds[k][0, e])).scaled(scale)
        ig = PhaseBreakdown(float(computes[k][1, e]),
                            float(exposeds[k][1, e])).scaled(scale)
        wg = PhaseBreakdown(float(computes[k][2, e]),
                            float(exposeds[k][2, e])).scaled(scale)
        out.append(IterationBreakdown(fp, ig, wg, float(optim[e]), rep,
                                      float(mem_bws[k, e]), fits_total[e],
                                      bubble_fraction=bubble))
    return out


def _time_compiled_assigned(cw, stage_envs, zero_stage, mem_bw_override,
                            require_fit, placement,
                            device) -> IterationBreakdown:
    """The placement-assigned pipeline (mixed fleet, ``pp > 1``, a
    placement whose ``assign_stages`` maps stages to node groups): each
    stage timed on its own (node, topology) environment, one
    ``stage_compute_exposed`` call a stage. Clause for clause the
    reference's: per-stage footprints gated against the assigned node,
    per-stage memory bandwidths, the gating stage, the optimizer as a max
    over stages, the schedule's scale."""
    wl = cw.workload
    pp = wl.pp
    m = max(1, wl.num_microbatches)
    v = max(1, getattr(wl, "virtual_stages", 1))
    nodes = [node for node, _ in stage_envs]
    reps = stage_footprints(wl, None, zero_stage, nodes=nodes)
    worst_rep = worst_report(reps)
    mem_bws = [node.local_bw if mem_bw_override == "local"
               else mem_bw_override if mem_bw_override is not None
               else effective_memory_bw(node, r.total)
               for node, r in zip(nodes, reps)]
    feasible = worst_rep.fits_total
    scale, bubble = _schedule_factors(wl.schedule, pp, m, v)
    if require_fit and not feasible:
        return _infeasible(worst_rep, min(mem_bws), bubble_fraction=bubble)
    data_ways = wl.dp * wl.ep
    per_stage = []
    for stage, env, bw in zip(cw.stages, stage_envs, mem_bws):
        compute, exposed = torch_engine.stage_compute_exposed(
            stage, [env], [env[0]], np.array([bw], dtype=float),
            wl.mp, wl.dp, pp, wl.ep, placement, device)
        fp = PhaseBreakdown(float(compute[0, 0]), float(exposed[0, 0]))
        ig = PhaseBreakdown(float(compute[1, 0]), float(exposed[1, 0]))
        wg = PhaseBreakdown(float(compute[2, 0]), float(exposed[2, 0]))
        per_stage.append((fp, ig, wg, fp.total + ig.total + wg.total))
    k = max(range(pp), key=lambda s: per_stage[s][3])
    fp, ig, wg, _ = per_stage[k]
    optim = max(_optimizer_numer(stage.dense_w, stage.expert_w, stage.sparse,
                                 data_ways, wl.dp, zero_stage) / bw
                for stage, bw in zip(cw.stages, mem_bws))
    return IterationBreakdown(fp.scaled(scale), ig.scaled(scale),
                              wg.scaled(scale), optim, worst_rep,
                              mem_bws[k], feasible,
                              bubble_fraction=bubble)


def time_compiled(
    cw,
    envs: "List[Tuple[NodeConfig, Topology]]",
    zero_stage: int = 2,
    mem_bw_override: "Optional[float | str]" = None,
    require_fit: bool = False,
    placement=None,
    device=None,
) -> List[IterationBreakdown]:
    """Time one :class:`~repro_torch.core.compiled.CompiledWorkload` on a
    batch of (node, topology) environments at once: one breakdown per
    environment, as the reference's ``simulate_iteration`` would give on a
    cluster of that node and topology (within 1e-9 relative). ``placement``
    resolves the collectives' hops (None: the paper's rank order). The
    stages' hot path runs on ``device``, the caller's, else the GPU; with
    no GPU and no ``device`` this raises."""
    device = resolve_device(device)
    if not envs:
        return []
    if getattr(cw.workload, "pp", 1) > 1:
        return _time_compiled_pipeline(cw, envs, zero_stage, mem_bw_override,
                                       require_fit, placement, device)
    return _time_compiled_flat(cw, envs, zero_stage, mem_bw_override,
                               require_fit, placement, device)


def _env_breakdowns(cw, envs, zero_stage, mem_bw_override, require_fit,
                    placement, env_cache, device) -> List[IterationBreakdown]:
    """Per-environment breakdowns through the optional cross-cell cache
    (key: placement x environment x require_fit; the study runner prefills
    it with one batch per strategy)."""
    if env_cache is None:
        return time_compiled(cw, envs, zero_stage, mem_bw_override,
                             require_fit, placement, device)
    missing = [env for env in dict.fromkeys(envs)
               if (placement, env, require_fit) not in env_cache]
    if missing:
        for env, br in zip(missing,
                           time_compiled(cw, missing, zero_stage,
                                         mem_bw_override, require_fit,
                                         placement, device)):
            env_cache[(placement, env, require_fit)] = br
    return [env_cache[(placement, env, require_fit)] for env in envs]


def compiled_stage_assignment(workload: Workload, cluster: ClusterLike,
                              placement, zero_stage: int = 2):
    """The per-stage (node, topology) environments a placement assigns,
    or None when replicate-everywhere semantics apply (one group, no
    placement, ``pp == 1``, or the placement declines the fleet). Shared
    by :func:`simulate_iteration_compiled` and the study runner's
    prefetch, so the two cannot drift."""
    groups = cluster.node_groups
    if len(groups) <= 1 or placement is None \
            or getattr(workload, "pp", 1) <= 1:
        return None
    stage_bytes = [r.total for r in
                   stage_footprints(workload, None, zero_stage)]
    nodes_per_stage = workload.mp * workload.dp * workload.ep
    assign = placement.assign_stages(stage_bytes, groups, nodes_per_stage)
    if assign is None:
        return None
    return [(groups[i].node, groups[i].topology) for i in assign]


def simulate_iteration_compiled(
    cw,
    cluster: ClusterLike,
    zero_stage: int = 2,
    mem_bw_override: "Optional[float | str]" = None,
    require_fit: bool = False,
    placement=None,
    env_cache: "Optional[dict]" = None,
    device=None,
) -> IterationBreakdown:
    """The reference's ``simulate_iteration`` over a pre-lowered workload.

    Single-group clusters and heterogeneous flat / replicate-everywhere
    cells run batched over the groups' environments, the worst group
    gating; the placement-assigned pipeline
    (:func:`compiled_stage_assignment` not None) runs each stage on its
    assigned environment. ``mem_bw_override`` may be a float or
    ``"local"``, each group's own ``local_bw``."""
    device = resolve_device(device)
    groups = cluster.node_groups
    stage_envs = compiled_stage_assignment(cw.workload, cluster, placement,
                                           zero_stage)
    if stage_envs is not None:
        return _time_compiled_assigned(cw, stage_envs, zero_stage,
                                       mem_bw_override, require_fit,
                                       placement, device)
    per = _env_breakdowns(cw, [(g.node, g.topology) for g in groups],
                          zero_stage, mem_bw_override, require_fit,
                          placement, env_cache, device)
    if len(per) == 1:
        return per[0]
    worst_rep = worst_report([b.footprint for b in per])
    feasible = all(b.feasible for b in per)
    if require_fit and not feasible:
        return _infeasible(worst_rep, min(b.mem_bw for b in per),
                           bubble_fraction=max(b.bubble_fraction
                                               for b in per))
    worst = max(per, key=lambda b: b.total)
    return IterationBreakdown(worst.fp, worst.ig, worst.wg, worst.optimizer,
                              worst_rep, worst.mem_bw, feasible,
                              bubble_fraction=worst.bubble_fraction)


def group_breakdowns_compiled(
    cw,
    cluster: ClusterLike,
    zero_stage: int = 2,
    mem_bw_override: "Optional[float | str]" = None,
    placement=None,
    env_cache: "Optional[dict]" = None,
    device=None,
) -> List[IterationBreakdown]:
    """The reference's ``group_breakdowns`` over a pre-lowered workload:
    one breakdown per node group (the multi-tenant ScheduleModel's
    per-group instance timings)."""
    return _env_breakdowns(cw, [(g.node, g.topology)
                                for g in cluster.node_groups],
                           zero_stage, mem_bw_override, False, placement,
                           env_cache, resolve_device(device))
