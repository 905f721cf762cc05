"""COMET §III-B / §IV-B: per-node memory footprint + hybrid-memory model.

The port's copy of the JAX package's ``core/memory.py``. Model states follow
ZeRO's accounting (fp16 weights and gradients, fp32 Adam states): 16 bytes a
parameter, staged down by ZeRO-1/2/3 across the DP dimension. Activation
working memory is the intermediates between two consecutive activation
checkpoints; the checkpoints themselves are host-offloaded, as in the paper.

The hybrid local + expanded memory bandwidth is the paper's Eqn (3):

    bw_hybrid = total / (data_LM / bw_LM + data_EM / bw_EM)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.cluster import NodeConfig
from repro_torch.core.workload import Workload

# bytes per parameter
FP16 = 2
GRAD = 2
OPTIM = 12  # fp32 master + momentum + variance (ZeRO's K=12)


def model_state_bytes(params: float, dp: int, zero_stage: int) -> float:
    """Per-node model-state bytes for ``params`` parameters held on this
    node's MP shard, under ZeRO stage 0..3 across ``dp`` replicas."""
    dp = max(1, dp)
    if zero_stage == 0:
        return (FP16 + GRAD + OPTIM) * params
    if zero_stage == 1:  # optimizer states sharded
        return (FP16 + GRAD) * params + OPTIM * params / dp
    if zero_stage == 2:  # + gradients sharded
        return FP16 * params + (GRAD + OPTIM) * params / dp
    if zero_stage == 3:  # + parameters sharded
        return (FP16 + GRAD + OPTIM) * params / dp
    raise ValueError(f"zero_stage must be 0..3, got {zero_stage}")


@dataclasses.dataclass(frozen=True)
class FootprintReport:
    model_states: float
    activation_working: float
    total: float
    fits_local: bool
    fits_total: bool


def worst_report(reps) -> FootprintReport:
    """Gating report over several footprints (pipeline stages, node
    groups): the largest total, with the fits flags ANDed — feasible only
    if every report fits."""
    return dataclasses.replace(
        max(reps, key=lambda r: r.total),
        fits_local=all(r.fits_local for r in reps),
        fits_total=all(r.fits_total for r in reps))


def _data_ways(workload: Workload) -> int:
    """ZeRO shards dense weights across the full data group: DP x EP (EP
    ranks replicate the dense weights, so they join the sharding group;
    pre-EP workloads have ep == 1 and this is exactly dp)."""
    return max(1, workload.dp * getattr(workload, "ep", 1))


def _layer_states(layers, dense_ways: int, expert_ways: int,
                  zero_stage: int) -> float:
    """Model-state bytes for a layer list: dense params replicate (and ZeRO-
    shard) across DP x EP, expert params are EP-sharded already and only
    replicate across DP — mirroring the "dp" vs "edp" gradient scopes."""
    dense = sum((ly.weight_bytes - ly.expert_bytes) * ly.repeat
                for ly in layers) / FP16
    expert = sum(ly.expert_bytes * ly.repeat for ly in layers) / FP16
    states = model_state_bytes(dense, dense_ways, zero_stage)
    if expert:
        states += model_state_bytes(expert, expert_ways, zero_stage)
    return states


def stage_footprints(
    workload: Workload,
    node: Optional[NodeConfig] = None,
    zero_stage: int = 2,
    nodes: Optional[list] = None,
) -> list:
    """Per-pipeline-stage footprint reports (one entry when pp == 1).

    Each stage holds its own layers' model states.  Activation working
    memory is per-microbatch (1/m of the full-batch intermediates) times
    the schedule's stash depth: GPipe stashes all ``m`` in-flight
    microbatches; 1F1B at stage ``s`` stashes at most ``pp - s``
    (Megatron-LM §2.2), so early stages pay more; the interleaved
    schedule pays the 1F1B stash scaled by ``1 + (pp-1)/(pp*v)``
    (Megatron-LM §2.2.2: ``v`` in-flight virtual-stage chunks).

    ``nodes`` (one :class:`NodeConfig` per stage) gates each stage
    against *its own* node — the EM-aware heterogeneous placement path;
    ``node`` gates every stage against the same node (the paper's
    replicate-everywhere semantics)."""
    m = max(1, getattr(workload, "num_microbatches", 1))
    schedule = getattr(workload, "schedule", "1f1b")
    v = max(1, getattr(workload, "virtual_stages", 1))
    pp = max(1, getattr(workload, "pp", 1))
    if nodes is not None and len(nodes) != pp:
        raise ValueError(f"nodes must have one entry per stage "
                         f"({pp}), got {len(nodes)}")
    dways = _data_ways(workload)
    reps = []
    for s, layers in enumerate(workload.stage_layers()):
        states = _layer_states(layers, dways, max(1, workload.dp),
                               zero_stage)
        max_act = max((ly.act_out_bytes for ly in layers), default=0)
        if schedule == "gpipe":
            stash = m
        else:
            stash = min(m, pp - s)
            if schedule == "interleaved":
                stash *= 1 + (pp - 1) / (pp * v)
        awm = max_act / m * stash
        total = states + awm
        gate = nodes[s] if nodes is not None else node
        fits_local = fits_total = True
        if gate is not None:
            fits_local = total <= gate.local_cap
            fits_total = total <= gate.total_cap
        reps.append(FootprintReport(states, awm, total, fits_local,
                                    fits_total))
    return reps


def per_node_footprint(
    workload: Workload,
    node: Optional[NodeConfig] = None,
    zero_stage: int = 2,
) -> FootprintReport:
    """Per-node footprint of a decomposed workload (paper defaults: ZeRO-2,
    fp16 activations, checkpoint activations host-offloaded).

    For pipeline workloads (pp > 1) this reports the *worst* stage's bytes,
    with the fits flags ANDed over every stage (feasibility = each stage
    fits its nodes)."""
    if getattr(workload, "pp", 1) > 1:
        return worst_report(stage_footprints(workload, node, zero_stage))
    states = _layer_states(workload.layers, _data_ways(workload),
                           max(1, workload.dp), zero_stage)
    awm = workload.activation_working_bytes()
    total = states + awm
    fits_local = fits_total = True
    if node is not None:
        fits_local = total <= node.local_cap
        fits_total = total <= node.total_cap
    return FootprintReport(states, awm, total, fits_local, fits_total)


def hybrid_bandwidth(total_bytes: float, data_lm: float,
                     bw_lm: float, bw_em: float) -> float:
    """Paper Eqn (3). ``data_lm`` = bytes served from local memory."""
    data_em = max(0.0, total_bytes - data_lm)
    if total_bytes <= 0:
        return bw_lm
    if data_em <= 0 or bw_em <= 0:
        return bw_lm
    return total_bytes / (data_lm / bw_lm + data_em / bw_em)


def effective_memory_bw(node: NodeConfig, footprint_bytes: float) -> float:
    """Roofline slope for a node given the working set it must hold:
    if the footprint spills past local capacity, accesses split between
    LM and EM proportionally to residency (paper §III-C2)."""
    if footprint_bytes <= node.local_cap or node.exp_cap <= 0:
        return node.local_bw
    frac_lm = node.local_cap / footprint_bytes
    # Accesses hit LM with probability = residency fraction.
    return hybrid_bandwidth(1.0, frac_lm, node.local_bw, node.exp_bw)
