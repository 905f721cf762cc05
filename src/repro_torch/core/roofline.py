"""COMET §III-C1: the roofline compute-delay model.

The port's copy of the JAX package's ``core/roofline.py``, held to it by
``tests/test_torch_serving.py``. The serving workload prices its prefill and
decode phases here:

    OI        = FLOPs / memory_traffic                      (Eqn 1)
    perf_max  = min(perf_peak, OI * BW_mem)
    delay     = FLOPs / perf_max                            (Eqn 2)
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.cluster import NodeConfig
from repro_torch.core.gemm import PhaseCost


@dataclasses.dataclass(frozen=True)
class RooflinePoint:
    flops: int
    traffic: int
    oi: float
    perf_max: float
    delay: float
    bound: str  # "compute" | "memory"


def attainable_perf(oi: float, peak_flops: float, mem_bw: float) -> float:
    """min{perf_peak, OI * BW_mem}."""
    if oi == float("inf"):
        return peak_flops
    return min(peak_flops, oi * mem_bw)


def compute_delay(cost: PhaseCost, node: NodeConfig,
                  mem_bw: float | None = None) -> RooflinePoint:
    """Roofline delay for one phase cost on one node.

    ``mem_bw`` overrides the node's local bandwidth (hybrid-memory studies
    pass ``effective_memory_bw`` here)."""
    bw = node.local_bw if mem_bw is None else mem_bw
    if cost.flops == 0:
        # Pure data movement (e.g. embedding lookup): memory-bound transfer.
        delay = cost.traffic / bw if cost.traffic else 0.0
        return RooflinePoint(0, cost.traffic, 0.0, bw, delay, "memory")
    oi = cost.operational_intensity
    perf = attainable_perf(oi, node.peak_flops, bw)
    bound = "compute" if perf >= node.peak_flops else "memory"
    return RooflinePoint(cost.flops, cost.traffic, oi, perf,
                         cost.flops / perf, bound)


def ridge_point(node: NodeConfig, mem_bw: float | None = None) -> float:
    """OI at which the node transitions memory- -> compute-bound."""
    bw = node.local_bw if mem_bw is None else mem_bw
    return node.peak_flops / bw
