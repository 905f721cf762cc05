"""COMET §III-B: parallelization-strategy sweeps (the seed surface).

The port's copy of the JAX package's ``core/strategy.py``, held to it by
``tests/test_torch_paper_claims.py``. Strategies are
:class:`~repro_torch.core.study.ParallelSpec` points and every sweep is a
:class:`~repro_torch.core.study.StudySpec` run through
:func:`~repro_torch.core.study.run_study`; this module keeps the seed API
(``power_of_two_strategies``, ``sweep_strategies``, ``best_strategy``,
``footprint_table``) as thin wrappers over it. ``sweep_strategies`` runs on
the caller's ``device``, else the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cluster import ClusterLike
from repro_torch.core.simulator import IterationBreakdown
from repro_torch.core.study import (
    PowerOfTwoSpace,
    StudySpec,
    run_study,
)
from repro_torch.core.workload import Workload, decompose


def power_of_two_strategies(num_nodes: int) -> List[Tuple[int, int]]:
    """All (MP, DP) with MP*DP = N, MP a power of two (paper sweep).

    Tuple form of ``PowerOfTwoSpace().specs(num_nodes)``."""
    return [(s.mp, s.dp) for s in PowerOfTwoSpace().specs(num_nodes)]


@dataclasses.dataclass
class StrategyResult:
    mp: int
    dp: int
    breakdown: IterationBreakdown
    footprint_bytes: float

    @property
    def label(self) -> str:
        return f"MP{self.mp}_DP{self.dp}"

    @property
    def total(self) -> float:
        return self.breakdown.total


def sweep_strategies(
    cfg: ModelConfig,
    shape: ShapeConfig,
    cluster: ClusterLike,
    zero_stage: int = 2,
    mem_bw_override: Optional[float] = None,
    min_mp: int = 1,
    max_mp: Optional[int] = None,
    workload_fn: Optional[Callable[..., Workload]] = None,
    device=None,
) -> List[StrategyResult]:
    """Fig. 8 engine: simulate every (MP, DP) combination on the cluster.

    ``mem_bw_override`` reproduces §V-B1's 'infinite capacity at baseline
    bandwidth' assumption when set to the node's local bandwidth."""
    decomp = workload_fn or decompose
    spec = StudySpec(
        name="strategy-sweep", model=cfg, shape=shape, cluster=cluster,
        strategies=PowerOfTwoSpace(zero_stage=zero_stage, min_mp=min_mp,
                                   max_mp=max_mp),
        workload=lambda ctx: decomp(cfg, shape, mp=ctx.strategy.mp,
                                    dp=ctx.strategy.dp),
        mem_bw_override=mem_bw_override,
    )
    return [StrategyResult(c.strategy.mp, c.strategy.dp, c.breakdown,
                           c.footprint.total)
            for c in run_study(spec, device=device)]


def best_strategy(results: List[StrategyResult],
                  require_fit_bytes: Optional[float] = None) -> StrategyResult:
    """Fastest strategy; optionally restricted to those fitting a capacity."""
    pool = results
    if require_fit_bytes is not None:
        pool = [r for r in results if r.footprint_bytes <= require_fit_bytes]
        if not pool:
            raise ValueError("no strategy fits the given capacity")
    return min(pool, key=lambda r: r.total)


def footprint_table(
    cfg: ModelConfig,
    shape: ShapeConfig,
    num_nodes: int,
    zero_stages=(0, 1, 2, 3),
) -> Dict[str, Dict[int, float]]:
    """Fig. 6 engine: per-node model-state footprint vs MP degree x ZeRO."""
    from repro_torch.core.memory import model_state_bytes

    table: Dict[str, Dict[int, float]] = {}
    for mp, dp in power_of_two_strategies(num_nodes):
        wl = decompose(cfg, shape, mp=mp, dp=dp)
        params = wl.total_weight_bytes() / 2
        table[f"MP{mp}_DP{dp}"] = {
            z: model_state_bytes(params, dp, z) for z in zero_stages}
    return table
