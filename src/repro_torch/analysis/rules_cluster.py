"""Cluster rules (K1xx): a ClusterConfig / ClusterSpec is well-formed.

======  ========  =====================================================
code    severity  invariant
======  ========  =====================================================
K101    warning   pod_size divides every node group's node count
K102    warning   hop bandwidths non-increasing fast -> slow
K103    error*    CostModel fields nonnegative, amortization positive
                  (*missing cost model is info; all-zero prices warn)
K104    error     node parameters positive; EM bandwidth present when
                  EM capacity is
======  ========  =====================================================
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.diagnostics import Diagnostic, RuleConfig, rule, run_pack
from repro_torch.core.cluster import ClusterLike, CostModel, NodeConfig

# SingleSwitch models "everything in one pod" with this sentinel.
_UNBOUNDED_POD = 1 << 20


def _name(cluster: ClusterLike) -> str:
    return f"cluster {cluster.name!r}"


@rule("K101", "cluster", "warning",
      "pod_size divides every node group's node count")
def _check_pods(cluster: ClusterLike,
                ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    for g, group in enumerate(cluster.node_groups):
        pod = group.topology.pod_size
        if pod <= 0:
            yield (f"{_name(cluster)} group[{g}]",
                   f"pod_size = {pod} (must be positive)")
            continue
        if pod >= _UNBOUNDED_POD or group.num_nodes <= pod:
            continue
        if group.num_nodes % pod:
            yield (f"{_name(cluster)} group[{g}]",
                   f"{group.num_nodes} nodes is not a multiple of "
                   f"pod_size {pod} — the last pod is ragged and "
                   "placement/collective models assume full pods")


@rule("K102", "cluster", "warning",
      "hop bandwidths non-increasing from fastest to slowest tier")
def _check_hierarchy(cluster: ClusterLike,
                     ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    for g, group in enumerate(cluster.node_groups):
        hops = group.topology.hops
        for near, far in zip(hops, hops[1:]):
            if far.bw > near.bw:
                yield (f"{_name(cluster)} group[{g}]",
                       f"hop {far.name!r} ({far.bw:.3g} B/s) is faster than "
                       f"the nearer hop {near.name!r} ({near.bw:.3g} B/s) — "
                       "inverted bandwidth hierarchy")
            if far.latency < near.latency:
                yield (f"{_name(cluster)} group[{g}]",
                       f"hop {far.name!r} ({far.latency:.3g} s) has lower "
                       f"latency than the nearer hop {near.name!r} "
                       f"({near.latency:.3g} s)")


def _cost_findings(cost: CostModel, loc: str) -> Iterator[Tuple[str, str]]:
    dollar_fields = ("usd_per_node", "usd_per_gb_local", "usd_per_gb_em",
                     "usd_per_link", "usd_per_kwh")
    for field in dollar_fields:
        v = getattr(cost, field)
        if not math.isfinite(v) or v < 0:
            yield loc, f"{field} = {v!r}"
    if not cost.amortization_years > 0:
        yield loc, (f"amortization_years = {cost.amortization_years!r} "
                    "(must be positive)")


@rule("K103", "cluster", "error",
      "CostModel complete: nonnegative prices, positive amortization")
def _check_cost(cluster: ClusterLike,
                ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    cost = cluster.cost
    if cost is None:
        return
    yield from _cost_findings(cost, f"{_name(cluster)} cost")


@rule("K104", "cluster", "error",
      "node parameters positive; EM bandwidth present when capacity is")
def _check_nodes(cluster: ClusterLike,
                 ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    for g, group in enumerate(cluster.node_groups):
        loc = f"{_name(cluster)} group[{g}] node"
        node: NodeConfig = group.node
        if group.num_nodes < 1:
            yield f"{_name(cluster)} group[{g}]", \
                f"num_nodes = {group.num_nodes}"
        for field in ("peak_flops", "local_cap", "local_bw", "sram_bytes"):
            v = getattr(node, field)
            if not math.isfinite(v) or v <= 0:
                yield loc, f"{field} = {v!r} (must be positive and finite)"
        for field in ("exp_cap", "exp_bw", "tdp_watts"):
            v = getattr(node, field)
            if not math.isfinite(v) or v < 0:
                yield loc, f"{field} = {v!r} (must be nonnegative and finite)"
        if node.exp_cap > 0 and node.exp_bw <= 0:
            yield loc, (f"exp_cap = {node.exp_cap:.3g} B with exp_bw = "
                        f"{node.exp_bw!r} — expanded memory that can never "
                        "be read")


def analyze_cluster(cluster: ClusterLike,
                    config: Optional[RuleConfig] = None) -> List[Diagnostic]:
    """Run the K1xx pack against one cluster."""
    diags = run_pack("cluster", cluster, {}, config)
    cfg = config if config is not None else RuleConfig()
    if cluster.cost is None and cfg.enabled("K103"):
        diags.append(Diagnostic(
            "K103", "info", _name(cluster),
            "no CostModel attached — cost_usd/tco/perf_per_dollar columns "
            "will be empty"))
    return diags
