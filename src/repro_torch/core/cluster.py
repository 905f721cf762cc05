"""COMET cluster descriptions: node resources + network topology + cost.

The port's copy of the part of the JAX package's ``core/cluster.py`` the
evaluator needs: :class:`NodeConfig`, :class:`CostModel`, the homogeneous
:class:`ClusterConfig` with its one :class:`NodeGroup`, and the paper's
Table I baseline (:data:`A100_NODE`, :data:`BASELINE_DGX_A100`). The Table
III registry and the composable ``ClusterSpec`` are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.topology import HierarchicalSwitch, Topology

GB = 1e9
MB = 1e6

HOURS_PER_YEAR = 8760.0


@dataclasses.dataclass(frozen=True)
class NodeConfig:
    """One compute unit (GPU / TPU / tray) — paper's 'node'."""

    name: str
    peak_flops: float              # peak fp16/bf16 FLOP/s
    local_cap: float               # local (HBM) capacity, bytes
    local_bw: float                # local memory bandwidth, bytes/s
    sram_bytes: float              # on-chip buffer S for the traffic model
    exp_cap: float = 0.0           # expanded-memory capacity, bytes
    exp_bw: float = 0.0            # expanded-memory bandwidth, bytes/s
    tdp_watts: float = 0.0         # board power draw, W (TCO energy term)

    @property
    def total_cap(self) -> float:
        return self.local_cap + self.exp_cap

    def with_expansion(self, cap: float, bw: float) -> "NodeConfig":
        return dataclasses.replace(self, exp_cap=cap, exp_bw=bw)

    def scaled_compute(self, factor: float) -> "NodeConfig":
        return dataclasses.replace(self, peak_flops=self.peak_flops * factor)


# --------------------------------------------------------------------- #
# Cost / TCO model (paper §V-D perf-per-dollar; MAD-Max-style knobs)
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class CostModel:
    """Capex + energy model attached to a cluster.

    Capex = per-node price + $/GB of local and expanded memory + $/link
    (links counted via ``Topology.links_per_node``).  Energy = per-node TDP
    x $/kWh over the amortization horizon.
    """

    usd_per_node: float = 0.0      # accelerator + host share, excl. memory
    usd_per_gb_local: float = 0.0  # HBM $/GB
    usd_per_gb_em: float = 0.0     # expanded memory $/GB (CXL / HBM-pool)
    usd_per_link: float = 0.0      # per node-facing network link
    usd_per_kwh: float = 0.0
    amortization_years: float = 4.0

    def node_capex(self, node: NodeConfig) -> float:
        return (self.usd_per_node
                + self.usd_per_gb_local * node.local_cap / GB
                + self.usd_per_gb_em * node.exp_cap / GB)

    def capex(self, cluster: "ClusterLike") -> float:
        """Purchase cost of every node + its network links."""
        total = 0.0
        for g in cluster.node_groups:
            per_node = (self.node_capex(g.node)
                        + self.usd_per_link * g.topology.links_per_node)
            total += g.num_nodes * per_node
        return total

    def energy_usd(self, cluster: "ClusterLike") -> float:
        """Electricity over the amortization horizon at per-node TDP."""
        kwh = sum(g.num_nodes * g.node.tdp_watts / 1e3
                  for g in cluster.node_groups) \
            * HOURS_PER_YEAR * self.amortization_years
        return kwh * self.usd_per_kwh

    def tco(self, cluster: "ClusterLike") -> float:
        return self.capex(cluster) + self.energy_usd(cluster)


@dataclasses.dataclass(frozen=True)
class NodeGroup:
    """One homogeneous slice of a cluster, as the simulator consumes it."""

    node: NodeConfig
    num_nodes: int
    topology: Topology


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """A homogeneous cluster: ``num_nodes`` of one node on one topology,
    seen by the simulator as one :class:`NodeGroup`."""

    name: str
    node: NodeConfig
    num_nodes: int
    topology: Topology
    notes: str = ""
    cost: Optional[CostModel] = None

    def with_node(self, node: NodeConfig) -> "ClusterConfig":
        return dataclasses.replace(self, node=node)

    def with_topology(self, topo) -> "ClusterConfig":
        return dataclasses.replace(self, topology=topo)

    def with_cost(self, cost: CostModel) -> "ClusterConfig":
        return dataclasses.replace(self, cost=cost)

    @property
    def node_groups(self) -> Tuple[NodeGroup, ...]:
        return (NodeGroup(self.node, self.num_nodes, self.topology),)

    @property
    def is_heterogeneous(self) -> bool:
        return False

    @property
    def min_node_cap(self) -> float:
        return self.node.total_cap


ClusterLike = ClusterConfig


# --------------------------------------------------------------------- #
# Paper Table I: baseline 1024-GPU DGX A100 cluster (8-GPU pods)
# --------------------------------------------------------------------- #

A100_NODE = NodeConfig(
    name="A100",
    peak_flops=624e12,            # fp16 TC peak, Table I
    local_cap=80 * GB,
    local_bw=2039 * GB,
    sram_bytes=40 * MB,
    tdp_watts=400,
)

# Illustrative list-price defaults (sweep them — they are knobs, not data):
# node $ excludes memory, which is priced per GB so EM axes move capex.
_A100_COST = CostModel(usd_per_node=15_000, usd_per_gb_local=24,
                       usd_per_link=400, usd_per_kwh=0.12)

BASELINE_DGX_A100 = ClusterConfig(
    name="dgx-a100-1k",
    node=A100_NODE,
    num_nodes=1024,
    topology=HierarchicalSwitch(pod_size=8, intra_bw=300 * GB, inter_bw=31.25 * GB),
    notes="Paper Table I: 128 pods x 8 GPUs, NVLink3 intra / IB inter.",
    cost=_A100_COST,
)
