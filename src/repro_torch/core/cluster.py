"""COMET cluster descriptions: node resources + network topology + cost.

The port's copy of the JAX package's ``core/cluster.py``, held to it field
for field by ``tests/test_torch_placement.py``. Every cluster here is a
*modelled* cluster: one of COMET's inputs, copied as data (the paper's
Table I baseline, its Table III clusters A0..C2, Dojo and TPU v4, the mixed
``B_HYBRID_EM`` fleet and the TPU v5e pods the JAX package's dry-run
analysis targets). None of them describes the hardware the port runs on,
and none of their numbers is a measurement of the port.

The layer is composable (cluster-workload co-design, paper §V-D; cost
modeling follows MAD-Max, arXiv:2310.02784):

  * :class:`~repro_torch.core.topology.Topology` — pluggable network
    protocol (families live in :mod:`repro_torch.core.topology`);
  * :class:`PodSpec` — ``count`` pods of ``nodes_per_pod`` x one
    :class:`NodeConfig`, optionally with their own intra-pod ``fabric``;
  * :class:`ClusterSpec` — a tuple of pod groups + shared interconnect +
    an optional :class:`CostModel`, so one cluster can mix node types and
    pod sizes;
  * :class:`ClusterConfig` — the homogeneous form, exposing the same
    ``node_groups`` interface the simulator consumes.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.core.topology import (
    HierarchicalSwitch,
    SingleSwitch,
    Topology,
    Torus,
)

GB = 1e9
TB = 1e12
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
    x $/kWh over the amortization horizon.  All dollar figures flow into
    the ``cost_usd`` / ``tco`` / ``perf_per_dollar`` StudyResult columns
    and are sweepable as Axis knobs (``path="cost.usd_per_gb_em"``).
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


# --------------------------------------------------------------------- #
# Composable cluster specs
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class PodSpec:
    """``count`` pods of ``nodes_per_pod`` identical nodes.

    ``fabric``, when given, is the complete network as seen by this group
    (its intra-pod fabric plus the shared uplink — e.g. a
    ``HierarchicalSwitch`` with this group's pod size and NVLink intra
    bandwidth); when None the group communicates over the cluster's
    ``interconnect`` unchanged.
    """

    node: NodeConfig
    count: int = 1
    nodes_per_pod: int = 1
    fabric: Optional[Topology] = None

    @property
    def num_nodes(self) -> int:
        return self.count * self.nodes_per_pod

    def with_(self, **updates) -> "PodSpec":
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass(frozen=True)
class NodeGroup:
    """One homogeneous slice of a cluster, as the simulator consumes it."""

    node: NodeConfig
    num_nodes: int
    topology: Topology


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A composable cluster: pod groups x interconnect x cost model.

    The homogeneous case is a one-liner (:meth:`homogeneous`); the
    heterogeneous case mixes node types / pod sizes by listing several
    :class:`PodSpec` groups.  Synchronous-training semantics downstream:
    the slowest / least-capable group gates the iteration (see
    ``simulate_iteration``).
    """

    name: str
    pods: Tuple[PodSpec, ...]
    interconnect: Topology
    cost: Optional[CostModel] = None
    notes: str = ""

    def __post_init__(self):
        if not self.pods:
            raise ValueError(f"cluster {self.name!r} has no pods")

    # -- interface shared with ClusterConfig ---------------------------- #
    @property
    def num_nodes(self) -> int:
        return sum(p.num_nodes for p in self.pods)

    @property
    def topology(self) -> Topology:
        return self.interconnect

    @property
    def node(self) -> NodeConfig:
        """The single node type — raises on heterogeneous clusters."""
        nodes = {g.node for g in self.node_groups}
        if len(nodes) != 1:
            raise ValueError(
                f"cluster {self.name!r} is heterogeneous "
                f"({len(nodes)} node types); iterate node_groups instead")
        return next(iter(nodes))

    @property
    def node_groups(self) -> Tuple[NodeGroup, ...]:
        groups: Dict[Tuple[NodeConfig, Topology], int] = {}
        for p in self.pods:
            key = (p.node, p.fabric if p.fabric is not None
                   else self.interconnect)
            groups[key] = groups.get(key, 0) + p.num_nodes
        return tuple(NodeGroup(node, n, topo)
                     for (node, topo), n in groups.items())

    @property
    def is_heterogeneous(self) -> bool:
        return len(self.node_groups) > 1

    @property
    def min_node_cap(self) -> float:
        """Least-capable group's per-node capacity (bytes) — the
        synchronous-training feasibility bound under the default
        replicate-everywhere placement."""
        return min(g.node.total_cap for g in self.node_groups)

    # -- functional updates (ClusterConfig-shim parity) ------------------ #
    def with_node(self, node: NodeConfig) -> "ClusterSpec":
        """Replace every pod group's node (legacy axis-lambda parity)."""
        return self.map_nodes(lambda _: node)

    def with_topology(self, topo: Topology) -> "ClusterSpec":
        """Replace the shared interconnect (per-pod fabrics are kept)."""
        return dataclasses.replace(self, interconnect=topo)

    def with_cost(self, cost: CostModel) -> "ClusterSpec":
        return dataclasses.replace(self, cost=cost)

    def with_pods(self, pods: Tuple[PodSpec, ...]) -> "ClusterSpec":
        return dataclasses.replace(self, pods=tuple(pods))

    def map_nodes(self, fn: Callable[[NodeConfig], NodeConfig]) -> "ClusterSpec":
        """Apply ``fn`` to every pod group's node (e.g. add EM everywhere)."""
        return self.with_pods(tuple(p.with_(node=fn(p.node))
                                    for p in self.pods))

    # -- construction ---------------------------------------------------- #
    @classmethod
    def homogeneous(cls, name: str, node: NodeConfig, num_nodes: int,
                    topology: Topology, cost: Optional[CostModel] = None,
                    notes: str = "") -> "ClusterSpec":
        """The seed ``ClusterConfig`` shape as one pod group."""
        return cls(name=name,
                   pods=(PodSpec(node=node, count=1,
                                 nodes_per_pod=num_nodes),),
                   interconnect=topology, cost=cost, notes=notes)


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Homogeneous shim: the seed constructor signature, same semantics.

    Exposes the ``node_groups`` interface of :class:`ClusterSpec`, so the
    simulator / cost model treat both uniformly; ``to_spec()`` lifts it
    into the composable form.
    """

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

    @property
    def pods(self) -> Tuple[PodSpec, ...]:
        per_pod = min(self.topology.pod_size, self.num_nodes)
        count, rem = divmod(self.num_nodes, per_pod)
        out = (PodSpec(self.node, count=count, nodes_per_pod=per_pod),)
        if rem:
            out += (PodSpec(self.node, count=1, nodes_per_pod=rem),)
        return out

    def to_spec(self) -> ClusterSpec:
        return ClusterSpec(name=self.name, pods=self.pods,
                           interconnect=self.topology, cost=self.cost,
                           notes=self.notes)


ClusterLike = Union[ClusterConfig, ClusterSpec]


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


# --------------------------------------------------------------------- #
# Paper Table III: clusters A/B/C (x memory systems 0/1/2), Dojo, TPU v4
# §V-D: GPU clusters organized in 16-GPU pods.
# --------------------------------------------------------------------- #

_V100 = NodeConfig("V100", 125e12, 80 * GB, 900 * GB, 36 * MB, tdp_watts=300)
_A100 = NodeConfig("A100", 625e12, 80 * GB, 2039 * GB, 40 * MB, tdp_watts=400)
_H100 = NodeConfig("H100", 1979e12, 80 * GB, 3350 * GB, 50 * MB, tdp_watts=700)

_MEMSYS = {
    0: (0.0, 0.0),
    1: (480 * GB, 500 * GB),       # CXL/DDR-class pool: cheap, slower
    2: (201 * GB, 1000 * GB),      # HBM-class pool: pricey, fast
}

_MEMSYS_USD_PER_GB = {0: 0.0, 1: 8.0, 2: 20.0}

_NET = {
    "A": HierarchicalSwitch(16, 150 * GB, 6.25 * GB),
    "B": HierarchicalSwitch(16, 300 * GB, 31.25 * GB),
    "C": HierarchicalSwitch(16, 450 * GB, 62.5 * GB),
}

_BASE = {"A": _V100, "B": _A100, "C": _H100}

_GEN_COST = {
    "A": CostModel(usd_per_node=8_000, usd_per_gb_local=20,
                   usd_per_link=300, usd_per_kwh=0.12),
    "B": CostModel(usd_per_node=15_000, usd_per_gb_local=24,
                   usd_per_link=400, usd_per_kwh=0.12),
    "C": CostModel(usd_per_node=30_000, usd_per_gb_local=40,
                   usd_per_link=600, usd_per_kwh=0.12),
}


def _gpu_variant(letter: str, mem: int) -> ClusterConfig:
    cap, bw = _MEMSYS[mem]
    cost = dataclasses.replace(_GEN_COST[letter],
                               usd_per_gb_em=_MEMSYS_USD_PER_GB[mem])
    return ClusterConfig(
        name=f"{letter}{mem}",
        node=_BASE[letter].with_expansion(cap, bw),
        num_nodes=1024,
        topology=_NET[letter],
        notes=f"Table III {letter}{mem}: {_BASE[letter].name} x1024, 16-GPU pods.",
        cost=cost,
    )


DOJO = ClusterConfig(
    name="dojo",
    node=NodeConfig("DojoTray", 54_300e12, 640 * GB, 16 * TB, 66 * GB,
                    tdp_watts=15_000),
    num_nodes=64,
    topology=SingleSwitch(bw=20 * 50 * GB),
    notes="Table III: 64 trays, one-level switch, 20x50GB/s per direction.",
    cost=CostModel(usd_per_node=180_000, usd_per_gb_local=30,
                   usd_per_link=2_000, usd_per_kwh=0.12),
)

TPU_V4 = ClusterConfig(
    name="tpu-v4",
    node=NodeConfig("TPUv4", 275e12, 32 * GB, 1200 * GB, 32 * MB,
                    exp_cap=39 * GB, exp_bw=1200 * GB, tdp_watts=270),
    num_nodes=4096,
    topology=Torus(dims=(16, 16, 16), link_bw=48 * GB),
    notes="Table III: 4096 chips, 3D torus, 6x48GB/s per direction.",
    cost=CostModel(usd_per_node=9_000, usd_per_gb_local=24,
                   usd_per_gb_em=24, usd_per_link=200, usd_per_kwh=0.12),
)

TABLE_III_CLUSTERS = {
    **{f"{tier}{m}": _gpu_variant(tier, m) for tier in "ABC" for m in (0, 1, 2)},
    "dojo": DOJO,
    "tpu-v4": TPU_V4,
}


# --------------------------------------------------------------------- #
# Heterogeneous example: B-class pods, half with the mem1 expansion
# (paper §V-D perf-per-dollar discussion over a mixed fleet).
# --------------------------------------------------------------------- #

B_HYBRID_EM = ClusterSpec(
    name="b-hybrid-em",
    pods=(PodSpec(_A100, count=32, nodes_per_pod=16),
          PodSpec(_A100.with_expansion(*_MEMSYS[1]), count=32,
                  nodes_per_pod=16)),
    interconnect=_NET["B"],
    cost=dataclasses.replace(_GEN_COST["B"],
                             usd_per_gb_em=_MEMSYS_USD_PER_GB[1]),
    notes="Hetero demo: 32 plain B0 pods + 32 memory-expanded B1 pods.",
)


# --------------------------------------------------------------------- #
# Deployment target: TPU v5e (this repo's dry-run hardware constants)
# --------------------------------------------------------------------- #

V5E_PEAK_FLOPS = 197e12            # bf16 per chip
V5E_HBM_BW = 819e9                 # bytes/s
V5E_HBM_CAP = 16 * GB
V5E_LINK_BW = 50e9                 # per ICI link per direction
V5E_VMEM = 128 * MB

V5E_NODE = NodeConfig(
    name="TPUv5e",
    peak_flops=V5E_PEAK_FLOPS,
    local_cap=V5E_HBM_CAP,
    local_bw=V5E_HBM_BW,
    sram_bytes=V5E_VMEM,
    tdp_watts=200,
)

_V5E_COST = CostModel(usd_per_node=5_000, usd_per_gb_local=24,
                      usd_per_link=150, usd_per_kwh=0.12)

TPU_V5E_POD = ClusterConfig(
    name="tpu-v5e-pod",
    node=V5E_NODE,
    num_nodes=256,
    topology=Torus(dims=(16, 16), link_bw=V5E_LINK_BW),
    notes="Production single-pod mesh: 16x16 ICI torus.",
    cost=_V5E_COST,
)

TPU_V5E_MULTIPOD = ClusterConfig(
    name="tpu-v5e-2pod",
    node=V5E_NODE,
    num_nodes=512,
    topology=Torus(dims=(16, 16), link_bw=V5E_LINK_BW, dcn_bw=25e9),
    notes="Production multi-pod mesh: 2 pods x (16x16 ICI), DCN inter-pod.",
    cost=_V5E_COST,
)


def _registry() -> Dict[str, ClusterLike]:
    return {
        "dgx-a100-1k": BASELINE_DGX_A100,
        "tpu-v5e-pod": TPU_V5E_POD,
        "tpu-v5e-2pod": TPU_V5E_MULTIPOD,
        "b-hybrid-em": B_HYBRID_EM,
        **TABLE_III_CLUSTERS,
    }


def list_clusters() -> List[str]:
    """Sorted names accepted by :func:`get_cluster`."""
    return sorted(_registry())


def get_cluster(name: str) -> ClusterLike:
    registry = _registry()
    if name not in registry:
        hints = difflib.get_close_matches(name, registry, n=3, cutoff=0.4)
        suggest = f"; did you mean {' / '.join(hints)}?" if hints else ""
        raise KeyError(f"unknown cluster {name!r}{suggest} "
                       f"(available: {sorted(registry)})")
    return registry[name]
