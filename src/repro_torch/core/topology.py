"""Network topologies and the collective formulas COMET prices on them.

The port's copy of the JAX package's ``core/topology.py``, held equal to it
by ``tests/test_torch_core.py``. COMET §III-C3 models collectives
analytically per topology family. :class:`Topology` is the structural
protocol (pod size, per-hop bandwidth and latency, functional updates, and
``collective_time``) that :mod:`repro_torch.core.collectives` and
:mod:`repro_torch.core.torch_engine` consume; the three families are
:class:`HierarchicalSwitch`, :class:`Torus` and :class:`SingleSwitch`,
frozen dataclasses whose value hash groups environments.

Rank placement follows the paper's order: MP groups fill consecutive ranks
(pods first), then EP, then DP, with PP stages outermost. ``collective_time``
takes an optional ``placement`` object with ``group_placement`` and
``p2p_crosses_pod``; ``None`` means the paper's order. All times are
seconds for one collective of ``size`` bytes issued by every member of the
group.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Protocol, Tuple, runtime_checkable

import numpy as np

# --------------------------------------------------------------------- #
# Ring / all-to-all primitives (shared by every topology family)
# --------------------------------------------------------------------- #


def ring_allreduce(size: float, n: int, bw: float, lat: float) -> float:
    """Logical-ring all-reduce: 2(n-1)/n * size / bw + 2(n-1) hops."""
    if n <= 1 or size <= 0:
        return 0.0
    return 2 * (n - 1) / n * size / bw + 2 * (n - 1) * lat


def ring_allgather(size: float, n: int, bw: float, lat: float) -> float:
    """All-gather / reduce-scatter: (n-1)/n * size / bw (one ring pass)."""
    if n <= 1 or size <= 0:
        return 0.0
    return (n - 1) / n * size / bw + (n - 1) * lat


def all_to_all(size: float, n: int, bw: float, lat: float) -> float:
    """All-to-all: each node sends size*(n-1)/n bytes through its link."""
    if n <= 1 or size <= 0:
        return 0.0
    return (n - 1) / n * size / bw + lat


def flat_time(collective: str, size: float, n: int, bw: float,
              lat: float) -> float:
    """One-level (flat) network: dispatch a collective to its ring form."""
    if collective == "all-reduce":
        return ring_allreduce(size, n, bw, lat)
    if collective in ("all-gather", "reduce-scatter"):
        return ring_allgather(size, n, bw, lat)
    if collective == "all-to-all":
        return all_to_all(size, n, bw, lat)
    if collective == "p2p":   # one point-to-point transfer (PP stage hop)
        return size / bw + lat if size > 0 else 0.0
    raise ValueError(f"unknown collective {collective!r}")


# --- batched variants (same formulas over a size *array*) -------------- #
# Consumed by the compiled study engine: one call times every event of a
# (collective, scope) group at once.  The arithmetic mirrors the scalar
# helpers term for term, so batch and scalar paths agree to float
# round-off.

def ring_allreduce_batch(sizes: np.ndarray, n: int, bw: float,
                         lat: float) -> np.ndarray:
    if n <= 1:
        return np.zeros(np.shape(sizes))
    t = 2 * (n - 1) / n * sizes / bw + 2 * (n - 1) * lat
    return np.where(sizes > 0, t, 0.0)


def ring_allgather_batch(sizes: np.ndarray, n: int, bw: float,
                         lat: float) -> np.ndarray:
    if n <= 1:
        return np.zeros(np.shape(sizes))
    t = (n - 1) / n * sizes / bw + (n - 1) * lat
    return np.where(sizes > 0, t, 0.0)


def all_to_all_batch(sizes: np.ndarray, n: int, bw: float,
                     lat: float) -> np.ndarray:
    if n <= 1:
        return np.zeros(np.shape(sizes))
    t = (n - 1) / n * sizes / bw + lat
    return np.where(sizes > 0, t, 0.0)


def flat_time_batch(collective: str, sizes: np.ndarray, n: int, bw: float,
                    lat: float) -> np.ndarray:
    """Batched :func:`flat_time`: dispatch one (collective, scope) group."""
    if collective == "all-reduce":
        return ring_allreduce_batch(sizes, n, bw, lat)
    if collective in ("all-gather", "reduce-scatter"):
        return ring_allgather_batch(sizes, n, bw, lat)
    if collective == "all-to-all":
        return all_to_all_batch(sizes, n, bw, lat)
    if collective == "p2p":
        return np.where(sizes > 0, sizes / bw + lat, 0.0)
    raise ValueError(f"unknown collective {collective!r}")


def _group_size(scope: str, mp: int, dp: int, pp: int = 1, ep: int = 1) -> int:
    """Communication-group size for a scope under the four-axis product.

    ``"ep"`` with ep == 1 keeps the legacy mapping onto the MP group;
    ``"dp"`` spans the full DP x EP data group (EP ranks replicate dense
    weights); ``"edp"`` is the expert-gradient group (DP only)."""
    if scope == "mp":
        return mp
    if scope == "ep":
        return ep if ep > 1 else mp
    if scope == "pp":
        return pp
    if scope == "edp":
        return dp
    return dp * ep


# --------------------------------------------------------------------- #
# Rank placement
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class GroupPlacement:
    """How a communication group maps onto pods.

    intra: members co-located per pod; inter: number of pods spanned.
    group size = intra * inter.
    """

    intra: int
    inter: int


def _strided(group: int, stride: int, pod_size: int) -> GroupPlacement:
    """Placement of a group whose peers stride ``stride`` consecutive
    ranks apart (pods fill rank-major)."""
    if stride >= pod_size:
        return GroupPlacement(intra=1, inter=group)
    per_pod = max(1, pod_size // stride)
    per_pod = min(per_pod, group)
    return GroupPlacement(intra=per_pod, inter=max(1, group // per_pod))


@functools.lru_cache(maxsize=65536)
def placement(scope: str, mp: int, dp: int, pod_size: int,
              pp: int = 1, ep: int = 1) -> GroupPlacement:
    """Paper's placement, extended to the four-axis mesh: MP consecutive
    (fills pods first), then EP, then DP, with PP stages outermost.

    Memoized: hop resolution is re-requested by every ``collective_time``
    call (one per communication event per cell), but only ever depends on
    this small integer tuple — the cache turns the per-event cost into a
    dict probe.  ``GroupPlacement`` is frozen, so sharing is safe."""
    if scope == "mp" or (scope == "ep" and ep <= 1):
        # legacy: the EP group rode the MP group
        if mp <= pod_size:
            return GroupPlacement(intra=mp, inter=1)
        return GroupPlacement(intra=pod_size, inter=mp // pod_size)
    if scope == "ep":
        return _strided(ep, mp, pod_size)
    if scope == "pp":
        return _strided(pp, mp * ep * dp, pod_size)
    if scope == "edp":
        return _strided(dp, mp * ep, pod_size)
    # dp: the full DP x EP data group, peers stride by mp
    return _strided(dp * ep, mp, pod_size)


class _PaperOrder:
    """Default hop resolution: the module-level paper rank order.  Stands
    in whenever ``collective_time`` is called without a placement, so the
    families have exactly one code path."""

    @staticmethod
    def group_placement(scope: str, mp: int, dp: int, pod_size: int,
                        pp: int = 1, ep: int = 1) -> "GroupPlacement":
        return placement(scope, mp, dp, pod_size, pp, ep)

    @staticmethod
    def p2p_crosses_pod(mp: int, dp: int, pod_size: int,
                        pp: int = 1, ep: int = 1) -> bool:
        return mp * ep * dp * pp > pod_size


_PAPER_ORDER = _PaperOrder()


# --------------------------------------------------------------------- #
# The protocol
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Hop:
    """One network level as seen by a node: per-node-per-direction
    bandwidth (bytes/s) and per-message latency (s)."""

    name: str
    bw: float
    latency: float


@runtime_checkable
class Topology(Protocol):
    """Structural interface every topology family implements.

    Consumers (``CollectiveModel``, the simulator, ``CostModel``) talk to
    this protocol only; concrete families are plain frozen dataclasses.
    """

    @property
    def pod_size(self) -> int: ...

    @property
    def hops(self) -> Tuple[Hop, ...]: ...

    @property
    def links_per_node(self) -> int: ...

    def collective_time(self, collective: str, size: float, scope: str,
                        mp: int, dp: int, pp: int = 1, ep: int = 1,
                        placement=None) -> float: ...

    # Families may additionally implement the batched form
    #   collective_time_batch(collective, sizes, scope, mp, dp, pp, ep,
    #                         placement) -> np.ndarray
    # (one (collective, scope) group, a whole size array at once).  It is
    # deliberately *not* part of the structural protocol: downstream
    # families that predate it keep passing isinstance checks, and the
    # compiled engine falls back to per-event scalar calls when absent.

    def with_(self, **updates): ...

    def scaled(self, **factors): ...


class TopologyBase:
    """Functional-update mixin shared by the concrete families."""

    def with_(self, **updates):
        """Return a copy with the named fields replaced."""
        return dataclasses.replace(self, **updates)

    def scaled(self, **factors):
        """Return a copy with each named field multiplied by its factor."""
        return dataclasses.replace(
            self, **{f: getattr(self, f) * v for f, v in factors.items()})


# --------------------------------------------------------------------- #
# Concrete families
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class HierarchicalSwitch(TopologyBase):
    """Two-level switch: fast intra-pod + slower inter-pod (Fig. 7)."""

    pod_size: int
    intra_bw: float                # per-node per-direction, bytes/s
    inter_bw: float
    intra_latency: float = 1e-6
    inter_latency: float = 5e-6

    def scaled(self, intra: float = 1.0, inter: float = 1.0) -> "HierarchicalSwitch":
        return dataclasses.replace(
            self, intra_bw=self.intra_bw * intra, inter_bw=self.inter_bw * inter)

    @property
    def hops(self) -> Tuple[Hop, ...]:
        return (Hop("intra", self.intra_bw, self.intra_latency),
                Hop("inter", self.inter_bw, self.inter_latency))

    @property
    def links_per_node(self) -> int:
        return 2                   # one intra-pod link + one inter-pod uplink

    def collective_time(self, collective: str, size: float, scope: str,
                        mp: int, dp: int, pp: int = 1, ep: int = 1,
                        placement=None) -> float:
        order = placement if placement is not None else _PAPER_ORDER
        if _group_size(scope, mp, dp, pp, ep) <= 1 or size <= 0:
            return 0.0
        if collective == "p2p":
            # Stage neighbours sit mp*ep*dp ranks apart.  Unless the whole
            # pp-stage mesh fits inside one pod, some stage boundary
            # crosses pods — and the simulator gates on the slowest stage,
            # so bill the inter-pod hop.
            if not order.p2p_crosses_pod(mp, dp, self.pod_size, pp, ep):
                return size / self.intra_bw + self.intra_latency
            return size / self.inter_bw + self.inter_latency
        pl = order.group_placement(scope, mp, dp, self.pod_size, pp, ep)
        p, q = pl.intra, pl.inter
        if q <= 1:  # fully intra-pod
            return flat_time(collective, size, p, self.intra_bw,
                             self.intra_latency)
        if p <= 1:  # fully inter-pod
            return flat_time(collective, size, q, self.inter_bw,
                             self.inter_latency)
        # Hierarchical collective [10],[58]: intra RS -> inter stage on
        # size/p -> intra AG.
        if collective == "all-reduce":
            t_intra = 2 * ring_allgather(size, p, self.intra_bw,
                                         self.intra_latency)
            t_inter = ring_allreduce(size / p, q, self.inter_bw,
                                     self.inter_latency)
            return t_intra + t_inter
        if collective in ("all-gather", "reduce-scatter"):
            t_intra = ring_allgather(size, p, self.intra_bw,
                                     self.intra_latency)
            t_inter = ring_allgather(size / p, q, self.inter_bw,
                                     self.inter_latency)
            return t_intra + t_inter
        if collective == "all-to-all":
            # Traffic share crossing pod boundaries vs. staying local.
            n = p * q
            inter_frac = (n - p) / n
            intra_frac = (p - 1) / n
            t_inter = inter_frac * size / self.inter_bw + self.inter_latency
            t_intra = intra_frac * size / self.intra_bw + self.intra_latency
            return max(t_inter, t_intra)
        raise ValueError(f"unknown collective {collective!r}")

    def collective_time_batch(self, collective: str, sizes: np.ndarray,
                              scope: str, mp: int, dp: int, pp: int = 1,
                              ep: int = 1, placement=None) -> np.ndarray:
        """Batched :meth:`collective_time`: same branches, a size array."""
        order = placement if placement is not None else _PAPER_ORDER
        sizes = np.asarray(sizes, dtype=float)
        if _group_size(scope, mp, dp, pp, ep) <= 1:
            return np.zeros(sizes.shape)
        if collective == "p2p":
            if not order.p2p_crosses_pod(mp, dp, self.pod_size, pp, ep):
                return np.where(sizes > 0,
                                sizes / self.intra_bw + self.intra_latency,
                                0.0)
            return np.where(sizes > 0,
                            sizes / self.inter_bw + self.inter_latency, 0.0)
        pl = order.group_placement(scope, mp, dp, self.pod_size, pp, ep)
        p, q = pl.intra, pl.inter
        if q <= 1:
            return flat_time_batch(collective, sizes, p, self.intra_bw,
                                   self.intra_latency)
        if p <= 1:
            return flat_time_batch(collective, sizes, q, self.inter_bw,
                                   self.inter_latency)
        if collective == "all-reduce":
            return 2 * ring_allgather_batch(sizes, p, self.intra_bw,
                                            self.intra_latency) \
                + ring_allreduce_batch(sizes / p, q, self.inter_bw,
                                       self.inter_latency)
        if collective in ("all-gather", "reduce-scatter"):
            return ring_allgather_batch(sizes, p, self.intra_bw,
                                        self.intra_latency) \
                + ring_allgather_batch(sizes / p, q, self.inter_bw,
                                       self.inter_latency)
        if collective == "all-to-all":
            n = p * q
            inter_frac = (n - p) / n
            intra_frac = (p - 1) / n
            t_inter = inter_frac * sizes / self.inter_bw + self.inter_latency
            t_intra = intra_frac * sizes / self.intra_bw + self.intra_latency
            return np.where(sizes > 0, np.maximum(t_inter, t_intra), 0.0)
        raise ValueError(f"unknown collective {collective!r}")


@dataclasses.dataclass(frozen=True)
class Torus(TopologyBase):
    """k-dimensional torus (TPU): per-direction link bandwidth per dim."""

    dims: Tuple[int, ...]
    link_bw: float
    latency: float = 1e-6
    # Optional DCN uplink for multi-pod torus clusters (v5e pods over DCN).
    dcn_bw: float = 0.0
    dcn_latency: float = 10e-6

    @property
    def pod_size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def hops(self) -> Tuple[Hop, ...]:
        out = (Hop("link", self.link_bw, self.latency),)
        if self.dcn_bw:
            out += (Hop("dcn", self.dcn_bw, self.dcn_latency),)
        return out

    @property
    def links_per_node(self) -> int:
        return 2 * len(self.dims) + (1 if self.dcn_bw else 0)

    def collective_time(self, collective: str, size: float, scope: str,
                        mp: int, dp: int, pp: int = 1, ep: int = 1,
                        placement=None) -> float:
        order = placement if placement is not None else _PAPER_ORDER
        group = _group_size(scope, mp, dp, pp, ep)
        if group <= 1 or size <= 0:
            return 0.0
        if collective == "p2p":
            # One hop to the neighbouring stage; DCN when the pp-stage mesh
            # spills past one torus pod (worst boundary gates, as above).
            if self.dcn_bw and order.p2p_crosses_pod(mp, dp, self.pod_size,
                                                     pp, ep):
                return size / self.dcn_bw + self.dcn_latency
            return size / self.link_bw + self.latency
        return self._time(collective, size, group)

    def collective_time_batch(self, collective: str, sizes: np.ndarray,
                              scope: str, mp: int, dp: int, pp: int = 1,
                              ep: int = 1, placement=None) -> np.ndarray:
        """Batched :meth:`collective_time`: same branches, a size array."""
        order = placement if placement is not None else _PAPER_ORDER
        sizes = np.asarray(sizes, dtype=float)
        group = _group_size(scope, mp, dp, pp, ep)
        if group <= 1:
            return np.zeros(sizes.shape)
        if collective == "p2p":
            if self.dcn_bw and order.p2p_crosses_pod(mp, dp, self.pod_size,
                                                     pp, ep):
                t = sizes / self.dcn_bw + self.dcn_latency
            else:
                t = sizes / self.link_bw + self.latency
            return np.where(sizes > 0, t, 0.0)
        return self._time_batch(collective, sizes, group)

    def _time_batch(self, collective: str, sizes: np.ndarray,
                    group: int) -> np.ndarray:
        """Batched :meth:`_time`: the same per-dimension ring sweeps over a
        size array (every size-independent decision — dims, DCN spill — is
        identical across the batch)."""
        pod = self.pod_size
        bw = 2 * self.link_bw
        if self.dcn_bw and group > pod:
            q = math.ceil(group / pod)
            if collective == "all-reduce":
                t_in = self._time_batch("reduce-scatter", sizes, pod) \
                     + self._time_batch("all-gather", sizes, pod)
                t_out = ring_allreduce_batch(sizes / pod, q, self.dcn_bw,
                                             self.dcn_latency)
                return t_in + t_out
            t_in = self._time_batch(collective, sizes, pod)
            t_out = flat_time_batch(collective, sizes / pod, q, self.dcn_bw,
                                    self.dcn_latency)
            return t_in + t_out
        dims = []
        rem = min(group, pod)
        for d in self.dims:
            if rem <= 1:
                break
            use = min(d, rem)
            dims.append(use)
            rem = max(1, rem // use)
        if not dims:
            return np.zeros(sizes.shape)
        if collective == "all-reduce":
            t, s = np.zeros(sizes.shape), sizes
            for d in dims:
                t = t + ring_allgather_batch(s, d, bw, self.latency)
                s = s / d
            for d in reversed(dims):
                s = s * d
                t = t + ring_allgather_batch(s, d, bw, self.latency)
            return t
        if collective in ("all-gather", "reduce-scatter"):
            t, s = np.zeros(sizes.shape), sizes
            for d in dims:
                t = t + ring_allgather_batch(s, d, bw, self.latency)
                s = s / d
            return t
        if collective == "all-to-all":
            n = 1
            for d in dims:
                n *= d
            return all_to_all_batch(sizes, n, bw * len(dims), self.latency)
        raise ValueError(f"unknown collective {collective!r}")

    def _time(self, collective: str, size: float, group: int) -> float:
        """Multi-dimensional bucket algorithm: per-dimension ring stages.

        Bidirectional links -> ring uses both directions (2x link bw).
        Groups smaller than the full torus use as many dims as needed
        (mesh-axis-major placement)."""
        pod = self.pod_size
        bw = 2 * self.link_bw
        if self.dcn_bw and group > pod:
            # group spans pods over DCN: hierarchical (torus intra + DCN flat)
            q = math.ceil(group / pod)
            if collective == "all-reduce":
                t_in = self._time("reduce-scatter", size, pod) \
                     + self._time("all-gather", size, pod)
                t_out = ring_allreduce(size / pod, q, self.dcn_bw,
                                       self.dcn_latency)
                return t_in + t_out
            t_in = self._time(collective, size, pod)
            t_out = flat_time(collective, size / pod, q, self.dcn_bw,
                              self.dcn_latency)
            return t_in + t_out
        # Decompose the group across torus dims (row-major).
        dims = []
        rem = min(group, pod)
        for d in self.dims:
            if rem <= 1:
                break
            use = min(d, rem)
            dims.append(use)
            rem = max(1, rem // use)
        if not dims:
            return 0.0
        if collective == "all-reduce":
            t, s = 0.0, size
            for d in dims:  # reduce-scatter sweep
                t += ring_allgather(s, d, bw, self.latency)
                s /= d
            for d in reversed(dims):  # all-gather sweep
                s *= d
                t += ring_allgather(s, d, bw, self.latency)
            return t
        if collective in ("all-gather", "reduce-scatter"):
            t, s = 0.0, size
            for d in dims:
                t += ring_allgather(s, d, bw, self.latency)
                s /= d
            return t
        if collective == "all-to-all":
            n = 1
            for d in dims:
                n *= d
            return all_to_all(size, n, bw * len(dims), self.latency)
        raise ValueError(f"unknown collective {collective!r}")


@dataclasses.dataclass(frozen=True)
class SingleSwitch(TopologyBase):
    """One logical switch delivering ``bw`` per node (Dojo model)."""

    bw: float
    latency: float = 1e-6

    @property
    def pod_size(self) -> int:  # flat network: one "pod"
        return 1 << 30

    @property
    def hops(self) -> Tuple[Hop, ...]:
        return (Hop("switch", self.bw, self.latency),)

    @property
    def links_per_node(self) -> int:
        return 1

    def collective_time(self, collective: str, size: float, scope: str,
                        mp: int, dp: int, pp: int = 1, ep: int = 1,
                        placement=None) -> float:
        group = _group_size(scope, mp, dp, pp, ep)
        if group <= 1 or size <= 0:
            return 0.0
        return flat_time(collective, size, group, self.bw, self.latency)

    def collective_time_batch(self, collective: str, sizes: np.ndarray,
                              scope: str, mp: int, dp: int, pp: int = 1,
                              ep: int = 1, placement=None) -> np.ndarray:
        """Batched :meth:`collective_time`: flat network, a size array."""
        sizes = np.asarray(sizes, dtype=float)
        group = _group_size(scope, mp, dp, pp, ep)
        if group <= 1:
            return np.zeros(sizes.shape)
        return flat_time_batch(collective, sizes, group, self.bw,
                               self.latency)
