"""COMET §III-C3: collective timing for one topology and one strategy.

The port's copy of the JAX package's ``core/collectives.py``.
:class:`CollectiveModel` consumes the :class:`~repro_torch.core.topology.Topology`
protocol, so a topology family outside the three built-ins prices its
collectives through its own ``collective_time_batch`` or
``collective_time``; :func:`repro_torch.core.torch_engine.comm_matrix`
falls back to it for such a topology.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.cluster import ClusterLike
from repro_torch.core.topology import Topology, _group_size


class CollectiveModel:
    """Collective timing for one cluster (or bare topology) + one
    (MP, DP, PP, EP) strategy.  Dispatches through the :class:`Topology`
    protocol; group sizing covers the four-axis product (scope ``"ep"``
    with ep == 1 keeps the legacy mapping onto the MP group, ``"dp"`` spans
    the DP x EP data group, ``"edp"`` the expert-gradient DP group, and
    ``"pp"`` carries the stage-boundary ``"p2p"`` transfers)."""

    def __init__(self, cluster: "ClusterLike | Topology", mp: int, dp: int,
                 pp: int = 1, ep: int = 1, placement=None):
        self.cluster = cluster
        # Optional placement object overriding the paper rank order for hop
        # resolution; None keeps the fixed MP→EP→DP→PP order.
        self.placement = placement
        # Use the node groups' topology (agreeing with the simulator when a
        # per-pod fabric overrides the interconnect); mixed fabrics need one
        # model per group, so refuse to pick one silently.
        topos = {g.topology for g in getattr(cluster, "node_groups", ())}
        if len(topos) > 1:
            raise ValueError(
                "cluster mixes per-pod fabrics; build one CollectiveModel "
                "per NodeGroup.topology (as the simulator does) instead of "
                "timing over the shared interconnect only")
        self.topo = topos.pop() if topos \
            else getattr(cluster, "topology", cluster)
        self.mp = max(1, mp)
        self.dp = max(1, dp)
        self.pp = max(1, pp)
        self.ep = max(1, ep)

    def time(self, collective: str, size: float, scope: str) -> float:
        group = _group_size(scope, self.mp, self.dp, self.pp, self.ep)
        if group <= 1 or size <= 0:
            return 0.0
        time_fn = getattr(self.topo, "collective_time", None)
        if time_fn is None:
            raise TypeError(
                f"{type(self.topo).__name__} does not implement the "
                "Topology protocol (missing collective_time)")
        if self.placement is None:
            # Topology implementations without the placement keyword.
            return time_fn(collective, size, scope, self.mp, self.dp,
                           pp=self.pp, ep=self.ep)
        return time_fn(collective, size, scope, self.mp, self.dp,
                       pp=self.pp, ep=self.ep, placement=self.placement)

    def time_batch(self, collectives, sizes, scopes) -> np.ndarray:
        """Times for a whole event table at once (compiled study engine).

        ``collectives`` / ``sizes`` / ``scopes`` are parallel sequences —
        one entry per communication event.  Events are grouped by
        (collective, scope) and dispatched to the topology's
        ``collective_time_batch`` (one vectorized call per group); a
        downstream family without the batched method falls back to
        per-event :meth:`time` calls, so correctness never depends on it.
        """
        out = np.zeros(len(sizes))
        if not len(sizes):
            return out
        sizes = np.asarray(sizes, dtype=float)
        groups: "dict[tuple, list]" = {}
        for i, (c, s) in enumerate(zip(collectives, scopes)):
            groups.setdefault((c, s), []).append(i)
        batch_fn = getattr(self.topo, "collective_time_batch", None)
        for (c, scope), idx in groups.items():
            if _group_size(scope, self.mp, self.dp, self.pp, self.ep) <= 1:
                continue                       # stays 0.0, as in time()
            if batch_fn is not None:
                out[idx] = batch_fn(c, sizes[idx], scope, self.mp, self.dp,
                                    pp=self.pp, ep=self.ep,
                                    placement=self.placement)
            else:
                out[idx] = [self.time(c, float(s), scope)
                            for s in sizes[idx]]
        return out
