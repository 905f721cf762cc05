"""Prefill/decode disaggregation as a first-class Placement.

The port's copy of the JAX package's ``serving/placement.py``.

:class:`ColocatedPlacement` and :class:`DisaggregatedPlacement`
implement the :class:`repro_torch.core.placement.Placement` protocol (so
``placement_axis`` sweeps them and study records carry their labels) and
add one serving-specific hook: :meth:`phase_plan`, mapping the serving
*phases* onto a cluster's heterogeneous pod groups the way
``assign_stages`` maps pipeline stages.

Disaggregation routes every request's KV cache from its prefill pod to
its decode pod; :func:`kv_transfer_time` prices that hand-off over the
pod fabric's outermost hop (prefill and decode pods are distinct pods by
construction).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.core.cluster import NodeGroup
from repro_torch.core.placement import _PaperOrderMixin
from repro_torch.core.topology import Topology


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """Node-group indices serving each phase.  Colocated fleets list
    every group under both phases; disaggregated fleets partition them."""

    prefill: Tuple[int, ...]
    decode: Tuple[int, ...]

    @property
    def disaggregated(self) -> bool:
        return set(self.prefill) != set(self.decode)


@dataclasses.dataclass(frozen=True)
class ColocatedPlacement(_PaperOrderMixin):
    """Every pod group hosts full replicas that both prefill and decode
    (the ``repro_torch.serve.engine`` behavior: admissions stall the batch)."""

    @property
    def label(self) -> str:
        return "colocated"

    def phase_plan(self, groups: Sequence[NodeGroup]) -> PhasePlan:
        every = tuple(range(len(groups)))
        return PhasePlan(prefill=every, decode=every)

    def assign_stages(self, stage_bytes: Sequence[float],
                      groups: Sequence[NodeGroup],
                      nodes_per_stage: int) -> Optional[Tuple[int, ...]]:
        return None

    def instance_groups(self, fits: Sequence[bool]) -> Tuple[int, ...]:
        return tuple(range(len(fits)))


@dataclasses.dataclass(frozen=True)
class DisaggregatedPlacement(_PaperOrderMixin):
    """Prefill pods vs decode pods over heterogeneous pod groups.

    ``decode_groups`` pins the node-group indices that decode (the rest
    prefill); ``None`` auto-assigns — the roomiest groups (largest
    per-node ``total_cap``, i.e. the EM pods, which hold the most KV
    slots) decode, at least one group per phase.  On a single-group
    (homogeneous) cluster both phases share group 0 and the evaluator
    splits its *nodes* by ``prefill_frac`` instead.

    An explicitly empty ``decode_groups`` is a fleet that can never emit
    a token past the first — the V104 analysis rule rejects it."""

    decode_groups: Optional[Tuple[int, ...]] = None
    prefill_frac: float = 0.5

    def __post_init__(self) -> None:
        if not 0.0 < self.prefill_frac < 1.0:
            raise ValueError(f"prefill_frac must be in (0, 1), "
                             f"got {self.prefill_frac}")

    @property
    def label(self) -> str:
        if self.decode_groups is None:
            return "disaggregated"
        return "disaggregated[" + \
            ",".join(map(str, self.decode_groups)) + "]"

    def phase_plan(self, groups: Sequence[NodeGroup]) -> PhasePlan:
        every = tuple(range(len(groups)))
        if self.decode_groups is not None:
            decode = tuple(self.decode_groups)
            bad = [g for g in decode if not 0 <= g < len(groups)]
            if bad:
                raise ValueError(
                    f"DisaggregatedPlacement decode_groups {sorted(bad)} "
                    f"out of range for {len(groups)} node group(s)")
            prefill = tuple(i for i in every if i not in decode)
            return PhasePlan(prefill=prefill or decode, decode=decode)
        if len(groups) == 1:
            return PhasePlan(prefill=every, decode=every)
        # Roomiest groups decode; split the order in half, decode side
        # first, keeping at least one group per phase.
        order = sorted(every, key=lambda i: (groups[i].node.total_cap,
                                             groups[i].num_nodes),
                       reverse=True)
        n_dec = max(1, len(groups) // 2)
        decode = tuple(sorted(order[:n_dec]))
        prefill = tuple(sorted(order[n_dec:]))
        return PhasePlan(prefill=prefill, decode=decode)

    def assign_stages(self, stage_bytes: Sequence[float],
                      groups: Sequence[NodeGroup],
                      nodes_per_stage: int) -> Optional[Tuple[int, ...]]:
        return None

    def instance_groups(self, fits: Sequence[bool]) -> Tuple[int, ...]:
        return tuple(range(len(fits)))


COLOCATED = ColocatedPlacement()
DISAGGREGATED = DisaggregatedPlacement()

_SERVING_PLACEMENTS = {
    "colocated": COLOCATED,
    "disaggregated": DISAGGREGATED,
}


def list_serving_placements() -> Tuple[str, ...]:
    return tuple(sorted(_SERVING_PLACEMENTS))


def get_serving_placement(obj: object) -> ColocatedPlacement | DisaggregatedPlacement:
    """Coerce a serving placement name or instance."""
    if isinstance(obj, (ColocatedPlacement, DisaggregatedPlacement)):
        return obj
    if isinstance(obj, str):
        if obj not in _SERVING_PLACEMENTS:
            raise KeyError(
                f"unknown serving placement {obj!r} "
                f"(available: {list(list_serving_placements())})")
        return _SERVING_PLACEMENTS[obj]
    raise TypeError("expected a serving Placement or its name, "
                    f"got {type(obj).__name__}")


def kv_transfer_time(size_bytes: float, topology: Topology) -> float:
    """Price one request's KV hand-off (prefill pod -> decode pod) over
    the fabric's outermost (slowest) hop."""
    hop = topology.hops[-1]
    return size_bytes / hop.bw + hop.latency
