"""Serving rules (V1xx): a ServingSpec is servable before any cell runs.

The port's copy of the JAX package's ``analysis/rules_serving.py``, held to
it diagnostic for diagnostic by ``tests/test_torch_serving.py``.
``run_study`` runs these (through the lowered
:class:`repro_torch.serving.ServingStudy`) under its ``validate=`` gate.

======  ========  =====================================================
code    severity  invariant
======  ========  =====================================================
V101    error     one KV slot + the weights fit *some* node group
V102    error     both SLO terms are positive
V103    error     the trace (and any swept rate) is non-empty, rate > 0
V104    error     a disaggregated placement keeps a decode group
======  ========  =====================================================
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.diagnostics import (Diagnostic, RuleConfig, rule,
                                        run_pack)
from repro_torch.serving.placement import DisaggregatedPlacement
from repro_torch.serving.spec import ServingSpec, is_serving_axis
from repro_torch.serving.workload import ServingWorkload


def _swept(spec: ServingSpec, path: str) -> List[Any]:
    """Values an axis sweeps onto ``path`` (empty if not swept)."""
    out: List[Any] = []
    for axis in spec.axes:
        if is_serving_axis(axis) and axis.path == path \
                and axis.mode == "set":
            out.extend(axis.values)
    return out


def _placements(spec: ServingSpec) -> List[Tuple[str, Any]]:
    """The spec's placement plus every placement-axis value."""
    out: List[Tuple[str, Any]] = [("placement", spec.placement)]
    for axis in spec.axes:
        if axis.kind == "placement":
            out += [(f"axis {axis.name!r}", v) for v in axis.values]
    return out


@rule("V101", "serving", "error",
      "per-replica KV footprint (weights + one slot) fits some node group")
def _check_kv_fits(spec: ServingSpec,
                   ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    if spec.cluster is None:
        return
    wl = ServingWorkload(spec.model, spec.serving)
    groups = spec.cluster.node_groups
    if any(wl.fits(g.node) for g in groups):
        return
    caps = ", ".join(f"{g.node.name}={g.node.total_cap / 1e9:.0f}GB"
                     for g in groups)
    yield (f"serving study {spec.name!r}",
           f"weights ({wl.weight_bytes / 1e9:.1f}GB) + one KV slot "
           f"({wl.kv_slot_bytes / 1e9:.2f}GB) over "
           f"{spec.serving.nodes_per_replica} node(s) exceed every "
           f"pod's memory ({caps}) — no replica can serve")


@rule("V102", "serving", "error",
      "SLO terms (ttft, tpot) are positive")
def _check_slo(spec: ServingSpec,
               ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    for field in ("ttft", "tpot"):
        vals = [getattr(spec.slo, field)] + _swept(spec, f"slo.{field}")
        for v in vals:
            if not v > 0:
                yield (f"serving study {spec.name!r} slo.{field}",
                       f"SLO must be > 0 seconds, got {v!r} — every "
                       "request would miss and goodput is identically 0")


@rule("V103", "serving", "error",
      "traffic trace is non-empty with a positive arrival rate")
def _check_trace(spec: ServingSpec,
                 ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    loc = f"serving study {spec.name!r} trace"
    rates = [spec.trace.rate] + _swept(spec, "trace.rate")
    for r in rates:
        if not r > 0:
            yield loc, f"arrival rate must be > 0 requests/s, got {r!r}"
    counts = [spec.trace.num_requests] + _swept(spec, "trace.num_requests")
    for n in counts:
        if not n > 0:
            yield loc, f"trace needs num_requests > 0, got {n!r}"


@rule("V104", "serving", "error",
      "disaggregated placements keep at least one decode group")
def _check_decode_group(spec: ServingSpec,
                        ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    n_groups = len(spec.cluster.node_groups) \
        if spec.cluster is not None else None
    for where, value in _placements(spec):
        if not isinstance(value, DisaggregatedPlacement):
            continue
        loc = f"serving study {spec.name!r} {where}"
        if value.decode_groups is None:
            continue
        if len(value.decode_groups) == 0:
            yield (loc, "DisaggregatedPlacement with no decode group — "
                        "the fleet can never emit a token past the first")
        elif n_groups is not None:
            bad = sorted(g for g in value.decode_groups
                         if not 0 <= g < n_groups)
            if bad:
                yield (loc, f"decode_groups {bad} out of range for the "
                            f"cluster's {n_groups} node group(s)")


def analyze_serving(spec: ServingSpec,
                    config: Optional[RuleConfig] = None) -> List[Diagnostic]:
    """Run the V1xx pack against a :class:`ServingSpec`."""
    return run_pack("serving", spec, config=config)
