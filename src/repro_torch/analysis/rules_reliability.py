"""Reliability rules (Y1xx): failure models and traces are sane before
any goodput column is computed or any fault is injected.

The port's copy of the JAX package's ``analysis/rules_reliability.py``,
held to it diagnostic for diagnostic by ``tests/test_torch_reliability.py``.
``run_study`` runs these under its ``validate=`` gate whenever a
:class:`repro_torch.core.study.StudySpec` carries a ``reliability``
:class:`~repro_torch.reliability.FailureModel` (closed-form goodput
columns) or a lowered :class:`repro_torch.fleet.FleetStudy`'s source
:class:`~repro_torch.fleet.FleetSpec` carries an enabled ``failures``
:class:`~repro_torch.reliability.FailureTrace` (fault injection); the
registry sweep command line runs them over ``dse.reliability_study`` and
``dse.reliability_fleet_study``.

======  ========  =====================================================
code    severity  invariant
======  ========  =====================================================
Y101    error     MTBF/MTTR/checkpoint-bw/restore-bw (and every swept
                  value) are positive and finite where required
Y102    error     a fixed checkpoint interval is > 0 and shorter than
                  the run it checkpoints
Y103    error     an enabled failure trace can actually produce events
Y104    error     explicit failure events name a real node group and a
                  blast radius within it
Y105    warning   a Poisson trace draws at least one failure over this
                  cluster and horizon (zero draws = the failure-aware
                  columns silently equal the failure-free ones)
======  ========  =====================================================
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.diagnostics import (Diagnostic, RuleConfig, rule,
                                        run_pack)
from repro_torch.reliability.model import FailureModel
from repro_torch.reliability.trace import FailureTrace

_REL_PREFIX = "reliability."
_FAIL_PREFIX = "fail."


def _model(spec: Any) -> Optional[FailureModel]:
    m = getattr(spec, "reliability", None)
    return m if isinstance(m, FailureModel) else None


def _trace(spec: Any) -> Optional[FailureTrace]:
    t = getattr(spec, "failures", None)
    return t if isinstance(t, FailureTrace) else None


def _swept(spec: Any, field: str) -> List[Any]:
    """Values any axis sweeps onto the failure model/trace field
    (``reliability.<field>`` on a StudySpec, ``fail.<field>`` on a
    FleetSpec)."""
    out: List[Any] = []
    for axis in getattr(spec, "axes", ()):
        path = getattr(axis, "path", None)
        if path in (_REL_PREFIX + field, _FAIL_PREFIX + field) \
                and getattr(axis, "mode", "set") == "set":
            out.extend(axis.values)
    return out


def _group_sizes(spec: Any) -> List[int]:
    cluster = getattr(spec, "cluster", None)
    if cluster is None:
        return []
    return [g.num_nodes for g in cluster.node_groups]


@rule("Y101", "reliability", "error",
      "failure-model rates and bandwidths are positive and finite")
def _check_rates(spec: Any,
                 ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    name = getattr(spec, "name", "?")
    model = _model(spec)
    if model is not None:
        loc = f"study {name!r} reliability"
        for v in [model.mtbf_hours] + _swept(spec, "mtbf_hours"):
            if not v > 0 or v != v:
                yield (loc, f"mtbf_hours must be > 0 (inf disables "
                            f"failures), got {v!r}")
        for v in [model.mttr_hours] + _swept(spec, "mttr_hours"):
            if not (v >= 0 and math.isfinite(v)):
                yield loc, f"mttr_hours must be finite and >= 0, got {v!r}"
        for v in [model.ckpt_bw] + _swept(spec, "ckpt_bw"):
            if not (v > 0 and math.isfinite(v)):
                yield (loc, f"ckpt_bw must be finite and > 0 bytes/s, got "
                            f"{v!r} — every checkpoint would stall forever")
        for v in [model.restore_bw] + _swept(spec, "restore_bw"):
            if not (v >= 0 and math.isfinite(v)):
                yield (loc, f"restore_bw must be finite and >= 0 "
                            f"(0 = ckpt_bw), got {v!r}")
    trace = _trace(spec)
    if trace is not None and trace.kind == "poisson":
        loc = f"fleet study {name!r} failures"
        for v in [trace.mtbf_hours] + _swept(spec, "mtbf_hours"):
            if not v > 0 or v != v:
                yield loc, f"mtbf_hours must be > 0, got {v!r}"
        for v in [trace.mttr_hours] + _swept(spec, "mttr_hours"):
            if not (v >= 0 and math.isfinite(v)):
                yield loc, f"mttr_hours must be finite and >= 0, got {v!r}"


@rule("Y102", "reliability", "error",
      "a fixed checkpoint interval is > 0 and shorter than the run")
def _check_interval(spec: Any,
                    ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    name = getattr(spec, "name", "?")
    model = _model(spec)
    if model is None:
        return
    loc = f"study {name!r} reliability"
    run_s = model.run_hours * 3600.0
    for v in [model.interval_s] + _swept(spec, "interval_s"):
        if not v >= 0 or v != v:
            yield (loc, f"interval_s must be >= 0 (0 = Young–Daly), "
                        f"got {v!r}")
        elif v >= run_s:
            yield (loc,
                   f"fixed checkpoint interval {v:g}s is not shorter than "
                   f"the {model.run_hours:g}h run ({run_s:g}s) — the run "
                   "would never commit a checkpoint")


@rule("Y103", "reliability", "error",
      "an enabled failure trace can produce events")
def _check_trace_events(spec: Any,
                        ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    name = getattr(spec, "name", "?")
    trace = _trace(spec)
    if trace is None or trace.kind == "none":
        return
    loc = f"fleet study {name!r} failures"
    if trace.kind == "explicit" and not trace.events:
        yield (loc, "explicit failure trace has no events — use "
                    "kind='none' to disable failures")
        return
    if trace.kind == "poisson" and not trace.horizon_hours > 0:
        yield (loc, f"poisson trace needs horizon_hours > 0, got "
                    f"{trace.horizon_hours!r}")


@rule("Y105", "reliability", "warning",
      "a Poisson failure trace draws at least one event over this "
      "cluster and horizon")
def _check_zero_draw(spec: Any,
                     ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    name = getattr(spec, "name", "?")
    trace = _trace(spec)
    if trace is None or trace.kind != "poisson" or not trace.enabled \
            or not trace.horizon_hours > 0:
        return
    sizes = _group_sizes(spec)
    if sizes and not trace.materialize(sizes):
        yield (f"fleet study {name!r} failures",
               f"poisson trace (mtbf={trace.mtbf_hours:g}h over "
               f"{sum(sizes)} nodes, horizon={trace.horizon_hours:g}h) "
               "drew zero failures — the failure-aware columns will "
               "equal the failure-free ones")


@rule("Y104", "reliability", "error",
      "explicit failure events name a real group and a blast radius "
      "within it")
def _check_blast(spec: Any,
                 ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    name = getattr(spec, "name", "?")
    trace = _trace(spec)
    if trace is None or trace.kind != "explicit" or not trace.events:
        return
    loc = f"fleet study {name!r} failures"
    sizes = _group_sizes(spec)
    for ev in trace.events:
        if sizes and ev.group >= len(sizes):
            yield (loc,
                   f"event at t={ev.time:g}s names group {ev.group} but "
                   f"the cluster has {len(sizes)} group(s)")
        elif sizes and ev.nodes > sizes[ev.group]:
            yield (loc,
                   f"event at t={ev.time:g}s downs {ev.nodes} nodes but "
                   f"group {ev.group} only has {sizes[ev.group]}")


def analyze_reliability(spec: Any,
                        config: Optional[RuleConfig] = None
                        ) -> List[Diagnostic]:
    """Run the Y1xx pack against a StudySpec carrying a ``reliability``
    FailureModel or a FleetSpec carrying a ``failures`` FailureTrace."""
    return run_pack("reliability", spec, config=config)
