"""Fleet rules (F1xx): a FleetSpec can run its timeline before any cell
simulates.

The port's copy of the JAX package's ``analysis/rules_fleet.py``, held to
it diagnostic for diagnostic by ``tests/test_torch_fleet.py`` and
``tests/test_torch_analysis.py``. ``run_study`` runs these (through the
lowered :class:`repro_torch.fleet.FleetStudy`) under its ``validate=``
gate; the registry sweep command line runs them over the default
``dse.fleet_study``.

======  ========  =====================================================
code    severity  invariant
======  ========  =====================================================
F101    error     every job template can hold one instance in some group
F102    error     the trace (and any swept rate) is positive/non-empty
F103    error     priority/burst sanity: burst jobs are single-instance
                  with a window inside their iteration budget, widths
                  divisible by mp
F104    error     preemption/resize costs are finite and positive
======  ========  =====================================================
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.diagnostics import (Diagnostic, RuleConfig, rule,
                                              run_pack)
from repro_torch.fleet.spec import FleetSpec, is_fleet_axis


def _swept(spec: FleetSpec, path: str) -> List[Any]:
    """Values an axis sweeps onto ``path`` (empty if not swept)."""
    out: List[Any] = []
    for axis in spec.axes:
        if is_fleet_axis(axis) and axis.path == path and axis.mode == "set":
            out.extend(axis.values)
    return out


@rule("F101", "fleet", "error",
      "every job template can hold one instance in some node group")
def _check_jobs_fit(spec: FleetSpec,
                    ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    if spec.cluster is None:
        return
    groups = spec.cluster.node_groups
    biggest = max(g.num_nodes for g in groups)
    for job in spec.jobs:
        loc = f"fleet study {spec.name!r} job {job.name!r}"
        narrowest = min(job.width_menu)
        if narrowest > biggest:
            yield (loc,
                   f"narrowest width {narrowest} exceeds every group "
                   f"(largest has {biggest} nodes) — the job can only run "
                   "under the oversubscribed legacy convention")
        if job.max_nodes and narrowest > job.max_nodes:
            yield (loc,
                   f"narrowest width {narrowest} exceeds the job's own "
                   f"max_nodes={job.max_nodes} cap — it can never place")


@rule("F102", "fleet", "error",
      "fleet trace rates/durations are positive")
def _check_trace(spec: FleetSpec,
                 ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    loc = f"fleet study {spec.name!r} ftrace"
    if spec.ftrace.kind != "static":
        for r in [spec.ftrace.rate] + _swept(spec, "ftrace.rate"):
            if not r > 0:
                yield loc, f"arrival rate must be > 0 jobs/s, got {r!r}"
        for n in [spec.ftrace.num_jobs] + _swept(spec, "ftrace.num_jobs"):
            if not n > 0:
                yield loc, f"trace needs num_jobs > 0, got {n!r}"
    for job in spec.jobs:
        if not job.iterations > 0:
            yield (f"fleet study {spec.name!r} job {job.name!r}",
                   f"iterations must be > 0, got {job.iterations!r}")


@rule("F103", "fleet", "error",
      "priority/burst sanity: single-instance bursts inside the "
      "iteration budget, widths divisible by mp")
def _check_burst(spec: FleetSpec,
                 ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    for job in spec.jobs:
        loc = f"fleet study {spec.name!r} job {job.name!r}"
        if job.burst_iters > 0:
            if job.instances != 1:
                yield (loc,
                       f"burst-parallel jobs must be single-instance, got "
                       f"instances={job.instances} — the lend/return "
                       "hand-off is per training state, not per replica")
            if job.burst_iters > job.iterations:
                yield (loc,
                       f"burst window ({job.burst_iters} iters) exceeds "
                       f"the job's whole run ({job.iterations} iters)")
            if not job.elastic:
                yield (loc,
                       "burst_iters set but the width menu is static — "
                       "bursting needs wider widths to borrow into "
                       "(set FleetJobSpec.widths)")
        if not job.model.startswith("dlrm"):
            for w in job.width_menu:
                if w % job.mp != 0:
                    yield (loc,
                           f"width {w} not divisible by mp={job.mp} — "
                           "elastic DP cannot re-decompose there")


@rule("F104", "fleet", "error",
      "preemption/resize costs are finite and positive")
def _check_costs(spec: FleetSpec,
                 ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    loc = f"fleet study {spec.name!r} fleet"
    for field in ("checkpoint_bw", "reshard_bw"):
        for v in [getattr(spec.fleet, field)] \
                + _swept(spec, f"fleet.{field}"):
            if not (v > 0 and math.isfinite(v)):
                yield (loc,
                       f"{field} must be finite and > 0 bytes/s, got {v!r} "
                       "— every preempt/resize would stall forever")
    for v in [spec.fleet.lend_overhead] + _swept(spec, "fleet.lend_overhead"):
        if not (v >= 0 and math.isfinite(v)):
            yield (loc,
                   f"lend_overhead must be finite and >= 0 s, got {v!r}")


def analyze_fleet(spec: FleetSpec,
                  config: Optional[RuleConfig] = None) -> List[Diagnostic]:
    """Run the F1xx pack against a :class:`FleetSpec`."""
    return run_pack("fleet", spec, config=config)
