"""Workload rules (W1xx): static invariants of a decomposed Workload.

These inspect the layer/op/event IR that :func:`repro_torch.core.workload.decompose`
emits — the same structures both engines consume — without timing anything.

======  ========  =====================================================
code    severity  invariant
======  ========  =====================================================
W101    error     CommEvent scopes limited to the simulator's streams
W102    warning   every communicator has group size > 1
W103    error     FLOP / weight-byte totals conserved vs. a baseline
                  factorization (needs ``ctx["baseline"]``)
W104    error     stage ids dense in [0, pp); p2p only at boundaries
W105    error     bytes / FLOPs / dims nonnegative and finite
======  ========  =====================================================
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.diagnostics import Diagnostic, RuleConfig, rule, run_pack
from repro_torch.core.compiled import SCOPES
from repro_torch.core.gemm import ExplicitOp, Gemm
from repro_torch.core.topology import _group_size
from repro_torch.core.workload import LayerSpec, Workload

_REL_TOL = 1e-9


def _loc(wl: Workload, i: int, layer: LayerSpec, detail: str = "") -> str:
    base = f"workload {wl.name!r} layer[{i}] {layer.name!r}"
    return f"{base} {detail}" if detail else base


@rule("W101", "workload", "error",
      "CommEvent scopes limited to the simulator's network streams")
def _check_scopes(wl: Workload,
                  ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    for i, layer, phase, ev in wl.comm_events():
        if ev.scope not in SCOPES:
            yield (_loc(wl, i, layer, f"{phase} {ev.collective}"),
                   f"scope {ev.scope!r} is not one of {SCOPES}")


@rule("W102", "workload", "warning",
      "every communication event addresses a group of size > 1")
def _check_group_sizes(wl: Workload,
                       ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    sizes = {s: _group_size(s, wl.mp, wl.dp, wl.pp, wl.ep) for s in SCOPES}
    for i, layer, phase, ev in wl.comm_events():
        n = sizes.get(ev.scope)
        if n is not None and n <= 1:
            yield (_loc(wl, i, layer, f"{phase} {ev.collective}"),
                   f"scope {ev.scope!r} has group size {n} at "
                   f"(mp={wl.mp}, dp={wl.dp}, pp={wl.pp}, ep={wl.ep}) — "
                   "the collective is a no-op")


@rule("W103", "workload", "error",
      "FLOP and weight-byte totals conserved across factorizations")
def _check_conservation(wl: Workload,
                        ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    baseline: Optional[Workload] = ctx.get("baseline")
    if baseline is None or baseline is wl:
        return
    # The invariant only holds exactly for dense workloads: expert layers
    # shard weights over EP and reroute tokens, and sparse layers override
    # optimizer traffic.
    if any(layer.expert_bytes for layer in wl.layers) \
            or any(layer.expert_bytes for layer in baseline.layers):
        return
    if wl.mp != baseline.mp or wl.dp * wl.ep != baseline.dp * baseline.ep:
        return
    loc = f"workload {wl.name!r}"
    f_wl, f_base = wl.total_flops(), baseline.total_flops()
    if not math.isclose(f_wl, f_base, rel_tol=_REL_TOL):
        yield (loc,
               f"per-node FLOPs {f_wl:.6g} != baseline {f_base:.6g} at equal "
               f"(mp, dp*ep) — lost or duplicated work across "
               f"(pp={wl.pp}, ep={wl.ep}) vs "
               f"(pp={baseline.pp}, ep={baseline.ep})")
    w_wl, w_base = wl.total_weight_bytes(), baseline.total_weight_bytes()
    if not math.isclose(w_wl, w_base, rel_tol=_REL_TOL):
        yield (loc,
               f"replica weight bytes {w_wl:.6g} != baseline {w_base:.6g} "
               f"at equal mp — parameters lost or duplicated across stages")


@rule("W104", "workload", "error",
      "stage ids dense in [0, pp); p2p events only at stage boundaries")
def _check_stages(wl: Workload,
                  ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    pp = max(1, wl.pp)
    stages = [layer.stage for layer in wl.layers]
    bad_ids = sorted({s for s in stages if not 0 <= s < pp})
    if bad_ids:
        yield (f"workload {wl.name!r}",
               f"stage ids {bad_ids} outside [0, {pp})")
    missing = sorted(set(range(pp)) - set(stages))
    if missing:
        yield (f"workload {wl.name!r}",
               f"stages {missing} own no layers (ids must be dense)")
    if any(b < a for a, b in zip(stages, stages[1:])):
        yield (f"workload {wl.name!r}",
               "stage ids decrease along the layer list — layers must be "
               "grouped in pipeline order")
    # p2p activation hand-offs: comm_fwd on the last layer of stage s (to
    # s+1), comm_ig on the first layer of stage s (from s-1), nowhere else.
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for i, layer in enumerate(wl.layers):
        first.setdefault(layer.stage, i)
        last[layer.stage] = i
    for i, layer, phase, ev in wl.comm_events():
        if ev.scope != "pp":
            continue
        where = _loc(wl, i, layer, f"{phase} {ev.collective}")
        if pp <= 1:
            yield where, "pp-scope event in an unpipelined workload"
        elif phase == "fp":
            if i != last.get(layer.stage) or layer.stage >= pp - 1:
                yield (where,
                       "forward p2p must sit on the last layer of a "
                       f"non-final stage (layer stage {layer.stage})")
        elif phase == "ig":
            if i != first.get(layer.stage) or layer.stage == 0:
                yield (where,
                       "backward p2p must sit on the first layer of a "
                       f"non-initial stage (layer stage {layer.stage})")
        else:
            yield where, "p2p events may not appear in the WG phase"


def _bad_number(x: float) -> bool:
    return not math.isfinite(x) or x < 0


@rule("W105", "workload", "error",
      "bytes, FLOPs, and operand dims nonnegative and finite")
def _check_finite(wl: Workload,
                  ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    for i, layer in enumerate(wl.layers):
        for field in ("weight_bytes", "act_out_bytes", "expert_bytes"):
            v = getattr(layer, field)
            if _bad_number(v):
                yield _loc(wl, i, layer), f"{field} = {v!r}"
        if layer.repeat < 1:
            yield _loc(wl, i, layer), f"repeat = {layer.repeat!r} (must be >= 1)"
        if layer.expert_bytes > layer.weight_bytes:
            yield (_loc(wl, i, layer),
                   f"expert_bytes {layer.expert_bytes} exceeds "
                   f"weight_bytes {layer.weight_bytes}")
        if layer.optim_bytes is not None and _bad_number(layer.optim_bytes):
            yield _loc(wl, i, layer), f"optim_bytes = {layer.optim_bytes!r}"
        for phase, ops in (("fp", layer.fwd), ("ig", layer.ig),
                           ("wg", layer.wg)):
            for op in ops:
                if isinstance(op, Gemm):
                    if min(op.m, op.k, op.n, op.batch) <= 0:
                        yield (_loc(wl, i, layer, phase),
                               f"degenerate GEMM dims (m={op.m}, k={op.k}, "
                               f"n={op.n}, batch={op.batch})")
                elif isinstance(op, ExplicitOp):
                    if _bad_number(op.flops) or _bad_number(op.bytes_moved):
                        yield (_loc(wl, i, layer, phase),
                               f"ExplicitOp flops={op.flops!r} "
                               f"bytes={op.bytes_moved!r}")
    for i, layer, phase, ev in wl.comm_events():
        if _bad_number(ev.size_bytes):
            yield (_loc(wl, i, layer, f"{phase} {ev.collective}"),
                   f"size_bytes = {ev.size_bytes!r}")


def analyze_workload(wl: Workload, baseline: Optional[Workload] = None,
                     config: Optional[RuleConfig] = None) -> List[Diagnostic]:
    """Run the W1xx pack. ``baseline`` (same model/shape/mp with
    ``baseline.dp * baseline.ep == wl.dp * wl.ep``) enables the W103
    conservation check; without one, W103 is vacuous."""
    return run_pack("workload", wl, {"baseline": baseline}, config)
