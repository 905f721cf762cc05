"""Compiled rules (C1xx): a CompiledWorkload structurally mirrors its source.

The compiled engine's dynamic guarantee (timings within 1e-9 of the
reference event loop, held by the tests of both packages)
is checked per cell at runtime.  These rules are its *static* shadow:
they re-derive, from the Workload's layer lists, what the flat arrays
must contain — so a stale or hand-mutated ``CompiledWorkload`` is caught
before any cell is timed.

======  ========  =====================================================
code    severity  invariant
======  ========  =====================================================
C101    error     one CompiledStage per pipeline stage
C102    error     per-(collective, scope) event counts match the source
C103    error     per-(collective, scope) total bytes match the source
C104    error     delay-class coverage: seq/count totals, index ranges
C105    error     optimizer byte totals match the layer list
======  ========  =====================================================
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.diagnostics import Diagnostic, RuleConfig, rule, run_pack
from repro_torch.core.compiled import (CompiledStage, CompiledWorkload,
                                 pass_event_totals)
from repro_torch.core.workload import LayerSpec, Workload

_REL_TOL = 1e-9


def _source(cw: CompiledWorkload, ctx: Dict[str, Any]) -> Workload:
    wl = ctx.get("workload")
    return wl if wl is not None else cw.workload


def _stage_pairs(cw: CompiledWorkload, ctx: Dict[str, Any]
                 ) -> Iterator[Tuple[int, CompiledStage, List[LayerSpec]]]:
    groups = _source(cw, ctx).stage_layers()
    for s, (stage, layers) in enumerate(zip(cw.stages, groups)):
        yield s, stage, layers


def _workload_event_totals(layers: List[LayerSpec]
                           ) -> Dict[Tuple[str, str], Tuple[int, float]]:
    """Repeat-weighted (count, bytes) per (collective, scope) that the
    reference event loop would issue for one stage."""
    totals: Dict[Tuple[str, str], List[float]] = {}
    for layer in layers:
        for events in (layer.comm_fwd, layer.comm_ig, layer.comm_wg):
            for ev in events:
                cell = totals.setdefault((ev.collective, ev.scope), [0, 0.0])
                cell[0] += layer.repeat
                cell[1] += ev.size_bytes * layer.repeat
    return {k: (int(c), b) for k, (c, b) in totals.items()}


@rule("C101", "compiled", "error",
      "one CompiledStage per pipeline stage of the source workload")
def _check_stage_count(cw: CompiledWorkload,
                       ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    wl = _source(cw, ctx)
    want = len(wl.stage_layers())
    if len(cw.stages) != want:
        yield (f"compiled {wl.name!r}",
               f"{len(cw.stages)} compiled stage(s) for {want} pipeline "
               f"stage(s) (pp={wl.pp})")


@rule("C102", "compiled", "error",
      "per-(collective, scope) event counts equal the source workload's")
def _check_event_counts(cw: CompiledWorkload,
                        ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    wl = _source(cw, ctx)
    for s, stage, layers in _stage_pairs(cw, ctx):
        want = _workload_event_totals(layers)
        got = pass_event_totals(stage)
        for key in sorted(set(want) | set(got)):
            kind, scope = key
            n_want = want.get(key, (0, 0.0))[0]
            n_got = got.get(key, (0, 0.0))[0]
            if n_want != n_got:
                yield (f"compiled {wl.name!r} stage[{s}]",
                       f"{kind}@{scope}: {n_got} stream event(s) vs "
                       f"{n_want} in the layer list")


@rule("C103", "compiled", "error",
      "per-(collective, scope) total bytes equal the source workload's")
def _check_event_bytes(cw: CompiledWorkload,
                       ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    wl = _source(cw, ctx)
    for s, stage, layers in _stage_pairs(cw, ctx):
        want = _workload_event_totals(layers)
        got = pass_event_totals(stage)
        for key in sorted(set(want) | set(got)):
            kind, scope = key
            b_want = want.get(key, (0, 0.0))[1]
            b_got = got.get(key, (0, 0.0))[1]
            if not math.isclose(b_want, b_got, rel_tol=_REL_TOL, abs_tol=0.5):
                yield (f"compiled {wl.name!r} stage[{s}]",
                       f"{kind}@{scope}: {b_got:.6g} stream bytes vs "
                       f"{b_want:.6g} in the layer list")


@rule("C104", "compiled", "error",
      "delay-class coverage: sequence lengths, phase counts, index ranges")
def _check_classes(cw: CompiledWorkload,
                   ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    wl = _source(cw, ctx)
    for s, stage, layers in _stage_pairs(cw, ctx):
        loc = f"compiled {wl.name!r} stage[{s}]"
        repeats = sum(layer.repeat for layer in layers)
        ncls = stage.n_classes
        if stage.flops.shape != (ncls,) or stage.base_traffic.shape != (ncls,):
            yield (loc, f"delay tables sized {stage.flops.shape} / "
                        f"{stage.base_traffic.shape} for {ncls} class(es)")
        if stage.counts.shape != (3, ncls):
            yield loc, f"counts shaped {stage.counts.shape}, want (3, {ncls})"
        else:
            for p, phase in enumerate(("fp", "ig", "wg")):
                total = float(stage.counts[p].sum())
                if not math.isclose(total, repeats, rel_tol=_REL_TOL):
                    yield (loc, f"{phase} class counts sum to {total:.6g}, "
                                f"want {repeats} (repeat-weighted layers)")
        for name, p, want_len in (("fwd", stage.fwd, repeats),
                                  ("bwd", stage.bwd, 2 * repeats)):
            if p.seq.size != want_len:
                yield (loc, f"{name} sequence has {p.seq.size} compute "
                            f"step(s), want {want_len}")
            if p.seq.size and not (0 <= p.seq.min()
                                   and int(p.seq.max()) < ncls):
                yield loc, f"{name} sequence indexes outside [0, {ncls})"
            ncomm = stage.comm_sizes.shape[0]
            if p.ev_comm.size and not (0 <= p.ev_comm.min()
                                       and int(p.ev_comm.max()) < ncomm):
                yield loc, f"{name} events reference comm rows >= {ncomm}"
            if p.ev_pos.size and not (0 <= p.ev_pos.min()
                                      and int(p.ev_pos.max()) <= p.seq.size):
                yield (loc, f"{name} event positions outside "
                            f"[0, {p.seq.size}]")


@rule("C105", "compiled", "error",
      "optimizer-update byte totals match the layer list")
def _check_optimizer(cw: CompiledWorkload,
                     ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    wl = _source(cw, ctx)
    for s, stage, layers in _stage_pairs(cw, ctx):
        dense = sum((layer.weight_bytes - layer.expert_bytes) * layer.repeat
                    for layer in layers if layer.optim_bytes is None)
        expert = sum(layer.expert_bytes * layer.repeat
                     for layer in layers if layer.optim_bytes is None)
        sparse = sum(layer.optim_bytes * layer.repeat
                     for layer in layers if layer.optim_bytes is not None)
        for name, got, want in (("dense_w", stage.dense_w, dense),
                                ("expert_w", stage.expert_w, expert),
                                ("sparse", stage.sparse, sparse)):
            if not math.isclose(got, want, rel_tol=_REL_TOL, abs_tol=0.5):
                yield (f"compiled {wl.name!r} stage[{s}]",
                       f"{name} = {got:.6g}, layer list says {want:.6g}")


def analyze_compiled(cw: CompiledWorkload,
                     workload: Optional[Workload] = None,
                     config: Optional[RuleConfig] = None) -> List[Diagnostic]:
    """Run the C1xx pack against ``cw`` (vs. ``workload``, default the one
    it was lowered from)."""
    return run_pack("compiled", cw, {"workload": workload}, config)
