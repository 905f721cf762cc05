"""Search rules (R1xx): objective sets and Pareto annotations are sane.

The search layer (:mod:`repro_torch.core.search`) ranks records by objective
columns and stamps ``pareto_rank`` / ``pareto_optimal`` annotations; a
degenerate objective set or a broken annotation silently turns a design
search into noise.  These rules run over a :class:`SearchTarget` — an
``(objectives, records)`` pair built by :func:`analyze_search` from a
:class:`repro_torch.core.study.StudyResult`, a :class:`repro_torch.core.search
.SearchResult` trace, or a bare record list.

======  ========  =====================================================
code    severity  invariant
======  ========  =====================================================
R101    error     objective set is non-empty with distinct columns that
                  at least one record carries
R102    warning   feasible records are finite on every objective
R103    error     ``pareto_optimal`` annotations are dominance-consistent
======  ========  =====================================================
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple, Union)

from repro_torch.analysis.diagnostics import (Diagnostic, RuleConfig, rule,
                                        run_pack)
from repro_torch.core.search import (DEFAULT_OBJECTIVES, Objective, _participates,
                               _scores, dominates)


@dataclasses.dataclass(frozen=True)
class SearchTarget:
    """What the R1xx pack inspects: the objective set plus the (possibly
    Pareto-annotated) records it ranks."""

    objectives: Tuple[Objective, ...]
    records: Tuple[Mapping[str, Any], ...]
    name: str = "search"


@rule("R101", "search", "error",
      "objective set is non-empty, has distinct columns, and matches "
      "at least one record column")
def _check_objectives(target: SearchTarget,
                      ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    loc = f"search {target.name!r} objectives"
    if not target.objectives:
        yield loc, ("empty objective set — nothing to rank; pass at "
                    "least one Objective (e.g. Objective('total'))")
        return
    cols = [o.column for o in target.objectives]
    dupes = sorted({c for c in cols if cols.count(c) > 1})
    if dupes:
        yield loc, (f"duplicate objective column(s) {dupes} — each axis "
                    "of the trade space must be a distinct column")
    if target.records:
        missing = [c for c in cols
                   if not any(c in r for r in target.records)]
        if missing:
            yield loc, (f"objective column(s) {missing} appear in none "
                        f"of the {len(target.records)} record(s) — every "
                        "cell would score +inf on them")


@rule("R102", "search", "warning",
      "feasible records carry finite values on every objective column")
def _check_finite(target: SearchTarget,
                  ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    if not target.objectives:
        return
    for i, r in enumerate(target.records):
        if not r.get("feasible", True):
            continue
        for o in target.objectives:
            v = r.get(o.column)
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or not math.isfinite(float(v)):
                yield (f"search {target.name!r} record[{i}]",
                       f"feasible record has non-finite objective "
                       f"{o.column}={v!r} — it can never rank and is "
                       "silently excluded from the frontier")


@rule("R103", "search", "error",
      "pareto_optimal annotations are dominance-consistent")
def _check_frontier(target: SearchTarget,
                    ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    """Two-sided check over annotated records: no frontier member is
    dominated by any participating record, and every participating
    non-frontier record is dominated by some frontier member.  Records
    without a ``pareto_optimal`` annotation are skipped (the trace was
    never run through ``pareto_front``)."""
    if not target.objectives:
        return
    annotated = [(i, r) for i, r in enumerate(target.records)
                 if "pareto_optimal" in r]
    live = [(i, r, _scores(r, target.objectives)) for i, r in annotated
            if _participates(r, target.objectives)]
    front = [(i, s) for i, r, s in live if r.get("pareto_optimal")]
    rest = [(i, s) for i, r, s in live if not r.get("pareto_optimal")]
    name = f"search {target.name!r}"
    for i, si in front:
        for j, r, sj in live:
            if j != i and dominates(sj, si):
                yield (f"{name} record[{i}]",
                       f"marked pareto_optimal but dominated by "
                       f"record[{j}] on "
                       f"{[o.name for o in target.objectives]}")
                break
    for i, si in rest:
        if not any(dominates(sf, si) or sf == si for _, sf in front):
            yield (f"{name} record[{i}]",
                   "feasible, not marked pareto_optimal, yet no frontier "
                   "record dominates it — the frontier is incomplete")


def _as_target(obj: Union[SearchTarget, Sequence[Mapping[str, Any]], Any],
               objectives: Optional[Sequence[Objective]],
               name: str) -> SearchTarget:
    if isinstance(obj, SearchTarget):
        return obj
    records = getattr(obj, "records", obj)   # StudyResult / SearchResult
    obs = tuple(objectives if objectives is not None
                else getattr(obj, "objectives", DEFAULT_OBJECTIVES))
    return SearchTarget(objectives=obs, records=tuple(records), name=name)


def analyze_search(result: Union[SearchTarget, Sequence[Mapping[str, Any]],
                                 Any],
                   objectives: Optional[Sequence[Objective]] = None,
                   config: Optional[RuleConfig] = None,
                   name: str = "search") -> List[Diagnostic]:
    """Run the R1xx pack.  ``result`` may be a :class:`SearchTarget`, a
    ``StudyResult``/``SearchResult`` (its ``records``/``objectives`` are
    lifted), or a bare record sequence; ``objectives`` defaults to the
    result's own, else the (time, TCO, energy) triple."""
    return run_pack("search", _as_target(result, objectives, name),
                    config=config)
