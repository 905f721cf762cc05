"""Study rules (S1xx): a StudySpec is executable before any cell runs.

``run_study`` calls these (plus the K1xx pack on the base cluster) under
its ``validate=`` gate; the same checks run standalone via
:func:`analyze_study`.

======  ========  =====================================================
code    severity  invariant
======  ========  =====================================================
S101    error     dotted-path axes resolve on the base cluster schema
S102    error     metric names don't collide with engine/axis columns
S103    error     placement names (spec + placement axes) resolvable
S104    warning   the strategy space is non-empty on the base cluster
======  ========  =====================================================
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.diagnostics import Diagnostic, RuleConfig, rule, run_pack
from repro_torch.core.placement import get_placement
from repro_torch.core.study import (StudySpec, as_strategy_space, check_path,
                              is_reliability_axis)


@rule("S101", "study", "error",
      "dotted-path axes resolve against the base cluster's dataclass schema")
def _check_axis_paths(spec: StudySpec,
                      ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    if spec.cluster is None:
        return
    transformed = False
    for axis in spec.axes:
        if axis.kind != "cluster":
            continue
        if is_reliability_axis(axis):
            # resolves against the FailureModel, not the cluster —
            # already validated by StudySpec (run_study refuses it)
            continue
        if axis.apply is not None:
            # An apply axis may rewrite the cluster arbitrarily (even swap
            # its type), so later paths can't be checked statically.
            transformed = True
            continue
        if axis.path is None or transformed:
            continue
        try:
            check_path(spec.cluster, axis.path)
        except (AttributeError, TypeError) as exc:
            yield (f"study {spec.name!r} axis {axis.name!r}",
                   f"path {axis.path!r} does not resolve: {exc}")


@rule("S102", "study", "error",
      "metric names don't shadow engine record columns or axis names")
def _check_metric_names(spec: StudySpec,
                        ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    axis_names = {a.name for a in spec.axes}
    for name in spec.metrics:
        if name in StudySpec.RESERVED_COLUMNS:
            yield (f"study {spec.name!r} metric {name!r}",
                   "shadows an engine record column — the metric value "
                   "would silently overwrite it")
        elif name in axis_names:
            yield (f"study {spec.name!r} metric {name!r}",
                   "shadows an axis column of the same name")


@rule("S103", "study", "error",
      "placement names (spec and placement-axis values) resolvable")
def _check_placements(spec: StudySpec,
                      ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    try:
        get_placement(spec.placement)
    except (KeyError, TypeError, ValueError) as exc:
        yield f"study {spec.name!r} placement", str(exc)
    for axis in spec.axes:
        if axis.kind != "placement":
            continue
        for value in axis.values:
            try:
                get_placement(value)
            except (KeyError, TypeError, ValueError) as exc:
                yield (f"study {spec.name!r} axis {axis.name!r} "
                       f"value {value!r}", str(exc))


@rule("S104", "study", "warning",
      "the strategy space yields at least one strategy on the base cluster")
def _check_strategy_space(spec: StudySpec,
                          ctx: Dict[str, Any]) -> Iterator[Tuple[str, str]]:
    space = as_strategy_space(spec.strategies)
    if space is None or spec.cluster is None:
        return
    num_nodes = spec.cluster.num_nodes
    if not space.specs(num_nodes):
        yield (f"study {spec.name!r}",
               f"{type(space).__name__} yields no strategies for the "
               f"{num_nodes}-node base cluster — every cell would be "
               "skipped")


def analyze_study(spec: StudySpec,
                  config: Optional[RuleConfig] = None) -> List[Diagnostic]:
    """Run the S1xx pack against one study spec."""
    return run_pack("study", spec, {}, config)
