"""Static analysis over the port's COMET IR: workloads, compiled workloads,
studies, clusters and search output — checked before anything is timed.

The port's copy of the JAX package's ``analysis`` rule packs, held to them
diagnostic for diagnostic by ``tests/test_torch_analysis.py`` and
``tests/test_torch_search.py``, ``tests/test_torch_serving.py``,
``tests/test_torch_reliability.py`` and ``tests/test_torch_fleet.py``.
Eight packs (codes grouped by hundreds digit):

* ``W1xx`` (:mod:`repro_torch.analysis.rules_workload`) — Workload
  invariants,
* ``C1xx`` (:mod:`repro_torch.analysis.rules_compiled`) — CompiledWorkload
  vs. its source,
* ``S1xx`` (:mod:`repro_torch.analysis.rules_study`) — StudySpec
  executability,
* ``K1xx`` (:mod:`repro_torch.analysis.rules_cluster`) — cluster
  well-formedness,
* ``V1xx`` (:mod:`repro_torch.analysis.rules_serving`) — ServingSpec
  servability (KV fits, SLO/trace sane, decode groups exist),
* ``R1xx`` (:mod:`repro_torch.analysis.rules_search`) — search objective
  sets and Pareto-frontier annotations,
* ``F1xx`` (:mod:`repro_torch.analysis.rules_fleet`) — FleetSpec timeline
  sanity (jobs fit some group, positive trace, burst windows, finite
  preemption/resize costs),
* ``Y1xx`` (:mod:`repro_torch.analysis.rules_reliability`) — failure
  models and traces (positive finite MTBF/MTTR/checkpoint-bw, fixed
  interval shorter than the run, non-empty traces, blast radius in range).

Entry points: the ``analyze_*`` helpers below, the ``validate=`` gate on
:func:`repro_torch.core.study.run_study` (S1xx, K1xx, V1xx, F1xx, Y1xx), and
the registry sweep command line (``python -m repro_torch.analysis
--all-registry``, :mod:`repro_torch.analysis.__main__`): pure inspection,
no tensor and no device.
"""

from repro_torch.analysis.diagnostics import (
    AnalysisError,
    Diagnostic,
    Rule,
    RuleConfig,
    SEVERITIES,
    format_report,
    has_errors,
    list_rules,
    max_severity,
    rule,
    run_pack,
)
from repro_torch.analysis.rules_cluster import analyze_cluster
from repro_torch.analysis.rules_compiled import analyze_compiled
from repro_torch.analysis.rules_fleet import analyze_fleet
from repro_torch.analysis.rules_reliability import analyze_reliability
from repro_torch.analysis.rules_search import SearchTarget, analyze_search
from repro_torch.analysis.rules_serving import analyze_serving
from repro_torch.analysis.rules_study import analyze_study
from repro_torch.analysis.rules_workload import analyze_workload

__all__ = [
    "AnalysisError",
    "Diagnostic",
    "Rule",
    "RuleConfig",
    "SEVERITIES",
    "SearchTarget",
    "analyze_cluster",
    "analyze_compiled",
    "analyze_fleet",
    "analyze_reliability",
    "analyze_search",
    "analyze_serving",
    "analyze_study",
    "analyze_workload",
    "format_report",
    "has_errors",
    "list_rules",
    "max_severity",
    "rule",
    "run_pack",
]
