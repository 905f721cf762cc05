"""Static analysis over the port's COMET IR: workloads, compiled workloads,
studies, clusters and search output — checked before anything is timed.

The port's copy of the JAX package's ``analysis`` rule packs, held to them
diagnostic for diagnostic by ``tests/test_torch_analysis.py`` and
``tests/test_torch_search.py``, ``tests/test_torch_serving.py`` and
``tests/test_torch_reliability.py``. Seven packs (codes grouped by hundreds
digit):

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
* ``Y1xx`` (:mod:`repro_torch.analysis.rules_reliability`) — failure
  models and traces (positive finite MTBF/MTTR/checkpoint-bw, fixed
  interval shorter than the run, non-empty traces, blast radius in range).

Entry points: the ``analyze_*`` helpers below and the ``validate=`` gate
on :func:`repro_torch.core.study.run_study` (S1xx, K1xx, V1xx, Y1xx). The
fleet pack (F1xx) and the registry-sweep command line come with the fleet
(ROADMAP Queue 1 item 19).
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
