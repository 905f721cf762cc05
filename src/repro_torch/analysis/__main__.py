"""Registry sweep command line: ``python -m repro_torch.analysis
--all-registry``.

The port's copy of the JAX package's ``analysis/__main__.py``: the same
flags, report and exit codes, over the port's rule packs and registries,
held to the reference diagnostic for diagnostic by
``tests/test_torch_analysis.py``. Statically checks, without timing
anything (no tensor, no device):

* every registry cluster (K1xx);
* every registry model decomposed under the default strategy space at
  each distinct registry cluster size (W1xx on the Workload, C1xx on its
  compiled lowering), with a same-(mp, dp*ep) baseline decomposition
  enabling the W103 conservation check;
* a default StudySpec per (model, cluster) pair plus the seven
  paper-figure studies (S1xx, and K1xx on their base clusters);
* the default ``dse.serving_study`` spec (V1xx on the ServingSpec plus
  S1xx on its lowered StudySpec);
* the default ``dse.fleet_study`` spec (F1xx on the FleetSpec plus
  S1xx on its lowered StudySpec);
* the default ``dse.reliability_study`` and ``dse.reliability_fleet_study``
  specs (Y1xx on the failure model/trace plus S1xx/F1xx on the carriers);
* the search pack (R1xx) over a deterministic synthetic Pareto
  annotation — a live gate on the dominance logic.

Exits 1 if any error-severity diagnostic fires, 0 otherwise.  ``--json``
writes the full report.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.diagnostics import (Diagnostic, RuleConfig,
                                              format_report, has_errors,
                                              list_rules)
from repro_torch.analysis.rules_cluster import analyze_cluster
from repro_torch.analysis.rules_compiled import analyze_compiled
from repro_torch.analysis.rules_study import analyze_study
from repro_torch.analysis.rules_workload import analyze_workload
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cluster import (ClusterLike, get_cluster,
                                      list_clusters)
from repro_torch.core.study import PowerOfTwoSpace, StudySpec
from repro_torch.core.workload import (InfeasibleStrategyError, Workload,
                                       decompose)

# A modest paper-style training shape: big enough to exercise every layer
# family, small enough that ~2k decompositions stay interactive.
SWEEP_SHAPE = ShapeConfig("analysis", seq_len=2048, global_batch=512,
                          kind="train")

# The default sweep space: the paper's power-of-two (MP, DP) enumeration,
# extended with one nontrivial PP and EP split so the stage/boundary (W104)
# and expert-gradient (edp) paths are exercised statically.
DEFAULT_SPACE = PowerOfTwoSpace(pp=(1, 2), ep=(1, 2))


def _parse_config(disable: Sequence[str],
                  severity: Sequence[str]) -> RuleConfig:
    overrides: Dict[str, str] = {}
    for item in severity:
        code, _, sev = item.partition("=")
        if not sev:
            raise SystemExit(f"--severity wants CODE=LEVEL, got {item!r}")
        overrides[code] = sev
    return RuleConfig(disable=frozenset(disable), severity=overrides)


def _decompose(cfg: ModelConfig, mp: int, dp: int, pp: int,
               ep: int) -> Optional[Workload]:
    try:
        return decompose(cfg, SWEEP_SHAPE, mp=mp, dp=dp, pp=pp, ep=ep)
    except InfeasibleStrategyError:
        return None


def sweep(models: Sequence[str], clusters: Sequence[str],
          config: Optional[RuleConfig] = None) -> List[Diagnostic]:
    """The full static sweep; pure (no simulator, no files)."""
    diags: List[Diagnostic] = []
    cluster_objs: Dict[str, ClusterLike] = {n: get_cluster(n)
                                            for n in clusters}
    for name in clusters:
        diags += analyze_cluster(cluster_objs[name], config)

    sizes = sorted({cl.num_nodes for cl in cluster_objs.values()})
    for arch in models:
        cfg = get_config(arch)
        baselines: Dict[Tuple[int, int], Optional[Workload]] = {}
        seen: set = set()
        for n in sizes:
            for s in DEFAULT_SPACE.specs(n):
                key = (s.mp, s.dp, s.pp, s.ep)
                if key in seen:
                    continue
                seen.add(key)
                wl = _decompose(cfg, s.mp, s.dp, s.pp, s.ep)
                if wl is None:
                    continue
                bkey = (s.mp, s.dp * s.ep)
                if bkey not in baselines:
                    baselines[bkey] = _decompose(cfg, s.mp, s.dp * s.ep,
                                                 1, 1)
                diags += analyze_workload(wl, baselines[bkey], config)
                diags += analyze_compiled(wl.compiled(), config=config)

    for arch in models:
        cfg = get_config(arch)
        for name in clusters:
            spec = StudySpec(name=f"registry:{arch}@{name}", model=cfg,
                             shape=SWEEP_SHAPE, cluster=cluster_objs[name],
                             strategies=DEFAULT_SPACE)
            diags += analyze_study(spec, config)

    from repro_torch.core.dse import figure_studies, serving_study
    for spec in figure_studies().values():
        diags += analyze_study(spec, config)
        if spec.cluster is not None:
            diags += analyze_cluster(spec.cluster, config)

    from repro_torch.analysis.rules_serving import analyze_serving
    sspec = serving_study()
    diags += analyze_serving(sspec, config)
    diags += analyze_study(sspec.to_study(), config)

    from repro_torch.analysis.rules_fleet import analyze_fleet
    from repro_torch.core.dse import fleet_study
    fspec = fleet_study()
    diags += analyze_fleet(fspec, config)
    diags += analyze_study(fspec.to_study(), config)

    from repro_torch.analysis.rules_reliability import analyze_reliability
    from repro_torch.core.dse import (reliability_fleet_study,
                                      reliability_study)
    rspec = reliability_study()
    diags += analyze_reliability(rspec, config)
    diags += analyze_study(rspec, config)
    rfspec = reliability_fleet_study()
    diags += analyze_reliability(rfspec, config)
    diags += analyze_fleet(rfspec, config)
    diags += analyze_study(rfspec.to_study(), config)

    # Search pack (R1xx) over a deterministic synthetic frontier: annotate
    # a fixed record set through the real pareto_front path, then check
    # the annotations.  Pure (no simulator), and a live gate on the
    # dominance logic itself: a broken pareto_rank trips R103 here.
    from repro_torch.analysis.rules_search import analyze_search
    from repro_torch.core.search import DEFAULT_OBJECTIVES, pareto_front
    from repro_torch.core.study import CellResult, StudyResult
    demo = [
        {"feasible": True, "total": 1.0, "tco": 9.0, "energy_usd": 2.0},
        {"feasible": True, "total": 3.0, "tco": 4.0, "energy_usd": 1.0},
        {"feasible": True, "total": 3.5, "tco": 9.5, "energy_usd": 2.5},
        {"feasible": False, "total": 0.5, "tco": 1.0, "energy_usd": 0.1},
    ]
    res = StudyResult(
        spec=StudySpec(name="search-demo", evaluate=lambda ctx: {}),
        cells=[CellResult(None, {}, None, None, None, r) for r in demo])
    pareto_front(res, DEFAULT_OBJECTIVES)
    diags += analyze_search(res, DEFAULT_OBJECTIVES, config,
                            name="registry-demo")
    return diags


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static diagnostics over the model/cluster registries.")
    ap.add_argument("--all-registry", action="store_true",
                    help="sweep every registry model x default strategy "
                         "space x registry cluster")
    ap.add_argument("--models", nargs="*", default=None,
                    help="restrict to these registry models")
    ap.add_argument("--clusters", nargs="*", default=None,
                    help="restrict to these registry clusters")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the diagnostic report as JSON")
    ap.add_argument("--disable", nargs="*", default=(),
                    metavar="CODE", help="skip these rule codes")
    ap.add_argument("--severity", nargs="*", default=(), metavar="CODE=LEVEL",
                    help="override a rule's severity (e.g. W102=error)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every registered rule and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in list_rules():
            print(f"{r.code}  {r.pack:<8} {r.severity:<8} {r.description}")
        return 0

    if not (args.all_registry or args.models or args.clusters):
        ap.print_help()
        return 0

    models = args.models if args.models else list_configs()
    clusters = args.clusters if args.clusters else list_clusters()
    config = _parse_config(args.disable, args.severity)
    diags = sweep(models, clusters, config)

    if args.json:
        report: Dict[str, Any] = {
            "models": list(models),
            "clusters": list(clusters),
            "diagnostics": [d.to_dict() for d in diags],
            "errors": sum(d.severity == "error" for d in diags),
            "warnings": sum(d.severity == "warning" for d in diags),
        }
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)

    if diags:
        print(format_report(diags))
    else:
        print(f"OK: no diagnostics over {len(models)} model(s) x "
              f"{len(clusters)} cluster(s).")
    return 1 if has_errors(diags) else 0


if __name__ == "__main__":
    sys.exit(main())
