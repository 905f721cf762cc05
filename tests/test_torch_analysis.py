"""The port's static analysis (``repro_torch.analysis``) and
``run_study``'s pre-flight against the JAX package's.

Mirrors ``tests/test_analysis.py``'s ``TestFramework``,
``TestWorkloadRules``, ``TestCompiledRules``, ``TestStudyRules``,
``TestClusterRules`` and its validate gate (``TestValidateGate``,
``TestValidateEquivalence``) on the port: the same violation planted in
each package's object gives the same diagnostics, code, severity, location
and message, and each clean object none. The port's registry holds exactly
the reference's rules of all eight packs (code, pack, severity,
description; V1xx and Y1xx are held case by case in
``tests/test_torch_serving.py`` and ``tests/test_torch_reliability.py``,
F1xx here and in ``tests/test_torch_fleet.py``).
``run_study(validate="warn")`` warns with the reference's text, ``"error"``
raises on what the reference raises on, and the records are identical
across ``"off"``, ``"warn"`` and ``"error"``. The registry sweep command
line (``python -m repro_torch.analysis``, ``TestCli``) takes the
reference's flags, prints its report and exits with its codes, and its
``sweep()`` gives the reference's diagnostics.
"""

import copy
import dataclasses
import json
import math
import warnings

import pytest

import repro.analysis.__main__ as cli_jax
import repro.fleet as fleet_jax
from repro.analysis import AnalysisError as AnalysisErrorJax
from repro.analysis import analyze_fleet as analyze_fleet_jax
from repro.analysis import analyze_cluster as analyze_cluster_jax
from repro.analysis import analyze_compiled as analyze_compiled_jax
from repro.analysis import analyze_study as analyze_study_jax
from repro.analysis import analyze_workload as analyze_workload_jax
from repro.analysis import list_rules as list_rules_jax
from repro.configs import get_config as get_config_jax
from repro.configs import get_dlrm_config as get_dlrm_config_jax
from repro.configs.base import ShapeConfig as ShapeConfigJax
from repro.core import cluster as cluster_jax
from repro.core import dse as dse_jax
from repro.core import gemm as gemm_jax
from repro.core import study as study_jax
from repro.core import workload as workload_jax
import repro_torch.analysis.__main__ as cli
import repro_torch.fleet as fleet
from repro_torch.analysis import (
    AnalysisError,
    Diagnostic,
    RuleConfig,
    analyze_cluster,
    analyze_compiled,
    analyze_fleet,
    analyze_study,
    analyze_workload,
    has_errors,
    list_rules,
    max_severity,
)
from repro_torch.configs import ShapeConfig, get_config, get_dlrm_config
from repro_torch.core import cluster, dse, gemm, study, workload
from repro_torch.core.cluster import CostModel, get_cluster, list_clusters
from repro_torch.core.study import (
    VALIDATE_MODES,
    Axis,
    StudySpec,
    check_path,
    run_study,
)
from repro_torch.core.workload import decompose

PAPER = ("paper", 2048, 1024, "train")
SMALL = ("small", 512, 64, "train")
PORTED_PACKS = ("workload", "compiled", "study", "cluster", "serving",
                "search", "fleet", "reliability")


def codes(diags):
    return sorted({d.code for d in diags})


def same_diagnostics(mine, ref):
    """The port's diagnostics are the reference's, field for field and in
    order."""
    assert [d.to_dict() for d in mine] == [d.to_dict() for d in ref]


class Pkg:
    """One package's modules, so a test plants the same violation in
    both: index 0 is the reference, 1 the port."""

    def __init__(self, i):
        self.i = i
        self.study = (study_jax, study)[i]
        self.cluster = (cluster_jax, cluster)[i]
        self.CommEvent = (gemm_jax, gemm)[i].CommEvent
        self.decompose = (workload_jax, workload)[i].decompose
        self.Shape = (ShapeConfigJax, ShapeConfig)[i]
        self.get_config = (get_config_jax, get_config)[i]
        self.dse = (dse_jax, dse)[i]
        self.analyze_workload = (analyze_workload_jax, analyze_workload)[i]
        self.analyze_compiled = (analyze_compiled_jax, analyze_compiled)[i]
        self.analyze_study = (analyze_study_jax, analyze_study)[i]
        self.analyze_cluster = (analyze_cluster_jax, analyze_cluster)[i]
        self.analyze_fleet = (analyze_fleet_jax, analyze_fleet)[i]
        self.fleet = (fleet_jax, fleet)[i]
        self.cli = (cli_jax, cli)[i]
        self.AnalysisError = (AnalysisErrorJax, AnalysisError)[i]

    @property
    def small_cfg(self):
        return self.get_config("smollm-135m")

    @property
    def small_cluster(self):
        return dataclasses.replace(self.cluster.BASELINE_DGX_A100,
                                   num_nodes=8)

    def wl(self, shape=SMALL, **kw):
        return self.decompose(self.small_cfg, self.Shape(*shape), **kw)


PKGS = (Pkg(0), Pkg(1))


def on_both(build, analyze):
    """``analyze(pkg, build(pkg))`` in each package: the diagnostics must
    agree; returns the port's."""
    ref, mine = (analyze(p, build(p)) for p in PKGS)
    same_diagnostics(mine, ref)
    return mine


# ===================================================================== #
# Framework
# ===================================================================== #

class TestFramework:
    def test_registry_covers_the_ported_packs(self):
        packs = {r.pack for r in list_rules()}
        assert packs == set(PORTED_PACKS)
        assert len(list_rules("workload")) == 5
        assert len(list_rules("compiled")) == 5
        assert len(list_rules("study")) == 4
        assert len(list_rules("cluster")) == 4
        assert len(list_rules("search")) == 3
        assert len(list_rules("serving")) == 4
        assert len(list_rules("reliability")) == 5
        assert len(list_rules("fleet")) == 4
        assert len(list_rules()) == 34

    def test_registry_is_the_references(self):
        def rows(rules):
            return [(r.code, r.pack, r.severity, r.description)
                    for r in rules]
        assert rows(list_rules()) == rows(
            r for r in list_rules_jax() if r.pack in PORTED_PACKS)

    def test_rule_config_disable(self):
        def build(p):
            wl = p.wl(mp=2, dp=4)
            wl.layers[0].stage = 3
            return wl
        assert codes(on_both(build, lambda p, wl: p.analyze_workload(wl))) \
            == ["W104"]
        cfg = RuleConfig(disable=frozenset({"W104"}))
        assert analyze_workload(build(PKGS[1]), config=cfg) == []

    def test_rule_config_severity_override(self):
        def build(p):
            wl = p.wl(mp=2, dp=4)
            wl.layers[0].comm_fwd.append(
                p.CommEvent("all-reduce", 8, "pp", True))
            return wl
        cfg = RuleConfig(disable=frozenset({"W104"}),
                         severity={"W102": "error"})
        diags = analyze_workload(build(PKGS[1]), config=cfg)
        assert codes(diags) == ["W102"] and has_errors(diags)

    def test_rule_config_rejects_unknown_severity(self):
        with pytest.raises(ValueError, match="unknown severity"):
            RuleConfig(severity={"W101": "fatal"})

    def test_max_severity(self):
        wl = PKGS[1].wl(mp=2, dp=4)
        assert max_severity(analyze_workload(wl)) is None
        wl.layers[0].stage = 9
        assert max_severity(analyze_workload(wl)) == "error"


# ===================================================================== #
# W1xx: workload rules
# ===================================================================== #

def workload_diags(build, baseline=None):
    def analyze(p, wl):
        return p.analyze_workload(wl, baseline=None if baseline is None
                                  else baseline(p))
    return on_both(build, analyze)


class TestWorkloadRules:
    @pytest.mark.parametrize("kw", [dict(mp=2, dp=4), dict(mp=1, dp=4, pp=2),
                                    dict(mp=2, dp=2, pp=2, ep=1)])
    def test_clean_decompositions(self, kw):
        assert workload_diags(lambda p: p.wl(**kw)) == []

    def test_w101_bad_scope(self):
        def build(p):
            wl = p.wl(mp=2, dp=4)
            wl.layers[1].comm_fwd.append(
                p.CommEvent("all-reduce", 100, "xx", False))
            return wl
        diags = workload_diags(build)
        assert codes(diags) == ["W101"] and has_errors(diags)

    def test_w102_degenerate_group(self):
        def ep_event(p):
            wl = p.wl(mp=2, dp=4)
            wl.layers[0].comm_wg.append(
                p.CommEvent("all-reduce", 64, "ep", False))
            return wl

        def mp_event(p):
            wl = p.wl(mp=1, dp=8)
            wl.layers[0].comm_fwd.append(
                p.CommEvent("all-gather", 64, "mp", True))
            return wl
        assert workload_diags(ep_event) == []
        diags = workload_diags(mp_event)
        assert codes(diags) == ["W102"]
        assert all(d.severity == "warning" for d in diags)

    def test_w103_conservation_violation(self):
        diags = workload_diags(
            lambda p: p.wl(mp=2, dp=4, pp=2),
            baseline=lambda p: p.wl(("big", 1024, 64, "train"), mp=2, dp=4))
        assert codes(diags) == ["W103"]

    @pytest.mark.parametrize("kw", [dict(mp=2, dp=8, pp=1),
                                    dict(mp=2, dp=4, pp=2),
                                    dict(mp=2, dp=4, ep=2)])
    def test_w103_holds_across_factorizations(self, kw):
        assert workload_diags(lambda p: p.wl(**kw),
                              baseline=lambda p: p.wl(mp=2, dp=8)) == []

    def test_w103_skips_mismatched_baselines(self):
        assert workload_diags(lambda p: p.wl(mp=2, dp=4),
                              baseline=lambda p: p.wl(mp=4, dp=2)) == []

    def test_w104_orphan_stage(self):
        def build(p):
            wl = p.wl(mp=2, dp=4)
            wl.layers[0].stage = 5
            return wl
        diags = workload_diags(build)
        assert codes(diags) == ["W104"] and has_errors(diags)

    def test_w104_missing_stage(self):
        def build(p):
            wl = p.wl(mp=1, dp=4, pp=2)
            for layer in wl.layers:
                layer.stage = 0
            return wl
        assert "W104" in codes(workload_diags(build))

    def test_w104_p2p_off_boundary(self):
        def build(p):
            wl = p.wl(mp=1, dp=4, pp=2)
            wl.layers[1].comm_fwd.append(p.CommEvent("p2p", 64, "pp", True))
            return wl
        assert codes(workload_diags(build)) == ["W104"]

    def test_w105_negative_bytes(self):
        def build(p):
            wl = p.wl(mp=2, dp=4)
            wl.layers[0].comm_ig.append(
                p.CommEvent("all-reduce", -5, "dp", False))
            return wl
        diags = workload_diags(build)
        assert codes(diags) == ["W105"] and has_errors(diags)

    def test_w105_bad_layer_fields(self):
        def build(p):
            wl = p.wl(mp=2, dp=4)
            wl.layers[2].weight_bytes = float("inf")
            wl.layers[3].repeat = 0
            return wl
        diags = workload_diags(build)
        assert codes(diags) == ["W105"] and len(diags) >= 2


# ===================================================================== #
# C1xx: compiled rules
# ===================================================================== #

def compiled_diags(mutate=None, **kw):
    """C1xx on each package's lowering of smollm-135m at ``kw`` (default
    (2, 4, pp 2)), after ``mutate(cw)`` on a deep copy."""
    kw = kw or dict(mp=2, dp=4, pp=2)

    def analyze(p, pair):
        wl, cw = pair
        return p.analyze_compiled(cw, workload=wl)

    def build(p):
        wl = p.wl(**kw)
        cw = copy.deepcopy(wl.compiled())
        if mutate is not None:
            mutate(cw)
        return wl, cw
    return on_both(build, analyze)


def _drop_last_event(cw):
    p = cw.stages[0].fwd
    for field in ("ev_pos", "ev_comm", "ev_blocking", "ev_scope",
                  "ev_phase"):
        setattr(p, field, getattr(p, field)[:-1])


def _bump(field, amount):
    def mutate(cw):
        stage = cw.stages[0 if field != "dense_w" else 1]
        if field == "comm_sizes":
            stage.comm_sizes[0] += amount
        elif field == "counts":
            stage.counts[0, 0] += amount
        else:
            setattr(stage, field, getattr(stage, field) + amount)
    return mutate


class TestCompiledRules:
    def test_clean_lowering(self):
        assert compiled_diags() == []
        wl = PKGS[1].wl(mp=2, dp=4, pp=2)
        assert analyze_compiled(wl.compiled()) == []

    def test_c101_missing_stage(self):
        assert "C101" in codes(compiled_diags(lambda cw: cw.stages.pop()))

    def test_c102_dropped_event(self):
        diags = compiled_diags(_drop_last_event)
        assert "C102" in codes(diags) and has_errors(diags)

    def test_c103_mutated_bytes(self):
        assert "C103" in codes(compiled_diags(_bump("comm_sizes", 7.0)))

    def test_c104_mutated_counts(self):
        assert codes(compiled_diags(_bump("counts", 1))) == ["C104"]

    def test_c105_mutated_optimizer_totals(self):
        assert codes(compiled_diags(_bump("dense_w", 100.0))) == ["C105"]

    @pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                      "mamba2-780m"])
    def test_registry_models_lower_cleanly(self, arch):
        cfg = get_config(arch)
        wl = decompose(cfg, ShapeConfig(*SMALL), mp=2, dp=2, ep=2)
        assert analyze_compiled(wl.compiled()) == []

    def test_pass_event_totals_are_the_references(self):
        """C102/C103 read ``pass_event_totals``, which the port's lowering
        carries as the reference's does."""
        from repro.core.compiled import pass_event_totals as totals_jax
        from repro_torch.core.compiled import pass_event_totals
        ref = PKGS[0].wl(mp=2, dp=4, pp=2).compiled()
        mine = PKGS[1].wl(mp=2, dp=4, pp=2).compiled()
        for a, b in zip(ref.stages, mine.stages):
            assert pass_event_totals(b) == totals_jax(a)


# ===================================================================== #
# S1xx: study rules + the construction-time path check
# ===================================================================== #

def small_spec(p, **kw):
    kw.setdefault("name", "s")
    return p.study.StudySpec(model=p.small_cfg, shape=p.Shape(*SMALL),
                             cluster=p.small_cluster, **kw)


def study_diags(build):
    return on_both(build, lambda p, spec: p.analyze_study(spec))


class TestStudyRules:
    @pytest.mark.parametrize("validate", VALIDATE_MODES)
    def test_typo_path_fails_at_construction(self, validate):
        """The misspelled dotted path raises the available-fields error
        before run_study runs a cell, whatever the pre-flight's mode."""
        small = PKGS[1]
        with pytest.raises(AttributeError,
                           match="no field 'peak_flpos'.*available"):
            spec = StudySpec(
                name="typo", model=small.small_cfg,
                shape=ShapeConfig(*SMALL), cluster=small.small_cluster,
                strategies=(2, 4),
                axes=[Axis("flops", (0.5, 2.0), path="node.peak_flpos",
                           mode="scale")])
            run_study(spec, validate=validate, device="cpu")

    def test_nested_typo_path(self):
        with pytest.raises(AttributeError, match="no field 'intra_bandwith'"):
            StudySpec(name="typo", model=PKGS[1].small_cfg,
                      shape=ShapeConfig(*SMALL),
                      cluster=PKGS[1].small_cluster,
                      axes=[Axis("bw", (1.0,),
                                 path="topology.intra_bandwith")])

    def test_path_behind_apply_axis_is_deferred(self):
        spec = StudySpec(
            name="deferred", model=PKGS[1].small_cfg,
            shape=ShapeConfig(*SMALL), cluster=PKGS[1].small_cluster,
            axes=[Axis("swap", (1,), apply=lambda cl, _: cl),
                  Axis("maybe", (1.0,), path="node.peak_flpos")])
        assert spec.axes[1].path == "node.peak_flpos"
        assert analyze_study(spec) == []

    def test_check_path_resolves_valid_paths(self):
        small_cluster = PKGS[1].small_cluster
        check_path(small_cluster, "node.peak_flops")
        check_path(small_cluster, "topology.intra_bw")
        with pytest.raises(TypeError, match="non-dataclass"):
            check_path(small_cluster, "num_nodes.nope")

    def test_s101_on_mutated_axes(self):
        def build(p):
            spec = small_spec(p, strategies=(2, 4))
            spec.axes = [p.study.Axis("bad", (1.0,), path="node.nope")]
            return spec
        assert codes(study_diags(build)) == ["S101"]

    def test_s102_metric_shadows_record_column(self):
        diags = study_diags(lambda p: small_spec(
            p, strategies=(2, 4), metrics={"total": lambda ctx: 0.0}))
        assert codes(diags) == ["S102"] and has_errors(diags)

    def test_s102_metric_shadows_axis(self):
        diags = study_diags(lambda p: small_spec(
            p, strategies=(2, 4),
            axes=[p.study.Axis("bw_x", (1.0,), path="node.local_bw",
                               mode="scale")],
            metrics={"bw_x": lambda ctx: 0.0}))
        assert codes(diags) == ["S102"]

    def test_s103_unknown_placement_value(self):
        diags = study_diags(lambda p: small_spec(
            p, strategies=(2, 4),
            axes=[p.study.placement_axis(("paper", "not-a-placement"))]))
        assert codes(diags) == ["S103"]

    def test_s104_empty_strategy_space(self):
        diags = study_diags(lambda p: small_spec(
            p, strategies=p.study.GridSpace(mp=(3,), dp=(5,))))
        assert codes(diags) == ["S104"]
        assert max_severity(diags) == "warning"

    def test_figure_studies_are_clean(self):
        ref = dse_jax.figure_studies()
        for name, spec in dse.figure_studies().items():
            diags = analyze_study(spec)
            same_diagnostics(diags, analyze_study_jax(ref[name]))
            assert [d for d in diags if d.severity == "error"] == [], name


# ===================================================================== #
# K1xx: cluster rules
# ===================================================================== #

def cluster_diags(build):
    return on_both(build, lambda p, cl: p.analyze_cluster(cl))


class TestClusterRules:
    @pytest.mark.parametrize("name", list_clusters())
    def test_registry_clusters_have_no_errors(self, name):
        diags = cluster_diags(lambda p: p.cluster.get_cluster(name))
        assert not has_errors(diags), f"{name}: {diags}"

    def test_k101_ragged_pod(self):
        diags = cluster_diags(
            lambda p: dataclasses.replace(p.small_cluster, num_nodes=12))
        assert codes(diags) == ["K101"]
        assert max_severity(diags) == "warning"

    def test_k102_inverted_hierarchy(self):
        def build(p):
            cl = p.small_cluster
            return cl.with_topology(dataclasses.replace(
                cl.topology, inter_bw=cl.topology.intra_bw * 4))
        assert codes(cluster_diags(build)) == ["K102"]

    def test_k103_negative_price(self):
        diags = cluster_diags(lambda p: p.small_cluster.with_cost(
            p.cluster.CostModel(usd_per_node=-1.0)))
        assert codes(diags) == ["K103"] and has_errors(diags)

    def test_k103_missing_cost_is_info(self):
        diags = cluster_diags(lambda p: p.small_cluster.with_cost(None))
        assert codes(diags) == ["K103"]
        assert max_severity(diags) == "info"

    def test_k104_zero_flops(self):
        diags = cluster_diags(lambda p: p.small_cluster.with_node(
            dataclasses.replace(p.small_cluster.node, peak_flops=0.0)))
        assert codes(diags) == ["K104"] and has_errors(diags)

    def test_k104_em_capacity_without_bandwidth(self):
        diags = cluster_diags(lambda p: p.small_cluster.with_node(
            p.small_cluster.node.with_expansion(cap=1e12, bw=0.0)))
        assert codes(diags) == ["K104"]

    def test_cost_model_is_the_ports(self):
        bad = PKGS[1].small_cluster.with_cost(CostModel(usd_per_kwh=-2.0))
        assert codes(analyze_cluster(bad)) == ["K103"]
        assert get_cluster("B1").cost is not None


# ===================================================================== #
# run_study(validate=...)
# ===================================================================== #

def bad_spec(p):
    spec = small_spec(p, name="bad", strategies=(2, 4))
    spec.axes = [p.study.Axis("bad", (1.0,), path="node.nope")]
    return spec


def empty_spec(p):
    return small_spec(p, name="empty",
                      strategies=p.study.GridSpace(mp=(3,), dp=(5,)))


def warned(run):
    """The messages of the warnings ``run()`` raises, and its result."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = run()
    return [str(w.message) for w in caught], out


class TestValidateGate:
    def test_error_mode_raises(self):
        with pytest.raises(AnalysisError) as exc:
            run_study(bad_spec(PKGS[1]), validate="error", device="cpu")
        assert any(d.code == "S101" for d in exc.value.diagnostics)
        with pytest.raises(AnalysisErrorJax) as ref:
            study_jax.run_study(bad_spec(PKGS[0]), validate="error")
        assert str(exc.value) == str(ref.value)
        same_diagnostics(exc.value.diagnostics, ref.value.diagnostics)

    def test_warn_mode_warns_and_runs(self):
        with pytest.warns(UserWarning, match="S104"):
            res = run_study(empty_spec(PKGS[1]), validate="warn",
                            device="cpu")
        assert len(res) == 0

    def test_warn_is_the_default(self):
        with pytest.warns(UserWarning, match="S104"):
            run_study(empty_spec(PKGS[1]), device="cpu")

    def test_warning_text_is_the_references(self):
        mine, _ = warned(lambda: run_study(empty_spec(PKGS[1]),
                                           validate="warn", device="cpu"))
        ref, _ = warned(lambda: study_jax.run_study(empty_spec(PKGS[0]),
                                                    validate="warn"))
        assert len(mine) == 1 and mine == ref
        assert mine[0].startswith("study 'empty' pre-flight:\n")

    def test_warning_points_at_the_caller(self):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run_study(empty_spec(PKGS[1]), validate="warn", device="cpu")
        assert caught[0].filename == __file__

    def test_off_mode_is_silent(self):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            run_study(empty_spec(PKGS[1]), validate="off", device="cpu")

    def test_info_findings_stay_silent(self):
        """A cluster with no cost model gives K103 at info only: the gate
        neither warns nor raises."""
        spec = small_spec(PKGS[1], strategies=(2, 4))
        spec.cluster = spec.cluster.with_cost(None)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            res = run_study(spec, validate="error", device="cpu")
        assert len(res) == 1

    def test_unknown_mode_rejected(self):
        with pytest.raises(ValueError, match="validate"):
            run_study(small_spec(PKGS[1], strategies=(2, 4)),
                      validate="loud", device="cpu")


class TestValidateEquivalence:
    """validate= must be purely observational: identical records with the
    gate off, warning and erroring, across every paper-figure study
    (reduced grids)."""

    @staticmethod
    def figure_spec(fig, p):
        t = p.get_config("transformer-1t")
        d = (get_dlrm_config_jax, get_dlrm_config)[p.i]()
        shape = p.Shape(*PAPER)
        base = p.cluster.BASELINE_DGX_A100
        mod = p.dse
        return {
            "fig8": lambda: mod.mpdp_study(t, shape, base),
            "fig9": lambda: mod.memory_expansion_study(
                t, shape, base, em_bandwidths_gbs=(100, 1000, 2000),
                strategies=[(32, 32), (8, 128)]),
            "fig10": lambda: mod.compute_scaling_study(
                t, shape, base, 8, 128, compute_factors=(0.5, 1.0, 2.0),
                em_bandwidths_gbs=(500, 2000)),
            "fig11": lambda: mod.network_scaling_study(
                t, shape, base, 64, 16, intra_factors=(0.5, 2.0),
                inter_factors=(1.0, 2.0)),
            "fig12": lambda: mod.bandwidth_rebalance_study(
                t, shape, base, 64, 16, ratios=(1, 6, 9.6, 16)),
            "fig13a": lambda: mod.dlrm_cluster_size_study(
                d, base, global_batch=65536, node_counts=(64, 16, 8)),
            "fig13b": lambda: mod.dlrm_memory_expansion_study(
                d, base, global_batch=65536, em_bandwidths_gbs=(500, 2000),
                nodes_per_instance_opts=(64, 8)),
        }[fig]()

    @pytest.mark.parametrize("fig", ["fig8", "fig9", "fig10", "fig11",
                                     "fig12", "fig13a", "fig13b"])
    def test_records_identical(self, fig):
        spec = self.figure_spec(fig, PKGS[1])
        off = run_study(spec, validate="off", device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            warn = run_study(spec, validate="warn", device="cpu")
            error = run_study(spec, validate="error", device="cpu")
        assert off.records == warn.records == error.records
        ref = study_jax.run_study(self.figure_spec(fig, PKGS[0]),
                                  validate="off")
        assert [list(r) for r in off.records] == \
            [list(r) for r in ref.records]

    def test_default_studies_pass_the_error_gate(self):
        """The case studies the paper's figures and the rankings run: no
        diagnostic in either package."""
        def specs(p):
            t, d = p.get_config("transformer-1t"), (
                get_dlrm_config_jax, get_dlrm_config)[p.i]()
            shape = p.Shape(*PAPER)
            return [*p.dse.figure_studies().values(),
                    *p.dse.cluster_comparison_studies(t, shape, d, 65536),
                    p.dse.pp_ep_study(), p.dse.placement_study(),
                    p.dse.multi_tenant_study(),
                    p.dse.hetero_cost_study(t, shape)]
        for ref, mine in zip(specs(PKGS[0]), specs(PKGS[1])):
            assert mine.name == ref.name
            diags = analyze_study(mine)
            if mine.cluster is not None:
                diags += analyze_cluster(mine.cluster)
            assert [d for d in diags if d.severity != "info"] == [], \
                mine.name
            study_jax._validate_spec(ref, "error")
            study._validate_spec(mine, "error")

    def test_fleet_studies_pass_the_error_gate(self):
        """The fleet studies lowered as run_study lowers them: F1xx on the
        FleetSpec, Y1xx on the injected failure trace, no diagnostic in
        either package."""
        for build in (lambda p: p.dse.fleet_study(),
                      lambda p: p.dse.reliability_fleet_study()):
            ref, mine = (build(p).to_study() for p in PKGS)
            assert mine.fleet is not None and mine.name == ref.name
            study_jax._validate_spec(ref, "error")
            study._validate_spec(mine, "error")


# ===================================================================== #
# F1xx: fleet rules
# ===================================================================== #

def _fleet_spec(p, jobs=None, **kw):
    jobs = jobs if jobs is not None else (
        p.fleet.FleetJobSpec(name="chat", model="chatglm3-6b", mp=2,
                             global_batch=256, nodes_per_instance=8,
                             widths=(8, 16, 32), iterations=10),)
    return p.fleet.FleetSpec(**{
        "name": "f-test", "jobs": jobs, "cluster": p.dse.mixed_dlrm_fleet(),
        "ftrace": p.fleet.FleetTrace(kind="static"),
        "placement": "em-aware", **kw})


def _job(p, name="j", **kw):
    return p.fleet.FleetJobSpec(name=name, model="chatglm3-6b", mp=2,
                                **kw)


FLEET_CASES = {
    "clean_fleet_study": ((), lambda p: p.dse.fleet_study()),
    "clean_reliability_fleet_study": (
        (), lambda p: p.dse.reliability_fleet_study()),
    "clean_small": ((), lambda p: _fleet_spec(p)),
    "f101_wider_than_every_group": (("F101",), lambda p: _fleet_spec(
        p, jobs=(_job(p, "wide", nodes_per_instance=64),
                 _job(p, "ok", nodes_per_instance=8)))),
    "f101_over_own_cap": (("F101",), lambda p: _fleet_spec(
        p, jobs=(_job(p, "c", nodes_per_instance=16, max_nodes=8),))),
    "f101_no_cluster_is_silent": ((), lambda p: _fleet_spec(
        p, cluster=None, jobs=(_job(p, "wide", nodes_per_instance=64),))),
    "f102_rate_and_jobs": (("F102", "F102", "F102", "F102"),
                           lambda p: _fleet_spec(
        p, ftrace=p.fleet.FleetTrace(kind="poisson", rate=0.0, num_jobs=0),
        axes=[p.study.Axis("rate", (1e-3, -1.0), path="ftrace.rate"),
              p.study.Axis("n", (4, -2), path="ftrace.num_jobs")])),
    "f102_static_ignores_rate": ((), lambda p: _fleet_spec(
        p, ftrace=p.fleet.FleetTrace(kind="static", rate=-1.0))),
    "f103_burst_window_and_instances": (("F103", "F103", "F103"),
                                        lambda p: _fleet_spec(
        p, jobs=(_job(p, "b", nodes_per_instance=8, iterations=4,
                      burst_iters=9, instances=2),))),
    "f103_widths_not_divisible": (("F103", "F103"), lambda p: _fleet_spec(
        p, jobs=(_job(p, "o", nodes_per_instance=8, widths=(3, 9)),))),
    "f103_dlrm_skips_mp": ((), lambda p: _fleet_spec(
        p, jobs=(p.fleet.FleetJobSpec(name="d", model="dlrm", mp=4,
                                      nodes_per_instance=16,
                                      widths=(16, 18)),))),
    "f104_costs": (("F104", "F104", "F104", "F104"), lambda p: _fleet_spec(
        p, fleet=p.fleet.FleetModel(policy="elastic", checkpoint_bw=0.0,
                                    reshard_bw=math.nan,
                                    lend_overhead=math.inf),
        axes=[p.study.Axis("bw", (1e9, -5.0),
                           path="fleet.reshard_bw")])),
    "f104_scale_axis_not_swept": ((), lambda p: _fleet_spec(
        p, axes=[p.study.Axis("bw", (0.5, 2.0), path="fleet.checkpoint_bw",
                              mode="scale")])),
}


class TestFleetRules:
    @pytest.mark.parametrize("case", sorted(FLEET_CASES))
    def test_fleet_rules_are_the_references(self, case):
        want, build = FLEET_CASES[case]
        diags = on_both(build, lambda p, spec: p.analyze_fleet(spec))
        assert [d.code for d in diags] == list(want)
        assert all(d.severity == "error" for d in diags)

    def test_fleet_rule_config(self):
        build = FLEET_CASES["f104_costs"][1]
        cfg = RuleConfig(disable=frozenset({"F104"}))
        assert analyze_fleet(build(PKGS[1]), config=cfg) == []
        cfg = RuleConfig(severity={"F104": "warning"})
        diags = analyze_fleet(build(PKGS[1]), config=cfg)
        assert {d.severity for d in diags} == {"warning"}
        assert not has_errors(diags)

    def test_validate_gate_runs_the_fleet_pack(self):
        """run_study's pre-flight lowers a FleetSpec and raises on an F1xx
        error with the reference's text; warns with it by default."""
        texts = []
        for p in PKGS:
            bad = FLEET_CASES["f101_over_own_cap"][1](p)
            run = (study.run_study if p.i else study_jax.run_study)
            kw = {"device": "cpu"} if p.i else {}
            with pytest.raises(p.AnalysisError, match="F101") as err:
                run(bad, validate="error", **kw)
            texts.append(str(err.value))
        assert texts[1] == texts[0]
        with pytest.warns(UserWarning, match="F101"):
            run_study(FLEET_CASES["f101_over_own_cap"][1](PKGS[1]),
                      device="cpu")


# ===================================================================== #
# The registry sweep command line
# ===================================================================== #

SUBSET = ["--models", "smollm-135m", "--clusters", "dojo"]


def cli_both(argv, capsys):
    """``main(argv)`` of each package: (return codes, printed outputs)."""
    rcs, outs = [], []
    for p in PKGS:
        rcs.append(p.cli.main(list(argv)))
        outs.append(capsys.readouterr().out)
    return rcs, outs


class TestCli:
    def test_subset_sweep_exits_zero(self, capsys):
        rcs, outs = cli_both(SUBSET, capsys)
        assert rcs == [0, 0]
        assert outs[1] == outs[0]
        assert outs[1] == \
            "OK: no diagnostics over 1 model(s) x 1 cluster(s).\n"

    def test_json_report(self, tmp_path, capsys):
        reports = []
        for p in PKGS:
            out = tmp_path / f"report{p.i}.json"
            assert p.cli.main(SUBSET + ["--json", str(out)]) == 0
            reports.append(json.loads(out.read_text()))
        capsys.readouterr()
        assert reports[1] == reports[0]
        assert reports[1]["errors"] == 0
        assert reports[1]["models"] == ["smollm-135m"]
        assert reports[1]["clusters"] == ["dojo"]

    def test_list_rules(self, capsys):
        rcs, outs = cli_both(["--list-rules"], capsys)
        assert rcs == [0, 0]
        assert outs[1] == outs[0]
        for code in ("W101", "C103", "S101", "K104", "V101", "R101", "F101",
                     "F104", "Y105"):
            assert code in outs[1]
        assert len(outs[1].splitlines()) == 34

    def test_error_findings_exit_nonzero(self, monkeypatch, capsys):
        for p, diag in zip(PKGS, (cli_jax.Diagnostic, Diagnostic)):
            monkeypatch.setattr(p.cli, "sweep", lambda *a, d=diag, **k: [
                d("W101", "error", "somewhere", "planted")])
        rcs, outs = cli_both(SUBSET, capsys)
        assert rcs == [1, 1]
        assert outs[1] == outs[0]
        assert "W101" in outs[1]

    def test_warning_findings_exit_zero(self, monkeypatch, capsys):
        monkeypatch.setattr(cli, "sweep", lambda *a, **k: [
            Diagnostic("Y105", "warning", "somewhere", "planted")])
        assert cli.main(SUBSET) == 0
        assert "Y105" in capsys.readouterr().out

    def test_disable_flag(self, monkeypatch):
        captured = {}

        def fake_sweep(models, clusters, config=None):
            captured["args"] = (models, clusters)
            captured["config"] = config
            return []

        monkeypatch.setattr(cli, "sweep", fake_sweep)
        rc = cli.main(SUBSET + ["--disable", "W102", "--severity",
                                "K101=error"])
        assert rc == 0
        assert captured["args"] == (["smollm-135m"], ["dojo"])
        assert not captured["config"].enabled("W102")
        assert captured["config"].severity["K101"] == "error"

    def test_flag_errors_and_help(self, capsys):
        with pytest.raises(SystemExit, match="CODE=LEVEL"):
            cli.main(SUBSET + ["--severity", "K101"])
        assert cli.main([]) == 0
        assert "python -m repro_torch.analysis" in capsys.readouterr().out

    def test_sweep_is_the_references(self):
        """The port's sweep over a subset (a dense LM and a MoE, a torus and
        a Table III cluster) gives the reference's diagnostics; so does a
        sweep whose clusters carry planted faults."""
        models = ["smollm-135m", "granite-moe-3b-a800m"]
        clusters = ["dojo", "B1"]
        diags = [p.cli.sweep(models, clusters) for p in PKGS]
        assert [d.to_dict() for d in diags[1]] == \
            [d.to_dict() for d in diags[0]]

    def test_sweep_of_planted_faults_is_the_references(self, monkeypatch):
        for p in PKGS:
            real = p.cli.get_cluster

            def planted(name, _real=real, _p=p):
                cl = _real(name)
                return cl.with_cost(_p.cluster.CostModel(usd_per_node=-1.0))
            monkeypatch.setattr(p.cli, "get_cluster", planted)
        diags = [p.cli.sweep(["smollm-135m"], ["dojo", "B0"],
                             RuleConfig(severity={"K103": "warning"})
                             if p.i else cli_jax.RuleConfig(
                                 severity={"K103": "warning"}))
                 for p in PKGS]
        assert [d.to_dict() for d in diags[1]] == \
            [d.to_dict() for d in diags[0]]
        assert {d.code for d in diags[1]} == {"K103"}
        assert {d.severity for d in diags[1]} == {"warning"}
        assert cli.format_report(diags[1]) == \
            cli_jax.format_report(diags[0])
