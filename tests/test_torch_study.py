"""The port's study runner (``repro_torch.core.study.run_study``) and case
studies (``repro_torch.core.dse``) against the JAX package's.

Each study is built with each package's own builder; the reference runs
through ``run_study(engine="compiled", validate="off")`` and the port
through ``run_study(..., device="cpu")``. Records must have the same keys
in the same order, the same type column by column, the same non-float
values, and floats within 1e-9 relative (the rule of
``tests/test_compiled.py::assert_records_equivalent``). The twelve goldens
of ``tests/test_compiled.py`` run at their sizes there; two of them are
also held to the reference's event loop (``engine="reference"``). Then
``StudyResult``, the runner's memo and prefetch, and the refusals that name
their ROADMAP item.
"""

import csv
import dataclasses
import io
import json
import math
import os
import signal
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.configs import get_dlrm_config as get_dlrm_config_jax
from repro.configs.base import ShapeConfig as ShapeConfigJax
from repro.core import dse as dse_jax
from repro.core import study as study_jax
from repro_torch.configs import ShapeConfig, get_config, get_dlrm_config
from repro_torch.convert import from_jax_cluster
from repro_torch.core import cluster, dse, simulator, study
from repro_torch.core.study import (
    Axis,
    ExplicitSpace,
    GridSpace,
    ParallelSpec,
    placement_axis,
    run_study,
)
from torch_pool_bound import pool_bound

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-9
PAPER = ("paper", 2048, 1024, "train")
SMALL = ("small", 512, 64, "train")


def assert_records_equivalent(ref, mine, rel: float = REL) -> None:
    """Same keys in the same order, the same type column by column, the
    same non-float values, floats within ``rel`` (abs 1e-12; inf and nan
    by their text)."""
    assert len(ref) == len(mine)
    for ra, rb in zip(ref.records, mine.records):
        assert list(ra) == list(rb)
        for k, va in ra.items():
            vb = rb[k]
            assert type(va) is type(vb), f"{k}: {type(va)} vs {type(vb)}"
            if isinstance(va, float):
                if math.isnan(va) or math.isinf(va):
                    assert str(va) == str(vb), k
                else:
                    assert va == pytest.approx(vb, rel=rel, abs=1e-12), \
                        f"{k}: {va} vs {vb}"
            else:
                assert va == vb, f"{k}: {va!r} vs {vb!r}"


def run_both(ref_spec, spec, engine="compiled"):
    ref = study_jax.run_study(ref_spec, engine=engine, validate="off")
    mine = run_study(spec, device="cpu")
    assert_records_equivalent(ref, mine)
    return ref, mine


@pytest.fixture(scope="module")
def models():
    """(transformer-1t, paper shape, DLRM) of each package: reference
    first."""
    return ((get_config_jax("transformer-1t"), ShapeConfigJax(*PAPER),
             get_dlrm_config_jax()),
            (get_config("transformer-1t"), ShapeConfig(*PAPER),
             get_dlrm_config()))


# ===================================================================== #
# The twelve goldens of tests/test_compiled.py
# ===================================================================== #

def _golden(name, pkg):
    """The study ``name`` built with ``pkg``'s own builders (0: the
    reference, 1: the port) at the size of tests/test_compiled.py."""
    from repro.core import cluster as cluster_jax
    mod, cl_mod = (dse_jax, cluster_jax) if pkg == 0 else (dse, cluster)
    cfg = (get_config_jax if pkg == 0 else get_config)("transformer-1t")
    shape = (ShapeConfigJax if pkg == 0 else ShapeConfig)(*PAPER)
    dlrm = (get_dlrm_config_jax if pkg == 0 else get_dlrm_config)()
    grid = (study_jax.GridSpace if pkg == 0 else GridSpace)
    base = cl_mod.BASELINE_DGX_A100
    return {
        "fig8": lambda: [mod.mpdp_study(cfg, shape, base)],
        "fig9": lambda: [mod.memory_expansion_study(
            cfg, shape, base, em_bandwidths_gbs=(100, 500, 2000),
            strategies=[(32, 32), (8, 128)])],
        "fig10": lambda: [mod.compute_scaling_study(
            cfg, shape, base, 8, 128, compute_factors=(0.5, 1.0, 4.0),
            em_bandwidths_gbs=(500, 2000))],
        "fig11": lambda: [mod.network_scaling_study(
            cfg, shape, base, 64, 16, intra_factors=(0.5, 2.0),
            inter_factors=(1.0, 4.0))],
        "fig12": lambda: [mod.bandwidth_rebalance_study(
            cfg, shape, base, 8, 128, ratios=(1, 4, 9.6))],
        "fig13a": lambda: [mod.dlrm_cluster_size_study(
            dlrm, base, global_batch=65536)],
        "fig13b": lambda: [mod.dlrm_memory_expansion_study(
            dlrm, base, global_batch=65536, em_bandwidths_gbs=(500, 1500),
            nodes_per_instance_opts=(64, 8))],
        "fig15": lambda: list(mod.cluster_comparison_studies(
            cfg, shape, dlrm, 65536)),
        "pp_ep": lambda: [mod.pp_ep_study(
            mp=(8, 16), dp=(4, 8, 16, 32), pp=(1, 2), ep=(1, 2),
            clusters=("A0", "B1"))],
        "placement": lambda: [mod.placement_study(
            cfg=cfg, em_pod_fractions=(0.0, 0.5),
            strategies=grid(mp=(16,), dp=(16, 32), pp=(2, 4)))],
        "multi_tenant": lambda: [mod.multi_tenant_study(
            nodes_per_instance_opts=(64, 16))],
        "hetero": lambda: [mod.hetero_cost_study(
            cfg, shape, em_pod_fractions=(0.0, 0.5, 1.0),
            strategies=[(64, 16), (8, 128)])],
    }[name]()


GOLDENS = ["fig8", "fig9", "fig10", "fig11", "fig12", "fig13a", "fig13b",
           "fig15", "pp_ep", "placement", "multi_tenant", "hetero"]


@pytest.mark.parametrize("name", GOLDENS)
def test_study_golden_matches_reference(name):
    for ref_spec, spec in zip(_golden(name, 0), _golden(name, 1)):
        assert spec.name == ref_spec.name
        _, mine = run_both(ref_spec, spec)
        assert len(mine) > 0
        assert all(math.isfinite(r["total"]) for r in mine.records
                   if "infeasible_reason" not in r)


@pytest.mark.parametrize("name", ["placement", "multi_tenant"])
def test_study_golden_matches_the_event_loop(name):
    """The NumPy engine is not the only oracle: the reference's event loop
    on the two placement studies (an assigned pipeline, a mixed-fleet
    schedule)."""
    for ref_spec, spec in zip(_golden(name, 0), _golden(name, 1)):
        run_both(ref_spec, spec, engine="reference")


def test_study_defaults_match_reference(models):
    """The builders' defaults: the figure registry and the defaults of the
    beyond-paper studies build the same cells as the reference's."""
    (tcfg_j, shape_j, dlrm_j), (tcfg, shape, dlrm) = models
    ref = dse_jax.figure_studies()
    mine = dse.figure_studies()
    assert list(mine) == list(ref)
    pairs = [(ref[key], mine[key]) for key in ref]
    pairs += [(dse_jax.placement_study(), dse.placement_study()),
              (dse_jax.multi_tenant_study(), dse.multi_tenant_study()),
              (dse_jax.pp_ep_study(), dse.pp_ep_study()),
              (dse_jax.hetero_cost_study(tcfg_j, shape_j),
               dse.hetero_cost_study(tcfg, shape))]
    pairs += list(zip(dse_jax.cluster_comparison_studies(tcfg_j, shape_j,
                                                         dlrm_j),
                      dse.cluster_comparison_studies(tcfg, shape, dlrm)))

    def cell_ids(cells):
        return [(s.label if s else None, p, c.name, pl.label if pl else None)
                for s, p, c, pl in cells]

    for spec_ref, spec in pairs:
        assert spec.name == spec_ref.name
        assert cell_ids(study._cells(spec)) == \
            cell_ids(study_jax._cells(spec_ref))


def test_dlrm_nodes_per_instance_on_mixed_fleets():
    assert dse._dlrm_nodes_per_instance(cluster.B_HYBRID_EM) == 64
    assert dse._dlrm_nodes_per_instance(cluster.TABLE_III_CLUSTERS["B1"]) == 16
    assert dse._dlrm_nodes_per_instance(cluster.TABLE_III_CLUSTERS["B2"]) == 8
    fleet = dse.mixed_dlrm_fleet()
    assert fleet == from_jax_cluster(dse_jax.mixed_dlrm_fleet())
    with pytest.raises(ValueError, match="em_pod_frac"):
        dse._em_pod_mix()(None, 1.5)


# ===================================================================== #
# The runner: prefetch, memo, record assembly
# ===================================================================== #

def _small_spec(pkg=1, **kw):
    """A small study of smollm-135m on 8 nodes of the DGX baseline."""
    from repro.core import cluster as cluster_jax
    cfg = (get_config_jax if pkg == 0 else get_config)("smollm-135m")
    shape = (ShapeConfigJax if pkg == 0 else ShapeConfig)(*SMALL)
    base = (cluster_jax if pkg == 0 else cluster).BASELINE_DGX_A100
    mod = study_jax if pkg == 0 else study
    defaults = dict(
        name="small", model=cfg, shape=shape,
        cluster=dataclasses.replace(base, num_nodes=8),
        strategies=mod.GridSpace(mp=(1, 2, 4, 8), dp=(1, 2, 4, 8)),
        axes=[mod.Axis("bw_x", (0.5, 1.0), path="node.local_bw",
                       mode="scale")])
    defaults.update(kw)
    return mod.StudySpec(**defaults)


def test_one_prefetch_batch_a_strategy_and_placement(monkeypatch):
    """placement_study (reduced): one time_compiled batch per (strategy,
    placement) whose cells are not assigned, none from a cache miss, and
    the assigned cells timed stage by stage."""
    calls, assigned, staged = [], [], []
    real_time, real_assign = simulator.time_compiled, \
        study.compiled_stage_assignment
    real_staged = simulator._time_compiled_assigned

    def count_time(cw, envs, *a, **k):
        calls.append((cw.workload.mp, cw.workload.dp, cw.workload.pp,
                      len(envs)))
        return real_time(cw, envs, *a, **k)

    def count_assign(*a, **k):
        out = real_assign(*a, **k)
        assigned.append(out is not None)
        return out

    def count_staged(*a, **k):
        staged.append(1)
        return real_staged(*a, **k)

    monkeypatch.setattr(study, "time_compiled", count_time)
    monkeypatch.setattr(simulator, "time_compiled", count_time)
    monkeypatch.setattr(study, "compiled_stage_assignment", count_assign)
    monkeypatch.setattr(simulator, "_time_compiled_assigned", count_staged)
    spec = _golden("placement", 1)[0]
    res = run_study(spec, device="cpu")
    cells = study._cells(spec)
    assert len(res) == len(cells) == 8
    strategies = {s for s, _, _, _ in cells}
    placements = {pl for _, _, _, pl in cells}
    assert len(calls) == len(strategies) * len(placements)
    assert sum(assigned) == 2 and len(staged) == 2
    # A strategy's paper batch holds the plain node and the EM node (the
    # all-plain fleet's one environment is the half-EM fleet's first); its
    # em-aware batch only the all-plain fleet's (the half-EM cells are
    # assigned).
    assert sorted(n for *_, n in calls) == [1, 1, 2, 2]


def test_cost_axis_shares_one_simulation(monkeypatch):
    """The simulator never reads the cost model: a pure cost-axis sweep
    simulates each physical configuration once."""
    calls = []
    real = study.simulate_iteration_compiled

    def count(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(study, "simulate_iteration_compiled", count)
    prices = (0.0, 8.0, 20.0)

    def spec(pkg):
        mod = study_jax if pkg == 0 else study
        return _small_spec(pkg, strategies=mod.GridSpace(mp=(2, 4),
                                                         dp=(2, 4)),
                           axes=[mod.Axis("em_price", prices,
                                          path="cost.usd_per_gb_em")])
    ref, mine = run_both(spec(0), spec(1))
    strategies = {s for s, _, _, _ in study._cells(spec(1))}
    assert len(calls) == len(strategies) == 2
    assert len(mine) == 2 * len(prices)
    assert len({r["tco"] for r in mine.records}) == 1   # no EM to price
    assert all("perf_per_dollar" in r for r in mine.records)


def test_raising_metric_leaves_run_study_reusable():
    def boom(ctx):
        raise RuntimeError("metric exploded")

    with pytest.raises(RuntimeError, match="metric exploded"):
        run_study(_small_spec(metrics={"boom": boom}), device="cpu")
    first = run_study(_small_spec(), device="cpu")
    again = run_study(_small_spec(), device="cpu")
    assert first.records == again.records
    run_both(_small_spec(0), _small_spec(1))


def test_infeasible_strategy_gives_the_reference_record():
    """A degree the model cannot realize (pp past smollm's layers) is an
    infeasible record, job columns, cost columns and metrics included."""
    def spec(pkg):
        mod = study_jax if pkg == 0 else study
        from repro.core import placement as placement_jax
        from repro_torch.core import placement
        job = (placement_jax if pkg == 0 else placement).JobSpec(
            instances=3, nodes_per_instance=4)
        return _small_spec(pkg, strategies=mod.ExplicitSpace((
            mod.ParallelSpec(mp=2, dp=2), mod.ParallelSpec(pp=1024))),
            axes=(), job=job,
            metrics={"double": lambda ctx: 2 * ctx.breakdown.total})
    ref, mine = run_both(spec(0), spec(1))
    bad = mine.records[1]
    assert bad["feasible"] is False and bad["total"] == float("inf")
    assert "infeasible_reason" in bad and math.isnan(bad["double"])
    # inf and nan serialize as null, as the reference's do
    assert json.loads(mine.to_json())["records"][1] == \
        json.loads(ref.to_json())["records"][1]


def test_evaluate_only_study():
    def spec(pkg):
        mod = study_jax if pkg == 0 else study
        return mod.StudySpec(
            name="evaluate", axes=[mod.Axis("a", (1, 2, 3))],
            evaluate=lambda ctx: {"x": ctx.point["a"] * 2.5},
            metrics={"y": lambda ctx: ctx.point["a"] + 1})
    _, mine = run_both(spec(0), spec(1))
    assert mine.column("x") == [2.5, 5.0, 7.5]
    assert [c.breakdown for c in mine] == [None] * 3


def test_job_and_placement_columns_and_require_fit():
    """A multi-tenant study with ``require_fit`` on a mixed fleet, swept
    over placements (the (pl, False) prefetch beside (pl, True))."""
    def spec(pkg):
        mod = study_jax if pkg == 0 else study
        from repro.core import placement as placement_jax
        from repro_torch.core import placement
        pm = placement_jax if pkg == 0 else placement
        fleet = (dse_jax if pkg == 0 else dse).mixed_dlrm_fleet()
        cfg = (get_config_jax if pkg == 0 else get_config)("smollm-135m")
        shape = (ShapeConfigJax if pkg == 0 else ShapeConfig)(*SMALL)
        return mod.StudySpec(
            name="jobs", model=cfg, shape=shape, cluster=fleet,
            strategies=mod.GridSpace(mp=(2, 4), dp=(2, 4), pp=(1, 2),
                                     fill_cluster=False),
            axes=[mod.placement_axis(("paper", "em-aware")),
                  mod.Axis("bw_x", (0.5, 1.0), path="interconnect.inter_bw",
                           mode="scale")],
            require_fit=True, mem_bw_override="local",
            job=pm.JobSpec(instances=5, max_nodes=48))
    _, mine = run_both(spec(0), spec(1))
    assert {r["placement"] for r in mine.records} == {"paper", "em-aware"}
    assert all("waves" in r for r in mine.records)


# ===================================================================== #
# StudyResult
# ===================================================================== #

@pytest.fixture(scope="module")
def hetero_pair(models):
    (tcfg_j, shape_j, _), (tcfg, shape, _) = models
    return run_both(
        dse_jax.hetero_cost_study(tcfg_j, shape_j,
                                  em_pod_fractions=(0.0, 0.5, 1.0),
                                  strategies=[(64, 16), (8, 128)]),
        dse.hetero_cost_study(tcfg, shape, em_pod_fractions=(0.0, 0.5, 1.0),
                              strategies=[(64, 16), (8, 128)]))


def test_select_column_best(hetero_pair):
    ref, mine = hetero_pair
    sel, sel_ref = mine.select(em_pod_frac=0.5), ref.select(em_pod_frac=0.5)
    assert len(sel) == len(sel_ref) == 2
    assert_records_equivalent(sel_ref, sel)
    assert mine.column("strategy") == ref.column("strategy")
    for metric, maximize in (("total", False), ("perf_per_dollar", True)):
        b, b_ref = (mine.best(metric, maximize=maximize),
                    ref.best(metric, maximize=maximize))
        assert (b.record["strategy"], b.record["em_pod_frac"]) == \
            (b_ref.record["strategy"], b_ref.record["em_pod_frac"])
    cap = 80e9
    b, b_ref = mine.best(require_fit_bytes=cap), \
        ref.best(require_fit_bytes=cap)
    assert (b.record["strategy"], b.record["em_pod_frac"]) == \
        (b_ref.record["strategy"], b_ref.record["em_pod_frac"])
    with pytest.raises(ValueError, match="no cell"):
        mine.best(require_fit_bytes=1.0)
    assert len(mine) == len(list(iter(mine)))


def test_normalize_and_pivot(hetero_pair):
    ref, mine = hetero_pair
    ref = study_jax.StudyResult(ref.spec, [dataclasses.replace(
        c, record=dict(c.record)) for c in ref.cells])
    mine = study.StudyResult(mine.spec, [dataclasses.replace(
        c, record=dict(c.record)) for c in mine.cells])
    where = dict(strategy="MP64_DP16", em_pod_frac=0.0)
    assert_records_equivalent(ref.normalize("total", **where),
                              mine.normalize("total", **where))
    with pytest.raises(ValueError, match="matched 2 cells"):
        mine.normalize("total", em_pod_frac=0.0)
    assert mine.normalize("tco", value=2.0).records[0]["tco_norm"] == \
        mine.records[0]["tco"] / 2.0
    got = mine.pivot("strategy", "em_pod_frac")
    want = ref.pivot("strategy", "em_pod_frac")
    assert list(got) == list(want)
    for k in want:
        assert list(got[k]) == list(want[k])
        assert got[k] == pytest.approx(want[k], rel=REL)
    with pytest.raises(ValueError, match="ambiguous"):
        mine.pivot("em_pod_frac", "feasible")


def test_csv_and_json_text_equal_reference(hetero_pair):
    """The port's writers on the reference's records give the reference's
    text; the port's own text parses back to the reference's within 1e-9
    (the engines differ in the last bits, so their raw text does too)."""
    ref, mine = hetero_pair
    same = study.StudyResult(mine.spec, [dataclasses.replace(
        c, record=dict(r.record)) for c, r in zip(mine.cells, ref.cells)])
    assert same.to_csv() == ref.to_csv()
    assert same.to_json() == ref.to_json()
    got, want = json.loads(mine.to_json()), json.loads(ref.to_json())
    assert got["study"] == want["study"]
    for a, b in zip(got["records"], want["records"]):
        assert list(a) == list(b)
        for k in b:
            assert type(a[k]) is type(b[k]), k
            assert a[k] == (pytest.approx(b[k], rel=REL)
                            if isinstance(b[k], float) else b[k]), k
    rows, rows_ref = (list(csv.reader(io.StringIO(r.to_csv())))
                      for r in (mine, ref))
    assert rows[0] == rows_ref[0] and len(rows) == len(rows_ref)


def test_csv_and_json_write_files(tmp_path, hetero_pair):
    _, mine = hetero_pair
    text = mine.to_csv(str(tmp_path / "s.csv"))
    assert (tmp_path / "s.csv").read_bytes().decode() == text
    text = mine.to_json(str(tmp_path / "s.json"))
    assert (tmp_path / "s.json").read_text() == text


# ===================================================================== #
# The spec's fail-fast checks, the refusals, the device rule
# ===================================================================== #

@pytest.mark.parametrize("kw,error,match", [
    (dict(axes=[Axis("turnaround", (1,))]), ValueError, "shadow"),
    (dict(axes=[placement_axis(("paper",), name="total")]), ValueError,
     "shadow"),
    (dict(axes=[Axis("a", (1,)), Axis("a", (2,))]), ValueError, "duplicate"),
    (dict(placement="typo"), KeyError, "unknown placement"),
    (dict(mem_bw_override="fast"), ValueError, "mem_bw_override"),
    (dict(workload_deps=("nope",)), ValueError, "workload_deps"),
    (dict(axes=[Axis("x", (1,), path="node.peak_flop")]), AttributeError,
     "no field"),
    (dict(axes=[Axis("x", (1,), path="reliability.mtbf_hours")]),
     ValueError, "FailureModel"),
])
def test_spec_checks_match_reference(kw, error, match):
    def translate(pkg):
        mod = study_jax if pkg == 0 else study
        out = {}
        for k, v in kw.items():
            if k == "axes":
                v = [mod.Axis(a.name, a.values, path=a.path, kind=a.kind)
                     for a in v]
            out[k] = v
        return out
    with pytest.raises(error, match=match):
        _small_spec(0, **translate(0))
    with pytest.raises(error, match=match):
        _small_spec(1, **translate(1))


def test_placement_axis_owns_its_column():
    spec = _small_spec(strategies=ParallelSpec(mp=2, dp=2, pp=2),
                       axes=[placement_axis()])
    res = run_study(spec, device="cpu")
    assert res.column("placement") == ["paper", "em-aware"]
    a, b = res.cells
    assert a.record["total"] == b.record["total"]   # one group: same physics
    with pytest.raises(ValueError, match="placement axis"):
        Axis("placement", ("paper",), kind="placement",
             apply=lambda cl, v: cl)


def test_parallel_spec_and_spaces_match_reference():
    for kw in (dict(mp=2, dp=2, pp=2, schedule="interleaved",
                    virtual_stages=3),
               dict(mp=2, dp=2, pp=2, schedule="gpipe"),
               dict(mp=2, dp=2, schedule="interleaved", virtual_stages=4),
               dict(mp=4, dp=8, pp=2, ep=2, zero_stage=3,
                    num_microbatches=8)):
        mine, ref = ParallelSpec(**kw), study_jax.ParallelSpec(**kw)
        assert dataclasses.astuple(mine) == dataclasses.astuple(ref)
        assert mine.label == ref.label
    with pytest.raises(ValueError):
        ParallelSpec(schedule="zigzag")
    for mine, ref, n in (
            (study.PowerOfTwoSpace(pp=(1, 2), ep=(1, 2)),
             study_jax.PowerOfTwoSpace(pp=(1, 2), ep=(1, 2)), 64),
            (study.FactorizationSpace(min_mp=2),
             study_jax.FactorizationSpace(min_mp=2), 12),
            (GridSpace(mp=(2,), dp=(4,), pp=(1, 2),
                       schedules=("1f1b", "interleaved"), fill_cluster=False),
             study_jax.GridSpace(mp=(2,), dp=(4,), pp=(1, 2),
                                 schedules=("1f1b", "interleaved"),
                                 fill_cluster=False), 0)):
        assert [s.label for s in mine.specs(n)] == \
            [s.label for s in ref.specs(n)]
    assert study.as_strategy_space((4, 8)) == \
        ExplicitSpace((ParallelSpec(mp=4, dp=8),))
    assert study.as_strategy_space([(4, 8), ParallelSpec(mp=2)]) == \
        ExplicitSpace((ParallelSpec(mp=4, dp=8), ParallelSpec(mp=2)))
    assert study.as_strategy_space(None) is None


def test_set_by_path_on_the_port_configs():
    base = cluster.BASELINE_DGX_A100
    out = study.set_by_path(base, "node.exp_bw", 1e12)
    assert out.node.exp_bw == 1e12 and base.node.exp_bw == 0.0
    out = study.set_by_path(base, "topology.intra_bw", 2.0, scale=True)
    assert out.topology.intra_bw == 2 * base.topology.intra_bw
    assert study.get_by_path(out, "topology.intra_bw") == 600e9
    with pytest.raises(AttributeError, match="no field"):
        study.check_path(base, "topology.intra_bandwidth")
    with pytest.raises(TypeError, match="non-dataclass"):
        study.set_by_path(base, "name.upper", 1)


def test_refusals_name_their_roadmap_item():
    """What the runner refuses (an unknown ``validate``, an object with no
    ``to_study()``); a process pool (item 22) gives the serial run's
    records, reliability columns (item 20) and a ``to_study()`` lowering
    (item 23) run as the reference runs them, record for record."""
    from repro.reliability import FailureModel as FailureModelJax
    from repro_torch.reliability import FailureModel
    spec = _small_spec()
    with pool_bound():
        assert (run_study(spec, processes=2, device="cpu").records
                == run_study(spec, device="cpu").records)
    with pytest.raises(ValueError, match="validate"):
        run_study(spec, validate="loud", device="cpu")
    ref, mine = run_both(
        _small_spec(0, reliability=FailureModelJax(mtbf_hours=1e4)),
        _small_spec(reliability=FailureModel(mtbf_hours=1e4)))
    assert all("goodput_frac" in r for r in mine.records)
    ref, mine = run_both(
        _small_spec(0, reliability=FailureModelJax(),
                    axes=[study_jax.Axis("mtbf", (1e3,),
                                         path="reliability.mtbf_hours")]),
        _small_spec(reliability=FailureModel(),
                    axes=[Axis("mtbf", (1e3,),
                               path="reliability.mtbf_hours")]))
    assert {r["mtbf"] for r in mine.records} == {1e3}
    run_study(_small_spec(strategies=ParallelSpec(mp=2, dp=4)),
              processes=1, device="cpu")

    class Lowered:
        def __init__(self, spec):
            self.spec = spec

        def to_study(self):
            return self.spec

    run_both(Lowered(_small_spec(0)), Lowered(spec))
    with pytest.raises(TypeError, match="StudySpec"):
        run_study(object(), device="cpu")


# ===================================================================== #
# The process pool (ROADMAP item 22): tests/test_compiled.py's TestForkPath
# ===================================================================== #

def _bounded_run(code: str, timeout: float = 120) -> str:
    """Runs ``code`` (dedented; this directory on the path) in a fresh
    interpreter in a session of its own and returns its standard output;
    fails the test, killing every process of the session, if it outlasts
    ``timeout`` seconds or exits other than 0. A fork pool that hangs then
    costs its test alone."""
    code = ("import sys\nsys.path.insert(0, "
            + repr(os.path.dirname(os.path.abspath(__file__))) + ")\n"
            + textwrap.dedent(code))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the run did not finish in {timeout} s")
    assert proc.returncode == 0, stderr[-3000:]
    return stdout


class TestForkPath:
    def test_chunks_partition_cells_by_workload_key(self):
        spec = _small_spec()
        cells = study._cells(spec)
        chunks = study._strategy_chunks(spec, cells, processes=3)
        assert sorted(i for ch in chunks for i in ch) == \
            list(range(len(cells)))
        # No workload key is split while more chunks than workers exist.
        keys_per_chunk = [{study._workload_key(spec, *cells[i][:2])
                           for i in ch} for ch in chunks]
        assert all(len(ks) == 1 for ks in keys_per_chunk)
        # the reference's chunks, index for index
        ref_spec = _small_spec(0)
        assert chunks == study_jax._strategy_chunks(
            ref_spec, study_jax._cells(ref_spec), processes=3)

    def test_chunks_split_when_fewer_groups_than_workers(self):
        spec = _small_spec(strategies=ParallelSpec(mp=2, dp=4),
                           axes=[Axis("bw_x", (0.5, 1.0, 2.0, 4.0),
                                      path="node.local_bw", mode="scale")])
        cells = study._cells(spec)
        chunks = study._strategy_chunks(spec, cells, processes=4)
        assert len(chunks) == 4
        assert sorted(i for ch in chunks for i in ch) == \
            list(range(len(cells)))

    def test_empty_cell_list_with_processes(self):
        # No strategy fills the 8-node cluster -> zero cells; the chunked
        # pool must return an empty result, not crash on max([]).
        spec = _small_spec(strategies=GridSpace(mp=(3,), dp=(3,)), axes=[])
        with pool_bound():
            assert len(run_study(spec, processes=4, device="cpu")) == 0

    def test_pool_equals_serial(self):
        """Equal records (the workers' one thread changes no bit here: each
        chunk is one strategy's batch, as in the serial run) and the
        reference's forked ``engine="compiled"`` records within 1e-9. The
        reference's pool, whose workers keep every thread, forks a fresh
        interpreter, not this one, under a 120 s bound."""
        spec = _small_spec()
        serial = run_study(spec, device="cpu")
        with pool_bound():
            pooled = run_study(spec, processes=2, device="cpu")
        assert serial.records == pooled.records
        out = _bounded_run("""
            from repro.core import study as study_jax
            from repro_torch.core.study import run_study
            from test_torch_study import _small_spec, assert_records_equivalent
            ref = study_jax.run_study(_small_spec(0), processes=2,
                                      engine="compiled", validate="off")
            assert_records_equivalent(
                ref, run_study(_small_spec(), processes=2, device="cpu"))
            print("equivalent", len(ref))
        """)
        assert "equivalent 8" in out

    @pytest.mark.parametrize("name", ["fig8", "placement"])
    def test_pool_equals_serial_on_the_goldens(self, name):
        """Two goldens with split chunks (more workers than strategies)
        and mixed fleets: the pool's records equal the serial run's. The
        pool of up to 64 workers forks a fresh interpreter under a 120 s
        bound."""
        out = _bounded_run(f"""
            from repro_torch.core.study import run_study
            from test_torch_study import _golden
            spec = _golden({name!r}, 1)[0]
            serial = run_study(spec, device="cpu")
            assert serial.records == run_study(spec, processes=64,
                                               device="cpu").records
            print("equal", len(serial))
        """)
        assert "equal " in out

    def test_raising_metric_leaves_run_study_reusable(self):
        # A worker raising mid-map must not poison module state for later
        # serial or pooled runs.
        def boom(ctx):
            raise RuntimeError("metric exploded")

        bad = _small_spec(metrics={"boom": boom})
        with pool_bound(), pytest.raises(RuntimeError,
                                         match="metric exploded"):
            run_study(bad, processes=2, device="cpu")
        assert study._FORK_STATE is None
        good = _small_spec()
        again = run_study(good, device="cpu")
        with pool_bound():
            assert run_study(good, processes=2,
                             device="cpu").records == again.records

    def test_a_pool_after_threaded_work_finishes(self):
        """A fresh interpreter runs multi-threaded torch work (a 2,000 x
        2,000 float64 product, a 4 M-element exp and sum), then a pool of
        two whose metric runs a 500 x 500 float64 product in the worker:
        it must finish inside 120 s. A child forked after such work that
        runs a parallel op on the parent's thread pool waits forever
        (without the pool's one-thread initializer this run hangs)."""
        out = _bounded_run("""
            import torch
            torch.set_num_threads(max(2, torch.get_num_threads()))
            a = torch.randn(2000, 2000, dtype=torch.float64)
            (a @ a).sum(); torch.randn(4_000_000).exp().sum()
            from repro_torch.core.study import run_study
            from test_torch_study import _small_spec

            def probe(ctx):
                b = torch.ones(500, 500, dtype=torch.float64)
                return float((b @ b).sum())
            spec = _small_spec(metrics={"probe": probe})
            pooled = run_study(spec, processes=2, device="cpu")
            assert pooled.records == run_study(spec, device="cpu").records
            print("pool done", len(pooled))
        """)
        assert "pool done 8" in out

    def test_a_nested_pool_runs_serially(self):
        """A run_study inside a pool's worker (``_FORK_STATE`` set) runs
        serially with the same records."""
        spec = _small_spec()
        inner = {}

        def nested(ctx):
            if not inner:
                inner["records"] = run_study(
                    _small_spec(strategies=ParallelSpec(mp=2, dp=4)),
                    processes=2, device="cpu").records
            return len(inner["records"])

        pooled = run_study(_small_spec(metrics={"inner": nested}),
                           processes=2, device="cpu")
        assert {r["inner"] for r in pooled.records} == {2}
        assert study._FORK_STATE is None
        assert run_study(spec, device="cpu").records == [
            {k: v for k, v in r.items() if k != "inner"}
            for r in pooled.records]


@pytest.mark.cuda
def test_the_pool_on_the_card_warns_and_runs_the_batch():
    """``processes=2`` on the card: no fork, one warning, and the serial
    card run's records."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the study runner's device path")
    spec = _small_spec()
    serial = run_study(spec, device="cuda")
    with pytest.warns(UserWarning, match="device's batch") as seen:
        pooled = run_study(spec, processes=2, device="cuda")
    assert len([w for w in seen if "device's batch" in str(w.message)]) == 1
    assert pooled.records == serial.records


def test_default_dtype_stays_float32():
    run_study(_small_spec(strategies=ParallelSpec(mp=2, dp=4)),
              device="cpu")
    assert torch.get_default_dtype() == torch.float32
    assert torch.ones(3).dtype == torch.float32


@pytest.mark.cuda
def test_placement_study_on_the_card():
    """placement_study (reduced as in tests/test_compiled.py) on the card:
    the CPU's records within 1e-9, and two card runs with the same
    records."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the study runner's device path")
    spec = _golden("placement", 1)[0]
    cpu = run_study(spec, device="cpu")
    card = run_study(spec, device="cuda")
    again = run_study(spec, device="cuda")
    assert_records_equivalent(cpu, card)
    assert card.records == again.records
