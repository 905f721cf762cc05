"""The port's search (``repro_torch.core.search``) and R1xx rules against
the JAX package's.

Mirrors ``tests/test_search.py`` case for case on the port (objective
scoring, dominance, Pareto ranks and fronts, successive halving's rungs,
the evolutionary loop's determinism and memo, ``dse.pareto_frontier``, the
R101-R103 rules, the reserved columns), each case that evaluates cells
also held to the reference on the same spec. Then the paper-shape search
over ``hetero_cost_study`` (transformer-1t, seq 2,048, batch 1,024):
``pareto_frontier``, ``successive_halving`` and ``evolutionary_search``
(seeds 0 and 1) give the reference's frontier, survivors, trace order and
``evaluations``; cells the reference ties exactly tie exactly in the port;
and R101-R103 give the reference's diagnostics on the same targets.
Records follow ``tests/test_torch_study.py::assert_records_equivalent``
(floats within 1e-9 relative, everything else equal); the reference runs
with ``engine="compiled"`` and ``validate="off"``, the port on the CPU.
"""

import dataclasses
import math

import pytest
import torch

from repro.analysis import analyze_search as analyze_search_jax
from repro.analysis.rules_search import SearchTarget as SearchTargetJax
from repro.configs import get_config as get_config_jax
from repro.configs.base import ShapeConfig as ShapeConfigJax
from repro.core import cluster as cluster_jax
from repro.core import dse as dse_jax
from repro.core import search as search_jax
from repro.core import study as study_jax
from repro_torch.analysis import analyze_search
from repro_torch.analysis.rules_search import SearchTarget
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.core import cluster, dse, search, study
from repro_torch.core.search import (
    DEFAULT_OBJECTIVES,
    Objective,
    SearchResult,
    dominates,
    evolutionary_search,
    pareto_front,
    pareto_rank,
    successive_halving,
)
from repro_torch.core.study import Axis, StudySpec, run_study
from test_torch_study import assert_records_equivalent

SMALL = ("small", 512, 64, "train")
PARETO = ("pareto", 2048, 1024, "train")


def result_from(records, mod=study):
    """A StudyResult of ``mod`` wrapping bare dict records (no
    simulation)."""
    return mod.StudyResult(
        spec=mod.StudySpec(name="synthetic", evaluate=lambda ctx: {}),
        cells=[mod.CellResult(None, {}, None, None, None, dict(r))
               for r in records])


def small_spec(pkg=1, **kwargs):
    """``tests/test_search.py``'s smollm-135m study on 8 DGX nodes, built
    with ``pkg``'s classes (0: the reference, 1: the port)."""
    mod = study_jax if pkg == 0 else study
    kwargs.setdefault("name", "search-smoke")
    kwargs.setdefault("model", (get_config_jax if pkg == 0
                                else get_config)("smollm-135m"))
    kwargs.setdefault("shape", (ShapeConfigJax if pkg == 0
                                else ShapeConfig)(*SMALL))
    base = (cluster_jax if pkg == 0 else cluster).BASELINE_DGX_A100
    kwargs.setdefault("cluster", dataclasses.replace(base, num_nodes=8))
    kwargs.setdefault("strategies", mod.PowerOfTwoSpace())
    return mod.StudySpec(**kwargs)


def evo_axes(pkg=1):
    mod = study_jax if pkg == 0 else study
    return [mod.Axis("flops_x", (0.5, 1.0, 2.0), path="node.peak_flops",
                     mode="scale")]


def hetero_spec(pkg=1):
    """``hetero_cost_study`` at the pareto shape (32 cells, 17 feasible)."""
    if pkg == 0:
        return dse_jax.hetero_cost_study(get_config_jax("transformer-1t"),
                                         ShapeConfigJax(*PARETO))
    return dse.hetero_cost_study(get_config("transformer-1t"),
                                 ShapeConfig(*PARETO))


def assert_search_equivalent(ref, mine):
    """Same evaluations, the same trace and final cells in the same order,
    records equivalent."""
    assert mine.evaluations == ref.evaluations
    assert [o.column for o in mine.objectives] == \
        [o.column for o in ref.objectives]
    assert_records_equivalent(ref.trace, mine.trace)
    assert_records_equivalent(ref.final, mine.final)


def best_identity(result):
    """The identity of ``result.best()``, or None where it raises (the
    search kept no feasible full-fidelity cell)."""
    try:
        return identity(result.best().record)
    except ValueError:
        return None


def identity(record):
    return tuple(record.get(k) for k in ("strategy", "em_pod_frac",
                                         "flops_x", "search_round"))


# ===================================================================== #
# Objectives and dominance
# ===================================================================== #

class TestObjective:
    def test_minimize_is_identity(self):
        assert Objective("total").score({"total": 2.5}) == 2.5

    def test_maximize_negates(self):
        o = Objective("tokens_per_s", maximize=True)
        assert o.score({"tokens_per_s": 4.0}) == -4.0

    def test_missing_nan_bool_score_inf(self):
        o = Objective("total")
        assert o.score({}) == math.inf
        assert o.score({"total": math.nan}) == math.inf
        assert o.score({"total": True}) == math.inf
        assert o.score({"total": "fast"}) == math.inf

    def test_label(self):
        assert Objective("total", label="time").name == "time"
        assert Objective("tco").name == "tco"

    def test_dominates(self):
        assert dominates((1.0, 1.0), (1.0, 2.0))
        assert not dominates((1.0, 2.0), (2.0, 1.0))   # incomparable
        assert not dominates((1.0, 1.0), (1.0, 1.0))   # equal: not strict

    def test_default_objectives_are_the_references(self):
        assert [(o.column, o.maximize, o.label) for o in DEFAULT_OBJECTIVES] \
            == [(o.column, o.maximize, o.label)
                for o in search_jax.DEFAULT_OBJECTIVES]


class TestParetoRank:
    RECORDS = [
        {"feasible": True, "total": 1.0, "tco": 9.0, "energy_usd": 2.0},
        {"feasible": True, "total": 3.0, "tco": 4.0, "energy_usd": 1.0},
        # dominated by record 1 on every axis:
        {"feasible": True, "total": 3.5, "tco": 9.5, "energy_usd": 2.5},
        # would dominate everything, but infeasible:
        {"feasible": False, "total": 0.5, "tco": 1.0, "energy_usd": 0.1},
        # feasible but non-finite on one objective:
        {"feasible": True, "total": math.inf, "tco": 1.0,
         "energy_usd": 1.0},
    ]

    def test_ranks(self):
        assert pareto_rank(self.RECORDS) == [0, 0, 1, None, None]
        assert pareto_rank(self.RECORDS) == \
            search_jax.pareto_rank(self.RECORDS)

    def test_single_objective_is_argmin(self):
        ranks = pareto_rank(self.RECORDS, (Objective("total"),))
        assert ranks == [0, 1, 2, None, None]

    def test_pareto_front_annotates_and_filters(self):
        res = result_from(self.RECORDS)
        front = pareto_front(res)
        assert [r["pareto_rank"] for r in res.records] == \
            [0, 0, 1, None, None]
        assert [r["pareto_optimal"] for r in res.records] == \
            [True, True, False, False, False]
        assert len(front) == 2
        assert all(r["pareto_optimal"] for r in front.records)
        ref = result_from(self.RECORDS, study_jax)
        search_jax.pareto_front(ref)
        assert res.records == ref.records

    def test_empty_objectives_rejected(self):
        with pytest.raises(ValueError, match="objective"):
            pareto_front(result_from(self.RECORDS), ())

    def test_studyresult_method_delegates(self):
        res = result_from(self.RECORDS)
        front = res.pareto_front()
        assert len(front) == 2
        assert "pareto_rank" in res.records[0]


# ===================================================================== #
# Successive halving
# ===================================================================== #

class TestSuccessiveHalving:
    def test_rung_accounting_and_final_fidelity(self):
        res = successive_halving(small_spec(), eta=2, rungs=3,
                                 min_fidelity=0.25, device="cpu")
        # PowerOfTwoSpace on 8 nodes -> 4 strategies; survivors per rung:
        # 4 -> ceil(4/2)=2 -> 1, so 4 + 2 + 1 evaluations.
        assert res.evaluations == 7
        assert len(res.trace) == 7
        by_round = {}
        for r in res.trace.records:
            by_round.setdefault(r["search_round"], []).append(r)
        assert {k: len(v) for k, v in by_round.items()} == {0: 4, 1: 2,
                                                            2: 1}
        # Geometric ramp 0.25 -> 0.5 -> 1.0; final rung authoritative.
        assert [by_round[k][0]["search_fidelity"] for k in (0, 1, 2)] == \
            pytest.approx([0.25, 0.5, 1.0])
        assert len(res.final) == 1
        assert all(r["search_fidelity"] == 1.0
                   for r in res.final.records)
        assert res.best().record is res.final.records[0] or \
            res.best().record == res.final.records[0]
        ref = search_jax.successive_halving(small_spec(0), eta=2, rungs=3,
                                            min_fidelity=0.25)
        assert_search_equivalent(ref, res)

    def test_matches_exhaustive_best(self):
        spec = small_spec()
        res = successive_halving(spec, eta=2, rungs=2, min_fidelity=0.5,
                                 device="cpu")
        exhaustive = run_study(spec, device="cpu")
        grid_best = min(
            (r for r in exhaustive.records if r["feasible"]),
            key=lambda r: r["total"])
        assert res.best().record["total"] == \
            pytest.approx(grid_best["total"], rel=1e-12)

    def test_requires_default_workload_builder(self):
        spec = StudySpec(name="custom", evaluate=lambda ctx: {})
        with pytest.raises(ValueError, match="global_batch"):
            successive_halving(spec, device="cpu")

    def test_validation(self):
        with pytest.raises(ValueError, match="eta"):
            successive_halving(small_spec(), eta=1, device="cpu")
        with pytest.raises(ValueError, match="rungs"):
            successive_halving(small_spec(), rungs=0, device="cpu")
        with pytest.raises(ValueError, match="min_fidelity"):
            successive_halving(small_spec(), min_fidelity=0.0, device="cpu")

    def test_single_rung_runs_full_fidelity(self):
        res = successive_halving(small_spec(), rungs=1, device="cpu")
        assert res.evaluations == 4
        assert all(r["search_fidelity"] == 1.0 for r in res.records)

    def test_one_device_batch_a_rung(self, monkeypatch):
        """Each rung is one call of the runner with fresh memos."""
        calls = []
        real = search._run_cells_compiled

        def counted(spec, cells, wl_memo, sim_memo, device):
            calls.append((len(cells), len(wl_memo), len(sim_memo)))
            return real(spec, cells, wl_memo, sim_memo, device)

        monkeypatch.setattr(search, "_run_cells_compiled", counted)
        successive_halving(small_spec(), eta=2, rungs=3, min_fidelity=0.25,
                           device="cpu")
        assert calls == [(4, 0, 0), (2, 0, 0), (1, 0, 0)]


# ===================================================================== #
# Evolutionary search
# ===================================================================== #

class TestEvolutionarySearch:
    def test_seed_determinism(self):
        a = evolutionary_search(small_spec(axes=evo_axes()), population=6,
                                generations=3, seed=7, device="cpu")
        b = evolutionary_search(small_spec(axes=evo_axes()), population=6,
                                generations=3, seed=7, device="cpu")
        assert a.evaluations == b.evaluations
        assert a.trace.records == b.trace.records
        ref = search_jax.evolutionary_search(
            small_spec(0, axes=evo_axes(0)), population=6, generations=3,
            seed=7)
        assert_search_equivalent(ref, a)

    def test_trace_columns_and_memoization(self):
        res = evolutionary_search(small_spec(axes=evo_axes()), population=6,
                                  generations=4, seed=1, device="cpu")
        assert res.evaluations == len(res.trace)
        seen = set()
        for r in res.records:
            assert {"search_round", "search_fidelity",
                    "search_score"} <= set(r)
            assert r["search_fidelity"] == 1.0
            key = (r["strategy"], r["flops_x"])
            assert key not in seen, "genome simulated twice"
            seen.add(key)
        # 12 distinct (strategy, axis) cells exist; memoization caps the
        # evaluation count at the cell-space size.
        assert res.evaluations <= 12
        ref = search_jax.evolutionary_search(
            small_spec(0, axes=evo_axes(0)), population=6, generations=4,
            seed=1)
        assert_search_equivalent(ref, res)

    def test_finds_grid_optimum_on_enumerable_space(self):
        spec = small_spec(axes=evo_axes())
        res = evolutionary_search(spec, population=12, generations=8,
                                  seed=0, device="cpu")
        exhaustive = run_study(spec, device="cpu")
        grid_best = min(
            (r for r in exhaustive.records if r["feasible"]),
            key=lambda r: r["total"])
        assert res.best().record["total"] == \
            pytest.approx(grid_best["total"], rel=1e-12)

    def test_validation(self):
        with pytest.raises(ValueError, match="population"):
            evolutionary_search(small_spec(), population=1, device="cpu")
        with pytest.raises(ValueError, match="generations"):
            evolutionary_search(small_spec(), generations=0, device="cpu")
        with pytest.raises(ValueError, match="cluster"):
            evolutionary_search(
                StudySpec(name="no-cluster",
                          model=get_config("smollm-135m"),
                          shape=ShapeConfig(*SMALL)), device="cpu")

    def test_best_requires_feasible_evaluation(self):
        empty = SearchResult(
            spec=small_spec(), objectives=(Objective("total"),),
            trace=result_from([]), final=result_from([]), evaluations=0)
        with pytest.raises(ValueError, match="no feasible"):
            empty.best()


# ===================================================================== #
# dse.pareto_frontier demo study
# ===================================================================== #

class TestDseParetoFrontier:
    def test_smoke(self):
        records = dse.pareto_frontier(
            cfg=get_config("smollm-135m"), shape=ShapeConfig(*SMALL),
            device="cpu")
        assert records
        assert all(r["pareto_optimal"] for r in records)
        assert all("energy_usd" in r and "tco" in r for r in records)
        totals = [r["total"] for r in records]
        assert totals == sorted(totals)
        ref = dse_jax.pareto_frontier(
            cfg=get_config_jax("smollm-135m"), shape=ShapeConfigJax(*SMALL))
        assert_records_equivalent(result_from(ref, study_jax),
                                  result_from(records))


# ===================================================================== #
# Analysis pack R101-R103
# ===================================================================== #

def codes(diags):
    return sorted(d.code for d in diags)


def same_diagnostics(mine, ref):
    """The port's diagnostics are the reference's, field for field."""
    assert [d.to_dict() for d in mine] == [d.to_dict() for d in ref]


def objectives_jax(objectives):
    return tuple(search_jax.Objective(o.column, o.maximize, o.label)
                 for o in objectives)


class TestSearchRules:
    GOOD = [
        {"feasible": True, "total": 1.0, "tco": 9.0, "energy_usd": 2.0,
         "pareto_optimal": True},
        {"feasible": True, "total": 3.0, "tco": 4.0, "energy_usd": 1.0,
         "pareto_optimal": True},
        {"feasible": True, "total": 3.5, "tco": 9.5, "energy_usd": 2.5,
         "pareto_optimal": False},
    ]

    def both(self, records, objectives=None):
        mine = analyze_search(records, objectives=objectives)
        ref = analyze_search_jax(
            records, objectives=(None if objectives is None
                                 else objectives_jax(objectives)))
        same_diagnostics(mine, ref)
        return mine

    def test_clean_target_is_silent(self):
        assert self.both(self.GOOD) == []

    def test_r101_empty_objectives(self):
        diags = analyze_search(SearchTarget(objectives=(),
                                            records=tuple(self.GOOD)))
        assert "R101" in codes(diags)
        same_diagnostics(diags, analyze_search_jax(SearchTargetJax(
            objectives=(), records=tuple(self.GOOD))))

    def test_r101_duplicate_and_missing_columns(self):
        # (R103 may also fire: the pareto annotations were made under a
        # different objective set — only R101 is asserted here.)
        dup = self.both(self.GOOD, (Objective("total"), Objective("total")))
        assert "R101" in codes(dup)
        missing = self.both(self.GOOD,
                            (Objective("total"), Objective("goodput")))
        assert "R101" in codes(missing)

    def test_r102_nonfinite_feasible(self):
        bad = [dict(self.GOOD[0]), {"feasible": True, "total": math.nan,
                                    "tco": 1.0, "energy_usd": 1.0}]
        diags = self.both(bad)
        assert codes(diags) == ["R102"]
        assert diags[0].severity == "warning"
        # Infeasible records are allowed to be non-finite.
        ok = [dict(self.GOOD[0]), {"feasible": False, "total": math.nan,
                                   "tco": 1.0, "energy_usd": 1.0}]
        assert self.both(ok) == []

    def test_r103_false_frontier_member(self):
        bad = [dict(r) for r in self.GOOD]
        bad[2]["pareto_optimal"] = True    # dominated, yet marked optimal
        assert "R103" in codes(self.both(bad))

    def test_r103_incomplete_frontier(self):
        bad = [dict(r) for r in self.GOOD]
        bad[1]["pareto_optimal"] = False   # nothing dominates it
        assert "R103" in codes(self.both(bad))

    def test_r103_skips_unannotated(self):
        plain = [{k: v for k, v in r.items() if k != "pareto_optimal"}
                 for r in self.GOOD]
        assert self.both(plain) == []

    def test_lifts_study_result_through_real_front(self):
        res = result_from(TestParetoRank.RECORDS)
        pareto_front(res, DEFAULT_OBJECTIVES)
        diags = analyze_search(res, DEFAULT_OBJECTIVES)
        # record[4] is feasible-but-inf, so R102 warns by design; the
        # real pareto_front annotation must raise no *errors*.
        assert codes(diags) == ["R102"]
        assert all(d.severity != "error" for d in diags)
        ref = result_from(TestParetoRank.RECORDS, study_jax)
        search_jax.pareto_front(ref, search_jax.DEFAULT_OBJECTIVES)
        same_diagnostics(diags, analyze_search_jax(
            ref, search_jax.DEFAULT_OBJECTIVES))

    def test_registry_is_the_references(self):
        from repro.analysis import list_rules as list_rules_jax
        from repro_torch.analysis import list_rules
        assert [(r.code, r.pack, r.severity, r.description)
                for r in list_rules("search")] == \
            [(r.code, r.pack, r.severity, r.description)
             for r in list_rules_jax("search")]


# ===================================================================== #
# Reserved columns
# ===================================================================== #

class TestReservedSearchColumns:
    @pytest.mark.parametrize("name", ["pareto_rank", "pareto_optimal",
                                      "search_round", "search_fidelity",
                                      "search_score", "energy_usd",
                                      "tco"])
    def test_axis_cannot_shadow_search_columns(self, name):
        with pytest.raises(ValueError, match="shadow"):
            StudySpec(name="bad", evaluate=lambda ctx: {},
                      axes=[Axis(name, (1,))])


# ===================================================================== #
# The paper-shape search over hetero_cost_study, against the reference
# ===================================================================== #

@pytest.fixture(scope="module")
def hetero_runs():
    """``hetero_cost_study`` at the pareto shape, run by each package."""
    ref = study_jax.run_study(hetero_spec(0), engine="compiled",
                              validate="off")
    mine = run_study(hetero_spec(), device="cpu")
    return ref, mine


def exact_ties(records, columns=("total", "tco", "energy_usd")):
    """(i, j, column) of every pair of feasible records whose column is
    equal to the bit."""
    feasible = [i for i, r in enumerate(records) if r["feasible"]]
    return {(i, j, k) for n, i in enumerate(feasible)
            for j in feasible[n + 1:] for k in columns
            if records[i][k] == records[j][k]}


class TestHeteroSearch:
    def test_records_match(self, hetero_runs):
        ref, mine = hetero_runs
        assert len(mine) == 32
        assert sum(r["feasible"] for r in mine.records) == 17
        assert_records_equivalent(ref, mine)

    def test_exact_ties_are_kept(self, hetero_runs):
        """Cells tied to the bit in the reference tie to the bit in the
        port (dominance and the stable sorts compare them exactly), and
        the port adds no tie of its own."""
        ref, mine = hetero_runs
        want = exact_ties(ref.records)
        # MP256_DP4, MP128_DP8 and MP64_DP16 take the same time at each of
        # the four fractions: 9 cells tie one before them, 18 pairs.
        assert sum(1 for _, _, k in want if k == "total") == 18
        assert exact_ties(mine.records) == want

    def test_reference_domination_survives(self, hetero_runs):
        """(0.0, MP64_DP16) dominates (0.25, MP64_DP16) through a tie on
        ``total`` in both packages."""
        for res, mod in zip(hetero_runs, (search_jax, search)):
            by = {(r["em_pod_frac"], r["strategy"]): r for r in res.records}
            a, b = by[(0.0, "MP64_DP16")], by[(0.25, "MP64_DP16")]
            assert a["total"] == b["total"]
            assert mod.dominates(mod._scores(a, mod.DEFAULT_OBJECTIVES),
                                 mod._scores(b, mod.DEFAULT_OBJECTIVES))

    def test_pareto_front_of_the_runs(self, hetero_runs):
        ref, mine = hetero_runs
        ref_front = search_jax.pareto_front(ref)
        front = mine.pareto_front()
        assert [identity(r) for r in front.records] == \
            [identity(r) for r in ref_front.records]
        assert [r["pareto_rank"] for r in mine.records] == \
            [r["pareto_rank"] for r in ref.records]
        same_diagnostics(analyze_search(mine), analyze_search_jax(ref))

    def test_pareto_frontier(self):
        ref = dse_jax.pareto_frontier()
        mine = dse.pareto_frontier(device="cpu")
        assert [identity(r) for r in mine] == [identity(r) for r in ref]
        assert_records_equivalent(result_from(ref, study_jax),
                                  result_from(mine))

    def test_successive_halving(self):
        ref = search_jax.successive_halving(hetero_spec(0))
        mine = successive_halving(hetero_spec(), device="cpu")
        assert mine.evaluations == ref.evaluations == 47
        assert [identity(r) for r in mine.records] == \
            [identity(r) for r in ref.records]
        assert [identity(r) for r in mine.final.records] == \
            [identity(r) for r in ref.final.records]
        assert_search_equivalent(ref, mine)
        # At a quarter of the batch the memory-hungry cells fit, so they
        # survive to the last rung, where none fits: both have no best.
        assert best_identity(mine) == best_identity(ref) is None
        same_diagnostics(analyze_search(mine), analyze_search_jax(ref))

    @pytest.mark.parametrize("seed,evaluations", [(0, 24), (1, 25)])
    def test_evolutionary_search(self, seed, evaluations):
        ref = search_jax.evolutionary_search(hetero_spec(0), seed=seed)
        mine = evolutionary_search(hetero_spec(), seed=seed, device="cpu")
        assert mine.evaluations == ref.evaluations == evaluations
        assert [identity(r) for r in mine.records] == \
            [identity(r) for r in ref.records]
        assert [identity(r) for r in mine.final.records] == \
            [identity(r) for r in ref.final.records]
        assert_search_equivalent(ref, mine)
        assert best_identity(mine) == best_identity(ref) is not None

    def test_search_without_a_device_needs_a_card(self):
        """No device and no GPU: the search raises, as every entry point
        does."""
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is the card")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            successive_halving(hetero_spec())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evolutionary_search(hetero_spec())


@pytest.mark.cuda
def test_search_on_the_card():
    """The paper-shape search on the card: the CPU's frontier, survivors
    and traces, the same exact ties, two card runs equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the study runner's device path")
    cpu = run_study(hetero_spec(), device="cpu")
    card = run_study(hetero_spec(), device="cuda")
    assert_records_equivalent(cpu, card)
    assert exact_ties(card.records) == exact_ties(cpu.records)
    assert [identity(r) for r in dse.pareto_frontier(device="cuda")] == \
        [identity(r) for r in dse.pareto_frontier(device="cpu")]
    for run in (lambda d: successive_halving(hetero_spec(), device=d),
                lambda d: evolutionary_search(hetero_spec(), device=d)):
        a, b, c = run("cpu"), run("cuda"), run("cuda")
        assert [identity(r) for r in b.records] == \
            [identity(r) for r in a.records]
        assert_search_equivalent(a, b)
        assert b.trace.records == c.trace.records
