"""The port's reliability (``repro_torch.reliability``, ``fleet/resize.py``,
``StudySpec.reliability``, fault injection in the fleet timeline, the Y1xx
rules, ``dse.reliability_study`` and ``dse.reliability_fleet_study``)
against the JAX package's.

Mirrors ``tests/test_reliability.py``'s ``TestDalyMath``,
``TestDalyProperties``, ``TestFailureTrace``, ``TestFaultInjection``,
``TestStudyColumns``, ``TestRules`` and ``TestHeadlines`` on the port. The
closed-form columns are Python floats on both sides and equal to the bit;
the failure traces' events are the reference's to the bit (numpy's
``default_rng([seed, group])`` on both sides), and so is every fault-injected
timeline on hand-fed width profiles (the same Python arithmetic). Study
records follow the runner's rule (``tests/test_torch_study.py``): the
reference's keys in its order, non-float values equal, floats within 1e-9
relative of its ``engine="compiled"``. The trace rules Y101 and Y103-Y105
read each package's ``FleetSpec``.
"""

import dataclasses
import math

import pytest

from repro.analysis import AnalysisError as AnalysisErrorJax
from repro.analysis import analyze_reliability as analyze_reliability_jax
from repro.configs import get_config as get_config_jax
from repro.configs.base import ShapeConfig as ShapeConfigJax
from repro.core import cluster as cluster_jax
from repro.core import dse as dse_jax
from repro.core import study as study_jax
from repro.core import workload as workload_jax
import repro.fleet as fleet_jax
import repro.fleet.resize as resize_jax
import repro.reliability as reliability_jax
from repro_torch.analysis import AnalysisError, analyze_reliability
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.core import cluster, dse, study, workload
from repro_torch.core.cluster import BASELINE_DGX_A100
from repro_torch.core.study import Axis, GridSpace, StudySpec, run_study
import repro_torch.fleet as fleet
import repro_torch.fleet.resize as resize
import repro_torch.reliability as reliability
from repro_torch.reliability import (
    FailureEvent,
    FailureModel,
    FailureTrace,
    daly_interval,
    goodput_frac,
    overhead,
    reliability_columns,
)
from test_torch_study import assert_records_equivalent


class Pkg:
    """One package's reliability surface: index 0 is the reference, 1 the
    port."""

    def __init__(self, i):
        self.i = i
        self.rel = (reliability_jax, reliability)[i]
        self.resize = (resize_jax, resize)[i]
        self.cluster = (cluster_jax, cluster)[i]
        self.study = (study_jax, study)[i]
        self.dse = (dse_jax, dse)[i]
        self.workload = (workload_jax, workload)[i]
        self.get_config = (get_config_jax, get_config)[i]
        self.Shape = (ShapeConfigJax, ShapeConfig)[i]
        self.analyze = (analyze_reliability_jax, analyze_reliability)[i]
        self.fleet = (fleet_jax, fleet)[i]
        self.AnalysisError = (AnalysisErrorJax, AnalysisError)[i]

    def run(self, spec, **kw):
        if self.i:
            return run_study(spec, device="cpu", **kw)
        return study_jax.run_study(spec, engine="compiled", **kw)

    def fleet_spec(self, failures, axes=()):
        return self.fleet.FleetSpec(
            name="y-test",
            jobs=(self.fleet.FleetJobSpec(name="j", nodes_per_instance=4,
                                          iterations=4),),
            cluster=self.cluster.BASELINE_DGX_A100, failures=failures,
            axes=list(axes))

    def job(self, uid=0, width=8, iters=10, it=1.0, **kw):
        spec = self.fleet.FleetJobSpec(name=kw.pop("name", f"j{uid}"),
                                       nodes_per_instance=width,
                                       iterations=iters, **kw)
        return self.fleet.FleetJob(spec=spec, profiles={
            w: self.fleet.WidthProfile(iter_times=(it,), fits=(True,),
                                       state_bytes=STATE)
            for w in spec.width_menu}, uid=uid)

    def one_failure(self, time=4.5, nodes=8, repair_s=100.0):
        return self.rel.FailureTrace(
            kind="explicit",
            events=(self.rel.FailureEvent(time=time, group=0, nodes=nodes,
                                          repair_s=repair_s),))

    def sim(self, caps, **kw):
        return self.fleet.FleetSimulator(caps, **kw)

    def tiny_spec(self, reliability=None, axes=()):
        return self.study.StudySpec(
            name="rel-test", model=self.get_config("chatglm3-6b"),
            shape=self.Shape("t", seq_len=2048, global_batch=256,
                             kind="train"),
            cluster=self.cluster.BASELINE_DGX_A100,
            strategies=self.study.GridSpace(mp=(8,), dp=(128,)),
            reliability=reliability, axes=list(axes))


STATE = 8e9
REF, PORT = Pkg(0), Pkg(1)
PKGS = (REF, PORT)


def on_both(fn):
    """``fn(pkg)`` in each package: equal outputs (dataclasses field for
    field, floats to the bit); returns the port's."""
    ref, mine = (fn(p) for p in PKGS)
    assert _plain(mine) == _plain(ref)
    return mine


def _plain(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple(_plain(v) for v in dataclasses.astuple(obj)))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def run_both(build, **kw):
    """``build(pkg)`` through each package's runner: the port's records
    hold to the reference's by the runner's rule; returns the port's."""
    ref, mine = (p.run(build(p), **kw) for p in PKGS)
    assert_records_equivalent(ref, mine)
    return mine


def _tiny_spec(reliability=None, axes=()):
    return PORT.tiny_spec(reliability, axes)


# --------------------------------------------------------------------- #
# The fleet's cost formula and the Young–Daly closed form
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,mp,dp", [("chatglm3-6b", 8, 16),
                                        ("transformer-1t", 8, 64),
                                        ("granite-moe-3b-a800m", 2, 8)])
def test_resize_matches_reference(arch, mp, dp):
    def fn(p):
        wl = p.workload.decompose(p.get_config(arch),
                                  p.Shape("t", 2048, 256, "train"),
                                  mp=mp, dp=dp)
        state = p.resize.instance_state_bytes(wl)
        return (state, p.resize.checkpoint_delay(state, 40e9),
                p.resize.remesh_delay(state, 40e9, 100e9))
    assert on_both(fn)[0] > 0
    assert fleet.instance_state_bytes is resize.instance_state_bytes
    with pytest.raises(ValueError, match="checkpoint_bw"):
        resize.checkpoint_delay(1.0, 0.0)
    with pytest.raises(ValueError, match="reshard_bw"):
        resize.remesh_delay(1.0, 1.0, 0.0)


class TestDalyMath:
    def test_goodput_in_unit_interval(self):
        for tau in (1.0, 60.0, 600.0, 86400.0):
            for c in (0.1, 10.0, 300.0):
                for lam in (1e-8, 1e-5, 1e-3):
                    g = goodput_frac(tau, c, lam, restart_cost_s=1800.0)
                    assert 0.0 < g <= 1.0
                    assert g == reliability_jax.goodput_frac(
                        tau, c, lam, restart_cost_s=1800.0)

    def test_analytic_optimum_matches_numeric_scan(self):
        c, lam = 120.0, 1.0 / 3600.0
        tau_star = daly_interval(c, lam)
        assert tau_star == reliability_jax.daly_interval(c, lam)
        best = min((overhead(t, c, lam), t)
                   for t in [tau_star * s for s in
                             (0.25, 0.5, 0.9, 0.99, 1.0, 1.01, 1.1, 2, 4)])
        assert best[1] == tau_star

    def test_goodput_monotone_in_cluster_size(self):
        prev = 1.1
        for n in (64, 256, 1024, 4096, 16384):
            cols = on_both(lambda p: p.rel.reliability_columns(
                p.rel.FailureModel(mtbf_hours=10_000.0), 1e12, n))
            assert cols["goodput_frac"] <= prev
            prev = cols["goodput_frac"]

    def test_zero_rate_degenerates_exactly(self):
        cols = reliability_columns(FailureModel(mtbf_hours=math.inf),
                                   1e12, 2048)
        assert cols == {"ckpt_interval_s": math.inf,
                        "ckpt_overhead_frac": 0.0,
                        "expected_restarts": 0.0,
                        "goodput_frac": 1.0}
        assert daly_interval(100.0, 0.0) == math.inf
        assert overhead(600.0, 100.0, 0.0) == 0.0
        assert goodput_frac(600.0, 100.0, 0.0) == 1.0

    def test_fixed_interval_never_beats_daly(self):
        model = FailureModel(mtbf_hours=5_000.0, ckpt_bw=100e9)
        daly = reliability_columns(model, 5e12, 1024)["goodput_frac"]
        for s in (30.0, 300.0, 3000.0, 30000.0):
            fixed = on_both(lambda p: p.rel.reliability_columns(
                p.rel.FailureModel(mtbf_hours=5_000.0, ckpt_bw=100e9,
                                   interval_s=s), 5e12, 1024))
            assert fixed["goodput_frac"] <= daly + 1e-12

    @pytest.mark.parametrize("kw", [
        {}, {"restore_bw": 10e9}, {"mttr_hours": 0.0},
        {"interval_s": 600.0, "run_hours": 24.0}, {"blast": "pod"},
        {"mtbf_hours": 1.0, "ckpt_bw": 1e9}])
    @pytest.mark.parametrize("state,nodes", [(1e12, 2048), (8e9, 0),
                                             (0.0, 16)])
    def test_columns_are_the_references(self, kw, state, nodes):
        on_both(lambda p: (
            p.rel.reliability_columns(p.rel.FailureModel(**kw), state,
                                      nodes),
            p.rel.FailureModel(**kw).failure_rate(nodes),
            p.rel.FailureModel(**kw).restart_cost_s(state),
            p.rel.FailureModel(**kw).interval_for(state, nodes)))

    def test_validation(self):
        with pytest.raises(ValueError):
            daly_interval(-1.0, 1e-5)
        with pytest.raises(ValueError):
            daly_interval(10.0, -1e-5)
        with pytest.raises(ValueError):
            FailureModel(mtbf_hours=0.0)
        with pytest.raises(ValueError):
            FailureModel(ckpt_bw=0.0)
        with pytest.raises(ValueError):
            FailureModel(blast="rack")
        for kw in ({"mttr_hours": math.inf}, {"restore_bw": -1.0},
                   {"interval_s": -1.0}, {"run_hours": 0.0}):
            with pytest.raises(ValueError):
                FailureModel(**kw)


class TestDalyProperties:
    """Hypothesis property tests, each example also against the
    reference (bounded examples, no deadline)."""

    def test_goodput_bounds_property(self):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        @settings(max_examples=60, deadline=None)
        @given(st.floats(1.0, 1e6), st.floats(0.01, 1e4),
               st.floats(1e-9, 1e-2), st.floats(0.0, 1e5))
        def check(tau, c, lam, r):
            g = goodput_frac(tau, c, lam, r)
            assert 0.0 < g <= 1.0
            assert g == reliability_jax.goodput_frac(tau, c, lam, r)

        check()

    def test_daly_is_global_minimum_property(self):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        @settings(max_examples=60, deadline=None)
        @given(st.floats(0.01, 1e4), st.floats(1e-9, 1e-2),
               st.floats(0.1, 10.0))
        def check(c, lam, scale):
            tau = daly_interval(c, lam)
            assert tau == reliability_jax.daly_interval(c, lam)
            assert overhead(tau, c, lam) <= \
                overhead(tau * scale, c, lam) + 1e-9

        check()

    def test_goodput_monotone_in_n_property(self):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        @settings(max_examples=60, deadline=None)
        @given(st.floats(100.0, 1e6), st.integers(1, 12))
        def check(mtbf, k):
            model = FailureModel(mtbf_hours=mtbf)
            g1 = reliability_columns(model, 1e12, 2 ** k)["goodput_frac"]
            g2 = reliability_columns(model, 1e12,
                                     2 ** (k + 1))["goodput_frac"]
            assert g2 <= g1 + 1e-12
            assert g1 == reliability_jax.reliability_columns(
                reliability_jax.FailureModel(mtbf_hours=mtbf), 1e12,
                2 ** k)["goodput_frac"]

        check()


# --------------------------------------------------------------------- #
# Failure traces
# --------------------------------------------------------------------- #

class TestFailureTrace:
    def test_default_is_disabled_and_empty(self):
        t = FailureTrace()
        assert not t.enabled
        assert t.rate_per_node == 0.0
        assert t.materialize([16, 16]) == ()

    def test_poisson_is_deterministic(self):
        t = FailureTrace(kind="poisson", mtbf_hours=50.0, horizon_hours=48.0)
        a, b = t.materialize([64]), t.materialize([64])
        assert a == b and len(a) > 0
        assert t.materialize([64]) != \
            dataclasses.replace(t, seed=7).materialize([64])

    @pytest.mark.parametrize("seed", [0, 7, 2024])
    @pytest.mark.parametrize("blast,pods", [("node", None), ("pod", [8, 4]),
                                            ("pod", None)])
    def test_poisson_events_are_the_references(self, seed, blast, pods):
        evs = on_both(lambda p: (
            p.rel.FailureTrace(kind="poisson", mtbf_hours=50.0,
                               mttr_hours=0.5, blast=blast,
                               horizon_hours=48.0, seed=seed
                               ).materialize([64, 16, 0], pod_sizes=pods),
            p.rel.FailureTrace(kind="poisson", mtbf_hours=50.0,
                               seed=seed).rate_per_node))
        assert len(evs[0]) > 10

    def test_pod_blast_downs_the_pod(self):
        t = FailureTrace(kind="poisson", mtbf_hours=50.0, blast="pod",
                         horizon_hours=48.0)
        evs = t.materialize([64], pod_sizes=[8])
        assert evs and all(e.nodes == 8 for e in evs)

    def test_explicit_replays_sorted(self):
        evs = (FailureEvent(time=9.0, group=0), FailureEvent(time=1.0,
                                                             group=0))
        t = FailureTrace(kind="explicit", events=evs)
        out = t.materialize([8])
        assert [e.time for e in out] == [1.0, 9.0]
        bad = FailureTrace(kind="explicit",
                           events=(FailureEvent(time=0.0, group=3),))
        with pytest.raises(ValueError):
            bad.materialize([8])
        for kw in ({"time": -1.0}, {"group": -1}, {"nodes": 0},
                   {"repair_s": math.inf}):
            with pytest.raises(ValueError):
                FailureEvent(**{"time": 0.0, "group": 0, **kw})
        with pytest.raises(ValueError, match="kind"):
            FailureTrace(kind="weibull")

    def test_model_hands_off_trace(self):
        assert FailureModel(mtbf_hours=math.inf).trace().kind == "none"
        tr = FailureModel(mtbf_hours=100.0, mttr_hours=1.0).trace(seed=3)
        assert tr.kind == "poisson" and tr.seed == 3
        assert tr.mtbf_hours == 100.0 and tr.mttr_hours == 1.0
        on_both(lambda p: p.rel.FailureModel(
            mtbf_hours=100.0, mttr_hours=1.0, blast="pod"
        ).trace(seed=3, horizon_hours=12.0).materialize([32], [8]))


# --------------------------------------------------------------------- #
# Fault injection in the fleet timeline
# --------------------------------------------------------------------- #

def _summary(res):
    """A FleetResult's fields (outcomes and events included) and its
    failure-side properties."""
    return _plain(res), (res.failures, res.lost_work_frac, res.goodput,
                         res.feasible, res.jobs_completed)


def sim_both(fn):
    """``fn(pkg) -> FleetResult`` in each package: equal to the bit;
    returns the port's."""
    ref, mine = (fn(p) for p in PKGS)
    assert _summary(mine) == _summary(ref)
    return mine


class TestFaultInjection:
    def test_disabled_trace_is_bit_for_bit_identical(self):
        def jobs(p):
            return [p.job(0, width=8, iters=10),
                    p.job(1, width=4, iters=6, arrival=2.0, priority=1)]

        def run(p, **kw):
            model = p.fleet.FleetModel(policy="elastic", ckpt_interval_s=2.0)
            return p.sim((8,), model=model, **kw).run(jobs(p))
        base = sim_both(run)
        off = sim_both(lambda p: run(p, failures=p.rel.FailureTrace()))
        assert off.makespan == base.makespan
        assert off.busy_node_seconds == base.busy_node_seconds
        assert off.events == base.events
        assert off.failures == 0 and off.lost_work_frac == 0.0

    def test_failure_kills_and_recovers(self):
        def run(p, failures=None):
            model = p.fleet.FleetModel(policy="static", ckpt_interval_s=2.0)
            return p.sim((8,), model=model, failures=failures).run(
                [p.job(0, width=8, iters=10, it=1.0)])
        res = sim_both(lambda p: run(p, p.one_failure()))
        clean = sim_both(run)
        assert res.failures == 1
        assert res.jobs_completed == 1
        assert res.makespan > clean.makespan
        assert res.lost_node_seconds > 0.0
        assert 0.0 < res.goodput < 1.0
        kinds = {e.kind for e in res.events}
        assert {"fail_node", "repair", "fault"} <= kinds

    def test_rollback_is_interval_quantized(self):
        """With a checkpoint cadence, a failure rolls back only to the
        last committed interval boundary — strictly less work lost than
        the same failure with no checkpoints (whole segment discarded)."""
        def mk(interval):
            return sim_both(lambda p: p.sim(
                (8,), model=p.fleet.FleetModel(policy="static",
                                               ckpt_interval_s=interval),
                failures=p.one_failure(time=4.5, nodes=8)).run(
                    [p.job(0, width=8, iters=100, it=1.0)]))
        with_ckpt, without = mk(2.0), mk(0.0)
        # no cadence: everything since segment start (4.5s x 8 nodes)
        assert without.lost_node_seconds == pytest.approx(4.5 * 8)
        assert 0.0 < with_ckpt.lost_node_seconds < without.lost_node_seconds

    def test_wait_stalls_until_repair(self):
        res = sim_both(lambda p: p.sim(
            (8,), model=p.fleet.FleetModel(policy="static",
                                           degradation="wait",
                                           ckpt_interval_s=2.0),
            failures=p.one_failure(time=4.5, nodes=8, repair_s=500.0)).run(
                [p.job(0, width=8, iters=10, it=1.0)]))
        assert res.jobs_completed == 1
        assert res.makespan > 4.5 + 500.0

    def test_shrink_survives_on_remaining_nodes(self):
        res = sim_both(lambda p: p.sim(
            (8,), model=p.fleet.FleetModel(policy="static",
                                           degradation="shrink",
                                           ckpt_interval_s=2.0),
            failures=p.one_failure(time=4.5, nodes=6, repair_s=5000.0)).run(
                [p.job(0, width=8, iters=10, it=1.0, widths=(2, 8))]))
        assert res.jobs_completed == 1
        assert res.makespan < 5000.0

    def test_per_job_on_failure_overrides_fleet_default(self):
        res = sim_both(lambda p: p.sim(
            (8,), model=p.fleet.FleetModel(policy="static",
                                           degradation="wait",
                                           ckpt_interval_s=2.0),
            failures=p.one_failure(time=4.5, nodes=6, repair_s=5000.0)).run(
                [p.job(0, width=8, iters=10, it=1.0, widths=(2, 8),
                       on_failure="shrink")]))
        assert res.makespan < 5000.0

    def test_capacity_conserved_through_repair(self):
        """After repair the full width is available again: a second job
        arriving post-repair starts at full width."""
        res = sim_both(lambda p: p.sim(
            (8,), model=p.fleet.FleetModel(policy="static",
                                           ckpt_interval_s=2.0),
            failures=p.one_failure(time=2.5, nodes=8, repair_s=50.0)).run(
                [p.job(0, width=8, iters=5, it=1.0),
                 p.job(1, width=8, iters=2, it=1.0, arrival=300.0)]))
        assert res.jobs_completed == 2
        starts = [e for e in res.events if e.kind == "start"
                  and e.job == "j1"]
        assert starts and starts[0].width == 8

    @pytest.mark.parametrize("policy", ["static", "elastic",
                                        "elastic+burst"])
    @pytest.mark.parametrize("seed", [0, 3])
    def test_poisson_faults_daly_cadence_are_the_references(self, policy,
                                                            seed):
        """A Poisson failure trace with pod blast radius over a busy
        two-group fleet, checkpoint cadence at the per-segment Young–Daly
        optimum: the same timeline in both packages."""
        def job(p, uid, it, **kw):
            spec = p.fleet.FleetJobSpec(name=f"j{uid}", **kw)
            return p.fleet.FleetJob(spec, {
                w: p.fleet.WidthProfile(iter_times=(it * 8 / w,) * 2,
                                        fits=(True, True), state_bytes=STATE)
                for w in spec.width_menu}, uid=uid)

        def fn(p):
            jobs = [job(p, 0, 3.0, nodes_per_instance=8, iterations=400,
                        widths=(4, 8, 16), on_failure="shrink"),
                    job(p, 1, 2.0, nodes_per_instance=4, iterations=300,
                        priority=1, arrival=50.0),
                    job(p, 2, 1.5, nodes_per_instance=8, iterations=200,
                        priority=2, arrival=120.0, widths=(8, 16),
                        burst_iters=60, preemptible=False)]
            trace = p.rel.FailureTrace(kind="poisson", mtbf_hours=2.0,
                                       mttr_hours=0.05, blast="pod",
                                       horizon_hours=0.5, seed=seed)
            return p.sim((16, 16), model=p.fleet.FleetModel(policy=policy),
                         failures=trace, pod_sizes=[4, 8]).run(jobs)
        res = sim_both(fn)
        assert any(e.kind == "fail_node" for e in res.events)
        assert res.jobs_completed == 3

    def test_validation(self):
        for build in (
                lambda p: p.fleet.FleetModel(degradation="panic"),
                lambda p: p.fleet.FleetModel(ckpt_interval_s=-1.0),
                lambda p: p.fleet.FleetJobSpec(name="x",
                                               nodes_per_instance=4,
                                               iterations=1,
                                               on_failure="retry"),
                lambda p: p.sim((8,), failures=p.rel.FailureTrace(),
                                pod_sizes=[8, 8])):
            texts = []
            for p in PKGS:
                with pytest.raises(ValueError) as err:
                    build(p)
                texts.append(str(err.value))
            assert texts[1] == texts[0]


# --------------------------------------------------------------------- #
# Study columns + degenerate equivalence
# --------------------------------------------------------------------- #

class TestStudyColumns:
    def test_no_model_no_columns(self):
        rec = run_both(lambda p: p.tiny_spec()).cells[0].record
        assert "goodput_frac" not in rec and "ckpt_interval_s" not in rec

    def test_no_model_records_are_todays(self):
        """reliability=None adds nothing: the records are the runner's
        without the reliability columns, key for key and bit for bit."""
        spec = _tiny_spec(axes=[Axis("flops_x", (0.5, 1.0, 2.0),
                                     path="node.peak_flops", mode="scale")])
        res = run_study(spec, device="cpu")
        again = run_study(dataclasses.replace(spec, reliability=None),
                          device="cpu")
        assert res.records == again.records
        for r in res.records:
            assert not {"goodput_frac", "goodput_per_dollar",
                        "ckpt_interval_s"} & set(r)

    def test_disabled_model_is_identity(self):
        base = run_study(_tiny_spec(), device="cpu").cells[0].record
        rec = run_both(lambda p: p.tiny_spec(
            reliability=p.rel.FailureModel(mtbf_hours=math.inf))
        ).cells[0].record
        for k, v in base.items():
            assert rec[k] == v, k
        assert rec["goodput_frac"] == 1.0
        assert rec["expected_restarts"] == 0.0
        assert rec["goodput_per_dollar"] == rec["perf_per_dollar"]

    def test_reliability_axis_folds_into_model(self):
        res = run_both(lambda p: p.tiny_spec(
            reliability=p.rel.FailureModel(mtbf_hours=math.inf),
            axes=[p.study.Axis("mtbf_hours", (math.inf, 1000.0),
                               path="reliability.mtbf_hours")]))
        by = {c.record["mtbf_hours"]: c.record for c in res}
        assert by[math.inf]["goodput_frac"] == 1.0
        assert 0.0 < by[1000.0]["goodput_frac"] < 1.0
        assert by[1000.0]["goodput_per_dollar"] < \
            by[1000.0]["perf_per_dollar"]
        assert by[1000.0]["expected_restarts"] > 0.0

    @pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                      "transformer-1t"])
    def test_infeasible_cells_get_zeroed_columns(self, arch):
        """A strategy the model cannot realise (granite: ep 7 does not
        divide its 40 experts) and strategies that do not fit
        (transformer-1t) get the reference's zeroed columns; granite's
        other strategies get the columns."""
        def spec(p):
            S = p.study
            return dataclasses.replace(
                p.tiny_spec(reliability=p.rel.FailureModel(
                    mtbf_hours=1000.0)),
                model=p.get_config(arch),
                strategies=S.ExplicitSpace((
                    S.ParallelSpec(mp=8, dp=128),
                    S.ParallelSpec(mp=8, dp=128, ep=7),
                    S.ParallelSpec(mp=1, dp=1024))),
                require_fit=True)
        res = run_both(spec, validate="off")
        bad = [r for r in res.records if not r["feasible"]]
        assert len(bad) == (1 if arch.startswith("granite") else 3)
        assert all(r["goodput_frac"] == 0.0 and r["expected_restarts"] == 0.0
                   and r["goodput_per_dollar"] == 0.0 for r in bad)
        assert all(0.0 < r["goodput_frac"] < 1.0
                   for r in res.records if r["feasible"])

    def test_figure_studies_unchanged_by_disabled_model(self):
        """All seven figure-study records are bit-for-bit identical with a
        disabled (MTBF = inf) failure model attached, and those records
        are the reference's."""
        for name, spec in dse.figure_studies().items():
            base = run_study(spec, device="cpu")
            rel = run_study(dataclasses.replace(
                spec, reliability=FailureModel(mtbf_hours=math.inf)),
                device="cpu")
            assert len(base.cells) == len(rel.cells), name
            for b, r in zip(base.cells, rel.cells):
                for k, v in b.record.items():
                    assert r.record[k] == v, (name, k)
                if r.record.get("feasible"):
                    assert r.record["goodput_frac"] == 1.0
            ref_spec = dse_jax.figure_studies()[name]
            assert_records_equivalent(
                study_jax.run_study(dataclasses.replace(
                    ref_spec, reliability=reliability_jax.FailureModel(
                        mtbf_hours=math.inf)), validate="off"), rel)

    def test_reliability_study_records_equal_reference(self):
        res = run_both(lambda p: p.dse.reliability_study(), validate="off")
        assert len(res) == 8        # each shape's one fill-the-cluster strategy
        assert {r["cluster"] for r in res.records} == {"many-weak",
                                                       "few-strong"}
        assert res.records == run_study(dse.reliability_study(),
                                        device="cpu").records

    def test_fleet_spec_failure_columns(self):
        res = run_both(lambda p: p.dse.reliability_fleet_study(
            num_iters_scale=0.25, fail_time=60.0, repair_s=3_000.0))
        assert len(res) == 2
        for cell in res:
            rec = cell.record
            assert rec["feasible"]
            assert rec["failures"] >= 1
            assert 0.0 <= rec["lost_work_frac"] < 1.0
            assert 0.0 < rec["goodput"] <= 1.0


# --------------------------------------------------------------------- #
# Y1xx rules
# --------------------------------------------------------------------- #

def same_diagnostics(build):
    ref, mine = (p.analyze(build(p)) for p in PKGS)
    assert [d.to_dict() for d in mine] == [d.to_dict() for d in ref]
    return mine


class TestRules:
    @staticmethod
    def _trace_spec(p, failures):
        return p.fleet_spec(failures)

    def test_clean_specs_are_clean(self):
        assert same_diagnostics(lambda p: p.tiny_spec(
            reliability=p.rel.FailureModel())) == []
        assert same_diagnostics(lambda p: p.dse.reliability_study()) == []
        assert same_diagnostics(lambda p: self._trace_spec(
            p, p.rel.FailureTrace(kind="poisson", mtbf_hours=100.0))) == []
        assert same_diagnostics(
            lambda p: p.dse.reliability_fleet_study()) == []

    def test_y101_bad_swept_rate(self):
        diags = same_diagnostics(lambda p: p.tiny_spec(
            reliability=p.rel.FailureModel(),
            axes=[p.study.Axis("mtbf_hours", (1000.0, -5.0),
                               path="reliability.mtbf_hours"),
                  p.study.Axis("bw", (0.0, math.inf),
                               path="reliability.ckpt_bw"),
                  p.study.Axis("mttr", (math.nan,),
                               path="reliability.mttr_hours"),
                  p.study.Axis("rbw", (-1.0,),
                               path="reliability.restore_bw")]))
        assert {d.code for d in diags} == {"Y101"}
        assert len(diags) == 5
        diags = same_diagnostics(lambda p: p.fleet_spec(
            p.rel.FailureTrace(kind="poisson", mtbf_hours=100.0),
            axes=[p.study.Axis("m", (-1.0,), path="fail.mtbf_hours"),
                  p.study.Axis("r", (math.inf,), path="fail.mttr_hours")]))
        assert [d.code for d in diags] == ["Y101", "Y101"]

    def test_y102_interval_longer_than_run(self):
        diags = same_diagnostics(lambda p: p.tiny_spec(
            reliability=p.rel.FailureModel(interval_s=200 * 3600.0,
                                           run_hours=168.0)))
        assert any(d.code == "Y102" and d.severity == "error"
                   for d in diags)
        diags = same_diagnostics(lambda p: p.tiny_spec(
            reliability=p.rel.FailureModel(),
            axes=[p.study.Axis("iv", (60.0, -1.0, 1e9),
                               path="reliability.interval_s")]))
        assert [d.code for d in diags] == ["Y102", "Y102"]

    def test_y103_empty_explicit_trace(self):
        diags = same_diagnostics(lambda p: self._trace_spec(
            p, p.rel.FailureTrace(kind="explicit")))
        assert any(d.code == "Y103" for d in diags)
        diags = same_diagnostics(lambda p: self._trace_spec(
            p, p.rel.FailureTrace(kind="poisson", mtbf_hours=10.0,
                                  horizon_hours=0.0)))
        assert [d.code for d in diags] == ["Y103"]

    def test_y104_blast_out_of_range(self):
        diags = same_diagnostics(lambda p: self._trace_spec(
            p, p.rel.FailureTrace(kind="explicit", events=(
                p.rel.FailureEvent(time=1.0, group=9),))))
        assert any(d.code == "Y104" for d in diags)
        diags = same_diagnostics(lambda p: self._trace_spec(
            p, p.rel.FailureTrace(kind="explicit", events=(
                p.rel.FailureEvent(time=1.0, group=0, nodes=10 ** 6),))))
        assert any(d.code == "Y104" for d in diags)

    def test_y105_zero_draw_warns(self):
        diags = same_diagnostics(lambda p: self._trace_spec(
            p, p.rel.FailureTrace(kind="poisson", mtbf_hours=1e9,
                                  horizon_hours=0.01)))
        assert any(d.code == "Y105" and d.severity == "warning"
                   for d in diags)

    def test_run_study_validate_gates_fleet_failures(self):
        """A fleet's enabled failure trace joins the pre-flight (Y1xx)
        when the spec has no failure model; a disabled one does not."""
        texts = []
        for p in PKGS:
            bad = dataclasses.replace(
                p.dse.reliability_fleet_study(),
                failures=p.rel.FailureTrace(kind="explicit", events=(
                    p.rel.FailureEvent(time=1.0, group=0, nodes=99),)))
            with pytest.raises(p.AnalysisError, match="Y104") as err:
                p.run(bad, validate="error")
            texts.append(str(err.value))
        assert texts[1] == texts[0]
        off = dataclasses.replace(dse.reliability_fleet_study(),
                                  failures=FailureTrace(kind="explicit"))
        assert len(run_study(off, validate="error", device="cpu")) == 2

    def test_run_study_validate_gates_reliability(self):
        spec = _tiny_spec(reliability=FailureModel(
            interval_s=200 * 3600.0, run_hours=168.0))
        with pytest.raises(AnalysisError, match="Y102"):
            run_study(spec, validate="error", device="cpu")
        with pytest.warns(UserWarning, match="Y102"):
            run_study(spec, device="cpu")


# --------------------------------------------------------------------- #
# Headlines
# --------------------------------------------------------------------- #

class TestHeadlines:
    def test_shrink_beats_wait_on_turnaround_p99(self):
        recs = dse.reliability_fleet_ranking(device="cpu")
        ref = dse_jax.reliability_fleet_ranking()
        assert [r["degradation"] for r in recs] == \
            [r["degradation"] for r in ref]
        h = dse.reliability_fleet_headline(recs)
        h_ref = dse_jax.reliability_fleet_headline(ref)
        assert list(h) == list(h_ref)
        for k, v in h_ref.items():
            assert h[k] == pytest.approx(v, rel=1e-9), k
        assert h["p99_ratio"] > 1.0
        assert h["shrink_p99"] < h["wait_p99"]
        assert h["shrink_goodput"] > h["wait_goodput"]

    def test_daly_beats_naive_and_ranking_flips(self):
        recs = dse.reliability_ranking(device="cpu")
        ref = dse_jax.reliability_ranking()
        assert [(r["cluster"], r["mtbf_hours"], r["ckpt_interval"])
                for r in recs] == \
            [(r["cluster"], r["mtbf_hours"], r["ckpt_interval"])
             for r in ref]
        h = dse.reliability_headline(recs)
        h_ref = dse_jax.reliability_headline(ref)
        assert list(h) == list(h_ref)
        for k, v in h_ref.items():
            if isinstance(v, float):
                assert h[k] == pytest.approx(v, rel=1e-9), k
            else:
                assert h[k] == v, k
        assert h["daly_vs_naive"] >= 1.0
        assert h["daly_goodput"] > h["naive_goodput"]
        assert h["ranking_flips"]
        assert h["best_failure_free"] != h["best_failure_aware"]
        assert isinstance(dse.reliability_study(), StudySpec)
        assert dse.RELIABILITY_SHAPE == ShapeConfig("reliability", 2048,
                                                    1024, "train")
        assert dse.reliability_study().strategies == GridSpace(
            mp=(8,), dp=(64, 256))
        assert BASELINE_DGX_A100.cost is not None
