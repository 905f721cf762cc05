"""The port's fleet timeline (``repro_torch.fleet``: jobs, trace, simulator,
spec; the F1xx rules; ``dse.fleet_study`` and its ranking) against the JAX
package's.

Mirrors ``tests/test_fleet.py`` case for case on the port and holds each
output to the reference's on the same inputs:

* specs, traces and the cost formula are Python and numpy on both sides:
  equal, errors with the same text;
* the simulator on hand-fed ``WidthProfile``s is the same Python arithmetic
  on both sides: every ``FleetResult`` field (outcomes and events included)
  and every property equal to the bit, also on the hypothesis draws;
* through ``run_study(..., device="cpu")`` the records follow the runner's
  rule (``tests/test_torch_study.py``: the reference's keys in its order,
  non-float values equal, floats within 1e-9 relative), since the width
  profiles come from each package's compiled evaluator; the event streams
  replayed from those profiles have equal kinds, jobs, groups, widths and
  allocations, and times within 1e-9 relative;
* the degenerate-equivalence cases hold the port's timeline to the port's
  ``ScheduleModel`` bit for bit (and to the reference's within 1e-9 where
  the iteration times come from the two evaluators);
* the profiles take ``run_study``'s device, and their memo keeps one
  device's profiles from standing in for another's.
"""

import dataclasses
import math

import pytest
import torch

import repro.fleet as fleet_jax
import repro.fleet.spec as fleet_spec_jax
from repro.analysis import AnalysisError as AnalysisErrorJax
from repro.analysis import analyze_fleet as analyze_fleet_jax
from repro.configs import get_config as get_config_jax
from repro.configs import get_dlrm_config as get_dlrm_config_jax
from repro.configs.base import ShapeConfig as ShapeConfigJax
from repro.core import cluster as cluster_jax
from repro.core import dse as dse_jax
from repro.core import memory as memory_jax
from repro.core import placement as placement_jax
from repro.core import study as study_jax
from repro.core import workload as workload_jax
from repro.core.simulator import \
    group_breakdowns_compiled as group_breakdowns_jax
import repro_torch.fleet as fleet
import repro_torch.fleet.spec as fleet_spec
from repro_torch.analysis import AnalysisError, analyze_fleet
from repro_torch.configs import ShapeConfig, get_config, get_dlrm_config
from repro_torch.core import cluster, dse, memory, placement, study, workload
from repro_torch.core.simulator import group_breakdowns_compiled
from repro_torch.core.study import Axis, StudySpec, run_study
from test_torch_study import assert_records_equivalent

REL = 1e-9
RESULT_PROPS = ("turnarounds", "turnaround_p50", "turnaround_p99",
                "fleet_util", "preemptions", "resize_events", "burst_events",
                "jobs_completed", "failures", "lost_work_frac", "goodput",
                "feasible")


class Pkg:
    """One package's fleet surface: index 0 is the reference, 1 the port,
    so a test builds the same object in both."""

    def __init__(self, i):
        self.i = i
        self.fleet = (fleet_jax, fleet)[i]
        self.dse = (dse_jax, dse)[i]
        self.study = (study_jax, study)[i]
        self.cluster = (cluster_jax, cluster)[i]
        self.placement = (placement_jax, placement)[i]
        self.workload = (workload_jax, workload)[i]
        self.memory = (memory_jax, memory)[i]
        self.get_config = (get_config_jax, get_config)[i]
        self.get_dlrm_config = (get_dlrm_config_jax, get_dlrm_config)[i]
        self.Shape = (ShapeConfigJax, ShapeConfig)[i]
        self.analyze_fleet = (analyze_fleet_jax, analyze_fleet)[i]
        self.AnalysisError = (AnalysisErrorJax, AnalysisError)[i]

    def run(self, spec, **kw):
        if self.i:
            return run_study(spec, device="cpu", **kw)
        return study_jax.run_study(spec, **kw)

    def group_breakdowns(self, cw, cl):
        if self.i:
            return group_breakdowns_compiled(cw, cl, zero_stage=2,
                                             env_cache={}, device="cpu")
        return group_breakdowns_jax(cw, cl, zero_stage=2, env_cache={})

    def profiles(self, spec, cl, placement_name):
        pl = self.placement.get_placement(placement_name)
        if self.i:
            return fleet_spec._profiles(spec, cl, 2, pl, {}, device="cpu")
        return fleet_spec_jax._profiles(spec, cl, 2, pl, {})

    def model(self, policy="elastic+burst", **kw):
        return self.fleet.FleetModel(policy=policy, **kw)

    def prof(self, times, fits=None, sb=8e9):
        """{width: (t_g0, t_g1, ...)} -> per-width WidthProfile map."""
        out = {}
        for w, ts in times.items():
            ts = ts if isinstance(ts, tuple) else (ts,)
            ft = fits[w] if fits else (True,) * len(ts)
            out[w] = self.fleet.WidthProfile(iter_times=ts, fits=ft,
                                             state_bytes=sb)
        return out

    def job(self, uid=0, width=8, iters=1, caps_groups=1, it=1.0, **kw):
        spec = self.fleet.FleetJobSpec(name=kw.pop("name", f"j{uid}"),
                                       nodes_per_instance=width,
                                       iterations=iters, **kw)
        times = {w: (it,) * caps_groups for w in spec.width_menu}
        return self.fleet.FleetJob(spec=spec, profiles=self.prof(times),
                                   uid=uid)

    def spec(self, name="j", **kw):
        return self.fleet.FleetJobSpec(name=name, **kw)

    def fjob(self, spec, profiles, uid=0):
        return self.fleet.FleetJob(spec, profiles, uid=uid)

    def sim(self, caps, model=None, **kw):
        return self.fleet.FleetSimulator(caps, model=model, **kw)

    def tiny_fleet_spec(self, **kw):
        jobs = kw.pop("jobs", (
            self.fleet.FleetJobSpec(name="chat", model="chatglm3-6b", mp=2,
                                    global_batch=256, nodes_per_instance=8,
                                    widths=(8, 16, 32), iterations=10),))
        defaults = dict(name="tiny-fleet", jobs=jobs,
                        cluster=self.dse.mixed_dlrm_fleet(),
                        ftrace=self.fleet.FleetTrace(kind="static"),
                        placement="em-aware")
        defaults.update(kw)
        return self.fleet.FleetSpec(**defaults)


REF, PORT = Pkg(0), Pkg(1)
PKGS = (REF, PORT)


def _plain(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple(_plain(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def summary(res):
    """Everything a FleetResult says: its fields (outcomes and events
    included) and every property."""
    return _plain(res), tuple(getattr(res, p) for p in RESULT_PROPS)


def on_both(fn):
    """``fn(pkg)`` in each package: equal outputs (dataclasses field for
    field, floats to the bit); returns the port's."""
    ref, mine = (fn(p) for p in PKGS)
    assert _plain(mine) == _plain(ref)
    return mine


def sim_both(fn):
    """``fn(pkg) -> FleetResult`` in each package: equal to the bit, field
    for field and property for property; returns the port's."""
    ref, mine = (fn(p) for p in PKGS)
    assert summary(mine) == summary(ref)
    return mine


def raises_both(fn, exc=ValueError, match=None):
    """``fn(pkg)`` raises ``exc`` in each package, with the same text."""
    texts = []
    for p in PKGS:
        with pytest.raises(exc, match=match) as err:
            fn(p)
        texts.append(str(err.value))
    assert texts[1] == texts[0]


def close(a, b, rel=REL):
    if isinstance(b, float) and math.isfinite(b):
        return a == pytest.approx(b, rel=rel, abs=1e-12)
    if isinstance(b, float):
        return str(a) == str(b)
    return a == b


def assert_results_close(ref, mine):
    """Two timelines replayed from the two evaluators' profiles: the same
    events (kind, job, group, width, allocation), times and outcome floats
    within 1e-9 relative, everything else equal."""
    assert [(e.kind, e.job, e.group, e.width, e.alloc)
            for e in mine.events] == \
        [(e.kind, e.job, e.group, e.width, e.alloc) for e in ref.events]
    assert all(close(a.time, b.time) for a, b in zip(mine.events,
                                                     ref.events))
    for a, b in zip(mine.outcomes, ref.outcomes):
        for f in dataclasses.fields(b):
            assert close(getattr(a, f.name), getattr(b, f.name)), f.name
    for name in RESULT_PROPS + ("makespan", "busy_node_seconds",
                                "useful_node_seconds", "lost_node_seconds"):
        va, vb = getattr(mine, name), getattr(ref, name)
        if isinstance(vb, tuple):
            assert all(close(x, y) for x, y in zip(va, vb)), name
        else:
            assert close(va, vb), name


def run_both(build, **kw):
    """``build(pkg)`` through each package's runner: the port's records
    hold to the reference's by the runner's rule; returns the port's."""
    ref, mine = (p.run(build(p), **kw) for p in PKGS)
    assert_records_equivalent(ref, mine)
    return mine


def same_diagnostics(build):
    ref, mine = (p.analyze_fleet(build(p)) for p in PKGS)
    assert [d.to_dict() for d in mine] == [d.to_dict() for d in ref]
    return mine


def test_exports_are_the_references():
    assert fleet.__all__ == fleet_jax.__all__
    assert issubclass(fleet.FleetJobSpec, placement.JobSpec)
    assert issubclass(fleet.FleetStudy, StudySpec)
    assert fleet.FLEET_POLICIES == fleet_jax.FLEET_POLICIES
    assert fleet.DEGRADATION_POLICIES == fleet_jax.DEGRADATION_POLICIES
    assert fleet.FLEET_TRACE_KINDS == fleet_jax.FLEET_TRACE_KINDS
    assert fleet.FLEET_COLUMNS == fleet_jax.FLEET_COLUMNS


# ===================================================================== #
# Specs, traces, and the resize-cost formula
# ===================================================================== #

class TestFleetJobSpec:
    def test_width_menu_and_elastic(self):
        s = on_both(lambda p: p.spec("a", nodes_per_instance=16,
                                     widths=(8, 32)))
        assert s.base_width == 16
        assert s.width_menu == (8, 16, 32)
        assert s.elastic
        assert not on_both(lambda p: p.spec("b", nodes_per_instance=8)
                           ).elastic

    @pytest.mark.parametrize("kw", [
        {"nodes_per_instance": 0}, {"arrival": -1.0}, {"iterations": 0},
        {"widths": (0,)}, {"burst_iters": -1}, {"mp": 0},
        {"nodes_per_instance": 4, "on_failure": "retry"}])
    def test_validation(self, kw):
        raises_both(lambda p: p.spec("x", **kw))

    def test_fleet_job_needs_full_menu(self):
        raises_both(lambda p: p.fjob(
            p.spec("a", nodes_per_instance=8, widths=(16,)),
            p.prof({8: 1.0})), match="WidthProfile")

    def test_width_profile_validation(self):
        raises_both(lambda p: p.fleet.WidthProfile(iter_times=(1.0, 2.0),
                                                   fits=(True,)))
        raises_both(lambda p: p.fleet.WidthProfile(iter_times=(-1.0,),
                                                   fits=(True,)))
        prof = on_both(lambda p: p.fleet.WidthProfile(
            iter_times=(math.inf, 0.5), fits=(False, True), state_bytes=3.0))
        assert prof.iter_times == (math.inf, 0.5)


class TestFleetTrace:
    def test_static_replays_templates_verbatim(self):
        def fn(p):
            tpl = (p.spec("a", nodes_per_instance=8, arrival=3.0),)
            out = p.fleet.FleetTrace(kind="static").materialize(tpl)
            assert out == tpl
            return out, p.fleet.FleetTrace(kind="static").arrivals
        on_both(fn)

    @pytest.mark.parametrize("seed", [0, 7, 8, 2024])
    def test_poisson_deterministic_per_seed(self, seed):
        t = on_both(lambda p: p.fleet.FleetTrace(
            kind="poisson", rate=0.01, num_jobs=6, seed=seed).arrivals)
        again = fleet.FleetTrace(kind="poisson", rate=0.01, num_jobs=6,
                                 seed=seed)
        assert t == again.arrivals
        other = fleet.FleetTrace(kind="poisson", rate=0.01, num_jobs=6,
                                 seed=seed + 1)
        assert t != other.arrivals
        assert t[0] == 0.0
        assert all(b >= a for a, b in zip(t, t[1:]))
        assert fleet.FleetTrace(kind="poisson", rate=0.01, num_jobs=6,
                                seed=seed).duration == t[-1]

    def test_uniform_spacing(self):
        t = on_both(lambda p: p.fleet.FleetTrace(kind="uniform", rate=0.5,
                                                 num_jobs=4).arrivals)
        assert t == (0.0, 2.0, 4.0, 6.0)

    def test_materialize_cycles_and_stamps(self):
        jobs = on_both(lambda p: p.fleet.FleetTrace(
            kind="uniform", rate=1.0, num_jobs=4).materialize(
                (p.spec("a", nodes_per_instance=8),
                 p.spec("b", nodes_per_instance=4))))
        assert [j.name for j in jobs] == ["a#0", "b#1", "a#2", "b#3"]
        assert [j.arrival for j in jobs] == [0.0, 1.0, 2.0, 3.0]

    def test_mean_iterations_stamps_durations(self):
        jobs = on_both(lambda p: p.fleet.FleetTrace(
            kind="uniform", rate=1.0, num_jobs=8, seed=3,
            mean_iterations=40).materialize(
                (p.spec("a", nodes_per_instance=8, iterations=5),)))
        assert all(j.iterations >= 1 for j in jobs)
        assert len({j.iterations for j in jobs}) > 1
        on_both(lambda p: p.fleet.FleetTrace(
            kind="poisson", rate=0.02, num_jobs=16, seed=11,
            mean_iterations=7).materialize(
                (p.spec("a", nodes_per_instance=8),
                 p.spec("b", nodes_per_instance=2, priority=3))))

    def test_validation(self):
        raises_both(lambda p: p.fleet.FleetTrace(kind="weird"))
        raises_both(lambda p: p.fleet.FleetTrace(
            kind="poisson", rate=0.0).materialize(
                (p.spec("a", nodes_per_instance=1),)))
        raises_both(lambda p: p.fleet.FleetTrace(
            kind="static").materialize(()))


class TestResizeCostModel:
    """The documented remesh formula, end to end."""

    def test_formula(self):
        sb = 64e9
        on_both(lambda p: (p.fleet.checkpoint_delay(sb, 40e9),
                           p.fleet.remesh_delay(sb, 40e9, 100e9)))
        assert fleet.checkpoint_delay(sb, 40e9) == sb / 40e9
        assert fleet.remesh_delay(sb, 40e9, 100e9) == \
            sb / 40e9 + sb / 100e9
        raises_both(lambda p: p.fleet.checkpoint_delay(sb, 0.0))
        raises_both(lambda p: p.fleet.remesh_delay(sb, 40e9, -1.0))

    def test_state_bytes_matches_memory_model(self):
        """(FP16+GRAD+OPTIM)/FP16 x one replica's weight bytes: the
        tensors a resize moves per instance."""
        def fn(p):
            spec = p.spec("t", model="chatglm3-6b", mp=2,
                          global_batch=256, nodes_per_instance=8)
            wl = p.fleet.build_workload(spec, 8)
            m = p.memory
            shard = sum(ly.weight_bytes * ly.repeat
                        for ly in wl.layers) / m.FP16
            expect = (m.FP16 + m.GRAD + m.OPTIM) * shard * wl.mp
            assert p.fleet.instance_state_bytes(wl) == expect
            return expect
        assert on_both(fn) > 0

    @pytest.mark.parametrize("model,mp,width", [
        ("dlrm", 1, 16), ("chatglm3-6b", 2, 8), ("internlm2-20b", 4, 32)])
    def test_build_workload_is_the_references(self, model, mp, width):
        def fn(p):
            wl = p.fleet.build_workload(
                p.spec("w", model=model, mp=mp, global_batch=256,
                       nodes_per_instance=width), width)
            return (wl.mp, wl.dp, len(wl.layers),
                    p.fleet.instance_state_bytes(wl))
        on_both(fn)
        raises_both(lambda p: p.fleet.build_workload(
            p.spec("odd", model="chatglm3-6b", mp=2,
                   nodes_per_instance=8), 9))

    def test_simulator_resize_delay_matches_formula_registry_model(self):
        """A registry-model grow pays exactly checkpoint + reshard: the
        makespan is remesh_delay + remaining x the wide iteration time."""
        def fn(p):
            cl = p.dse.mixed_dlrm_fleet()
            spec = p.spec("chat", model="chatglm3-6b", mp=2,
                          global_batch=256, nodes_per_instance=8,
                          widths=(8, 16, 32), iterations=100)
            profiles = p.profiles(spec, cl, "em-aware")
            job = p.fjob(spec, profiles)
            res = p.sim([g.num_nodes for g in cl.node_groups],
                        model=p.model("elastic", checkpoint_bw=40e9,
                                      reshard_bw=100e9)).run([job])
            sb = p.fleet.instance_state_bytes(
                p.fleet.build_workload(spec, 8))
            assert job.state_bytes == sb
            grow = [e for e in res.events if e.kind == "grow"]
            assert len(grow) == 1 and grow[0].width == 32
            cost = p.fleet.remesh_delay(sb, 40e9, 100e9)
            wide_it = profiles[32].iter_times[grow[0].group]
            assert res.makespan == cost + 100 * wide_it
            assert res.resize_events == 1
            return res
        assert_results_close(*(fn(p) for p in PKGS))

    def test_preemption_pays_checkpoint_then_restore(self):
        """The victim's nodes free one checkpoint write after the
        preemption; its rerun is delayed by the restore charge."""
        sb = 80e9

        def fn(p):
            low = p.fjob(p.spec("low", nodes_per_instance=8, iterations=10),
                         p.prof({8: 5.0}, sb=sb), uid=0)
            hi = p.fjob(p.spec("hi", nodes_per_instance=8, iterations=2,
                               priority=5, arrival=12.0),
                        p.prof({8: 1.0}, sb=sb), uid=1)
            return p.sim((8,), model=p.model("elastic")).run([low, hi])
        res = sim_both(fn)
        ck = fleet.checkpoint_delay(sb, fleet.FleetModel().checkpoint_bw)
        hi_out = next(o for o in res.outcomes if o.name == "hi")
        assert hi_out.first_start == 12.0 + ck
        assert hi_out.finish == 12.0 + ck + 2 * 1.0
        low_out = next(o for o in res.outcomes if o.name == "low")
        assert low_out.preemptions == 1
        assert low_out.finish == hi_out.finish + ck + 8 * 5.0
        assert res.feasible


# ===================================================================== #
# Degenerate equivalence: static single-job traces == ScheduleModel
# ===================================================================== #

class _GroupStub:
    def __init__(self, num_nodes):
        self.num_nodes = num_nodes


def _check(p, caps, iter_times, fits, instances, npi, max_nodes=0,
           placement_name=None):
    """``p``'s timeline against ``p``'s own ScheduleModel, bit for bit."""
    pl = p.placement.get_placement(placement_name)
    sched = p.placement.ScheduleModel().schedule(
        p.placement.JobSpec(instances=instances, nodes_per_instance=npi,
                            max_nodes=max_nodes),
        [_GroupStub(n) for n in caps], iter_times, fits=fits, placement=pl)
    job = p.fjob(
        p.spec("j", instances=instances, nodes_per_instance=npi,
               max_nodes=max_nodes, iterations=1),
        p.prof({npi: tuple(iter_times)},
               fits={npi: tuple(fits)} if fits else None))
    res = p.sim(caps, model=p.model("static"), placement=pl).run([job])
    assert res.makespan == sched.makespan          # bit for bit
    assert res.feasible == sched.feasible
    assert res.jobs_completed == 1
    assert res.preemptions == res.resize_events == 0
    return res


class TestDegenerateEquivalence:
    @pytest.mark.parametrize("caps,its,fits,inst,npi,cap", [
        ((32, 32), (1.0, 3.0), None, 8, 8, 0),
        ((64,), (0.1,), None, 8, 8, 0),
        ((64,), (0.7,), None, 10, 16, 64),
        ((32, 32), (0.31, 0.17), None, 8, 16, 48),
        ((12, 8), (1.0, 2.0), None, 3, 16, 0),   # legacy fallback
        ((32, 32), (0.5, 0.5), (False, True), 8, 16, 0),
    ])
    def test_synthetic_grid(self, caps, its, fits, inst, npi, cap):
        sim_both(lambda p: _check(p, caps, its, fits, inst, npi,
                                  max_nodes=cap))

    @pytest.mark.parametrize("npi", (64, 32, 16))
    def test_fig13b_record_equivalent(self, npi):
        """The Fig. 13b cells: N DLRM instances on the half-EM fleet,
        timed by each package's compiled evaluator — each timeline equals
        its own ScheduleModel's makespan exactly, both placements, and
        the two packages agree within 1e-9."""
        def fn(p):
            cl = p.dse.mixed_dlrm_fleet()
            wl = p.workload.decompose_dlrm(p.get_dlrm_config(), 4096, npi)
            per = p.group_breakdowns(wl.compiled(), cl)
            its = [b.total for b in per]
            fits = [b.feasible for b in per]
            return [_check(p, tuple(g.num_nodes for g in cl.node_groups),
                           its, fits, 8, npi, placement_name=pl)
                    for pl in ("paper", "em-aware")]
        for ref, mine in zip(*(fn(p) for p in PKGS)):
            assert_results_close(ref, mine)

    @pytest.mark.parametrize("cluster_name,mp,dp", [("B0", 8, 128),
                                                    ("B1", 64, 16)])
    def test_fig15_record_equivalent(self, cluster_name, mp, dp):
        """fig15-style transformer cells, multi-instance on one group."""
        def fn(p):
            cl = p.cluster.TABLE_III_CLUSTERS[cluster_name]
            wl = p.workload.decompose(p.get_config("transformer-1t"),
                                      p.Shape("paper", 2048, 1024, "train"),
                                      mp=mp, dp=dp)
            per = p.group_breakdowns(wl.compiled(), cl)
            its = [b.total for b in per]
            fits = [b.feasible for b in per]
            return [_check(p, (cl.num_nodes,), its, fits, instances, npi)
                    for instances, npi in ((1, cl.num_nodes), (4, 256),
                                           (9, 512))]
        for ref, mine in zip(*(fn(p) for p in PKGS)):
            assert_results_close(ref, mine)

    def test_multi_iteration_scales_linearly(self):
        res = sim_both(lambda p: p.sim((8,), model=p.model("static")).run(
            [p.job(width=8, iters=7, it=0.31)]))
        assert res.makespan == 7 * 0.31      # one multiply, no drift


# ===================================================================== #
# Timeline behavior: waiting, preemption, elastic resize, burst
# ===================================================================== #

class TestTimeline:
    def test_infeasible_on_free_waits_for_fitting_group(self):
        """A job whose only fitting group is busy queues for it instead
        of squatting infeasibly on a non-fitting one."""
        def fn(p):
            blocker = p.fjob(p.spec("blk", nodes_per_instance=8,
                                    iterations=3),
                             p.prof({8: (1.0, 1.0)}), uid=0)
            picky = p.fjob(p.spec("picky", nodes_per_instance=8,
                                  iterations=1, arrival=0.5),
                           p.prof({8: (0.1, 2.0)}, fits={8: (False, True)}),
                           uid=1)
            return p.sim((8, 8), model=p.model("static")).run(
                [blocker, picky])
        res = sim_both(fn)
        out = next(o for o in res.outcomes if o.name == "picky")
        assert out.feasible and res.feasible

    def test_never_feasible_job_adopts_legacy_fallback(self):
        res = sim_both(lambda p: p.sim((8,), model=p.model("static")).run(
            [p.job(width=16, caps_groups=1)]))   # wider than the fleet
        assert res.jobs_completed == 1 and not res.feasible

    def test_unplannable_job_fails_cleanly(self):
        """A job whose profile does not match the fleet's group count
        can never be planned: it fails, the rest of the trace runs."""
        def fn(p):
            job = p.fjob(p.spec("j", nodes_per_instance=8, iterations=1),
                         p.prof({8: (1.0, 1.0)}))   # 2 groups
            ok = p.job(uid=1, width=8, iters=2, it=0.5, caps_groups=1)
            return p.sim((8,), model=p.model("static")).run([job, ok])
        res = sim_both(fn)
        assert not res.feasible
        assert any(e.kind == "fail" for e in res.events)
        assert next(o for o in res.outcomes if o.uid == 1).completed

    def test_profiles_reject_nan_iteration_times(self):
        raises_both(lambda p: p.fleet.WidthProfile(
            iter_times=(float("nan"),), fits=(True,)), match="NaN")

    def test_static_policy_never_preempts_or_resizes(self):
        res = sim_both(lambda p: p.sim((16,), model=p.model("static")).run(
            [p.job(uid=0, width=8, iters=5, it=2.0, caps_groups=1),
             p.job(uid=1, width=8, iters=1, it=1.0, caps_groups=1,
                   priority=9, arrival=3.0, widths=(8, 16))]))
        assert res.preemptions == res.resize_events == 0
        assert res.feasible

    def test_elastic_grow_beats_static_makespan(self):
        def fn(p, policy):
            spec = p.spec("el", nodes_per_instance=8, iterations=100,
                          widths=(8, 32))
            return p.sim((32,), model=p.model(policy)).run(
                [p.fjob(spec, p.prof({8: 4.0, 32: 1.0}))])
        stat = sim_both(lambda p: fn(p, "static"))
        elas = sim_both(lambda p: fn(p, "elastic"))
        assert elas.resize_events == 1
        assert elas.makespan < stat.makespan
        m = fleet.FleetModel(policy="elastic")
        cost = fleet.remesh_delay(8e9, m.checkpoint_bw, m.reshard_bw)
        assert elas.makespan == cost + 100 * 1.0

    def test_grow_skipped_when_remesh_outweighs_gain(self):
        res = sim_both(lambda p: p.sim((32,), model=p.model("elastic")).run(
            [p.fjob(p.spec("el", nodes_per_instance=8, iterations=2,
                           widths=(8, 32)),
                    p.prof({8: 1.0, 32: 0.9}, sb=400e9))]))
        assert res.resize_events == 0
        assert res.makespan == 2 * 1.0

    def test_shrink_frees_nodes_for_higher_priority(self):
        def fn(p):
            low = p.fjob(p.spec("low", nodes_per_instance=32, iterations=40,
                                widths=(8, 32)),
                         p.prof({8: 4.0, 32: 1.0}), uid=0)
            hi = p.fjob(p.spec("hi", nodes_per_instance=16, iterations=4,
                               priority=5, arrival=10.0),
                        p.prof({16: 1.0}), uid=1)
            return p.sim((32,), model=p.model("elastic")).run([low, hi])
        res = sim_both(fn)
        assert any(e.kind == "shrink" for e in res.events)
        lo = next(o for o in res.outcomes if o.name == "low")
        assert lo.resizes >= 1 and lo.preemptions == 0
        assert res.feasible

    def test_burst_borrows_and_returns(self):
        def jobs(p):
            lenders = [p.fjob(p.spec(f"l{i}", nodes_per_instance=16,
                                     iterations=50),
                              p.prof({16: 2.0}), uid=i) for i in (0, 1)]
            burst = p.fjob(
                p.spec("b", nodes_per_instance=8, iterations=20, priority=5,
                       arrival=10.0, widths=(8, 32), burst_iters=16,
                       preemptible=False),
                p.prof({8: 4.0, 32: 0.5}), uid=2)
            return lenders + [burst]
        res = sim_both(lambda p: p.sim(
            (32,), model=p.model("elastic+burst")).run(jobs(p)))
        kinds = [e.kind for e in res.events]
        assert "lend" in kinds and "return" in kinds
        bo = next(o for o in res.outcomes if o.name == "b")
        assert bo.bursts == 1
        stat = sim_both(lambda p: p.sim((32,), model=p.model("static")).run(
            jobs(p)))
        so = next(o for o in stat.outcomes if o.name == "b")
        assert bo.turnaround < so.turnaround
        assert res.feasible and stat.feasible

    def test_result_percentiles_and_util(self):
        res = sim_both(lambda p: p.sim((32,), model=p.model("static")).run(
            [p.job(uid=i, width=8, iters=1, it=float(i + 1), caps_groups=1)
             for i in range(4)]))
        assert res.turnaround_p50 == 2.0
        assert res.turnaround_p99 == 4.0
        assert 0.0 < res.fleet_util <= 1.0
        # 4 jobs x 8 nodes x i seconds of busy time over 32 x makespan
        assert res.fleet_util == pytest.approx(
            8 * (1 + 2 + 3 + 4) / (32 * 4.0))

    def test_model_validation(self):
        raises_both(lambda p: p.model("greedy"))
        raises_both(lambda p: p.model("static", degradation="panic"))
        raises_both(lambda p: p.model("static", ckpt_interval_s=-1.0))
        flags = on_both(lambda p: [
            (m.elastic, m.burst, m.preempt) for m in (
                p.model("static"), p.model("elastic"),
                p.model("elastic+burst"),
                p.model("elastic", preemption=False))])
        assert flags == [(False, False, False), (True, False, True),
                         (True, True, True), (True, False, False)]
        raises_both(lambda p: p.sim((8, 0)))
        raises_both(lambda p: p.sim((8,), pod_sizes=[8, 8]))


# ===================================================================== #
# Hypothesis properties: the same draws through both simulators
# ===================================================================== #

class TestFleetProperties:
    def test_capacity_conserved_at_every_event(self):
        """No event may observe more allocated nodes than a group has,
        and the fleet must be empty again after the last completion; the
        port's timeline is the reference's to the bit on every draw."""
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st
        durs = st.floats(min_value=0.05, max_value=30.0, allow_nan=False)

        @given(caps=st.lists(st.integers(min_value=4, max_value=48),
                             min_size=1, max_size=3),
               jobs=st.lists(st.tuples(st.integers(2, 32),
                                       st.integers(1, 20), durs,
                                       st.integers(0, 3),
                                       st.floats(0.0, 50.0)),
                             min_size=1, max_size=6),
               policy=st.sampled_from(("static", "elastic",
                                       "elastic+burst")))
        @settings(max_examples=60, deadline=None)
        def check(caps, jobs, policy):
            def fn(p):
                flt = []
                for uid, (w, it_n, dur, pr, arr) in enumerate(jobs):
                    widths = (w, min(2 * w, max(caps))) if uid % 2 else ()
                    spec = p.spec(f"j{uid}", nodes_per_instance=w,
                                  iterations=it_n, priority=pr, arrival=arr,
                                  widths=widths,
                                  burst_iters=it_n // 2 if uid % 3 == 0
                                  else 0)
                    times = {x: (dur,) * len(caps) for x in spec.width_menu}
                    flt.append(p.fjob(spec, p.prof(times), uid=uid))
                return p.sim(caps, model=p.model(policy)).run(flt)
            res = sim_both(fn)
            for ev in res.events:
                assert all(0 <= a <= c for a, c in zip(ev.alloc, caps)), ev
            assert res.events[-1].alloc == tuple(0 for _ in caps)
            assert res.jobs_completed == len(jobs)
            assert 0.0 <= res.fleet_util <= 1.0 + 1e-12

        check()

    def test_turnaround_monotone_in_fleet_size(self):
        """Adding nodes to a single-group static fleet never worsens any
        job's turnaround (all jobs same width, batch arrival)."""
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st
        durs = st.floats(min_value=0.05, max_value=30.0, allow_nan=False)

        @given(base=st.integers(min_value=1, max_value=4),
               extra=st.integers(min_value=1, max_value=4),
               durs=st.lists(durs, min_size=1, max_size=6))
        @settings(max_examples=60, deadline=None)
        def check(base, extra, durs):
            w = 8

            def turns(cap):
                res = sim_both(lambda p: p.sim(
                    (cap,), model=p.model("static")).run(
                        [p.job(uid=i, width=w, iters=1, it=d, caps_groups=1)
                         for i, d in enumerate(durs)]))
                return [o.turnaround for o in res.outcomes]

            small = turns(w * base)
            big = turns(w * (base + extra))
            assert all(b <= s + 1e-9 for s, b in zip(small, big))

        check()

    def test_preemption_never_helps_the_victim(self):
        """The victim's own turnaround with preemption enabled is never
        better than when the high-priority job must wait."""
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st
        durs = st.floats(min_value=0.05, max_value=30.0, allow_nan=False)

        @given(low_iters=st.integers(2, 15), low_dur=durs,
               hi_iters=st.integers(1, 20), hi_dur=durs,
               frac=st.floats(0.05, 0.95))
        @settings(max_examples=60, deadline=None)
        def check(low_iters, low_dur, hi_iters, hi_dur, frac):
            arrival = frac * low_iters * low_dur

            def run(preemption):
                def fn(p):
                    low = p.fjob(p.spec("low", nodes_per_instance=8,
                                        iterations=low_iters),
                                 p.prof({8: low_dur}), uid=0)
                    hi = p.fjob(p.spec("hi", nodes_per_instance=8,
                                       iterations=hi_iters, priority=5,
                                       arrival=arrival),
                                p.prof({8: hi_dur}), uid=1)
                    return p.sim((8,), model=p.model(
                        "elastic", preemption=preemption)).run([low, hi])
                res = sim_both(fn)
                return next(o for o in res.outcomes if o.name == "low")

            assert run(True).turnaround >= run(False).turnaround - 1e-9

        check()


# ===================================================================== #
# Study integration, rules, and the headline claim
# ===================================================================== #

class TestFleetStudy:
    def test_run_study_emits_fleet_columns(self):
        res = run_both(lambda p: p.tiny_fleet_spec())
        assert len(res) == 1
        rec = res.records[0]
        for col in fleet.FLEET_COLUMNS:
            assert col in rec, col
        assert rec["feasible"]
        assert rec["jobs_completed"] == 1
        assert rec["total"] == rec["makespan"] > 0
        assert rec["perf_per_dollar"] > 0
        assert rec["n_events"] > 0

    def test_policy_axis_sweeps_fleet_point(self):
        res = run_both(lambda p: p.tiny_fleet_spec(axes=[
            p.study.Axis("policy", ("static", "elastic"),
                         path="fleet.policy")]))
        by = {r["policy"]: r for r in res.records}
        assert set(by) == {"static", "elastic"}
        assert by["static"]["resize_events"] == 0
        assert by["elastic"]["resize_events"] >= 1
        assert by["elastic"]["makespan"] < by["static"]["makespan"]

    def test_ftrace_axis_sweeps_trace(self):
        res = run_both(lambda p: p.tiny_fleet_spec(
            ftrace=p.fleet.FleetTrace(kind="uniform", rate=1 / 500.0,
                                      num_jobs=2),
            axes=[p.study.Axis("njobs", (1, 3), path="ftrace.num_jobs")]))
        done = sorted(r["jobs_completed"] for r in res.records)
        assert done == [1, 3]

    def test_unknown_fleet_axis_path_fails_fast(self):
        for p in PKGS:
            with pytest.raises((AttributeError, ValueError)):
                p.tiny_fleet_spec(axes=[p.study.Axis("x", (1,),
                                                     path="fleet.nope")])

    def test_spec_needs_jobs_and_cluster(self):
        raises_both(lambda p: p.tiny_fleet_spec(jobs=()))
        rec = on_both(lambda p: p.fleet.fleet_record(
            None, p.tiny_fleet_spec(), p.tiny_fleet_spec().point(),
            "paper"))
        assert not rec["feasible"] and rec["total"] == float("inf")
        assert rec["infeasible_reason"] == "fleet study needs a cluster"

    def test_validate_gate_raises_on_fleet_errors(self):
        texts = []
        for p in PKGS:
            bad = p.tiny_fleet_spec(fleet=p.model("elastic",
                                                  checkpoint_bw=0.0))
            with pytest.raises(p.AnalysisError, match="F104") as err:
                p.run(bad, validate="error")
            texts.append(str(err.value))
        assert texts[1] == texts[0]
        assert len(run_both(lambda p: p.tiny_fleet_spec(),
                            validate="error")) == 1


class TestFleetRules:
    def test_clean_default_study(self):
        assert same_diagnostics(lambda p: p.dse.fleet_study()) == []

    def test_f101_job_wider_than_every_group(self):
        diags = same_diagnostics(lambda p: p.tiny_fleet_spec(jobs=(
            p.spec("wide", model="chatglm3-6b", mp=2,
                   nodes_per_instance=64),)))
        assert "F101" in {d.code for d in diags}
        diags = same_diagnostics(lambda p: p.tiny_fleet_spec(jobs=(
            p.spec("c", model="chatglm3-6b", mp=2, nodes_per_instance=16,
                   max_nodes=8),)))
        assert "F101" in {d.code for d in diags}

    def test_f102_bad_trace(self):
        diags = same_diagnostics(lambda p: p.tiny_fleet_spec(
            ftrace=p.fleet.FleetTrace(kind="poisson", rate=-1.0),
            axes=[p.study.Axis("rate", (0.01, 0.0), path="ftrace.rate"),
                  p.study.Axis("n", (0,), path="ftrace.num_jobs")]))
        assert {d.code for d in diags} == {"F102"}
        assert len(diags) == 3

    def test_f103_burst_sanity(self):
        diags = same_diagnostics(lambda p: p.tiny_fleet_spec(jobs=(
            p.spec("b", model="chatglm3-6b", mp=2, nodes_per_instance=8,
                   iterations=4, burst_iters=9, instances=2),)))
        assert [d.code for d in diags] == ["F103"] * 3
        diags = same_diagnostics(lambda p: p.tiny_fleet_spec(jobs=(
            p.spec("o", model="chatglm3-6b", mp=2, nodes_per_instance=8,
                   widths=(9,)),)))
        assert "F103" in {d.code for d in diags}

    def test_f104_bad_costs(self):
        diags = same_diagnostics(lambda p: p.tiny_fleet_spec(
            fleet=p.model("elastic", reshard_bw=float("inf"))))
        assert "F104" in {d.code for d in diags}
        diags = same_diagnostics(lambda p: p.tiny_fleet_spec(
            fleet=p.model("elastic", lend_overhead=-2.0),
            axes=[p.study.Axis("bw", (1e9, 0.0),
                               path="fleet.checkpoint_bw")]))
        assert [d.code for d in diags] == ["F104", "F104"]


class TestHeadlineClaim:
    def test_elastic_burst_beats_static_by_1_3x(self):
        """On the mixed EM/plain fleet the elastic+burst policy wins
        >= 1.3x over the static ScheduleModel allocation on
        turnaround-p99 or perf-per-dollar; the port's ranking is the
        reference's (order, integers equal, floats within 1e-9) and so is
        its headline."""
        ranked = dse.fleet_ranking(device="cpu")
        ref = dse_jax.fleet_ranking()
        assert [r["policy"] for r in ranked] == [r["policy"] for r in ref]
        for a, b in zip(ranked, ref):
            assert list(a) == list(b)
            assert all(close(a[k], v) for k, v in b.items())
        assert {r["policy"] for r in ranked} == {
            "static", "elastic", "elastic+burst"}
        head = dse.fleet_headline(ranked)
        head_ref = dse_jax.fleet_headline(ref)
        assert list(head) == list(head_ref)
        assert all(close(head[k], v) for k, v in head_ref.items())
        assert max(head["turnaround_p99_ratio"],
                   head["perf_per_dollar_ratio"]) >= 1.3
        stat = next(r for r in ranked if r["policy"] == "static")
        eb = next(r for r in ranked if r["policy"] == "elastic+burst")
        assert eb["resize_events"] > 0 and eb["burst_events"] > 0
        assert stat["resize_events"] == stat["burst_events"] == 0
        assert all(math.isfinite(r["turnaround_p99"]) for r in ranked)
        assert all(r["jobs_completed"] == 12 for r in ranked)

    def test_fleet_study_spec_is_analyzable_and_swept(self):
        spec = dse.fleet_study()
        assert analyze_fleet(spec) == []
        study_ = spec.to_study()
        assert study_.fleet is spec
        assert isinstance(study_, fleet.FleetStudy)
        assert [a.name for a in study_.axes] == ["policy"]
        assert [a.path for a in study_.axes] == [None]
        ref = dse_jax.fleet_study()
        assert _plain(tuple(spec.jobs)) == _plain(tuple(ref.jobs))
        assert _plain(spec.ftrace) == _plain(ref.ftrace)
        assert spec.cluster.name == ref.cluster.name


# ===================================================================== #
# The port's own: the device, the memo, the event streams
# ===================================================================== #

def test_event_streams_are_the_references():
    """The default fleet study's three policies replayed from each
    package's profiles: the same events in the same order."""
    def fn(p, policy):
        spec = p.dse.fleet_study()
        cl = spec.cluster
        jobs = [p.fjob(js, p.profiles(js, cl, "em-aware"), uid=uid)
                for uid, js in enumerate(spec.ftrace.materialize(spec.jobs))]
        groups = cl.node_groups
        return p.sim([g.num_nodes for g in groups],
                     model=p.model(policy),
                     placement=p.placement.get_placement("em-aware"),
                     failures=spec.failures,
                     pod_sizes=[min(g.topology.pod_size, g.num_nodes)
                                for g in groups]).run(jobs)
    for policy in fleet.FLEET_POLICIES:
        ref, mine = (fn(p, policy) for p in PKGS)
        assert_results_close(ref, mine)
        assert len(mine.events) > 40


def _spy(monkeypatch):
    """Wrap the fleet's ``group_breakdowns_compiled``: record the device
    each call asked for, and time it on the CPU, so the test needs no
    GPU."""
    calls = []

    def spy(cw, cl, *args, device=None, **kw):
        calls.append(device)
        return group_breakdowns_compiled(cw, cl, *args, device="cpu", **kw)
    monkeypatch.setattr(fleet_spec, "group_breakdowns_compiled", spy)
    return calls


def test_profiles_take_run_studys_device(monkeypatch):
    """Every width profile of a fleet study is timed on the device
    ``run_study`` resolved, never on one the fleet picks itself."""
    calls = _spy(monkeypatch)
    spec = PORT.tiny_fleet_spec(axes=[Axis("policy", ("static", "elastic"),
                                           path="fleet.policy")])
    run_study(spec, device="cuda")
    assert calls and all(d == torch.device("cuda") for d in calls)
    n = len(calls)
    assert n == 3                   # one job, three widths, memoized
    calls.clear()
    res = run_study(spec, device="cpu")
    assert calls == [torch.device("cpu")] * n
    assert res.records == run_study(spec, device="cpu").records


def test_profile_memo_keys_on_the_device(monkeypatch):
    """One lowered FleetStudy run on two devices: the second device's
    profiles are timed anew, a rerun on the first reuses its own."""
    calls = _spy(monkeypatch)
    lowered = dse.fleet_study().to_study()
    run_study(lowered, device="cuda")
    on_card = len(calls)
    assert on_card > 0 and set(calls) == {torch.device("cuda")}
    run_study(lowered, device="cpu")
    assert len(calls) == 2 * on_card
    assert set(calls[on_card:]) == {torch.device("cpu")}
    run_study(lowered, device="cpu")
    run_study(lowered, device="cuda")
    assert len(calls) == 2 * on_card


def test_study_context_carries_the_device():
    """Every cell's context holds run_study's device: an evaluate study
    and a simulated one."""
    seen = []

    def evaluate(ctx):
        seen.append(ctx.device)
        return {"total": 1.0, "feasible": True}
    run_study(StudySpec(name="dev", evaluate=evaluate,
                        axes=[Axis("k", (1, 2), apply=lambda c, v: c)]),
              device="cpu", validate="off")
    spec = PORT.tiny_fleet_spec()
    lowered = dataclasses.replace(
        spec.to_study(), metrics={"dev": lambda ctx: str(ctx.device)})
    rec = run_study(lowered, device="cpu").records[0]
    assert seen == [torch.device("cpu")] * 2
    assert rec["dev"] == "cpu"


def test_fleet_runs_on_the_card_unless_asked():
    """No GPU and no device: the fleet study raises as run_study does;
    a process pool is refused as elsewhere."""
    with pytest.raises(NotImplementedError, match="item 22"):
        dse.fleet_ranking(processes=2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 22"):
        dse.reliability_fleet_ranking(processes=2, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_study(dse.fleet_study())
    with pytest.raises(RuntimeError, match="CUDA"):
        dse.fleet_ranking()
