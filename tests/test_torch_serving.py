"""The port's serving DSE (``repro_torch.serving``, ``core/roofline.py``, the
V1xx rules, ``dse.serving_study``) against the JAX package's.

Mirrors ``tests/test_serving.py`` case for case on the port, and holds every
output to the reference's on the same inputs. All of it is numpy and Python
on both sides, so every value must be *equal*, not close: KV bytes, slots
that fit, roofline points, decode curves, the arrivals of every trace kind,
the fleet queue's metrics, phase plans, KV transfer times, study records
(key for key, in order) and diagnostics (code, severity, location,
message). The engine-shaped schedule is locked against the port's own
``Engine`` on the CPU (the card's lock, at full width, is ``chip_smoke.py``'s
``serve`` phase: the reduced config's head_dim 16 has no decode kernel).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis import analyze_serving as analyze_serving_jax
from repro.configs import get_config as get_config_jax
from repro.core import cluster as cluster_jax
from repro.core import dse as dse_jax
from repro.core import roofline as roofline_jax
from repro.core import study as study_jax
from repro.core.gemm import PhaseCost as PhaseCostJax
import repro.serving as serving_jax
from repro_torch.analysis import AnalysisError, analyze_serving
from repro_torch.configs import get_config
from repro_torch.core import cluster, dse, roofline, study
from repro_torch.core.gemm import PhaseCost
from repro_torch.core.study import Axis, run_study
from repro_torch.models import get_model
from repro_torch.serve import Engine, EngineConfig, Request
import repro_torch.serving as serving
from repro_torch.serving import (
    COLOCATED,
    DISAGGREGATED,
    DisaggregatedPlacement,
    ReplicaProfile,
    SERVING_COLUMNS,
    SLOSpec,
    ServingModel,
    ServingSpec,
    ServingWorkload,
    TrafficTrace,
    kv_transfer_time,
    simulate_colocated,
    simulate_disaggregated,
)

ARCH = "internlm2-20b"
CFG = get_config(ARCH)
PLAIN = cluster.TABLE_III_CLUSTERS["B0"].node
EM = cluster.TABLE_III_CLUSTERS["B1"].node
WL_DEFAULTS = dict(max_batch=32, max_seq=8192, prompt_len=1024,
                   max_new_tokens=64)


class Pkg:
    """One package's serving surface: index 0 is the reference, 1 the
    port, so a test builds the same object in both."""

    def __init__(self, i):
        self.serving = (serving_jax, serving)[i]
        self.cluster = (cluster_jax, cluster)[i]
        self.dse = (dse_jax, dse)[i]
        self.study = (study_jax, study)[i]
        self.roofline = (roofline_jax, roofline)[i]
        self.PhaseCost = (PhaseCostJax, PhaseCost)[i]
        self.analyze_serving = (analyze_serving_jax, analyze_serving)[i]
        self.cfg = (get_config_jax, get_config)[i](ARCH)
        self.plain = self.cluster.TABLE_III_CLUSTERS["B0"].node
        self.em = self.cluster.TABLE_III_CLUSTERS["B1"].node

    def wl(self, **kw):
        s = self.serving
        return s.ServingWorkload(self.cfg, s.ServingModel(
            **{**WL_DEFAULTS, **kw}))

    def run(self, spec):
        if self.study is study:
            return run_study(spec, device="cpu")
        return study_jax.run_study(spec, processes=1)

    def small_spec(self, **kw):
        s = self.serving
        defaults = dict(
            name="t-serving", model=self.cfg,
            cluster=self.dse.mixed_dlrm_fleet(),
            serving=s.ServingModel(**WL_DEFAULTS),
            trace=s.TrafficTrace(rate=40.0, num_requests=80),
            slo=s.SLOSpec(ttft=2.0, tpot=0.1))
        defaults.update(kw)
        return s.ServingSpec(**defaults)


REF, PORT = Pkg(0), Pkg(1)
PKGS = (REF, PORT)


def on_both(fn):
    """``fn(pkg)`` in each package: the outputs must be equal (dataclasses
    field for field); returns the port's."""
    ref, mine = (fn(p) for p in PKGS)
    assert _plain(mine) == _plain(ref)
    return mine


def _plain(obj):
    """Dataclasses as tuples of their fields (the two packages' classes
    differ), everything else as is."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple(_plain(v) for v in dataclasses.astuple(obj)))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def same_records(ref, mine):
    """Records equal key for key, in the same order, value for value (the
    serving evaluator is host code on both sides); inf and nan by text."""
    assert len(ref) == len(mine)
    for ra, rb in zip(ref.records, mine.records):
        assert list(ra) == list(rb)
        for k, va in ra.items():
            vb = rb[k]
            assert type(va) is type(vb), k
            if isinstance(va, float) and va != va:
                assert vb != vb, k
            else:
                assert va == vb, f"{k}: {va!r} vs {vb!r}"


def same_diagnostics(fn):
    ref, mine = (p.analyze_serving(fn(p)) for p in PKGS)
    assert [d.to_dict() for d in mine] == [d.to_dict() for d in ref]
    return mine


def _wl(**kw):
    return ServingWorkload(CFG, ServingModel(**{**WL_DEFAULTS, **kw}))


# --------------------------------------------------------------------- #
# Roofline
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("flops,traffic", [(0, 0), (0, 4096),
                                           (10 ** 12, 10 ** 9),
                                           (10 ** 9, 10 ** 9)])
@pytest.mark.parametrize("node", ["B0", "B1", "C2"])
def test_roofline_matches_reference(flops, traffic, node):
    def fn(p):
        n = p.cluster.TABLE_III_CLUSTERS[node].node
        cost = p.PhaseCost(flops, traffic)
        return (p.roofline.compute_delay(cost, n),
                p.roofline.compute_delay(cost, n, mem_bw=n.local_bw / 3),
                p.roofline.ridge_point(n),
                p.roofline.ridge_point(n, mem_bw=1e11),
                p.roofline.attainable_perf(float("inf"), n.peak_flops, 1e9),
                p.roofline.attainable_perf(7.5, n.peak_flops, n.local_bw))
    pt = on_both(fn)[0]
    assert pt.bound in ("compute", "memory")


# --------------------------------------------------------------------- #
# Workload: KV footprint + rooflines
# --------------------------------------------------------------------- #

def test_kv_bytes_formula():
    wl = _wl()
    want = (2 * CFG.num_layers * CFG.num_kv_heads * CFG.resolved_head_dim
            * 2)  # k and v, every layer, bf16
    assert wl.kv_bytes_per_token == want
    assert wl.kv_slot_bytes == want * 8192
    assert wl.kv_bytes_for(100) == want * 100
    assert _wl(kv_bytes=123.0).kv_bytes_per_token == 123.0
    on_both(lambda p: [(w.kv_bytes_per_token, w.kv_slot_bytes,
                        w.kv_bytes_for(100), w.weight_bytes,
                        w.replica_bytes(), w.replica_bytes(3),
                        w.decode_steps, w.mean_context)
                       for w in (p.wl(), p.wl(kv_bytes=123.0),
                                 p.wl(nodes_per_replica=4))])


def test_serving_model_rejects_overflow():
    with pytest.raises(ValueError, match="max_seq"):
        ServingModel(max_seq=512, prompt_len=500, max_new_tokens=64)
    with pytest.raises(ValueError, match="max_batch"):
        ServingModel(max_batch=0)
    with pytest.raises(ValueError, match="nodes_per_replica"):
        ServingModel(nodes_per_replica=0)


def test_prefill_compute_bound_decode_memory_bound():
    wl = _wl()
    pre = wl.prefill_point(PLAIN)
    assert pre.bound == "compute"
    dec = wl.decode_point(PLAIN, batch=wl.slots_that_fit(PLAIN))
    assert dec.bound == "memory"
    assert pre.oi > dec.oi
    assert pre.delay > 2 * dec.delay
    on_both(lambda p: [
        p.wl().prefill_point(p.plain), p.wl().prefill_point(p.em, 333),
        p.wl().decode_point(p.plain, p.wl().slots_that_fit(p.plain)),
        p.wl().decode_point(p.em, 7, context=2000),
        p.wl(nodes_per_replica=2).decode_point(p.plain, 5, mem_bw=1e12)])


def test_slots_that_fit_em_pool():
    wl = _wl()
    plain, em = wl.slots_that_fit(PLAIN), wl.slots_that_fit(EM)
    assert 0 < plain < wl.serving.max_batch
    assert em == wl.serving.max_batch
    want = int((PLAIN.total_cap - wl.weight_bytes) // wl.kv_slot_bytes)
    assert plain == want
    rep = wl.replica_report(EM)
    assert rep.fits_total and not rep.fits_local
    on_both(lambda p: [(p.wl().slots_that_fit(n), p.wl().fits(n),
                        p.wl().replica_report(n), p.wl().replica_report(n, 2))
                       for n in (p.plain, p.em)])


def test_em_decode_slower_per_tick():
    wl = _wl()
    t_plain = wl.decode_time(PLAIN, wl.slots_that_fit(PLAIN))
    t_em = wl.decode_time(EM, wl.slots_that_fit(EM))
    assert t_em > t_plain


@pytest.mark.parametrize("node", ["B0", "B1", "C0"])
def test_decode_curve_monotone(node):
    curve = _wl().decode_curve(cluster.TABLE_III_CLUSTERS[node].node,
                               max_batch=8)
    assert len(curve) == 8
    assert all(b >= a for a, b in zip(curve, curve[1:]))
    on_both(lambda p: (
        p.wl().decode_curve(p.cluster.TABLE_III_CLUSTERS[node].node),
        p.wl().prefill_time(p.cluster.TABLE_III_CLUSTERS[node].node)))


# --------------------------------------------------------------------- #
# Traffic traces
# --------------------------------------------------------------------- #

def test_trace_deterministic_and_replaceable():
    tr = TrafficTrace(kind="poisson", rate=10.0, num_requests=50, seed=3)
    assert tr.arrivals == TrafficTrace(kind="poisson", rate=10.0,
                                       num_requests=50, seed=3).arrivals
    assert len(tr.arrivals) == 50 and tr.arrivals[0] == 0.0
    faster = dataclasses.replace(tr, rate=100.0)
    assert faster.duration < tr.duration


def test_trace_kinds():
    uni = TrafficTrace(kind="uniform", rate=4.0, num_requests=9)
    assert uni.arrivals == tuple(i * 0.25 for i in range(9))
    bur = TrafficTrace(kind="bursty", rate=20.0, num_requests=400, seed=1)
    mean_rate = (bur.num_requests - 1) / bur.duration
    assert 0.5 * 20.0 < mean_rate < 2.0 * 20.0
    with pytest.raises(ValueError, match="kind"):
        TrafficTrace(kind="fractal")
    with pytest.raises(ValueError, match="rate"):
        TrafficTrace(rate=-1.0).arrivals


@pytest.mark.parametrize("kind", ["poisson", "uniform", "bursty"])
@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_arrivals_are_the_references(kind, seed):
    """Every kind's arrivals are the reference's to the bit (numpy's
    ``default_rng(seed)`` on both sides)."""
    arr = on_both(lambda p: p.serving.TrafficTrace(
        kind=kind, rate=37.5, num_requests=257, seed=seed,
        burst_factor=3.0, burst_frac=0.3).arrivals)
    assert len(arr) == 257 and arr == tuple(sorted(arr))


# --------------------------------------------------------------------- #
# Engine-shaped schedule + the lock against the port's engine
# --------------------------------------------------------------------- #

def test_engine_schedule_conservation():
    wl = _wl(max_new_tokens=16)
    tr = wl.engine_schedule(10, max_batch=4)
    assert tr.prefills == 10
    assert sum(tr.admitted) == 10
    assert sum(tr.occupancy) == 10 * wl.decode_steps
    assert max(tr.occupancy) <= 4
    t = wl.schedule_time(tr, PLAIN)
    assert t > tr.prefills * wl.prefill_time(PLAIN)
    on_both(lambda p: [
        (s, s.ticks, p.wl(max_new_tokens=16).schedule_time(s, p.plain))
        for s in (p.wl(max_new_tokens=16).engine_schedule(10, max_batch=4),
                  p.wl().engine_schedule(
                      7, new_tokens=[1, 2, 5, 64, 3, 9, 2]),
                  p.wl(max_batch=8).engine_schedule(16,
                                                    new_tokens=[32] * 16))])


def _spied_engine(engine):
    """Record, for each tick, the requests ``_admit`` admitted and the
    active slots at each ``decode_step``."""
    admitted, occupancy = [], []
    admit, decode = engine._admit, engine.model.decode_step

    def admit_spy():
        q0 = len(engine.queue)
        admit()
        admitted.append(q0 - len(engine.queue))

    def decode_spy(cache, tokens):
        occupancy.append(len(engine.active))
        return decode(cache, tokens)

    engine._admit = admit_spy
    engine.model.decode_step = decode_spy
    return admitted, occupancy


@pytest.mark.parametrize("n_req,n_new,slots",
                         [(5, 5, 2), (6, [1, 4, 2, 6, 3, 2], 3)])
def test_engine_schedule_matches_port_engine(n_req, n_new, slots):
    """The analytic TickTrace reproduces the port's continuous-batching
    engine tick for tick on the CPU (no request stops early: ``eos_id``
    -1), and the roofline-priced schedule time is the fleet queue's
    makespan for the same backlog."""
    cfg = get_config("smollm-135m", reduced=True)
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    eng = Engine(cfg, model, EngineConfig(max_batch=slots, max_seq=64),
                 dtype=torch.float32, device="cpu")
    budgets = n_new if isinstance(n_new, list) else [n_new] * n_req
    for i in range(n_req):
        eng.submit(Request(uid=i, prompt=np.array([1 + i, 2, 3]),
                           max_new_tokens=budgets[i]))
    admitted, occupancy = _spied_engine(eng)
    done = eng.run_until_drained()
    assert len(done) == n_req
    assert [len(r.out_tokens) for r in sorted(done, key=lambda r: r.uid)] \
        == [max(2, b) for b in budgets]          # R7: one new token yields two

    sv = ServingModel(max_batch=slots, max_seq=64, prompt_len=3,
                      max_new_tokens=max(budgets))
    wl = ServingWorkload(cfg, sv)
    trace = wl.engine_schedule(n_req, new_tokens=budgets)
    assert trace.occupancy == tuple(occupancy)
    assert trace.admitted == tuple(admitted)
    assert trace.prefills == n_req

    if isinstance(n_new, list):
        return
    # timing: the fleet queue on one replica with the whole backlog at
    # t=0 replays the same schedule, so its makespan is schedule_time
    tr = TrafficTrace(num_requests=n_req)
    tr.__dict__["arrivals"] = (0.0,) * n_req   # backlog, like the engine
    prof = ReplicaProfile(wl.prefill_time(PLAIN),
                          wl.decode_curve(PLAIN), sv.max_batch)
    m = simulate_colocated([prof], wl.decode_steps, tr,
                           SLOSpec(ttft=1e9, tpot=1e9))
    want = wl.schedule_time(trace, PLAIN)
    makespan = m.completed / m.throughput
    assert makespan == pytest.approx(want, rel=1e-9)


# --------------------------------------------------------------------- #
# Fleet queue
# --------------------------------------------------------------------- #

def test_fleet_queue_drains_and_scales():
    wl = _wl()
    prof = ReplicaProfile(wl.prefill_time(PLAIN),
                          wl.decode_curve(PLAIN, 24), 24)
    tr = TrafficTrace(rate=30.0, num_requests=120, seed=0)
    slo = SLOSpec(ttft=5.0, tpot=1.0)
    one = simulate_colocated([dataclasses.replace(prof, count=4)],
                             wl.decode_steps, tr, slo)
    assert one.completed == 120 and one.slo_met == 120
    eight = simulate_colocated([dataclasses.replace(prof, count=8)],
                               wl.decode_steps, tr, slo)
    assert eight.ttft_p99 <= one.ttft_p99 + 1e-12

    def fn(p):
        s, w = p.serving, p.wl()
        prof = s.ReplicaProfile(w.prefill_time(p.plain),
                                w.decode_curve(p.plain, 24), 24)
        tr = s.TrafficTrace(rate=30.0, num_requests=120, seed=0)
        slo = s.SLOSpec(ttft=5.0, tpot=1.0)
        return [s.simulate_colocated([dataclasses.replace(prof, count=c)],
                                     w.decode_steps, tr, slo)
                for c in (1, 4, 8)]
    on_both(fn)


@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_disaggregated_decode_never_stalls(kind):
    """Under load, colocated admissions inflate TPOT past the pure decode
    cadence; disaggregated decode replicas stay at tick speed."""
    wl = _wl()
    pt = wl.prefill_time(PLAIN)
    curve = wl.decode_curve(PLAIN, 24)
    tr = TrafficTrace(kind=kind, rate=60.0, num_requests=400, seed=0)
    slo = SLOSpec(ttft=5.0, tpot=1.0)
    col = simulate_colocated([ReplicaProfile(pt, curve, 24, count=8)],
                             wl.decode_steps, tr, slo)
    dis = simulate_disaggregated(
        [ReplicaProfile(pt, (0.0,), 1, count=4)],
        [ReplicaProfile(0.0, curve, 24, count=4)],
        wl.decode_steps, tr, slo, kv_delay=0.005)
    assert dis.tpot < col.tpot
    assert dis.tpot <= max(curve) + 1e-9

    def fn(p):
        s, w = p.serving, p.wl()
        pt, curve = w.prefill_time(p.plain), w.decode_curve(p.plain, 24)
        tr = s.TrafficTrace(kind=kind, rate=60.0, num_requests=400, seed=0)
        slo = s.SLOSpec(ttft=5.0, tpot=1.0)
        return (s.simulate_colocated(
                    [s.ReplicaProfile(pt, curve, 24, count=8)],
                    w.decode_steps, tr, slo),
                s.simulate_disaggregated(
                    [s.ReplicaProfile(pt, (0.0,), 1, count=4)],
                    [s.ReplicaProfile(0.0, curve, 24, count=4)],
                    w.decode_steps, tr, slo, kv_delay=0.005))
    on_both(fn)


def test_kv_transfer_priced_on_outer_hop():
    fleet = dse.mixed_dlrm_fleet()
    hop = fleet.topology.hops[-1]
    size = 1e9
    assert kv_transfer_time(size, fleet.topology) == \
        pytest.approx(size / hop.bw + hop.latency)
    on_both(lambda p: [p.serving.kv_transfer_time(
        s, p.dse.mixed_dlrm_fleet().topology) for s in (0.0, 1e9, 3.3e7)])


# --------------------------------------------------------------------- #
# Placements
# --------------------------------------------------------------------- #

def test_phase_plans():
    fleet = dse.mixed_dlrm_fleet()          # [plain pods, EM pods]
    groups = fleet.node_groups
    col = COLOCATED.phase_plan(groups)
    assert not col.disaggregated
    assert col.prefill == col.decode == (0, 1)
    auto = DISAGGREGATED.phase_plan(groups)
    assert auto.disaggregated
    assert auto.decode == (1,) and auto.prefill == (0,)
    pinned = DisaggregatedPlacement(decode_groups=(0,)).phase_plan(groups)
    assert pinned.decode == (0,) and pinned.prefill == (1,)
    with pytest.raises(ValueError, match="out of range"):
        DisaggregatedPlacement(decode_groups=(7,)).phase_plan(groups)
    with pytest.raises(ValueError, match="prefill_frac"):
        DisaggregatedPlacement(prefill_frac=1.5)
    assert DISAGGREGATED.label == "disaggregated"
    assert DisaggregatedPlacement(decode_groups=(1,)).label == \
        "disaggregated[1]"
    assert serving.list_serving_placements() == ("colocated",
                                                 "disaggregated")
    with pytest.raises(KeyError, match="unknown serving placement"):
        serving.get_serving_placement("paper")

    def fn(p):
        s = p.serving
        out = []
        for fleet in (p.dse.mixed_dlrm_fleet(),
                      p.cluster.TABLE_III_CLUSTERS["B1"],
                      p.dse._serving_pod_mix()(None, 0.75)):
            g = fleet.node_groups
            for pl in (s.COLOCATED, s.DISAGGREGATED,
                       s.DisaggregatedPlacement(decode_groups=(0,))):
                plan = pl.phase_plan(g)
                out.append((pl.label, plan, plan.disaggregated,
                            pl.instance_groups([True] * len(g))))
        return out
    on_both(fn)


# --------------------------------------------------------------------- #
# Study wiring
# --------------------------------------------------------------------- #

def test_serving_spec_through_run_study():
    def spec(p):
        return p.small_spec(
            axes=[p.study.Axis("rate", (20.0, 60.0), path="trace.rate"),
                  p.serving.serving_placement_axis()])
    ref, res = (p.run(spec(p)) for p in PKGS)
    same_records(ref, res)
    assert len(res) == 4
    for cell in res:
        r = cell.record
        for col in SERVING_COLUMNS:
            assert col in r, col
        assert r["feasible"]
        assert r["placement"] in ("colocated", "disaggregated")
        assert r["tco"] > 0
        assert r["goodput_per_dollar"] == \
            pytest.approx(r["goodput"] / r["tco"])
    by = {(c.record["rate"], c.record["placement"]): c.record for c in res}
    assert by[(60.0, "colocated")]["goodput"] > \
        by[(20.0, "colocated")]["goodput"]


def test_serving_knob_axes():
    """`serving.*` dotted paths sweep the workload itself."""
    def spec(p):
        return p.small_spec(
            trace=p.serving.TrafficTrace(rate=30.0, num_requests=60),
            axes=[p.study.Axis("max_batch", (4, 32),
                               path="serving.max_batch"),
                  p.study.Axis("kvb", (196608.0,),
                               path="serving.kv_bytes")])
    ref, res = (p.run(spec(p)) for p in PKGS)
    same_records(ref, res)
    by = {c.record["max_batch"]: c.record for c in res}
    assert len(by) == 2
    assert by[4]["ttft_p99"] >= by[32]["ttft_p99"]
    s = spec(PORT)
    s.axes = [Axis("nope", (1,), path="serving.not_a_field")]
    with pytest.raises(AttributeError):
        s.__post_init__()


def test_infeasible_cells_match_reference():
    """Cells that cannot serve (a model too large for every pod, a
    homogeneous cluster split too thin) give the reference's infeasible
    records."""
    def spec(p):
        return p.small_spec(
            model=(get_config_jax, get_config)[PKGS.index(p)](
                "transformer-1t"),
            axes=[p.serving.serving_placement_axis()])
    ref, res = (p.run(spec(p)) for p in PKGS)
    same_records(ref, res)
    assert not any(r["feasible"] for r in res.records)

    def homogeneous(p):
        return p.small_spec(
            cluster=p.cluster.TABLE_III_CLUSTERS["B1"],
            axes=[p.serving.serving_placement_axis(
                ("colocated", "disaggregated",
                 p.serving.DisaggregatedPlacement(prefill_frac=0.25)))])
    ref, res = (p.run(homogeneous(p)) for p in PKGS)
    same_records(ref, res)


def test_serving_spec_requires_to_study_type():
    with pytest.raises(TypeError):
        run_study(object(), device="cpu")


def test_lowered_study_still_needs_a_device():
    """An evaluate-only study touches no tensor, but run_study resolves
    ``device`` as for any study: with no GPU and no ``device`` it
    raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_study(PORT.small_spec())


@pytest.fixture(scope="module")
def serving_records():
    """dse.serving_study() at its defaults (18 cells, 3,000 requests each)
    through each package's runner."""
    return (study_jax.run_study(dse_jax.serving_study(), validate="off"),
            run_study(dse.serving_study(), device="cpu"))


def test_serving_study_records_equal_reference(serving_records):
    ref, mine = serving_records
    assert len(mine) == 18
    same_records(ref, mine)
    assert isinstance(dse.serving_study(), ServingSpec)
    assert isinstance(dse.serving_study().to_study(), serving.ServingStudy)


def test_serving_ranking_headline(serving_records):
    """On the mixed plain/EM fleet there is a rate regime where
    disaggregated prefill/decode placement beats the best colocated
    configuration on goodput-per-dollar; the port's ranking is the
    reference's."""
    recs = dse.serving_ranking(device="cpu")
    assert recs == dse_jax.serving_ranking(processes=1)
    assert recs == sorted(
        [r for r in serving_records[1].records if r["feasible"]],
        key=lambda r: r["goodput_per_dollar"], reverse=True)
    assert recs and all(r["feasible"] for r in recs)
    rates = sorted({r["rate"] for r in recs})

    def best(placement, rate, frac=None):
        pool = [r["goodput_per_dollar"] for r in recs
                if r["placement"] == placement and r["rate"] == rate
                and (frac is None or r["em_pod_frac"] == frac)]
        return max(pool) if pool else 0.0

    assert any(best("disaggregated", rt) > best("colocated", rt)
               for rt in rates)
    assert any(best("disaggregated", rt, 0.5) > best("colocated", rt, 0.5)
               for rt in rates)
    top = max(rates)
    assert best("disaggregated", top, 0.5) > 1.2 * best("colocated", top, 0.5)


# --------------------------------------------------------------------- #
# V1xx analysis rules
# --------------------------------------------------------------------- #

def test_v101_kv_never_fits():
    diags = same_diagnostics(lambda p: p.small_spec(
        model=(get_config_jax, get_config)[PKGS.index(p)]("transformer-1t")))
    assert "V101" in [d.code for d in diags]


def test_v102_v103_slo_and_trace():
    diags = same_diagnostics(lambda p: p.small_spec(
        slo=p.serving.SLOSpec(ttft=0.0, tpot=0.1)))
    assert [d.code for d in diags] == ["V102"]
    diags = same_diagnostics(lambda p: p.small_spec(
        axes=[p.study.Axis("rate", (8.0, -1.0), path="trace.rate")]))
    assert [d.code for d in diags] == ["V103"]

    def empty(p):
        spec = p.small_spec()
        object.__setattr__(spec.trace, "num_requests", 0)
        return spec
    diags = same_diagnostics(empty)
    assert [d.code for d in diags] == ["V103"]


def test_v104_decode_groups():
    diags = same_diagnostics(lambda p: p.small_spec(
        placement=p.serving.DisaggregatedPlacement(decode_groups=())))
    assert [d.code for d in diags] == ["V104"]
    diags = same_diagnostics(lambda p: p.small_spec(
        axes=[p.serving.serving_placement_axis(
            ("colocated",
             p.serving.DisaggregatedPlacement(decode_groups=(9,))))]))
    assert [d.code for d in diags] == ["V104"]
    assert same_diagnostics(
        lambda p: p.small_spec(placement=p.serving.DISAGGREGATED)) == []
    assert same_diagnostics(lambda p: p.dse.serving_study()) == []


def test_validate_gate_raises_on_serving_errors():
    spec = PORT.small_spec(slo=SLOSpec(ttft=2.0, tpot=-1.0))
    with pytest.raises(AnalysisError, match="V102"):
        run_study(spec, validate="error", processes=1, device="cpu")
    ok = PORT.small_spec(trace=TrafficTrace(rate=50.0, num_requests=40))
    cells = list(run_study(ok, validate="error", processes=1, device="cpu"))
    assert len(cells) == 1 and cells[0].record["feasible"]
    ref = REF.small_spec(trace=serving_jax.TrafficTrace(rate=50.0,
                                                        num_requests=40))
    same_records(study_jax.run_study(ref, validate="error", processes=1),
                 run_study(ok, validate="error", device="cpu"))
