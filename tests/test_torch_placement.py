"""The port's placement layer, composable clusters and the simulator's
placement paths against the JAX package's.

``repro_torch.core.placement`` and ``repro_torch.core.cluster`` are copies
of the reference's jax-free modules; ``repro_torch.core.simulator`` times
mixed fleets and placement-assigned pipelines on the port's engine. Each
test gives both packages the same inputs (the port's built through
``repro_torch.convert``) and compares the outputs: the registry, stage
assignment, every ``ScheduleModel`` case of ``tests/test_placement.py``,
every registered cluster field for field, and breakdowns within 1e-9
relative of the reference's ``simulate_iteration`` / ``group_breakdowns``
(the event loop). The simulator runs with ``device="cpu"``.
"""

import dataclasses

import pytest

from repro.configs import get_config as get_config_jax
from repro.configs.base import ShapeConfig as ShapeConfigJax
from repro.core import cluster as cluster_jax
from repro.core import dse as dse_jax
from repro.core import placement as placement_jax
from repro.core.collectives import CollectiveModel as CollectiveModelJax
from repro.core.simulator import group_breakdowns as group_breakdowns_jax
from repro.core.simulator import simulate_iteration as simulate_iteration_jax
from repro.core.workload import decompose as decompose_jax
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.convert import from_jax_cluster, from_jax_placement
from repro_torch.core import cluster, placement
from repro_torch.core.collectives import CollectiveModel
from repro_torch.core.simulator import (
    compiled_stage_assignment,
    group_breakdowns_compiled,
    simulate_iteration_compiled,
)
from repro_torch.core.workload import decompose
from test_jax_engine import assert_breakdowns_equivalent

GB = 1e9
PAPER_SHAPE = ("paper", 2048, 1024, "train")
SMALL_SHAPE = ("small", 512, 64, "train")


def _pair(arch, shape, **kw):
    """The reference's workload and the port's lowered one, decomposed
    alike."""
    ref = decompose_jax(get_config_jax(arch), ShapeConfigJax(*shape), **kw)
    mine = decompose(get_config(arch), ShapeConfig(*shape), **kw)
    return ref, mine.compiled()


def _half_em_mix():
    ref = dse_jax._em_pod_mix("B0", "B1")(None, 0.5)
    return ref, from_jax_cluster(ref)


def assert_footprints_equal(a, b) -> None:
    assert dataclasses.asdict(a.footprint) == dataclasses.asdict(b.footprint)


# ===================================================================== #
# Placements: registry, labels, value hashing
# ===================================================================== #

def test_registry_matches_reference():
    assert placement.list_placements() == placement_jax.list_placements()
    for name in placement.list_placements():
        mine = placement.get_placement(name)
        ref = placement_jax.get_placement(name)
        assert type(mine).__name__ == type(ref).__name__
        assert mine.label == ref.label
        assert isinstance(mine, placement.Placement)
    assert placement.get_placement(None) is None
    aware = placement.EMAwarePlacement()
    assert placement.get_placement(aware) is aware
    with pytest.raises(KeyError, match="unknown placement"):
        placement.get_placement("nope")
    with pytest.raises(TypeError):
        placement.get_placement(42)


def test_placements_hash_by_value_and_label_as_reference():
    """The study runner keys its caches on placements: equal placements
    must be equal dict keys."""
    for ref in (placement_jax.PaperPlacement(),
                placement_jax.EMAwarePlacement(),
                placement_jax.ExplicitPlacement((1, 0, 1)),
                placement_jax.ExplicitPlacement()):
        mine = from_jax_placement(ref)
        again = from_jax_placement(ref)
        assert mine == again and hash(mine) == hash(again)
        assert len({mine: 1, again: 2}) == 1
        assert mine.label == ref.label
    assert from_jax_placement(None) is None


def test_hop_resolution_is_the_paper_order():
    """Every placement resolves hops through the topology's paper order."""
    from repro_torch.core.topology import _PAPER_ORDER
    for pl in (placement.PaperPlacement(), placement.EMAwarePlacement(),
               placement.ExplicitPlacement((0, 1))):
        for scope in ("mp", "dp", "ep", "pp", "edp"):
            assert pl.group_placement(scope, 4, 8, 8, 2, 2) == \
                _PAPER_ORDER.group_placement(scope, 4, 8, 8, 2, 2)
        assert pl.p2p_crosses_pod(4, 8, 8, 2, 1) == \
            _PAPER_ORDER.p2p_crosses_pod(4, 8, 8, 2, 1)


# ===================================================================== #
# Stage assignment
# ===================================================================== #

def _groups(*caps_nodes):
    """[(total_cap_gb, num_nodes), ...] -> (reference groups, port
    groups)."""
    ref, mine = [], []
    for i, (cap, n) in enumerate(caps_nodes):
        args = (f"n{i}", 1e12, cap * GB, 1e12, 1e6)
        ref.append(cluster_jax.NodeGroup(
            cluster_jax.NodeConfig(*args), n,
            cluster_jax.BASELINE_DGX_A100.topology))
        mine.append(cluster.NodeGroup(cluster.NodeConfig(*args), n,
                                      cluster.BASELINE_DGX_A100.topology))
    return ref, mine


ASSIGN_CASES = [
    # (placement, stage bytes, groups, nodes per stage, expected)
    ("em-aware", (100 * GB, 70 * GB, 120 * GB, 50 * GB),
     ((80, 2), (560, 2)), 1, (1, 0, 1, 0)),
    ("em-aware", (1, 2, 3), ((80, 1), (560, 1)), 1, None),
    ("em-aware", (1, 2), ((80, 4),), 1, None),
    ("em-aware", (1,), ((80, 2), (560, 2)), 1, None),
    ("em-aware", (5, 9, 7), ((80, 6), (560, 4), (320, 4)), 2, (2, 1, 1)),
    ("paper", (100 * GB, 70 * GB), ((80, 2), (560, 2)), 1, None),
    ("explicit", (1, 2), ((80, 2), (560, 2)), 1, (1, 0)),
]


@pytest.mark.parametrize("case", ASSIGN_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(ASSIGN_CASES)])
def test_assign_stages_matches_reference(case):
    name, stage_bytes, caps, nps, expected = case
    ref_groups, groups = _groups(*caps)
    if name == "explicit":
        ref_pl = placement_jax.ExplicitPlacement((1, 0))
    else:
        ref_pl = placement_jax.get_placement(name)
    want = ref_pl.assign_stages(list(stage_bytes), ref_groups, nps)
    got = from_jax_placement(ref_pl).assign_stages(list(stage_bytes), groups,
                                                   nps)
    assert want == expected
    assert got == want


@pytest.mark.parametrize("stage_groups,nps,match", [
    ((0, 1, 0), 1, "stages"),
    ((0, 7), 1, "node groups"),
    ((0, 0), 2, "nodes"),
])
def test_explicit_placement_checks_match_reference(stage_groups, nps, match):
    ref_groups, groups = _groups((80, 2), (560, 2))
    with pytest.raises(ValueError, match=match) as ref_err:
        placement_jax.ExplicitPlacement(stage_groups).assign_stages(
            [1, 2], ref_groups, nps)
    with pytest.raises(ValueError, match=match) as err:
        placement.ExplicitPlacement(stage_groups).assign_stages(
            [1, 2], groups, nps)
    assert str(err.value) == str(ref_err.value)
    assert placement.ExplicitPlacement().assign_stages([1, 2], groups,
                                                       1) is None


@pytest.mark.parametrize("fits", [(True, False, True), (False, False),
                                  (False, True)])
def test_instance_groups_match_reference(fits):
    for name in ("paper", "em-aware"):
        assert placement.get_placement(name).instance_groups(fits) == \
            placement_jax.get_placement(name).instance_groups(fits)
    assert placement.ExplicitPlacement((0,)).instance_groups(fits) == \
        placement_jax.ExplicitPlacement((0,)).instance_groups(fits)


# ===================================================================== #
# ScheduleModel: every case of tests/test_placement.py, both packages
# ===================================================================== #

SCHEDULE_CASES = {
    # name: (job kwargs, groups, iter_times, fits, per-group npi, placement)
    **{f"waves-n{n}-i{i}": (dict(instances=i, nodes_per_instance=n),
                            ((80, 64),), (0.5,), None, None, None)
       for n in (64, 32, 16, 8) for i in (1, 5, 8)},
    "max-nodes-caps-fleet": (dict(instances=8, nodes_per_instance=8,
                                  max_nodes=64),
                             ((80, 4096),), (1.0,), None, None, None),
    "greedy-balances-two-groups": (dict(instances=8, nodes_per_instance=16),
                                   ((80, 32), (560, 32)), (1.0, 3.0), None,
                                   None, None),
    "em-aware-confines": (dict(instances=8, nodes_per_instance=16),
                          ((80, 32), (560, 32)), (1.0, 1.0), (False, True),
                          None, "em-aware"),
    "paper-spreads-infeasible": (dict(instances=8, nodes_per_instance=16),
                                 ((80, 32), (560, 32)), (1.0, 1.0),
                                 (False, True), None, "paper"),
    "budget-to-eligible-groups": (dict(instances=8, nodes_per_instance=8,
                                       max_nodes=64),
                                  ((80, 512), (560, 512)), (1.0, 1.0),
                                  (False, True), None, "em-aware"),
    "budget-not-eaten-by-small-group": (dict(instances=3,
                                             nodes_per_instance=16,
                                             max_nodes=8),
                                        ((80, 12), (560, 8)), (1.0, 1.0),
                                        None, (16, 8), None),
    "forced-fallback-respects-max-nodes": (dict(instances=2,
                                                nodes_per_instance=8,
                                                max_nodes=4),
                                           ((80, 64),), (1.0,), None, None,
                                           None),
    "oversubscribed-infeasible": (dict(instances=2, nodes_per_instance=64),
                                  ((80, 32), (560, 32)), (1.0, 1.0), None,
                                  None, None),
    "em-aware-nothing-fits-falls-back": (dict(instances=4,
                                              nodes_per_instance=16),
                                         ((80, 32), (560, 16)), (2.0, 1.0),
                                         (False, False), None, "em-aware"),
    "em-aware-forced-to-whole-fleet": (dict(instances=3,
                                            nodes_per_instance=32),
                                       ((80, 64), (560, 16)), (1.0, 1.0),
                                       (False, True), None, "em-aware"),
}


def _schedule_fields(s) -> dict:
    return {"groups": [dataclasses.astuple(g) for g in s.groups],
            "group_waves": [g.waves for g in s.groups],
            "finish": [g.finish_time for g in s.groups],
            "concurrent": s.concurrent, "waves": s.waves,
            "makespan": s.makespan, "turnaround": s.turnaround,
            "feasible": s.feasible, "job": dataclasses.astuple(s.job)}


@pytest.mark.parametrize("name", sorted(SCHEDULE_CASES))
def test_schedule_model_matches_reference(name):
    job, caps, times, fits, npis, pl = SCHEDULE_CASES[name]
    ref_groups, groups = _groups(*caps)
    want = placement_jax.ScheduleModel().schedule(
        placement_jax.JobSpec(**job), ref_groups, list(times), fits=fits,
        nodes_per_instance=npis,
        placement=placement_jax.get_placement(pl))
    got = placement.ScheduleModel().schedule(
        placement.JobSpec(**job), groups, list(times), fits=fits,
        nodes_per_instance=npis, placement=placement.get_placement(pl))
    assert _schedule_fields(got) == _schedule_fields(want)


def test_schedule_model_legacy_waves_formula():
    """waves = ceil(instances / max(1, fleet // n)); turnaround = waves x
    iteration time: the Fig. 13b formula."""
    _, groups = _groups((80, 64))
    for n in (64, 32, 16, 8):
        for instances in (1, 5, 8):
            s = placement.ScheduleModel().schedule(
                placement.JobSpec(instances=instances, nodes_per_instance=n),
                groups, [0.5])
            waves = -(-instances // max(1, 64 // n))
            assert (s.concurrent, s.waves, s.turnaround) == \
                (max(1, 64 // n), waves, waves * 0.5)


def test_schedule_validation_matches_reference():
    for mod in (placement, placement_jax):
        with pytest.raises(ValueError, match="instances"):
            mod.JobSpec(instances=0)
        with pytest.raises(ValueError, match="nodes_per_instance"):
            mod.JobSpec(nodes_per_instance=-1)
        with pytest.raises(ValueError, match="max_nodes"):
            mod.JobSpec(max_nodes=-1)
    _, groups = _groups((80, 4))
    model = placement.ScheduleModel()
    with pytest.raises(ValueError, match="per node group"):
        model.schedule(placement.JobSpec(instances=1, nodes_per_instance=1),
                       groups, [1.0, 2.0])
    with pytest.raises(ValueError, match="nodes_per_instance"):
        model.schedule(placement.JobSpec(instances=1), groups, [1.0])
    empty = placement.Schedule(placement.JobSpec(), (), True)
    assert (empty.waves, empty.makespan, empty.concurrent) == (0, 0.0, 0)


# ===================================================================== #
# The cluster registry and ClusterSpec, field for field
# ===================================================================== #

def _cluster_view(cl) -> dict:
    """Everything the simulator and the cost columns read of a cluster."""
    view = {"type": type(cl).__name__, "fields": dataclasses.asdict(cl),
            "num_nodes": cl.num_nodes, "topology": dataclasses.asdict(
                cl.topology),
            "topology_type": type(cl.topology).__name__,
            "is_heterogeneous": cl.is_heterogeneous,
            "min_node_cap": cl.min_node_cap,
            "node_groups": [(dataclasses.asdict(g.node), g.num_nodes,
                             type(g.topology).__name__,
                             dataclasses.asdict(g.topology))
                            for g in cl.node_groups],
            "pods": [dataclasses.asdict(p) for p in cl.pods],
            "links_per_node": cl.topology.links_per_node}
    if cl.cost is not None:
        view["cost"] = (cl.cost.capex(cl), cl.cost.energy_usd(cl),
                        cl.cost.tco(cl))
    return view


def test_list_clusters_matches_reference():
    assert cluster.list_clusters() == cluster_jax.list_clusters()
    assert sorted(cluster.TABLE_III_CLUSTERS) == \
        sorted(cluster_jax.TABLE_III_CLUSTERS)


@pytest.mark.parametrize("name", cluster_jax.list_clusters())
def test_registered_cluster_matches_reference(name):
    mine = cluster.get_cluster(name)
    ref = cluster_jax.get_cluster(name)
    assert _cluster_view(mine) == _cluster_view(ref)
    assert mine == from_jax_cluster(ref)
    if type(ref).__name__ == "ClusterConfig":
        assert _cluster_view(mine.to_spec()) == _cluster_view(ref.to_spec())


def test_unknown_cluster_hint_matches_reference():
    with pytest.raises(KeyError) as ref_err:
        cluster_jax.get_cluster("B9")
    with pytest.raises(KeyError, match="did you mean") as err:
        cluster.get_cluster("B9")
    assert str(err.value) == str(ref_err.value)


def test_cluster_spec_operations_match_reference():
    ref = cluster_jax.B_HYBRID_EM
    mine = cluster.B_HYBRID_EM
    with pytest.raises(ValueError, match="heterogeneous"):
        mine.node
    with pytest.raises(ValueError, match="no pods"):
        cluster.ClusterSpec("empty", (), mine.interconnect)
    # identical pods merge into one node group
    dup_ref = ref.with_pods(ref.pods + (ref.pods[0],))
    dup = mine.with_pods(mine.pods + (mine.pods[0],))
    assert len(dup.node_groups) == 2
    assert _cluster_view(dup) == _cluster_view(dup_ref)
    node_ref = cluster_jax.TABLE_III_CLUSTERS["C2"].node
    node = cluster.TABLE_III_CLUSTERS["C2"].node
    topo_ref = cluster_jax.TABLE_III_CLUSTERS["A0"].topology
    topo = cluster.TABLE_III_CLUSTERS["A0"].topology
    for a, b in ((mine.with_node(node), ref.with_node(node_ref)),
                 (mine.with_topology(topo), ref.with_topology(topo_ref)),
                 (mine.map_nodes(lambda n: n.scaled_compute(2.0)),
                  ref.map_nodes(lambda n: n.scaled_compute(2.0))),
                 (mine.with_cost(cluster.TABLE_III_CLUSTERS["C0"].cost),
                  ref.with_cost(cluster_jax.TABLE_III_CLUSTERS["C0"].cost))):
        assert _cluster_view(a) == _cluster_view(b)
    homo = cluster.ClusterSpec.homogeneous("h", node, 48, topo)
    homo_ref = cluster_jax.ClusterSpec.homogeneous("h", node_ref, 48,
                                                   topo_ref)
    assert _cluster_view(homo) == _cluster_view(homo_ref)
    assert homo.node == node
    fabric_pod = cluster.PodSpec(node, 2, 8, fabric=topo)
    assert from_jax_cluster(cluster_jax.PodSpec(
        node_ref, 2, 8, fabric=topo_ref)) == fabric_pod
    assert fabric_pod.num_nodes == 16 and \
        fabric_pod.with_(count=3).num_nodes == 24


def test_pods_of_a_config_with_a_remainder_match_reference():
    ref = dataclasses.replace(cluster_jax.TABLE_III_CLUSTERS["B0"],
                              num_nodes=40)
    mine = dataclasses.replace(cluster.TABLE_III_CLUSTERS["B0"],
                               num_nodes=40)
    assert _cluster_view(mine.to_spec()) == _cluster_view(ref.to_spec())


# ===================================================================== #
# The simulator on mixed fleets and under placements
# ===================================================================== #

def test_heterogeneous_flat_and_per_group():
    ref_wl, cw = _pair("smollm-135m", SMALL_SHAPE, mp=4, dp=4)
    hybrid = cluster.B_HYBRID_EM
    want = simulate_iteration_jax(ref_wl, cluster_jax.B_HYBRID_EM)
    got = simulate_iteration_compiled(cw, hybrid, device="cpu")
    assert_breakdowns_equivalent(want, got)
    assert_footprints_equal(want, got)
    per_ref = group_breakdowns_jax(ref_wl, cluster_jax.B_HYBRID_EM)
    per = group_breakdowns_compiled(cw, hybrid, device="cpu")
    assert len(per) == len(per_ref) == 2
    for a, b in zip(per_ref, per):
        assert_breakdowns_equivalent(a, b)
        assert_footprints_equal(a, b)


def test_assigned_placement_pipeline():
    """transformer-1t, mp 16, dp 16, pp 4 on B_HYBRID_EM under the EM-aware
    placement: each stage on its own group's environment."""
    ref_wl, cw = _pair("transformer-1t", PAPER_SHAPE, mp=16, dp=16, pp=4)
    aware = placement.EMAwarePlacement()
    envs = compiled_stage_assignment(cw.workload, cluster.B_HYBRID_EM, aware)
    assert envs is not None and len(envs) == 4
    assert {n.name for n, _ in envs} == {"A100"}
    assert len({n for n, _ in envs}) == 2     # both groups host a stage
    want = simulate_iteration_jax(ref_wl, cluster_jax.B_HYBRID_EM,
                                  placement=placement_jax.EM_AWARE_PLACEMENT)
    got = simulate_iteration_compiled(cw, cluster.B_HYBRID_EM,
                                      placement=aware, device="cpu")
    assert_breakdowns_equivalent(want, got)
    assert_footprints_equal(want, got)


@pytest.mark.parametrize("override", [None, "local", 500e9])
@pytest.mark.parametrize("require_fit", [False, True])
def test_assigned_pipeline_override_and_fit(override, require_fit):
    ref_wl, cw = _pair("transformer-1t", PAPER_SHAPE, mp=16, dp=16, pp=4)
    want = simulate_iteration_jax(
        ref_wl, cluster_jax.B_HYBRID_EM, mem_bw_override=override,
        require_fit=require_fit, placement=placement_jax.EM_AWARE_PLACEMENT)
    got = simulate_iteration_compiled(
        cw, cluster.B_HYBRID_EM, mem_bw_override=override,
        require_fit=require_fit, placement=placement.EMAwarePlacement(),
        device="cpu")
    assert_breakdowns_equivalent(want, got)
    assert_footprints_equal(want, got)


def test_explicit_placement_on_a_half_em_fleet():
    ref_mix, mix = _half_em_mix()
    ref_wl, cw = _pair("transformer-1t", PAPER_SHAPE, mp=8, dp=64, pp=2)
    for groups in ((1, 0), (0, 1)):
        want = simulate_iteration_jax(
            ref_wl, ref_mix, placement=placement_jax.ExplicitPlacement(groups))
        got = simulate_iteration_compiled(
            cw, mix, placement=placement.ExplicitPlacement(groups),
            device="cpu")
        assert_breakdowns_equivalent(want, got)
        assert_footprints_equal(want, got)
    for groups, match in (((0, 1, 0), "stages"), ((0, 7), "node groups"),
                          ((0, 0), "nodes")):
        with pytest.raises(ValueError, match=match):
            simulate_iteration_compiled(
                cw, mix, placement=placement.ExplicitPlacement(groups),
                device="cpu")


def test_em_aware_unlocks_a_partial_em_fleet():
    """The paper placement is gated by the plain pods; EM-aware puts the
    hungry stage on the EM pods. Both as the reference has them."""
    ref_mix, mix = _half_em_mix()
    shape = ("placement", 4096, 2048, "train")
    ref_wl, cw = _pair("transformer-1t", shape, mp=16, dp=32, pp=2)
    for ref_pl, pl, feasible in (
            (placement_jax.PaperPlacement(), placement.PaperPlacement(),
             False),
            (placement_jax.EMAwarePlacement(), placement.EMAwarePlacement(),
             True)):
        want = simulate_iteration_jax(ref_wl, ref_mix, placement=ref_pl)
        got = simulate_iteration_compiled(cw, mix, placement=pl,
                                          device="cpu")
        assert got.feasible is feasible
        assert_breakdowns_equivalent(want, got)


@pytest.mark.parametrize("arch,kw", [
    ("smollm-135m", dict(mp=4, dp=4)),
    ("smollm-135m", dict(mp=2, dp=2, pp=4)),
    ("transformer-1t", dict(mp=8, dp=64, pp=2)),
])
@pytest.mark.parametrize("override,require_fit", [("local", False),
                                                  (None, True),
                                                  ("local", True)])
def test_mixed_fleet_local_override_and_require_fit(arch, kw, override,
                                                    require_fit):
    """``"local"`` resolves per group (each group's own local_bw);
    ``require_fit`` gates on the least-capable group."""
    shape = SMALL_SHAPE if arch == "smollm-135m" else PAPER_SHAPE
    ref_wl, cw = _pair(arch, shape, **kw)
    ref_mix, mix = _half_em_mix()
    for ref_cl, cl in ((cluster_jax.B_HYBRID_EM, cluster.B_HYBRID_EM),
                       (ref_mix, mix)):
        want = simulate_iteration_jax(ref_wl, ref_cl,
                                      mem_bw_override=override,
                                      require_fit=require_fit)
        got = simulate_iteration_compiled(cw, cl, mem_bw_override=override,
                                          require_fit=require_fit,
                                          device="cpu")
        assert_breakdowns_equivalent(want, got)
        assert_footprints_equal(want, got)


@pytest.mark.parametrize("pl", [None, "paper", "em-aware"])
def test_group_breakdowns_match_reference(pl):
    ref_wl, cw = _pair("transformer-1t", PAPER_SHAPE, mp=16, dp=16, pp=4)
    want = group_breakdowns_jax(ref_wl, cluster_jax.B_HYBRID_EM,
                                mem_bw_override="local",
                                placement=placement_jax.get_placement(pl))
    cache = {}
    got = group_breakdowns_compiled(cw, cluster.B_HYBRID_EM,
                                    mem_bw_override="local",
                                    placement=placement.get_placement(pl),
                                    env_cache=cache, device="cpu")
    assert len(cache) == 2
    for a, b in zip(want, got):
        assert_breakdowns_equivalent(a, b)
        assert_footprints_equal(a, b)


@pytest.mark.parametrize("arch,kw,cl", [
    ("smollm-135m", dict(mp=4, dp=4), "dgx-a100-1k"),
    ("smollm-135m", dict(mp=2, dp=2, pp=4), "tpu-v4"),
    ("transformer-1t", dict(mp=8, dp=64, pp=2), "b-hybrid-em"),
    ("transformer-1t", dict(mp=16, dp=64), "dojo"),
])
def test_paper_placement_gives_the_same_bits_as_none(arch, kw, cl):
    shape = SMALL_SHAPE if arch == "smollm-135m" else PAPER_SHAPE
    _, cw = _pair(arch, shape, **kw)
    mine = cluster.get_cluster(cl)
    none = simulate_iteration_compiled(cw, mine, device="cpu")
    paper = simulate_iteration_compiled(cw, mine,
                                        placement=placement.PaperPlacement(),
                                        device="cpu")
    assert paper.as_dict() == none.as_dict()
    assert (paper.feasible, paper.mem_bw, paper.bubble_fraction) == \
        (none.feasible, none.mem_bw, none.bubble_fraction)


@pytest.mark.parametrize("name", ["dgx-a100-1k", "A0", "tpu-v4", "dojo",
                                  "tpu-v5e-2pod"])
def test_collective_times_under_placements_match_reference(name):
    """The port's collective model under each placement against the
    reference's, and the paper placement against None, bit for bit."""
    mine, ref = cluster.get_cluster(name), cluster_jax.get_cluster(name)
    base = CollectiveModel(mine, mp=8, dp=16, pp=2, ep=4)
    for ref_pl in (placement_jax.PaperPlacement(),
                   placement_jax.EMAwarePlacement()):
        model = CollectiveModel(mine, mp=8, dp=16, pp=2, ep=4,
                                placement=from_jax_placement(ref_pl))
        model_ref = CollectiveModelJax(ref, mp=8, dp=16, pp=2, ep=4,
                                       placement=ref_pl)
        for coll in ("all-reduce", "all-gather", "reduce-scatter",
                     "all-to-all"):
            for scope in ("mp", "dp", "ep", "edp"):
                t = model.time(coll, 1e9, scope)
                assert t == base.time(coll, 1e9, scope)
                assert t == pytest.approx(model_ref.time(coll, 1e9, scope),
                                          rel=1e-12)
        assert model.time("p2p", 1e9, "pp") == base.time("p2p", 1e9, "pp")
