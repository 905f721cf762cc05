"""The paper's §V claims on the port's figure wrappers, held to the JAX
package's.

Every wrapper of the port's ``core/dse.py`` (``mpdp_sweep``,
``memory_expansion_heatmap``, ``compute_scaling``, ``network_scaling``,
``bandwidth_rebalance``, ``dlrm_cluster_size_sweep``,
``dlrm_memory_expansion``, ``hetero_cost_ranking``, ``pareto_frontier``,
``pp_ep_ranking``, ``cluster_comparison``, ``placement_ranking``,
``multi_tenant_ranking``) and of ``core/strategy.py`` runs in both
packages at ``tests/test_paper_claims.py``'s settings (transformer-1t at
seq 2,048 x batch 1,024 on the DGX-A100 baseline; the DLRM at batch
65,536; the 11 Table III clusters), the port on the CPU. The outputs must
have the same shape and keys in the same order, the same non-float values,
and floats within 1e-9 relative (inf and nan by their text). Then each
claim of ``tests/test_paper_claims.py`` is asserted on the port's numbers,
the pipeline claims through ``simulate_iteration_compiled``.
"""

import dataclasses
import math

import pytest

from repro.configs import get_config as get_config_jax
from repro.configs import get_dlrm_config as get_dlrm_config_jax
from repro.configs.base import ShapeConfig as ShapeConfigJax
from repro.core import cluster as cluster_jax
from repro.core import dse as dse_jax
from repro.core import strategy as strategy_jax
from repro.core.simulator import simulate_iteration as simulate_jax
from repro.core.workload import decompose as decompose_jax
from repro_torch.configs import ShapeConfig, get_config, get_dlrm_config
from repro_torch.core import dse, strategy
from repro_torch.core.cluster import BASELINE_DGX_A100, get_cluster
from repro_torch.core.simulator import simulate_iteration_compiled
from repro_torch.core.workload import decompose

REL = 1e-9
PAPER = ("paper", 2048, 1024, "train")
DLRM_BATCH = 65536


def assert_same(ref, mine, rel: float = REL, where: str = "out") -> None:
    """``mine`` has ``ref``'s structure: dicts with the same keys in the
    same order, sequences of the same length, dataclasses field for field,
    floats within ``rel`` (abs 1e-12; inf and nan by their text), other
    values equal and of the same type."""
    if dataclasses.is_dataclass(ref):
        assert type(ref).__name__ == type(mine).__name__, where
        ref, mine = dataclasses.asdict(ref), dataclasses.asdict(mine)
    if isinstance(ref, dict):
        assert isinstance(mine, dict), where
        assert list(ref) == list(mine), where
        for k in ref:
            assert_same(ref[k], mine[k], rel, f"{where}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert type(ref) is type(mine) and len(ref) == len(mine), where
        for i, (a, b) in enumerate(zip(ref, mine)):
            assert_same(a, b, rel, f"{where}[{i}]")
    elif isinstance(ref, float):
        assert type(mine) is float, f"{where}: {type(mine)}"
        if math.isnan(ref) or math.isinf(ref):
            assert str(ref) == str(mine), where
        else:
            assert mine == pytest.approx(ref, rel=rel, abs=1e-12), \
                f"{where}: {ref} vs {mine}"
    else:
        assert type(ref) is type(mine), f"{where}: {type(ref)} {type(mine)}"
        assert ref == mine, f"{where}: {ref!r} vs {mine!r}"


@pytest.fixture(scope="module")
def models():
    """(transformer-1t, paper shape, DLRM, DGX baseline) of each package:
    the reference first."""
    return ((get_config_jax("transformer-1t"), ShapeConfigJax(*PAPER),
             get_dlrm_config_jax(), cluster_jax.BASELINE_DGX_A100),
            (get_config("transformer-1t"), ShapeConfig(*PAPER),
             get_dlrm_config(), BASELINE_DGX_A100))


def both(models, name, *args, **kwargs):
    """``dse.<name>`` of each package on its own models; ``args`` are
    picked from the models tuple by name."""
    out = []
    for pkg, mod in enumerate((dse_jax, dse)):
        t, shape, dlrm, base = models[pkg]
        pick = {"t": t, "shape": shape, "dlrm": dlrm, "base": base}
        call = [pick.get(a, a) if isinstance(a, str) else a for a in args]
        extra = {} if pkg == 0 else {"device": "cpu"}
        out.append(getattr(mod, name)(*call, **kwargs, **extra))
    assert_same(out[0], out[1], where=name)
    return out[1]


# ===================================================================== #
# The wrappers, held to the reference at the claims' settings
# ===================================================================== #

@pytest.fixture(scope="module")
def sweep(models):
    return both(models, "mpdp_sweep", "t", "shape", "base")


@pytest.fixture(scope="module")
def cmp(models):
    return both(models, "cluster_comparison", "t", "shape", "dlrm",
                dlrm_batch=DLRM_BATCH)


class TestWrappersMatchReference:
    def test_mpdp_sweep(self, sweep):
        assert [r.label for r in sweep][:3] == ["MP1024_DP1", "MP512_DP2",
                                                "MP256_DP4"]

    def test_strategy_module(self, models):
        (tj, sj, _, bj), (t, s, _, b) = models
        ref = strategy_jax.sweep_strategies(tj, sj, bj, min_mp=8)
        mine = strategy.sweep_strategies(t, s, b, min_mp=8, device="cpu")
        assert_same(ref, mine)
        cap = b.node.local_cap
        assert_same(strategy_jax.best_strategy(ref),
                    strategy.best_strategy(mine))
        assert_same(strategy_jax.best_strategy(ref, require_fit_bytes=cap),
                    strategy.best_strategy(mine, require_fit_bytes=cap))
        with pytest.raises(ValueError, match="no strategy fits"):
            strategy.best_strategy(mine, require_fit_bytes=1.0)
        assert_same(strategy_jax.footprint_table(tj, sj, 1024),
                    strategy.footprint_table(t, s, 1024))
        assert strategy.power_of_two_strategies(12) == \
            strategy_jax.power_of_two_strategies(12)

    @pytest.mark.parametrize("kwargs", [
        dict(em_bandwidths_gbs=(100, 1000, 2000), strategies=[(64, 16)]),
        dict(em_bandwidths_gbs=(50, 2000), strategies=[(8, 128)]),
        dict(),
    ], ids=["fig9_flat", "fig9_break_even", "fig9_default"])
    def test_memory_expansion_heatmap(self, models, kwargs):
        both(models, "memory_expansion_heatmap", "t", "shape", "base",
             **kwargs)

    def test_compute_scaling(self, models):
        both(models, "compute_scaling", "t", "shape", "base", 8, 128,
             compute_factors=(0.5, 1.0, 2.0, 4.0), em_bandwidths_gbs=(2000,))
        both(models, "compute_scaling", "t", "shape", "base", 8, 128)

    @pytest.mark.parametrize("mp,dp", [(64, 16), (8, 128)])
    def test_network_scaling(self, models, mp, dp):
        both(models, "network_scaling", "t", "shape", "base", mp, dp,
             intra_factors=(1.0, 2.0), inter_factors=(1.0, 2.0))
        both(models, "network_scaling", "t", "shape", "base", mp, dp)

    def test_bandwidth_rebalance(self, models):
        both(models, "bandwidth_rebalance", "t", "shape", "base", 64, 16)

    def test_dlrm_cluster_size_sweep(self, models):
        out = both(models, "dlrm_cluster_size_sweep", "dlrm", "base",
                   global_batch=DLRM_BATCH)
        assert list(out) == [64, 32, 16, 8]
        assert all("footprint_gb" in row for row in out.values())

    def test_dlrm_memory_expansion(self, models):
        both(models, "dlrm_memory_expansion", "dlrm", "base",
             global_batch=DLRM_BATCH, em_bandwidths_gbs=(500, 2000),
             nodes_per_instance_opts=(8,))
        both(models, "dlrm_memory_expansion", "dlrm", "base",
             global_batch=DLRM_BATCH)

    def test_hetero_cost_ranking(self, models):
        out = both(models, "hetero_cost_ranking", "t", "shape")
        ppd = [r["perf_per_dollar"] for r in out]
        assert ppd == sorted(ppd, reverse=True) and len(out) == 17

    def test_pareto_frontier(self, models):
        out = both(models, "pareto_frontier")
        assert [(r["em_pod_frac"], r["strategy"]) for r in out] == \
            [(1.0, "MP8_DP128"), (0.0, "MP64_DP16")]

    def test_pp_ep_ranking(self, models):
        out = both(models, "pp_ep_ranking")
        totals = [r["total"] for r in out]
        assert totals == sorted(totals)

    def test_placement_ranking(self, models):
        out = both(models, "placement_ranking")
        ppd = [r["perf_per_dollar"] for r in out]
        assert ppd == sorted(ppd, reverse=True)

    def test_multi_tenant_ranking(self, models):
        out = both(models, "multi_tenant_ranking")
        turnaround = [r["turnaround"] for r in out]
        assert turnaround == sorted(turnaround)

    def test_cluster_comparison(self, cmp):
        assert list(cmp) == list(dse.TABLE_III_CLUSTERS)

    def test_processes_still_refused(self, models):
        with pytest.raises(NotImplementedError, match="item 22"):
            dse.hetero_cost_ranking(*models[1][:2], processes=2,
                                    device="cpu")


# ===================================================================== #
# The claims of tests/test_paper_claims.py, on the port's numbers
# ===================================================================== #

def simulate(wl, cluster):
    return simulate_iteration_compiled(wl.compiled(), cluster, device="cpu")


class TestFig8:
    def test_mp8_dp128_is_optimal(self, sweep):
        best = min(sweep, key=lambda r: r.total)
        assert best.label == "MP8_DP128"

    def test_high_mp_is_communication_bound(self, sweep):
        by = {r.label: r.breakdown for r in sweep}
        hi = by["MP64_DP16"]
        assert hi.fp.exposed_comm > hi.fp.compute
        lo = by["MP8_DP128"]
        assert lo.fp.exposed_comm < lo.fp.compute

    def test_low_mp_exposes_dp_gradients(self, sweep):
        by = {r.label: r.breakdown for r in sweep}
        assert by["MP1_DP1024"].wg.exposed_comm > \
            by["MP8_DP128"].wg.exposed_comm


class TestFig9:
    def test_high_mp_insensitive_to_em_bandwidth(self, models):
        t, shape, _, base = models[1]
        hm = dse.memory_expansion_heatmap(
            t, shape, base, em_bandwidths_gbs=(100, 1000, 2000),
            strategies=[(64, 16)], device="cpu")
        row = list(hm["MP64_DP16"].values())
        assert max(row) / min(row) < 1.01

    def test_break_even_bandwidth_exists(self, models):
        t, shape, _, base = models[1]
        base_total = simulate(decompose(t, shape, mp=64, dp=16), base).total
        tj, sj, _, bj = models[0]
        assert base_total == pytest.approx(
            simulate_jax(decompose_jax(tj, sj, mp=64, dp=16), bj).total,
            rel=REL)
        hm = dse.memory_expansion_heatmap(
            t, shape, base, em_bandwidths_gbs=(50, 2000),
            strategies=[(8, 128)], device="cpu")
        assert hm["MP8_DP128"][2000] < base_total
        assert hm["MP8_DP128"][50] > base_total


class TestFig10:
    def test_compute_scaling_diminishing_returns(self, models):
        t, shape, _, base = models[1]
        cs = dse.compute_scaling(t, shape, base, 8, 128,
                                 compute_factors=(0.5, 1.0, 2.0, 4.0),
                                 em_bandwidths_gbs=(2000,), device="cpu")
        f = {x: cs[x][2000] for x in (0.5, 1.0, 2.0, 4.0)}
        slow_penalty = f[0.5] / f[1.0]
        fast_gain = f[1.0] / f[2.0]
        assert slow_penalty > fast_gain
        assert f[2.0] / f[4.0] < fast_gain + 0.05


class TestFig11:
    def test_both_dims_amplify(self, models):
        t, shape, _, base = models[1]
        ns = dse.network_scaling(t, shape, base, 64, 16,
                                 intra_factors=(1.0, 2.0),
                                 inter_factors=(1.0, 2.0), device="cpu")
        b = ns[(1.0, 1.0)]
        gain_intra = b - ns[(2.0, 1.0)]
        gain_inter = b - ns[(1.0, 2.0)]
        gain_both = b - ns[(2.0, 2.0)]
        assert gain_both > max(gain_intra, gain_inter)

    def test_mp8_less_network_sensitive_than_mp64(self, models):
        t, shape, _, base = models[1]
        kw = dict(intra_factors=(1.0, 2.0), inter_factors=(1.0, 2.0),
                  device="cpu")
        n64 = dse.network_scaling(t, shape, base, 64, 16, **kw)
        n8 = dse.network_scaling(t, shape, base, 8, 128, **kw)
        gain64 = 1 - n64[(2.0, 2.0)] / n64[(1.0, 1.0)]
        gain8 = 1 - n8[(2.0, 2.0)] / n8[(1.0, 1.0)]
        assert gain64 > gain8


class TestFig12:
    def test_rebalance_optimum_is_interior(self, models):
        t, shape, _, base = models[1]
        rb = dse.bandwidth_rebalance(t, shape, base, 64, 16, device="cpu")
        best_r = min(rb, key=rb.get)
        assert 1 < best_r < 9.6
        assert rb[best_r] < rb[9.6]
        assert rb[16] > rb[best_r]


class TestFig13:
    def test_dlrm_memory_bandwidth_sensitivity(self, models):
        _, _, dlrm, base = models[1]
        me = dse.dlrm_memory_expansion(dlrm, base, global_batch=DLRM_BATCH,
                                       em_bandwidths_gbs=(500, 2000),
                                       nodes_per_instance_opts=(8,),
                                       device="cpu")
        assert me[8][500] / me[8][2000] > 2.0

    def test_multi_instance_speedup_with_fast_em(self, models):
        _, _, dlrm, base = models[1]
        me = dse.dlrm_memory_expansion(dlrm, base, global_batch=DLRM_BATCH,
                                       em_bandwidths_gbs=(2000,),
                                       nodes_per_instance_opts=(64, 8),
                                       device="cpu")
        assert me[8][2000] < me[64][2000]


class TestPipelineParallel:
    def test_gpipe_bubble_matches_analytical_form(self, models):
        t, shape, _, base = models[1]
        for pp, m in ((2, 4), (4, 8), (8, 8), (8, 64)):
            wl = decompose(t, shape, mp=8, dp=16, pp=pp,
                           num_microbatches=m, schedule="gpipe")
            br = simulate(wl, base)
            assert br.bubble_fraction == pytest.approx((pp - 1) / (m + pp - 1))

    def test_more_microbatches_shrink_the_bubble(self, models):
        t, shape, _, base = models[1]
        few = simulate(decompose(t, shape, mp=8, dp=16, pp=8,
                                 num_microbatches=8), base)
        many = simulate(decompose(t, shape, mp=8, dp=16, pp=8,
                                  num_microbatches=64), base)
        assert many.bubble_fraction < few.bubble_fraction
        assert many.total < few.total

    def test_pp_beats_pure_mp_on_bandwidth_starved_cluster(self, models):
        t, shape, _, _ = models[1]
        a0 = get_cluster("A0")
        pure_mp = simulate(decompose(t, shape, mp=64, dp=16), a0)
        pp_heavy = simulate(decompose(t, shape, mp=8, dp=16, pp=8), a0)
        assert pp_heavy.total < pure_mp.total
        tj, sj, _, _ = models[0]
        ref = simulate_jax(decompose_jax(tj, sj, mp=8, dp=16, pp=8),
                           cluster_jax.get_cluster("A0"))
        assert pp_heavy.total == pytest.approx(ref.total, rel=REL)

    def test_flat_iteration_has_no_bubble(self, models):
        t, shape, _, base = models[1]
        wl = decompose(t, shape, mp=8, dp=128)
        assert simulate(wl, base).bubble_fraction == 0.0


class TestFig15:
    def test_b1_transformer_speedup_near_paper(self, cmp):
        """Paper: B1 delivers 7.2x for Transformer-1T (the reference:
        7.684)."""
        s = cmp["A0"]["transformer-1t"] / cmp["B1"]["transformer-1t"]
        assert 5.0 < s < 10.0
        assert s == pytest.approx(7.684, abs=5e-4)

    def test_memory_expansion_helps_dlrm_only_on_low_end(self, cmp):
        def dlrm_speedup(c):
            return cmp["A0"]["dlrm"] / cmp[c]["dlrm"]
        assert dlrm_speedup("A2") > dlrm_speedup("A0")
        assert dlrm_speedup("C1") < dlrm_speedup("C0")
        assert dlrm_speedup("B1") < dlrm_speedup("B0")

    def test_transformer_gains_from_expansion_everywhere(self, cmp):
        for a, b in (("A0", "A1"), ("B0", "B1"), ("C0", "C1")):
            assert cmp[b]["transformer-1t"] < cmp[a]["transformer-1t"]

    def test_tpu_story(self, cmp):
        tf = cmp["A0"]["transformer-1t"] / cmp["tpu-v4"]["transformer-1t"]
        dl = cmp["A0"]["dlrm"] / cmp["tpu-v4"]["dlrm"]
        assert tf > 2 * dl

    def test_dojo_strong_on_both(self, cmp):
        tf = cmp["A0"]["transformer-1t"] / cmp["dojo"]["transformer-1t"]
        dl = cmp["A0"]["dlrm"] / cmp["dojo"]["dlrm"]
        assert tf > 5 and dl > 5
