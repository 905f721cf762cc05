"""The port's batch evaluator (``repro_torch.core.torch_engine`` under
``repro_torch.core.simulator``) against the JAX package's.

On every ``JAX_CASES`` row of ``tests/test_jax_engine.py`` the port's
breakdown agrees within 1e-9 relative (abs 1e-12) with the reference's
event loop and with both of its compiled backends; the engine alone, fed
the reference's own lowered stages (``convert.from_jax_stage``), agrees
with ``jax_engine.stage_compute_exposed``; the event walk agrees with the
closed form wherever both apply, and prices the DLRM's stage, which only
the walk can. The CPU runs use ``device="cpu"``: without it and without a
GPU the entry points raise.

The reference's jax engine imports ``jax.experimental.enable_x64``, which
newer jax releases no longer have; there it reports ``HAVE_JAX`` False and
its ``"jax"`` backend runs the NumPy engine. The ``reference_jax_kernel``
fixture hands it ``jax.enable_x64(True)`` for this module, so that its real
jit/vmap kernel is the oracle (the JAX package itself is not changed).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.configs import get_dlrm_config as get_dlrm_config_jax
from repro.core import jax_engine
from repro.core.cluster import ClusterConfig as ClusterConfigJax
from repro.core.simulator import simulate_iteration as simulate_iteration_jax
from repro.core.simulator import (
    simulate_iteration_compiled as simulate_iteration_compiled_jax,
)
from repro.core.simulator import time_compiled as time_compiled_jax
from repro.core.workload import decompose as decompose_jax
from repro.core.workload import decompose_dlrm as decompose_dlrm_jax
from repro_torch.configs import ShapeConfig, get_config, get_dlrm_config
from repro_torch.convert import from_jax_env, from_jax_stage
from repro_torch.core import torch_engine
from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.simulator import simulate_iteration_compiled, time_compiled
from repro_torch.core.workload import decompose, decompose_dlrm
from test_jax_engine import (
    EM_NODE,
    GB,
    JAX_CASES,
    SMALL_NODE,
    SMALL_SHAPE,
    TOPOLOGIES,
    assert_breakdowns_equivalent,
)

REL = 1e-9
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def reference_jax_kernel():
    import jax
    import jax.numpy as jnp
    with pytest.MonkeyPatch.context() as mp:
        if not jax_engine.HAVE_JAX:
            mp.setattr(jax_engine, "jax", jax)
            mp.setattr(jax_engine, "jnp", jnp)
            mp.setattr(jax_engine, "enable_x64",
                       lambda: jax.enable_x64(True))
            mp.setattr(jax_engine, "HAVE_JAX", True)
        yield


CASE_IDS = [f"{c[0]}-{c[1]}-mp{c[3]}dp{c[4]}pp{c[5]}ep{c[6]}-{c[7]}"
            f"{'-fit' if c[9] else ''}" for c in JAX_CASES]


def _shape() -> ShapeConfig:
    return ShapeConfig(**dataclasses.asdict(SMALL_SHAPE))


def _workloads(arch, mp, dp, pp=1, ep=1, schedule="1f1b"):
    ref = decompose_jax(get_config_jax(arch), SMALL_SHAPE, mp=mp, dp=dp,
                        pp=pp, ep=ep, schedule=schedule)
    mine = decompose(get_config(arch), _shape(), mp=mp, dp=dp, pp=pp, ep=ep,
                     schedule=schedule)
    return ref, mine


def _clusters(node, topo, nodes):
    ref = ClusterConfigJax("sim", node, nodes, topo)
    mine_node, mine_topo = from_jax_env((node, topo))
    return ref, ClusterConfig("sim", mine_node, nodes, mine_topo)


def assert_close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=REL, atol=1e-12)


@pytest.mark.parametrize("case", JAX_CASES, ids=CASE_IDS)
def test_breakdowns_match_reference_and_both_backends(case):
    arch, topo_key, node, mp, dp, pp, ep, sched, override, req = case
    ref_wl, wl = _workloads(arch, mp, dp, pp, ep, sched)
    ref_cluster, cluster = _clusters(node, TOPOLOGIES[topo_key],
                                     mp * dp * pp * ep)
    mine = simulate_iteration_compiled(wl.compiled(), cluster,
                                       mem_bw_override=override,
                                       require_fit=req, device="cpu")
    assert_breakdowns_equivalent(
        simulate_iteration_jax(ref_wl, ref_cluster, mem_bw_override=override,
                               require_fit=req), mine)
    for backend in ("numpy", "jax"):
        assert_breakdowns_equivalent(simulate_iteration_compiled_jax(
            ref_wl.compiled(), ref_cluster, mem_bw_override=override,
            require_fit=req, backend=backend), mine)
    assert dataclasses.asdict(mine.footprint) == dataclasses.asdict(
        simulate_iteration_jax(ref_wl, ref_cluster, mem_bw_override=override,
                               require_fit=req).footprint)


def test_batched_envs_match_reference():
    """One call over several environments (both node kinds, three
    families) against the reference's NumPy and jax backends."""
    ref_wl, wl = _workloads("smollm-135m", 4, 4)
    envs = [(SMALL_NODE, TOPOLOGIES["hier"]), (EM_NODE, TOPOLOGIES["hier"]),
            (SMALL_NODE, TOPOLOGIES["torus"]),
            (SMALL_NODE, TOPOLOGIES["switch"])]
    mine = time_compiled(wl.compiled(), [from_jax_env(e) for e in envs],
                         device="cpu")
    for backend in ("numpy", "jax"):
        for a, b in zip(time_compiled_jax(ref_wl.compiled(), envs,
                                          backend=backend), mine):
            assert_breakdowns_equivalent(a, b)


ENV_SET = [(SMALL_NODE, TOPOLOGIES[k]) for k in TOPOLOGIES] \
    + [(EM_NODE, TOPOLOGIES["hier"])]


def assert_engine_matches_reference(stage, mp, dp, pp, ep):
    """The port's ``stage_compute_exposed`` on ``from_jax_stage(stage)``
    and ``ENV_SET`` through ``from_jax_env`` against the reference's on
    the stage itself, at per-environment memory bandwidths."""
    nodes = [n for n, _ in ENV_SET]
    mem_bw = np.array([n.local_bw * (0.5 + 0.25 * i)
                       for i, n in enumerate(nodes)])
    want = jax_engine.stage_compute_exposed(stage, ENV_SET, nodes, mem_bw,
                                            mp, dp, pp, ep, None)
    envs = [from_jax_env(e) for e in ENV_SET]
    got = torch_engine.stage_compute_exposed(
        from_jax_stage(stage), envs, [n for n, _ in envs], mem_bw, mp, dp,
        pp, ep, None, device="cpu")
    for g, w in zip(got, want):
        assert_close(g, w)


ZERO_CASES = [(c, z) for c in JAX_CASES for z in (0, 1, 3)]


@pytest.mark.parametrize("case,zero", ZERO_CASES,
                         ids=[f"{CASE_IDS[i // 3]}-z{z}"
                              for i, (_, z) in enumerate(ZERO_CASES)])
def test_zero_stages_match_reference(case, zero):
    """ZeRO stages 0, 1 and 3 (the cases above run at the default 2)
    against the reference's event loop and NumPy engine."""
    arch, topo_key, node, mp, dp, pp, ep, sched, override, req = case
    ref_wl, wl = _workloads(arch, mp, dp, pp, ep, sched)
    ref_cluster, cluster = _clusters(node, TOPOLOGIES[topo_key],
                                     mp * dp * pp * ep)
    mine = simulate_iteration_compiled(wl.compiled(), cluster,
                                       zero_stage=zero,
                                       mem_bw_override=override,
                                       require_fit=req, device="cpu")
    want = simulate_iteration_jax(ref_wl, ref_cluster, zero_stage=zero,
                                  mem_bw_override=override, require_fit=req)
    assert_breakdowns_equivalent(want, mine)
    assert dataclasses.asdict(mine.footprint) == \
        dataclasses.asdict(want.footprint)
    assert_breakdowns_equivalent(simulate_iteration_compiled_jax(
        ref_wl.compiled(), ref_cluster, zero_stage=zero,
        mem_bw_override=override, require_fit=req), mine)


@pytest.mark.parametrize("case", JAX_CASES, ids=CASE_IDS)
def test_engine_alone_on_reference_inputs(case):
    """``stage_compute_exposed`` fed the reference's own lowered stages and
    environments (``from_jax_stage`` / ``from_jax_env``) against
    ``jax_engine.stage_compute_exposed``: a fault of the engine shows here
    apart from one of the lowering."""
    arch, _, _, mp, dp, pp, ep, sched, _, _ = case
    ref_wl, _ = _workloads(arch, mp, dp, pp, ep, sched)
    for stage in ref_wl.compiled().stages:
        assert_engine_matches_reference(stage, mp, dp, pp, ep)


def _both_kernels(stage, envs, mp, dp, pp, ep):
    nodes = [n for n, _ in envs]
    T, fast = torch_engine._device_prep(stage, CPU)
    f64 = dict(dtype=torch.float64)
    args = (T, torch.tensor([max(int(n.sram_bytes), 1) for n in nodes], **f64),
            torch.tensor([n.peak_flops for n in nodes], **f64),
            torch.tensor([n.local_bw for n in nodes], **f64),
            torch.as_tensor(torch_engine.comm_matrix(stage, envs, mp, dp, pp,
                                                     ep, None), **f64))
    return fast, torch_engine._stage_fn_fast(*args), \
        torch_engine._stage_fn_scan(*args)


@pytest.mark.parametrize("case", JAX_CASES, ids=CASE_IDS)
def test_walk_equals_closed_form(case):
    arch, _, _, mp, dp, pp, ep, sched, _, _ = case
    _, wl = _workloads(arch, mp, dp, pp, ep, sched)
    envs = [from_jax_env(e) for e in ENV_SET]
    for stage in wl.compiled().stages:
        fast, (c_fast, e_fast), (c_scan, e_scan) = _both_kernels(
            stage, envs, mp, dp, pp, ep)
        assert fast
        assert torch.equal(c_fast, c_scan)
        assert_close(e_scan.numpy(), e_fast.numpy())


def test_dlrm_takes_the_walk():
    """The DLRM's backward issues its MLPs' non-blocking gradient
    all-reduces on scope ``mp`` before the embedding's blocking
    all-to-all on the same scope: the closed form cannot price it, the
    walk does, and agrees with the reference's event loop, NumPy and jax
    backends."""
    nodes = 64
    ref_wl = decompose_dlrm_jax(get_dlrm_config_jax(), 65536, nodes)
    wl = decompose_dlrm(get_dlrm_config(), 65536, nodes)
    assert not torch_engine._prep(wl.compiled().stages[0])[1]
    assert_engine_matches_reference(ref_wl.compiled().stages[0], nodes,
                                    nodes, 1, 1)
    for topo_key in ("hier", "switch"):
        ref_cluster, cluster = _clusters(SMALL_NODE, TOPOLOGIES[topo_key],
                                         nodes)
        mine = simulate_iteration_compiled(wl.compiled(), cluster,
                                           device="cpu")
        assert_breakdowns_equivalent(
            simulate_iteration_jax(ref_wl, ref_cluster), mine)
        for backend in ("numpy", "jax"):
            assert_breakdowns_equivalent(simulate_iteration_compiled_jax(
                ref_wl.compiled(), ref_cluster, backend=backend), mine)


def _overlap_workload(workload_mod, gemm_mod):
    """Two layers built by hand: a long weightless compute layer first, and
    after it a small layer whose gradient all-reduce is non-blocking. The
    backward runs the small layer first, so its transfer ends long before
    the compute does: the residue past the end of compute is negative
    before the clamp, and nothing is exposed."""
    big = workload_mod.LayerSpec("big")
    big.add_gemm(gemm_mod.Gemm(4096, 4096, 4096), has_weight=False)
    small = workload_mod.LayerSpec("small")
    small.add_gemm(gemm_mod.Gemm(64, 64, 64))
    small.comm_wg.append(gemm_mod.CommEvent("all-reduce", small.weight_bytes,
                                            "dp", False))
    return workload_mod.Workload("overlap", [big, small], mp=1, dp=4,
                                 per_replica_batch=1, seq_len=1)


def test_residue_hidden_under_compute_is_not_exposed():
    from repro.core import gemm as gemm_jax
    from repro.core import workload as workload_jax
    from repro_torch.core import gemm, workload
    ref_wl = _overlap_workload(workload_jax, gemm_jax)
    wl = _overlap_workload(workload, gemm)
    ref_cluster, cluster = _clusters(SMALL_NODE, TOPOLOGIES["hier"], 4)
    mine = simulate_iteration_compiled(wl.compiled(), cluster, device="cpu")
    want = simulate_iteration_jax(ref_wl, ref_cluster)
    assert want.wg.exposed_comm == 0.0
    assert_breakdowns_equivalent(want, mine)
    envs = [from_jax_env(e) for e in ENV_SET]
    fast, (_, e_fast), (_, e_scan) = _both_kernels(wl.compiled().stages[0],
                                                   envs, 1, 4, 1, 1)
    assert fast
    assert_close(e_scan.numpy(), e_fast.numpy())


def test_transformer_1t_grid_strategies_take_the_closed_form():
    """The paper's transformer-1t strategies of the study grid: closed form
    everywhere, and the walk agrees with it on one stage at full size."""
    shape = ShapeConfig("paper", 2048, 1024, "train")
    for mp, dp, pp in ((64, 16, 1), (16, 64, 1), (8, 128, 1), (16, 16, 4)):
        cw = decompose(get_config("transformer-1t"), shape, mp=mp, dp=dp,
                       pp=pp).compiled()
        assert all(torch_engine._prep(st)[1] for st in cw.stages)
    envs = [from_jax_env(e) for e in ENV_SET]
    fast, (_, e_fast), (_, e_scan) = _both_kernels(cw.stages[1], envs, 16, 16,
                                                   4, 1)
    assert_close(e_scan.numpy(), e_fast.numpy())


def test_default_dtype_stays_float32():
    """The engine computes in float64 without touching the process's
    default dtype: the model stack shares the process."""
    _, wl = _workloads("smollm-135m", 4, 4)
    _, cluster = _clusters(SMALL_NODE, TOPOLOGIES["hier"], 16)
    simulate_iteration_compiled(wl.compiled(), cluster, device="cpu")
    assert torch.get_default_dtype() == torch.float32
    assert torch.ones(3).dtype == torch.float32


def test_entry_points_refuse(monkeypatch):
    """No GPU and no ``device``: time_compiled, simulate_iteration_compiled
    and run_study raise (none drops to the CPU). The runner's own refusals
    are in tests/test_torch_study.py."""
    from repro_torch.core.study import ParallelSpec, StudySpec, run_study
    _, wl = _workloads("smollm-135m", 4, 4)
    _, cluster = _clusters(SMALL_NODE, TOPOLOGIES["hier"], 16)
    envs = [(cluster.node, cluster.topology)]
    spec = StudySpec(name="refuse", model=get_config("smollm-135m"),
                     shape=_shape(), cluster=cluster,
                     strategies=ParallelSpec(mp=4, dp=4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        time_compiled(wl.compiled(), envs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_iteration_compiled(wl.compiled(), cluster)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_study(spec)
    assert len(run_study(spec, device="cpu")) == 1


@pytest.mark.cuda
def test_card_matches_cpu_and_repeats_bitwise():
    """On the card: the same breakdowns as the CPU within 1e-9, and two
    calls with the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine's device path")
    _, wl = _workloads("smollm-135m", 2, 2, pp=4, schedule="gpipe")
    envs = [from_jax_env(e) for e in ENV_SET]
    cpu = time_compiled(wl.compiled(), envs, device="cpu")
    card = time_compiled(wl.compiled(), envs, device="cuda")
    again = time_compiled(wl.compiled(), envs, device="cuda")
    for a, b, c in zip(cpu, card, again):
        assert_breakdowns_equivalent(a, b)
        assert b.as_dict() == c.as_dict()


# ===================================================================== #
# Hypothesis property (the reference's, restated for the port)
# ===================================================================== #

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    from repro.core.topology import HierarchicalSwitch, SingleSwitch, Torus

    @st.composite
    def engine_inputs(draw):
        mp = draw(st.sampled_from([1, 2, 4]))
        dp = draw(st.sampled_from([1, 2, 4]))
        pp = draw(st.sampled_from([1, 2, 4]))
        schedule = draw(st.sampled_from(["1f1b", "gpipe", "interleaved"]))
        fam = draw(st.sampled_from(["hier", "torus", "torus-dcn",
                                    "switch"]))
        if fam == "hier":
            topo = HierarchicalSwitch(
                pod_size=draw(st.sampled_from([2, 4, 8])),
                intra_bw=draw(st.floats(50, 500)) * GB,
                inter_bw=draw(st.floats(5, 50)) * GB)
        elif fam == "torus":
            topo = Torus(dims=(4, 4),
                         link_bw=draw(st.floats(10, 100)) * GB)
        elif fam == "torus-dcn":
            topo = Torus(dims=(2, 2),
                         link_bw=draw(st.floats(10, 100)) * GB,
                         dcn_bw=draw(st.floats(2, 20)) * GB)
        else:
            topo = SingleSwitch(bw=draw(st.floats(50, 500)) * GB)
        node = dataclasses.replace(
            SMALL_NODE,
            peak_flops=draw(st.floats(20, 500)) * 1e12,
            local_bw=draw(st.floats(200, 3000)) * GB,
            local_cap=draw(st.floats(0.5, 64)) * GB,
            exp_cap=draw(st.sampled_from([0.0, 64 * GB])),
            exp_bw=draw(st.floats(100, 1000)) * GB)
        override = draw(st.sampled_from([None, "local", 500 * GB]))
        zero = draw(st.sampled_from([0, 2, 3]))
        return mp, dp, pp, schedule, topo, node, override, zero

    class TestHypothesisEquivalence:
        @settings(max_examples=25, deadline=None)
        @given(engine_inputs())
        def test_port_matches_reference_and_numpy(self, inputs):
            mp, dp, pp, schedule, topo, node, override, zero = inputs
            ref_wl, wl = _workloads("smollm-135m", mp, dp, pp,
                                    schedule=schedule)
            ref_cluster, cluster = _clusters(node, topo, mp * dp * pp)
            mine = simulate_iteration_compiled(
                wl.compiled(), cluster, zero_stage=zero,
                mem_bw_override=override, device="cpu")
            assert_breakdowns_equivalent(simulate_iteration_jax(
                ref_wl, ref_cluster, zero_stage=zero,
                mem_bw_override=override), mine)
            assert_breakdowns_equivalent(simulate_iteration_compiled_jax(
                ref_wl.compiled(), ref_cluster, zero_stage=zero,
                mem_bw_override=override, backend="numpy"), mine)
