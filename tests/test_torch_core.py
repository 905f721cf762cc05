"""The port's copies of the analytic modules against the JAX package's.

``repro_torch.core`` keeps its own ``topology``, ``collectives``, ``gemm``,
``workload``, ``compiled``, ``memory`` and ``cluster`` (the port imports
nothing of ``repro``). These tests hold the copies to the reference: the
lowered stages array for array (same dtype), the decompositions to the
digests of ``tests/golden_decompose.json``, the cluster baseline field for
field, each family's collective formulas, and the collective matrix of the
evaluator on every topology family and on one outside them.
"""

import dataclasses
import hashlib
import json

import numpy as np
import pytest

from repro.configs import get_config as get_config_jax
from repro.configs import get_dlrm_config as get_dlrm_config_jax
from repro.configs.base import ShapeConfig as ShapeConfigJax
from repro.core import jax_engine
from repro.core.compiled import stage_traffic as stage_traffic_jax
from repro.core.workload import decompose as decompose_jax
from repro.core.workload import decompose_dlrm as decompose_dlrm_jax
from repro_torch.configs import ShapeConfig, get_config, get_dlrm_config
from repro_torch.configs.base import SHAPES
from repro_torch.convert import from_jax_env, from_jax_stage
from repro_torch.core import torch_engine
from repro_torch.core.compiled import CompiledPass, CompiledStage, stage_traffic
from repro_torch.core.gemm import CommEvent, ExplicitOp, Gemm
from repro_torch.core.workload import decompose, decompose_dlrm
from test_decompose_golden import CASES as GOLDEN_CASES
from test_decompose_golden import GOLDEN_PATH
from test_jax_engine import JAX_CASES, SMALL_NODE, SMALL_SHAPE, TOPOLOGIES

PAPER = ("paper", 2048, 1024, "train")


def _shape(ref_shape) -> ShapeConfig:
    return ShapeConfig(**dataclasses.asdict(ref_shape))


def _pair(arch, shape, mp, dp, pp=1, ep=1, schedule="1f1b"):
    """The reference's workload and the port's, decomposed alike."""
    ref = decompose_jax(get_config_jax(arch), shape, mp=mp, dp=dp, pp=pp,
                        ep=ep, schedule=schedule)
    mine = decompose(get_config(arch), _shape(shape), mp=mp, dp=dp, pp=pp,
                     ep=ep, schedule=schedule)
    return ref, mine


def _assert_arrays_equal(mine, ref, where):
    assert type(mine) is np.ndarray and type(ref) is np.ndarray, where
    assert mine.dtype == ref.dtype, where
    assert np.array_equal(mine, ref), where


def assert_stages_equal(mine: CompiledStage, ref) -> None:
    for f in dataclasses.fields(CompiledStage):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if f.name in ("fwd", "bwd"):
            for g in dataclasses.fields(CompiledPass):
                _assert_arrays_equal(getattr(a, g.name), getattr(b, g.name),
                                     f"{f.name}.{g.name}")
        elif isinstance(b, np.ndarray):
            _assert_arrays_equal(a, b, f.name)
        else:
            assert type(a) is type(b) and a == b, f.name


STAGE_CASES = [c[:1] + c[3:8] for c in JAX_CASES]
STAGE_CASES += [("transformer-1t", 8, 128, 1, 1, "1f1b"),
                ("transformer-1t", 64, 16, 1, 1, "1f1b")]


@pytest.mark.parametrize("case", STAGE_CASES,
                         ids=[f"{c[0]}-mp{c[1]}dp{c[2]}pp{c[3]}ep{c[4]}-{c[5]}"
                              for c in STAGE_CASES])
def test_compiled_stages_equal_reference(case):
    """``decompose`` + ``compile_workload`` of the port give the
    reference's lowering: every field of every stage, arrays with their
    dtype, and the workload's pipeline metadata."""
    arch, mp, dp, pp, ep, schedule = case
    shape = ShapeConfigJax(*PAPER) if arch == "transformer-1t" else SMALL_SHAPE
    ref, mine = _pair(arch, shape, mp, dp, pp, ep, schedule)
    for name in ("name", "mp", "dp", "pp", "ep", "num_microbatches",
                 "schedule", "virtual_stages", "per_replica_batch", "seq_len"):
        assert getattr(mine, name) == getattr(ref, name), name
    cw, cw_ref = mine.compiled(), ref.compiled()
    assert cw.pp == cw_ref.pp == pp
    for s, (a, b) in enumerate(zip(cw.stages, cw_ref.stages)):
        assert_stages_equal(a, b)
        # from_jax_stage carries the reference's stage over unchanged
        assert_stages_equal(from_jax_stage(b), b)
        sram = np.array([1.0, 2e6, 20e6, 40e6, 1e12])
        assert np.array_equal(stage_traffic(a, sram),
                              stage_traffic_jax(b, sram)), s


def test_dlrm_stage_equals_reference():
    ref = decompose_dlrm_jax(get_dlrm_config_jax(), 65536, 64).compiled()
    mine = decompose_dlrm(get_dlrm_config(), 65536, 64).compiled()
    assert_stages_equal(mine.stages[0], ref.stages[0])


# ------------------------------------------------------------------------- #
# decompose against the golden digests
# ------------------------------------------------------------------------- #

def _op_fp(op):
    if isinstance(op, Gemm):
        return ["gemm", op.m, op.k, op.n, op.batch, op.bytes_per_element]
    if isinstance(op, ExplicitOp):
        return ["explicit", op.flops, op.bytes_moved]
    raise TypeError(type(op))


def _comm_fp(e: CommEvent):
    return [e.collective, e.size_bytes, e.scope, e.blocking]


def _digest(wl) -> str:
    """The digest of ``tests/test_decompose_golden.py``'s fingerprint, over
    the port's op classes."""
    fp = {
        "name": wl.name, "mp": wl.mp, "dp": wl.dp,
        "per_replica_batch": wl.per_replica_batch, "seq_len": wl.seq_len,
        "layers": [{
            "name": ly.name, "repeat": ly.repeat,
            "weight_bytes": ly.weight_bytes,
            "act_out_bytes": ly.act_out_bytes,
            "optim_bytes": ly.optim_bytes,
            "fwd": [_op_fp(o) for o in ly.fwd],
            "ig": [_op_fp(o) for o in ly.ig],
            "wg": [_op_fp(o) for o in ly.wg],
            "comm_fwd": [_comm_fp(e) for e in ly.comm_fwd],
            "comm_ig": [_comm_fp(e) for e in ly.comm_ig],
            "comm_wg": [_comm_fp(e) for e in ly.comm_wg],
        } for ly in wl.layers],
    }
    blob = json.dumps(fp, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


@pytest.mark.parametrize("arch,shape_name,mp,dp", GOLDEN_CASES)
def test_decompose_matches_golden(golden, arch, shape_name, mp, dp):
    shape = ShapeConfig(*PAPER) if shape_name == "paper" else SHAPES[shape_name]
    wl = decompose(get_config(arch), shape, mp=mp, dp=dp)
    assert _digest(wl) == golden[f"{arch}@{shape_name}[mp{mp}_dp{dp}]"]


def test_decompose_dlrm_matches_golden(golden):
    wl = decompose_dlrm(get_dlrm_config(), 65536, 64)
    assert _digest(wl) == golden["dlrm-1p2t[n64]"]


def test_transformer_1t_registered_but_not_assigned():
    from repro_torch.configs import ASSIGNED_ARCHS, list_configs
    assert "transformer-1t" in list_configs()
    assert "transformer-1t" not in ASSIGNED_ARCHS


# ------------------------------------------------------------------------- #
# comm_matrix
# ------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class FlatRing:
    """A topology outside the three families: one ring at ``bw`` with
    the scalar protocol only (no ``collective_time_batch``)."""

    bw: float
    latency: float = 2e-6

    @property
    def pod_size(self) -> int:
        return 1 << 30

    def collective_time(self, collective, size, scope, mp, dp, pp=1, ep=1,
                        placement=None):
        from repro_torch.core.topology import _group_size, flat_time
        return flat_time(collective, size, _group_size(scope, mp, dp, pp, ep),
                         self.bw, self.latency)


COMM_CASES = [c for c in JAX_CASES if c[0] == "smollm-135m"][:6] \
    + [c for c in JAX_CASES if c[0] != "smollm-135m"]


@pytest.mark.parametrize("case", COMM_CASES,
                         ids=[f"{c[0]}-mp{c[3]}dp{c[4]}pp{c[5]}ep{c[6]}-{c[7]}"
                              for c in COMM_CASES])
def test_comm_matrix_equals_reference(case):
    """Every family (a column each, two bandwidths of the hierarchical
    switch sharing a structural key) and a topology outside them, for
    every stage of the case: the same formulas, the same bits."""
    arch, _, _, mp, dp, pp, ep, schedule, _, _ = case
    ref, _ = _pair(arch, SMALL_SHAPE, mp, dp, pp, ep, schedule)
    envs = [(SMALL_NODE, t) for t in TOPOLOGIES.values()]
    envs += [(SMALL_NODE, TOPOLOGIES["hier"].scaled(intra=0.5)),
             (SMALL_NODE, FlatRing(bw=100e9))]
    mine_envs = [from_jax_env(e) for e in envs]
    assert mine_envs[-1][1] is envs[-1][1]
    for st in ref.compiled().stages:
        want = jax_engine.comm_matrix(st, envs, mp, dp, pp, ep, None)
        got = torch_engine.comm_matrix(from_jax_stage(st), mine_envs, mp, dp,
                                       pp, ep, None)
        assert want.shape == got.shape and np.array_equal(got, want)
        assert np.all(np.isfinite(got))


def test_cluster_copy_equals_reference():
    """The evaluator's part of ``core/cluster.py``: the paper's Table I
    baseline field for field (node, topology, cost model)."""
    from repro.core import cluster as cluster_jax
    from repro_torch.core import cluster
    for name in ("A100_NODE", "BASELINE_DGX_A100"):
        assert dataclasses.asdict(getattr(cluster, name)) \
            == dataclasses.asdict(getattr(cluster_jax, name)), name
    mine = cluster.BASELINE_DGX_A100.node_groups
    ref = cluster_jax.BASELINE_DGX_A100.node_groups
    assert [dataclasses.asdict(g) for g in mine] \
        == [dataclasses.asdict(g) for g in ref]


COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "p2p")


@pytest.mark.parametrize("family", sorted(TOPOLOGIES))
def test_scalar_and_batch_formulas_equal_reference(family):
    """Each family's scalar ``collective_time`` and batched
    ``collective_time_batch`` against the reference's, every collective
    and scope, over strategies that keep a group in one pod, span pods, or
    spill over the torus's DCN."""
    ref_topo = TOPOLOGIES[family]
    _, topo = from_jax_env((SMALL_NODE, ref_topo))
    sizes = np.array([0.0, 1.0, 4096.0, 3e6, 7.5e8])
    for mp, dp, pp, ep in ((1, 1, 1, 1), (2, 4, 1, 1), (4, 4, 2, 2),
                           (8, 8, 4, 1), (16, 2, 1, 4)):
        for c in COLLECTIVES:
            for scope in ("mp", "dp", "ep", "pp", "edp"):
                want = ref_topo.collective_time_batch(c, sizes, scope, mp, dp,
                                                      pp, ep)
                got = topo.collective_time_batch(c, sizes, scope, mp, dp, pp,
                                                 ep)
                assert np.array_equal(got, want), (c, scope, mp, dp, pp, ep)
                for size in sizes:
                    assert topo.collective_time(c, size, scope, mp, dp, pp,
                                                ep) == ref_topo.collective_time(
                        c, size, scope, mp, dp, pp, ep)
