"""repro_torch.parallel's rules against the JAX package's, in one process.

The sharding rules are pure functions of (config, path, shape, mesh axes):
the reference's are evaluated on ``jax.sharding.AbstractMesh`` and the
port's on ``MeshSpec``, with no devices, at every assigned architecture's
full widths (the reference's tree from ``jax.eval_shape``, the port's
parameters as fake tensors: shapes without storage). Held spec for spec:
``param_spec``, ``opt_state_spec``, ``batch_spec``, ``kv_cache_spec``, and
the port's placements of its per-layer tensors against the reference's
stacked specs. Also the int8 quantizer bit for bit, the mesh helpers, the
pipeline's bubble and the refusals that need no process group. The
multi-process checks are in ``tests/test_torch_distributed.py``.
"""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as get_config_jax
from repro.models import get_model as get_model_jax
from repro.parallel import compression as compression_jax
from repro.parallel import mesh as mesh_jax
from repro.parallel import pipeline as pipeline_jax
from repro.parallel import sharding as sharding_jax
from repro.parallel import zero as zero_jax
from repro.parallel.policy import MemoryPlan as MemoryPlanJax
from repro_torch.configs import get_config
from repro_torch.convert import reference_leaf
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import get_model
from repro_torch.parallel import (
    MeshSpec,
    batch_shardings,
    build_mesh,
    cache_shardings,
    dp_axes,
    dp_size,
    fsdp_axes,
    mp_size,
    opt_state_shardings,
    param_shardings,
)
from repro_torch.parallel import compression, pipeline, sharding, zero
from repro_torch.parallel.policy import MemoryPlan
from repro_torch.parallel.sharding import Placement
from repro_torch.train import init_train_state, shard_model, shard_train_state
from repro_torch.train import sharded_train_step

torch.set_num_threads(1)

ARCHS = ["smollm-135m", "chatglm3-6b", "minitron-8b", "internlm2-20b",
         "mamba2-780m", "granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
         "internvl2-76b", "zamba2-2.7b", "seamless-m4t-large-v2"]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# The families whose per-layer leaves the FSDP/ZeRO rule can give whole to
# one rank (it picks the stacked layer axis): found by the rules, held here.
LAYER_OWNED = {"mamba2-780m", "zamba2-2.7b"}


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), MeshSpec(sizes, axes)


def _plans(fsdp):
    zero_stage = 3 if fsdp else 1
    return (MemoryPlanJax(zero_stage, "float32", True, "dots", 0.0),
            MemoryPlan(zero_stage, "float32", True, "dots", 0.0))


@functools.lru_cache(maxsize=None)
def _reference_leaves(arch):
    """(path, stacked shape) of every leaf of the reference's full-width
    parameter tree."""
    cfg = get_config_jax(arch)
    mod = get_model_jax(cfg)
    shapes = jax.eval_shape(lambda: mod.init_params(
        jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return tuple((tuple(p.key for p in path), tuple(leaf.shape))
                 for path, leaf in flat)


@functools.lru_cache(maxsize=None)
def _fake_model(arch):
    """The port's full-width model as fake tensors (shapes, no storage)."""
    cfg = get_config(arch)
    with FakeTensorMode():
        return get_model(cfg)(cfg, dtype=torch.bfloat16, device="cpu")


def _port_params(arch):
    return dict(_fake_model(arch).named_parameters())


# ------------------------------------------------------------------------- #
# Parameter and optimizer-state specs
# ------------------------------------------------------------------------- #

@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_equal_reference(arch, mesh, fsdp):
    """Every leaf of the reference's tree: ``param_spec`` and
    ``opt_state_spec`` (ZeRO-1, or ZeRO-3 with fsdp) equal, entry for
    entry."""
    am, ms = _meshes(mesh)
    plan_j, plan_t = _plans(fsdp)
    cfg_j, cfg_t = get_config_jax(arch), get_config(arch)
    for path, shape in _reference_leaves(arch):
        want = tuple(sharding_jax.param_spec(cfg_j, path, shape, am, fsdp))
        assert sharding.param_spec(cfg_t, path, shape, ms, fsdp) == want, path
        want = tuple(zero_jax.opt_state_spec(cfg_j, path, shape, am, plan_j))
        assert zero.opt_state_spec(cfg_t, path, shape, ms, plan_t) == want, (
            path)


def _unstacked(spec, shape, layer, size_of):
    """What the port must hold for one layer of a stacked spec."""
    spec = tuple(spec)
    if layer is None:
        return Placement(spec, shape)
    (n, i), head = layer, spec[0]
    owner = None if head is None else (head, i // (n // size_of[head]))
    return Placement(spec[1:], shape, owner)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_port_placements_are_the_reference_specs_unstacked(arch, mesh, fsdp):
    """Each of the port's per-layer parameters: ``reference_leaf`` finds its
    stacked leaf (whose shape is the layers' count before the port's), and
    its parameter and optimizer-state placements are the reference's specs
    there without the layer axis; where that axis is sharded, the layer is
    held whole at the coordinate of its block."""
    am, ms = _meshes(mesh)
    plan_j, plan_t = _plans(fsdp)
    cfg_j, cfg = get_config_jax(arch), get_config(arch)
    by_path = dict(_reference_leaves(arch))
    params = _port_params(arch)
    p_sh = param_shardings(cfg, params, ms, fsdp=fsdp)
    o_sh = opt_state_shardings(cfg, params, ms, plan_t)
    assert set(p_sh) == set(o_sh) == set(params)
    covered = set()
    for name, t in params.items():
        path, layer = reference_leaf(cfg, name)
        shape = tuple(t.shape)
        stacked = shape if layer is None else (layer[0],) + shape
        assert by_path[path] == stacked, name
        covered.add(path)
        want_p = sharding_jax.param_spec(cfg_j, path, stacked, am, fsdp)
        want_o = zero_jax.opt_state_spec(cfg_j, path, stacked, am, plan_j)
        assert p_sh[name] == _unstacked(want_p, shape, layer, ms.shape), name
        assert o_sh[name] == _unstacked(want_o, shape, layer, ms.shape), name
    assert covered == set(by_path)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_axis_is_sharded_only_for_the_ssm_families(arch):
    """Whether the FSDP/ZeRO rule picks the stacked layer axis of any leaf
    on the meshes tested: mamba2 and zamba2 only (their per-layer head
    vectors, conv and norm leaves), and the port then holds each such layer
    whole on one coordinate of the data axis, as many layers on each."""
    cfg = get_config(arch)
    params = _port_params(arch)
    owned = []
    for mesh in MESHES:
        ms = MeshSpec(*MESHES[mesh])
        for fsdp in (False, True):
            placements = list(param_shardings(cfg, params, ms, fsdp).items())
            placements += opt_state_shardings(cfg, params, ms,
                                              _plans(fsdp)[1]).items()
            owned += [(mesh, name, pl.owner) for name, pl in placements
                      if pl.owner is not None]
    assert bool(owned) == (arch in LAYER_OWNED)
    for mesh, name, (axis, holder) in owned:
        assert axis == "data"
        size = MeshSpec(*MESHES[mesh]).shape["data"]
        layer = int(name.split(".")[1])
        assert holder == layer // (cfg.num_layers // size), (mesh, name)


# ------------------------------------------------------------------------- #
# Batches and caches
# ------------------------------------------------------------------------- #

BATCH_SHAPES = [(256, 4096), (32, 2048), (1, 524288), (3, 7), (16, 1),
                (512, 128, 64), (2, 30)]


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_equals_reference(mesh, seq_shard):
    am, ms = _meshes(mesh)
    for shape in BATCH_SHAPES:
        want = tuple(sharding_jax.batch_spec(am, shape, seq_shard))
        assert sharding.batch_spec(ms, shape, seq_shard) == want, shape
    batch = {"tokens": (1, 4096), "targets": (32, 2048)}
    cfg_j, cfg = get_config_jax("smollm-135m"), get_config("smollm-135m")
    want = sharding_jax.batch_shardings(
        am, {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in batch.items()},
        cfg_j)
    got = batch_shardings(ms, {k: torch.empty(v, dtype=torch.int32,
                                              device="meta")
                               for k, v in batch.items()}, cfg)
    assert got == {k: tuple(v.spec) for k, v in want.items()}


def _reference_cache(arch, batch, max_seq, src_len):
    cfg = get_config_jax(arch)
    mod = get_model_jax(cfg)
    kw = {"src_len": src_len} if cfg.family == "encdec" else {}
    return jax.eval_shape(lambda: mod.init_cache(cfg, batch, max_seq, **kw))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_equal_reference(arch, mesh):
    """The port's cache (fake tensors of ``init_cache``, the reference's
    layout) at a batch that divides over the data axes and at one sequence
    of a long context: ``cache_shardings`` against ``kv_cache_spec`` of the
    reference's cache, entry for entry; the clock replicated."""
    am, ms = _meshes(mesh)
    cfg_j, cfg = get_config_jax(arch), get_config(arch)
    model = _fake_model(arch)
    for batch, max_seq in ((32, 256), (1, 4096)):
        ref = _reference_cache(arch, batch, max_seq, 64)
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = (batch, max_seq, 64) if cfg.family == "encdec" else (
                batch, max_seq)
            cache = model.init_cache(*args)
        assert set(cache) == set(ref)
        got = cache_shardings(cfg, ms, cache)
        for name, leaf in ref.items():
            assert tuple(cache[name].shape) == tuple(leaf.shape), name
            if name == "pos" or leaf.ndim == 0:
                assert got[name] == (), name
            else:
                want = tuple(sharding_jax.kv_cache_spec(
                    cfg_j, am, name, tuple(leaf.shape)))
                assert got[name] == want, (name, batch)


# ------------------------------------------------------------------------- #
# Mesh helpers, the production meshes, the pipeline's bubble
# ------------------------------------------------------------------------- #

@pytest.mark.parametrize("mesh", list(MESHES) + ["8", "pipe4"])
def test_mesh_helpers_equal_reference(mesh):
    sizes, axes = MESHES.get(mesh, {"8": ((8,), ("data",)),
                                    "pipe4": ((4,), ("pipe",))}.get(mesh))
    am, ms = AbstractMesh(sizes, axes), MeshSpec(sizes, axes)
    assert dp_axes(ms) == mesh_jax.dp_axes(am)
    assert dp_size(ms) == mesh_jax.dp_size(am)
    assert mp_size(ms) == mesh_jax.mp_size(am)
    assert fsdp_axes(ms) == mesh_jax.fsdp_axes(am)
    assert ms.shape == dict(am.shape)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_is_the_reference_shape(multi_pod):
    """``make_production_mesh`` is a ``MeshSpec`` (no process group), of
    the axes and sizes the reference's mesh has."""
    ms = launch_mesh.make_production_mesh(multi_pod=multi_pod)
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert ms == MeshSpec(sizes, axes)
    assert launch_mesh.make_debug_mesh(4, 2) == MeshSpec((4, 2),
                                                         ("data", "model"))


def test_build_mesh_raises_without_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        build_mesh((1, 1), ("data", "model"), "cpu")


@pytest.mark.parametrize("stages,micro", [(4, 8), (2, 1), (8, 32), (1, 4)])
def test_bubble_fraction_equals_reference(stages, micro):
    assert pipeline.bubble_fraction(stages, micro) == (
        pipeline_jax.bubble_fraction(stages, micro))


# ------------------------------------------------------------------------- #
# int8 compression
# ------------------------------------------------------------------------- #

def _inputs(case):
    rs = np.random.RandomState(7)
    if case == "normal":
        return (rs.randn(256) * 3.0).astype(np.float32)
    if case == "extremes":
        return np.array([-4.0, 0.0, 4.0], np.float32)
    if case == "zeros":
        return np.zeros(8, np.float32)
    if case == "halves":        # x / scale lands on .5: round half to even
        return np.array([127.0, 0.5, 1.5, 2.5, -3.5, -0.5], np.float32)
    return (rs.randn(8, 64) * np.exp(rs.randn(8, 1))).astype(np.float32)


@pytest.mark.parametrize("case", ["normal", "extremes", "zeros", "halves",
                                  "wide"])
def test_quantize_int8_equals_reference_bitwise(case):
    x = _inputs(case)
    qj, sj = compression_jax.quantize_int8(jnp.asarray(x))
    q, s = compression.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert s.item() == float(sj)
    back = compression.dequantize_int8(q, s)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(compression_jax.dequantize_int8(qj, sj)))


@pytest.mark.parametrize("dtype,jdtype", [
    (torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32),
    (torch.float16, jnp.float16)])
def test_compression_ratio_equals_reference(dtype, jdtype):
    assert compression.compression_ratio(dtype) == (
        compression_jax.compression_ratio(jdtype))


# ------------------------------------------------------------------------- #
# The mapping to the reference's tree, and refusals before any step
# ------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,name,path,layer", [
    ("smollm-135m", "embed", ("embed",), None),
    ("smollm-135m", "layers.3.attn.wq", ("layers", "attn", "wq"), (30, 3)),
    ("smollm-135m", "layers.29.ln2", ("layers", "ln2"), (30, 29)),
    ("smollm-135m", "layers.7.ffn.wd", ("dense_ffn", "wd"), (30, 7)),
    ("llama4-maverick-400b-a17b", "layers.1.moe.shared.wu",
     ("moe", "shared", "wu"), (24, 0)),
    ("llama4-maverick-400b-a17b", "layers.2.ffn.wg", ("dense_ffn", "wg"),
     (24, 1)),
    ("mamba2-780m", "layers.47.A_log", ("layers", "A_log"), (48, 47)),
    ("seamless-m4t-large-v2", "decoder.5.cross_attn.wq",
     ("decoder", "cross_attn", "wq"), (24, 5)),
])
def test_reference_leaf(arch, name, path, layer):
    assert reference_leaf(get_config(arch), name) == (path, layer)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "llama4-maverick-400b-a17b"])
def test_moe_state_shards_over_the_model_axis(arch):
    """The MoE splits over the model axis as every family does: on a
    (1, 2) mesh of a fake group of two, as its rank 0, the reduced state
    takes each leaf's piece as ``param_shardings`` places it (the 4 experts
    2 a rank, EP; the router replicated; llama4's shared expert split as an
    FFN) and its moments their ZeRO-1 pieces, and every MoE layer is
    pointed at the model axis's group by experts."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.parallel.sharding import shard_shape
    cfg = get_config(arch, reduced=True)
    plan = MemoryPlan(1, "float32", True, "dots", 0.0)
    state = init_train_state(cfg, plan, torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
    want = param_shardings(cfg, state["params"],
                           MeshSpec((1, 2), ("data", "model")))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = build_mesh((1, 2), ("data", "model"), "cpu")
        state = shard_train_state(cfg, plan, state, mesh)
        moes = [layer.moe for layer in state["model"].layers
                if hasattr(layer, "moe")]
        pointed = [(m.tp_group is not None, m.we_up.shape[0])
                   for m in moes]
        shared = [m.shared.tp_group is not None for m in moes
                  if hasattr(m, "shared")]
    finally:
        dist.destroy_process_group()
    sh = state["shardings"]
    assert sh["params"] == want
    for name, p in state["params"].items():
        assert tuple(p.shape) == shard_shape(want[name], mesh), name
    for name, t in state["opt"]["m"].items():
        assert tuple(t.shape) == shard_shape(sh["opt"]["m"][name], mesh), name
    layer = cfg.moe.moe_every - 1
    assert sh["params"][f"layers.{layer}.moe.we_up"].spec == (
        "model", None, None)
    assert sh["params"][f"layers.{layer}.moe.we_down"].spec == (
        "model", None, None)
    assert sh["params"][f"layers.{layer}.moe.router"].spec == (None, None)
    assert tuple(state["params"][f"layers.{layer}.moe.we_up"].shape) == (
        2, cfg.d_model, cfg.moe.d_ff)
    assert pointed == [(True, 2)] * (cfg.num_layers // cfg.moe.moe_every)
    assert shared == ([True] * len(moes) if cfg.moe.shared_expert else [])


def test_sharded_step_needs_a_device_mesh():
    """A ``MeshSpec`` has no processes behind it: the sharded step and the
    sharding of a state refuse it rather than run as one process."""
    cfg = get_config("smollm-135m", reduced=True)
    plan = MemoryPlan(1, "float32", True, "dots", 0.0)
    mesh = MeshSpec((1, 1), ("data", "model"))
    with pytest.raises(TypeError, match="build_mesh"):
        sharded_train_step(cfg, plan, mesh)
    state = init_train_state(cfg, plan, torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
    with pytest.raises(TypeError, match="build_mesh"):
        shard_train_state(cfg, plan, state, mesh)


def test_zero3_of_the_ssm_family_raises_before_any_step():
    """The ssm family runs ZeRO-3 (the gloo cases in
    ``tests/test_torch_distributed_ssm.py``). A one-row batch over two data
    ranks (a fake group of two): ``shard_model`` takes it for serving, each
    data rank running the whole row (its caches may split along the
    sequence over the data axis: ``tests/test_torch_distributed_long.py``),
    every parameter given its ZeRO-3 piece. The sharded train step over it
    splits the row's sequence over the data ranks (the numbers on gloo
    ranks: ``tests/test_torch_distributed_seq.py``); a row whose blocks
    would be shorter than the conv's halo raises before any step, every
    parameter as it was."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.parallel import build_mesh
    cfg = get_config("mamba2-780m", reduced=True)
    plan = dataclasses.replace(MemoryPlan(1, "float32", True, "dots", 0.0),
                               zero_stage=3)
    make = lambda: get_model(cfg)(cfg, dtype=torch.float32, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = build_mesh((2, 1), ("data", "model"), "cpu")
        model = make()
        names = {n for n, _ in model.named_parameters()}
        assert set(shard_model(cfg, plan, model, mesh, batch_rows=1)) == names
        state = init_train_state(cfg, plan, torch.Generator().manual_seed(0),
                                 dtype=torch.float32, device="cpu")
        state = shard_train_state(cfg, plan, state, mesh)
        step = sharded_train_step(cfg, plan, mesh)
        before = {n: p.detach().clone() for n, p in state["params"].items()}
        short = torch.zeros((1, 4), dtype=torch.long)    # blocks of 2 rows
        with pytest.raises(ValueError, match="shorter than the conv's halo"):
            step(state, {"tokens": short, "targets": short})
        assert all(torch.equal(p.detach(), before[n])
                   for n, p in state["params"].items())
        assert state["model"].seq_block is None
        toks = torch.zeros((1, 16), dtype=torch.long)
        _, metrics = step(state, {"tokens": toks, "targets": toks})
        assert set(metrics) >= {"loss", "grad_norm"}
    finally:
        dist.destroy_process_group()
