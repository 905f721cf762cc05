"""COMET's measured frontend in the port: ``repro_torch.launch.specs`` and
``repro_torch.launch.dryrun``, on the CPU.

* ``input_specs``, ``abstract_params``, ``abstract_cache`` and
  ``model_flops`` against the JAX package's ``repro.launch.specs``: every
  runnable cell's inputs shape for shape and dtype for dtype, every
  assigned arch's parameters leaf for leaf (through ``convert``'s naming;
  both sides abstract, so full size is cheap), every serving cell's cache,
  and ``model_flops`` exactly for all 40 cells.
* ``lower_cell`` on a (2 data, 2 model) fake group with the reduced
  configs: every family's cells are ``ok`` with the reference's JSON
  keys (long_500k's one-row batch served whole on every data rank, its
  cache split along the sequence where the data axis divides it), a
  refusal names its ROADMAP item, and no process group is left behind. The CLI on one full-size cell of the
  production mesh, in a fresh interpreter that never loads ``jax``.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import SHAPES as SHAPES_JAX
from repro.configs import all_cells as all_cells_jax
from repro.configs import get_config as get_config_jax
from repro.launch import specs as specs_jax
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, all_cells, get_config
from repro_torch.convert import to_jax_params
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_debug_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a, s, runnable, _ in all_cells() if runnable]
ALL_CELLS = [(a, s) for a, s, _, _ in all_cells()]
SERVING_CELLS = [(a, s) for a, s in CELLS if SHAPES[s].kind != "train"]
DENSE = [a for a in ASSIGNED_ARCHS if get_config(a).family == "dense"]

_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
           jnp.float32: torch.float32}


def _sds(x):
    return tuple(x.shape), _DTYPES[x.dtype.type]


def _meta(t):
    assert t.device.type == "meta"
    return tuple(t.shape), t.dtype


def test_cells_match_the_reference():
    """32 runnable cells of 40, the reference's (the registries list the
    archs in another order)."""
    assert ({c[:3] for c in all_cells()}
            == {c[:3] for c in all_cells_jax()})
    assert len(CELLS) == 32 and len(ALL_CELLS) == 40


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    want = specs_jax.input_specs(get_config_jax(arch), SHAPES_JAX[shape])
    got = specs.input_specs(get_config(arch), SHAPES[shape])
    assert ({k: _meta(v) for k, v in got.items()}
            == {k: _sds(v) for k, v in want.items()})


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_abstract_params_match_the_reference(arch):
    """``jax.eval_shape`` of ``init_params`` against the port's meta
    parameters carried to the reference's stacked tree by ``convert``."""
    want = _flat(specs_jax.abstract_params(get_config_jax(arch)))
    params = specs.abstract_params(get_config(arch))
    assert all(p.device.type == "meta" for p in params.values())
    got = _flat(to_jax_params(params, get_config(arch)))
    assert ({k: _meta(v) for k, v in got.items()}
            == {k: _sds(v) for k, v in want.items()})


@pytest.mark.parametrize("arch,shape", SERVING_CELLS)
def test_abstract_cache_matches_the_reference(arch, shape):
    want = specs_jax.abstract_cache(get_config_jax(arch), SHAPES_JAX[shape])
    got = specs.abstract_cache(get_config(arch), SHAPES[shape])
    assert ({k: _meta(v) for k, v in got.items()}
            == {k: _sds(v) for k, v in want.items()})


@pytest.mark.parametrize("arch,shape", ALL_CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    assert (specs.model_flops(get_config(arch), SHAPES[shape])
            == specs_jax.model_flops(get_config_jax(arch), SHAPES_JAX[shape]))


# ------------------------------------------------------------------------- #
# lower_cell on a debug mesh
# ------------------------------------------------------------------------- #

KEYS = {"flops", "hbm_bytes", "coll_bytes", "chips", "compute_s",
        "memory_s", "collective_s", "dominant", "roofline_fraction",
        "model_flops", "model_flops_util", "coll_breakdown",
        "memory_analysis", "arch", "shape", "mesh", "zero_stage",
        "opt_dtype", "remat", "microbatches", "trace_s"}


@pytest.fixture(autouse=True)
def _debug_mesh(monkeypatch):
    """The dry run's production mesh replaced by a (2 data, 2 model) one."""
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: make_debug_mesh(2, 2))


def _lower(arch, shape):
    return dryrun.lower_cell(
        arch, shape, cfg_transform=lambda _: get_config(arch, reduced=True))


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_dense_cells_are_ok(arch, shape):
    """The reduced dense configs at the cells' shapes on a (2, 2) fake
    group: the reference's keys, the memory analysis, collectives on the
    model axis (the embedding, attention and FFN outputs summed), the
    group gone afterwards."""
    counter, info = _lower(arch, shape)
    assert not dist.is_initialized()
    assert KEYS <= set(info)
    assert set(info["memory_analysis"]) == {"argument_bytes",
                                            "output_bytes", "temp_bytes"}
    assert (info["chips"], info["mesh"]) == (4, "2x2")
    assert info["flops"] == counter.cost.flops * 4
    assert info["flops"] > 0 and info["hbm_bytes"] > 0
    assert info["coll_breakdown"]["all-reduce"] > 0
    assert info["model_flops"] == specs.model_flops(
        get_config(arch, reduced=True), SHAPES[shape])
    assert counter.peak_bytes >= info["memory_analysis"]["argument_bytes"]
    json.dumps(info)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_ssm_and_hybrid_cells_are_ok(arch, shape):
    """The reduced mamba2 and zamba2 split over the (2, 2) fake group (8
    SSD heads, 4 a rank; zamba2's shared block 2 heads a rank): the checks
    of ``test_dense_cells_are_ok``, the model axis's all-reduces (the
    blocks' outputs, the gated norm's sums of squares) among them."""
    test_dense_cells_are_ok(arch, shape)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-76b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_encdec_and_vlm_cells_are_ok(arch, shape):
    """The reduced seamless and internvl2 split over the (2, 2) fake group
    (2 heads and one KV head a rank; the encdec's cross K/V projected and
    cached on them, the VLM's patches ahead of the split vocabulary): the
    checks of ``test_dense_cells_are_ok``."""
    test_dense_cells_are_ok(arch, shape)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_moe_cells_are_ok(arch, shape):
    """The reduced granite-moe and llama4-maverick split over the (2, 2)
    fake group (4 experts, 2 a rank: EP; llama4's shared expert split as
    an FFN): the checks of ``test_dense_cells_are_ok``. A training step
    and a prefill route the global microbatch over the data axis: each MoE
    layer all-gathers the ranks' combine matrices, (t, e) fp32."""
    test_dense_cells_are_ok(arch, shape)
    counter, _ = _lower(arch, shape)
    cfg = get_config(arch, reduced=True)
    gathers = counter.by_op.get("c10d._allgather_base_", [0])[0]
    if SHAPES[shape].kind == "decode":
        assert gathers == 1                       # the logits' blocks
    else:
        assert gathers >= cfg.num_layers // cfg.moe.moe_every


# The cells that refused until item 13's first half (serving a batch that
# does not divide over the data ranks): ``items``, what they waited for.
REFUSED = [("mamba2-780m", "long_500k", [13]),
           ("zamba2-2.7b", "long_500k", [13])]


def _cache_of(rows_less: int):
    """``abstract_cache`` with ``rows_less`` fewer rows than the cell's."""
    def cache(cfg, shape, dtype, model):
        return specs.abstract_cache(
            cfg, dataclasses.replace(shape, seq_len=shape.seq_len - rows_less),
            dtype, model)
    return cache


@pytest.mark.parametrize("arch,shape,items", REFUSED)
def test_other_families_are_refused_naming_their_item(arch, shape, items,
                                                      monkeypatch):
    """The long_500k cells, which refused naming item 13 until its serving
    half, trace ``ok`` on the (2, 2) fake group: one row served whole on
    both data ranks. The cell's cache of 524,289 rows (the prompt and one
    more, as the reference sizes it) does not divide over the data axis, so
    ``kv_cache_spec`` keeps it whole and the tick gathers the logits' blocks
    and mamba's conv channels alone; at 524,288 rows zamba2's shared-block
    cache splits along its sequence and each application of the block adds
    one all-gather, the combine's: its rows' partial output and
    log-sum-exp, (2 ranks, 1, 2 heads, 1, head_dim + 1) fp32."""
    assert items == [13]
    counter, info = _lower(arch, shape)
    assert not dist.is_initialized()
    assert KEYS <= set(info) and info["flops"] > 0
    cfg = get_config(arch, reduced=True)
    gathers = counter.by_op["c10d._allgather_base_"][0]
    monkeypatch.setattr(dryrun, "abstract_cache", _cache_of(1))
    split, _ = _lower(arch, shape)
    groups = (cfg.num_layers // cfg.hybrid.attn_every
              if cfg.family == "hybrid" else 0)
    assert split.by_op["c10d._allgather_base_"][0] == gathers + groups
    combine = 2 * 2 * (cfg.resolved_head_dim + 1) * 4
    assert (split.cost.coll["all-gather"]
            == counter.cost.coll["all-gather"] + groups * combine)


def _one_row_microbatches(monkeypatch):
    """Plans that cut the global batch into microbatches of one row, which
    do not divide over the 32 data ranks of the 2 x 16 x 16 mesh."""
    plan_memory = dryrun.plan_memory
    monkeypatch.setattr(dryrun, "plan_memory", lambda cfg, tp, dp, shape: (
        dataclasses.replace(plan_memory(cfg, tp=tp, dp=dp, shape=shape),
                            microbatches=shape.global_batch)))


def test_a_refused_cell_is_recorded_as_the_reference_records_an_error(
        tmp_path, monkeypatch):
    """A cell that fails inside its fake group (here a training cell whose
    trace raises, naming a ROADMAP item, as a refusal does) is recorded as
    the reference records a failed cell: its status, the error and the
    mesh in the cell's JSON, and no process group left behind."""
    monkeypatch.undo()                   # the production mesh

    def refuse(*args, **kwargs):
        raise NotImplementedError("waits for ROADMAP Queue 1 item 13")

    monkeypatch.setattr(dryrun, "_train_cell", refuse)
    info = dryrun.run_cell("granite-moe-3b-a800m", "train_4k", True,
                           str(tmp_path))
    saved = json.loads((tmp_path / "granite-moe-3b-a800m_train_4k_2x16x16"
                                   ".json").read_text())
    assert saved["status"] == info["status"] == "error"
    assert "ROADMAP Queue 1 item 13" in saved["error"]
    assert saved["error"].startswith("NotImplementedError")
    assert saved["mesh"] == "2x16x16"
    assert not dist.is_initialized()


def _one_row_cell(arch, monkeypatch):
    """``arch``'s train_4k cell of one-row microbatches on 2 x 16 x 16 at
    full width, 2 layers and 16 of the 256 rows, so that it traces in
    seconds: it traces ``ok``, each microbatch's 4,096 positions split over
    the 16 data ranks, something all-gathered over the data axis."""
    monkeypatch.undo()
    _one_row_microbatches(monkeypatch)
    monkeypatch.setitem(dryrun.SHAPES, "train_4k", dataclasses.replace(
        SHAPES["train_4k"], global_batch=16))
    counter, info = dryrun.lower_cell(
        arch, "train_4k", True,
        cfg_transform=lambda cfg: dataclasses.replace(cfg, num_layers=2))
    assert info["mesh"] == "2x16x16" and info["microbatches"] == 16
    assert KEYS <= set(info) and info["flops"] > 0
    assert counter.by_op["c10d._allgather_base_"][0] > 0
    assert not dist.is_initialized()


def test_a_one_row_microbatch_splits_along_the_sequence(tmp_path,
                                                        monkeypatch):
    """The mamba2 cell of one-row microbatches, which refused until item
    13's second half (``_one_row_cell``): the blocks' halos and SSD states
    all-gathered over the data axis."""
    _one_row_cell("mamba2-780m", monkeypatch)


def test_a_one_row_moe_microbatch_splits_along_the_sequence(monkeypatch):
    """granite-moe's cell of one-row microbatches, the dry run's last
    refusal until item 13's remainder (``_one_row_cell``): its experts
    route the 16 blocks as one microbatch, the combine matrix all-gathered
    over the data axis."""
    _one_row_cell("granite-moe-3b-a800m", monkeypatch)


def test_lower_cell_refuses_a_process_that_holds_a_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        with pytest.raises(RuntimeError, match="holds one already"):
            _lower("smollm-135m", "train_4k")
    finally:
        dist.destroy_process_group()


def test_the_dense_step_counts_its_activations_collectives():
    """At (2, 2) with ZeRO-1, fp32 moments and the reduced smollm's 4
    heads and 2 KV heads split one pair a rank: the decode step's
    collectives are the model axis's all-reduces of the embedding, every
    attention and every FFN output ((b / 2) x d each, bf16), then the
    all-gather of the vocabulary blocks of the logits."""
    cfg = get_config("smollm-135m", reduced=True)
    counter, info = _lower("smollm-135m", "decode_32k")
    b = SHAPES["decode_32k"].global_batch // 2
    act = b * 1 * cfg.d_model * 2
    assert counter.cost.coll == {
        "all-reduce": (1 + 2 * cfg.num_layers) * act,
        "all-gather": b * cfg.padded_vocab * 2}
    assert counter.by_op["c10d.allreduce_"][0] == 1 + 2 * cfg.num_layers


def test_the_cli_writes_a_cell_without_loading_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch smollm-135m --shape
    decode_32k`` on the production mesh, in a fresh interpreter: the JSON
    of the cell, and neither ``jax`` nor ``repro`` in ``sys.modules``."""
    code = textwrap.dedent(f"""
        import sys
        from repro_torch.launch import dryrun
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                     "--out", {str(tmp_path)!r}])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    info = json.loads((tmp_path / "smollm-135m_decode_32k_16x16.json")
                      .read_text())
    assert info["status"] == "ok" and KEYS <= set(info)
    assert (info["chips"], info["zero_stage"]) == (256, 1)
    assert " ok dom=" in out.stdout
    np.testing.assert_allclose(
        info["memory_s"], info["hbm_bytes"] / (256 * 3.35e12))
