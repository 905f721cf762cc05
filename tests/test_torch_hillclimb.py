"""The hillclimb sweep over the port's dry run
(``repro_torch.launch.hillclimb``) against ``experiments/hillclimb_run.py``.

* The 22 variants: the reference's names, and each transform gives the
  config and memory plan the reference's gives (its functions and its
  table are taken from the script's source without running the script,
  which parses ``sys.argv`` and sets ``XLA_FLAGS`` at import).
* On the debug mesh (2 data, 2 model) with the reduced smollm-135m at 3
  query heads (one KV head), so that its attention is replicated over the
  model axis: ``baseline,remat-blocks,micro8,bshard`` write four JSONs
  with ``variant``, ``wall_s`` and the dry run's keys; ``remat-blocks`` and
  ``micro8`` change ``remat`` and ``microbatches``; ``bshard`` halves the
  attention kernels' counted FLOPs and adds the gathered rows' bytes to the
  all-gathers. Unknown names exit, naming the available ones.
* In a fresh interpreter, on the production mesh (16 x 16): smollm-135m's
  train_4k ``baseline`` against the reference's own record
  (``experiments/hillclimb/smollm-135m_train_4k_baseline.json``), then
  ``bshard-micro16``, which raises (one row a data rank does not split
  over 16 model ranks) and leaves the baseline's file; neither ``jax`` nor
  ``repro`` is loaded (~15 s).
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs import get_config as get_config_jax
from repro.parallel.policy import MemoryPlan as MemoryPlanJax
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.parallel.policy import MemoryPlan
from test_torch_dryrun import KEYS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "experiments", "hillclimb_run.py")
RECORD = os.path.join(REPO, "experiments", "hillclimb",
                      "smollm-135m_train_4k_baseline.json")


def _reference_variants() -> dict:
    """The script's transforms and ``VARIANTS`` table, evaluated from its
    source alone (its imports of the JAX package's runner and dry run, and
    its run, left out)."""
    tree = ast.parse(open(SCRIPT).read())
    keep = [node for node in tree.body
            if isinstance(node, ast.FunctionDef)
            or (isinstance(node, ast.Assign)
                and [ast.unparse(t) for t in node.targets] == ["VARIANTS"])]
    namespace = {"dataclasses": dataclasses}
    exec(compile(ast.Module(body=keep, type_ignores=[]), SCRIPT, "exec"),
         namespace)
    return namespace["VARIANTS"]


def _apply(t, x):
    return x if t is None else t(x)


def test_the_variants_are_the_references():
    ref = _reference_variants()
    assert list(hillclimb.VARIANTS) == list(ref) and len(ref) == 22
    cfg_j, cfg = (get_config_jax("granite-moe-3b-a800m"),
                  get_config("granite-moe-3b-a800m"))
    plan_j = MemoryPlanJax(1, "float32", True, "dots", 0.0, 1)
    plan = MemoryPlan(1, "float32", True, "dots", 0.0, 1)
    for name, (cfg_t, plan_t) in hillclimb.VARIANTS.items():
        ref_cfg_t, ref_plan_t = ref[name]
        got, want = _apply(cfg_t, cfg), _apply(ref_cfg_t, cfg_j)
        assert ((got.attn_batch_shard, got.moe.dispatch,
                 got.moe.capacity_factor)
                == (want.attn_batch_shard, want.moe.dispatch,
                    want.moe.capacity_factor)), name
        assert (dataclasses.asdict(_apply(plan_t, plan))
                == dataclasses.asdict(_apply(ref_plan_t, plan_j))), name


@pytest.fixture
def debug_cell(monkeypatch):
    """The dry run on a (2 data, 2 model) mesh with the reduced smollm at 3
    query heads (one KV head): its attention is replicated over the model
    axis. Returns the attention kernels' counted FLOPs of each lowered
    variant, in order."""
    reduced = dataclasses.replace(get_config("smollm-135m", reduced=True),
                                  num_heads=3, num_kv_heads=1)
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: make_debug_mesh(2, 2))
    monkeypatch.setattr(dryrun, "get_config", lambda arch: reduced)
    core, lower = [], dryrun.lower_cell

    def counted(*args, **kwargs):
        counter, info = lower(*args, **kwargs)
        core.append(sum(row[1] for op, row in counter.by_op.items()
                        if op.startswith("repro_torch.flash_attention")))
        return counter, info
    monkeypatch.setattr(dryrun, "lower_cell", counted)
    return reduced, core


def test_four_variants_on_the_debug_mesh(debug_cell, tmp_path, capsys):
    cfg, core = debug_cell
    names = ["baseline", "remat-blocks", "micro8", "bshard"]
    res = hillclimb.main(["smollm-135m:train_4k", ",".join(names),
                          "--out", str(tmp_path)])
    assert len(res) == 4
    info = {n: json.loads((tmp_path / f"smollm-135m_train_4k_{n}.json")
                          .read_text()) for n in names}
    for n in names:
        assert KEYS | {"variant", "wall_s"} <= set(info[n])
        assert info[n]["variant"] == n and info[n]["wall_s"] > 0
        assert (info[n]["chips"], info[n]["mesh"]) == (4, "2x2")
    out = capsys.readouterr().out
    assert all(f"smollm-135m_train_4k_{n}: compute=" in out for n in names)
    base = info["baseline"]
    assert (base["remat"], base["microbatches"]) == ("dots", 1)
    assert info["remat-blocks"]["remat"] == "blocks"
    assert info["micro8"]["microbatches"] == 8
    # bshard: each of the 2 model ranks attends over half the rows, and
    # each layer all-gathers the attention's (b, s, d) bf16 output in the
    # forward and in the remat's recompute, and its input's gradient in
    # the backward; the baseline all-gathers the replicated weights'
    # gradients instead (each rank computes its block of their rows)
    assert core[3] == core[0] / 2 and core[0] > 0
    shape = SHAPES["train_4k"]
    rows = shape.global_batch // 2 * shape.seq_len * cfg.d_model
    grown = (info["bshard"]["coll_breakdown"]["all-gather"]
             - base["coll_breakdown"]["all-gather"])
    weights = cfg.num_layers * 2 * cfg.d_model * cfg.resolved_head_dim * 2 * (
        cfg.num_heads + cfg.num_kv_heads)
    assert grown == cfg.num_layers * 3 * rows * 2 - weights
    assert info["bshard"]["flops"] < base["flops"]
    assert info["bshard"]["model_flops"] == base["model_flops"]


def test_unknown_variants_exit_naming_the_available(tmp_path):
    with pytest.raises(SystemExit, match=r"unknown variant\(s\) \['nope'\]"
                       r".*available: .*'bshard-micro16'"):
        hillclimb.main(["smollm-135m:train_4k", "baseline,nope",
                        "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_the_production_baseline_against_the_references_record(tmp_path):
    """A fresh interpreter: the 16 x 16 smollm-135m train_4k baseline,
    then ``bshard-micro16``, which raises and leaves the baseline's file;
    no ``jax`` or ``repro`` module loaded. The record's shared keys equal
    the reference's record (its counted terms differ: the op counter is
    not XLA's HLO walk; ``PERF.md`` sets them side by side)."""
    code = textwrap.dedent(f"""
        import sys
        from repro_torch.launch import hillclimb
        try:
            hillclimb.main(["smollm-135m:train_4k", "baseline,bshard-micro16",
                            "--out", {str(tmp_path)!r}])
        except ValueError as err:
            print("raised:", err)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "smollm-135m_train_4k_baseline: compute=" in out.stdout
    assert ("raised: attn_batch_shard: the local batch (1, 4096, 576) has "
            "1 rows, which do not divide over 16 model ranks") in out.stdout
    assert [p.name for p in tmp_path.iterdir()] == [
        "smollm-135m_train_4k_baseline.json"]
    got = json.loads((tmp_path / "smollm-135m_train_4k_baseline.json")
                     .read_text())
    want = json.loads(open(RECORD).read())
    assert KEYS | {"variant", "wall_s"} <= set(got)
    for key in ("model_flops", "chips", "mesh", "zero_stage", "opt_dtype",
                "remat", "microbatches", "arch", "shape", "variant"):
        assert got[key] == want[key], key
    assert want["model_flops"] == 846295254171648.0
