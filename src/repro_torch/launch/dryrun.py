"""Multi-pod dry run: trace every (arch x shape x mesh) cell on ``meta``.

Counterpart of ``src/repro/launch/dryrun.py``, which lowers and compiles
each cell for a 512-device XLA host mesh. Here, for each cell:

  1. the process joins a fake process group of 256 (single pod, 16 x 16) or
     512 (two pods, 2 x 16 x 16) ranks as rank 0, and builds the production
     mesh over it (``parallel.build_mesh(..., device_type="cpu")``);
  2. rank 0's state is laid out as ``meta`` shards: the whole model is built
     on ``meta`` (nothing drawn, ``launch/specs.py``) and sharded by the
     port's rules (``train.shard_train_state`` / ``train.shard_model``, the
     plan from ``parallel.plan_memory`` as in the reference); a serving
     cell's cache takes the shapes ``parallel.sharding.shard_shape`` gives
     its placements (``cache_shardings``), and a batch that does not divide
     over the data ranks (long_500k's one row) runs whole on every rank,
     the caches the rules split along the sequence holding a block each
     (``split_caches``), and a train step's microbatch whose rows do not
     divide splits its sequence over the data axis (every family);
  3. one step runs under the op counter (``core/op_counter.py``): the
     sharded train step (``train_4k``), the split prefill (``prefill_32k``)
     or a decode step (``decode_32k``, ``long_500k``), every collective on
     the fake group (it moves nothing and returns at once);
  4. the group is destroyed, and the counts become the three roofline
     terms at the H100's rates (``core/hlo.py``), with the peak live bytes
     as ``memory_analysis`` — into ``experiments/dryrun_torch/*.json``.

A cell the port cannot shard raises naming its ROADMAP item, and is
recorded as the reference records a failed cell (``status: "error"``);
every runnable cell of the registry traces.
Importing this module joins no group and sets nothing; ``lower_cell``
refuses to run in a process that holds a process group already.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, all_cells, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.hlo import PEAK_FLOPS, model_flops_util, terms_from_counts
from repro_torch.core.op_counter import OpCounter
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (
    abstract_cache,
    abstract_model,
    input_specs,
    model_flops,
)
from repro_torch.parallel import build_mesh, plan_memory
from repro_torch.parallel.sharding import (
    Placement,
    batch_spec,
    cache_shardings,
    shard_shape,
    split_caches,
)
from repro_torch.train import (
    init_train_state,
    shard_model,
    shard_train_state,
    sharded_train_step,
)

# The fake process group is an internal module of PyTorch's test suite:
# pinned here, imported only when a cell is lowered.
FAKE_PG_MODULE = "torch.testing._internal.distributed.fake_pg"
DTYPE = torch.bfloat16          # the reference's abstract params and cache


def _join_fake_group(world: int) -> None:
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            "lower_cell joins a fake process group of its own; this process "
            "holds one already (run the dry run in a process of its own)")
    fake_pg = __import__(FAKE_PG_MODULE, fromlist=["FakeStore"])
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=world)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _local(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A fresh ``meta`` tensor of this rank's piece of ``t`` under ``spec``."""
    return _meta(shard_shape(Placement(tuple(spec), tuple(t.shape)), mesh),
                 t.dtype)


def _train_cell(cfg: ModelConfig, plan, shape: ShapeConfig, mesh):
    state = init_train_state(cfg, plan, dtype=DTYPE, device="meta")
    state = shard_train_state(cfg, plan, state, mesh)
    batch = input_specs(cfg, shape)          # every rank passes the whole
    step = sharded_train_step(cfg, plan, mesh)
    args = ({"params": state["params"], "opt": state["opt"]}, batch)
    with OpCounter(hold=args) as counter:
        _, metrics = step(state, batch)
    return counter, metrics


def _serving_cell(cfg: ModelConfig, plan, shape: ShapeConfig, mesh):
    model = abstract_model(cfg, DTYPE)
    whole_cache = abstract_cache(cfg, shape, DTYPE, model)
    shard_model(cfg, plan, model, mesh, batch_rows=shape.global_batch)
    specs = cache_shardings(cfg, mesh, whole_cache)
    rows = batch_spec(mesh, (shape.global_batch,))
    cache = {name: _local(t, rows if name == "pos" else specs[name], mesh)
             for name, t in whole_cache.items()}
    cache.update(split_caches(mesh, specs))
    del whole_cache
    # each rank's rows; a batch that does not divide runs whole on every
    # rank (a prefill then takes the rank's block of the prompt itself)
    batch = {k: _local(v, batch_spec(mesh, tuple(v.shape)), mesh)
             for k, v in input_specs(cfg, shape).items()}
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    args = (dict(model.named_parameters()), cache, batch)
    with OpCounter(hold=args) as counter, torch.no_grad():
        if shape.kind == "prefill":
            out = model.prefill(batch["tokens"], cache, **extras)
        else:
            out = model.decode_step(cache, batch["tokens"])
    return counter, out


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               remat_override: Optional[str] = None,
               cfg_transform=None, plan_transform=None):
    """Trace one cell under the op counter. Returns (counter, info dict).

    ``cfg_transform`` / ``plan_transform`` are the reference's hillclimb
    hooks: they rewrite the ModelConfig / MemoryPlan for a variant before
    the trace (e.g. MoE dispatch mode, remat policy, microbatch count)."""
    cfg = get_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    shape = SHAPES[shape_name]
    spec = make_production_mesh(multi_pod=multi_pod)
    chips = math.prod(spec.sizes)
    tp = spec.shape["model"]
    dp = chips // tp
    plan = plan_memory(cfg, tp=tp, dp=dp, shape=shape)
    if plan_transform is not None:
        plan = plan_transform(plan)
    if remat_override is not None:
        plan = dataclasses.replace(plan, remat=remat_override)

    _join_fake_group(chips)
    try:
        mesh = build_mesh(spec.sizes, spec.axis_names, device_type="cpu")
        t0 = time.monotonic()
        if shape.kind == "train":
            counter, outputs = _train_cell(cfg, plan, shape, mesh)
        else:
            counter, outputs = _serving_cell(cfg, plan, shape, mesh)
        trace_s = time.monotonic() - t0
    finally:
        dist.destroy_process_group()

    info = analyze(counter, cfg, shape, chips, outputs)
    info.update({
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(n) for n in spec.sizes),
        "chips": chips, "zero_stage": plan.zero_stage,
        "opt_dtype": plan.opt_dtype, "remat": plan.remat,
        "microbatches": plan.microbatches,
        "trace_s": round(trace_s, 3),
    })
    return counter, info


def analyze(counter: OpCounter, cfg: ModelConfig, shape: ShapeConfig,
            chips: int, outputs=None, dtype: torch.dtype = DTYPE) -> Dict:
    """Roofline terms and the memory analysis from a counted step: the
    counter's per-device cost times ``chips``, at the H100's peak for the
    step's compute ``dtype``."""
    cost = counter.cost
    terms = terms_from_counts(cost, chips, peak_flops=PEAK_FLOPS[dtype])
    mf = model_flops(cfg, shape)
    info = terms.as_dict()
    info["model_flops"] = mf
    info["model_flops_util"] = model_flops_util(mf, terms)
    info["coll_breakdown"] = {k: v for k, v in terms.coll_breakdown.items()
                              if v}
    info["memory_analysis"] = counter.memory(outputs)
    return info


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str) -> Dict:
    tag = f"{arch}_{shape_name}_{'2x16x16' if multi_pod else '16x16'}"
    try:
        _, info = lower_cell(arch, shape_name, multi_pod)
        info["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        info = {"arch": arch, "shape": shape_name,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(info, f, indent=1, default=str)
    return info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch, shape_name, runnable, _ in all_cells():
            if runnable:
                cells.append((arch, shape_name))
    else:
        cells.append((args.arch, args.shape))
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    for arch, shape_name in cells:
        for mp in meshes:
            tag = f"{arch}_{shape_name}_{'2x16x16' if mp else '16x16'}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    prev = json.load(f)
                if prev.get("status") == "ok":
                    continue
            t0 = time.monotonic()
            info = run_cell(arch, shape_name, mp, args.out)
            status = info["status"]
            extra = ""
            if status == "ok":
                extra = (f" dom={info['dominant']}"
                         f" frac={info['roofline_fraction']:.3f}"
                         f" trace={info['trace_s']}s")
            else:
                extra = " " + info["error"][:120]
            print(f"[{time.monotonic()-t0:7.1f}s] {arch:28s}"
                  f" {shape_name:12s} {info['mesh']:8s} {status}{extra}",
                  flush=True)


if __name__ == "__main__":
    main()
