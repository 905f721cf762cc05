"""The hillclimb sweep: named variants of one cell through the port's dry
run, one JSON each.

Counterpart of ``experiments/hillclimb_run.py``. Each variant is a
(cfg_transform, plan_transform) pair that rewrites the ModelConfig or the
MemoryPlan before the trace (remat policy, microbatch count, MoE dispatch
and capacity, ``attn_batch_shard``). The sweep is a
``repro_torch.core.study`` StudySpec with a ``variant`` Axis whose
``evaluate`` runs the measured dry-run frontend
(``launch.dryrun.lower_cell``, on ``meta`` as rank 0 of a fake process
group) instead of the analytical simulator: the same runner, another
evaluator. It needs no GPU: the runner is given ``device="cpu"``, and the
evaluator touches no device tensor.

Each variant's info dict gains ``variant`` and ``wall_s`` and is written as
soon as the variant finishes, so that a later variant that raises (one the
port cannot lower, e.g. ``bshard-micro16`` on smollm-135m, whose one row a
data rank does not split over 16 model ranks) leaves the earlier files.

Usage:
  python -m repro_torch.launch.hillclimb <arch:shape> <variant>[,<variant>...]
      [--out DIR]

Results go to ``DIR/<arch>_<shape>_<variant>.json``
(``experiments/hillclimb_torch/`` by default). Importing this module sets
nothing and joins no group.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core.study import Axis, StudySpec, run_study
from repro_torch.launch import dryrun

DEFAULT_OUT = "experiments/hillclimb_torch"

Transform = Optional[Callable]


def remat_blocks(plan):
    return dataclasses.replace(plan, remat="blocks")


def remat_dots(plan):
    return dataclasses.replace(plan, remat="dots")


def micro(n: int) -> Callable:
    return lambda plan: dataclasses.replace(plan, microbatches=n)


def moe_dense(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            dispatch="dense"))


def bshard(cfg):
    return dataclasses.replace(cfg, attn_batch_shard=True)


def cap(f: float) -> Callable:
    return lambda cfg: dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=f))


def chain(*fns: Callable) -> Callable:
    """The transforms applied left to right."""
    def t(x):
        for f in fns:
            x = f(x)
        return x
    return t


# name -> (cfg_transform, plan_transform): the reference's 22 variants
VARIANTS: Dict[str, Tuple[Transform, Transform]] = {
    "baseline": (None, None),
    "remat-blocks": (None, remat_blocks),
    "remat-dots": (None, remat_dots),
    "micro8": (None, micro(8)),
    "moe-dense": (moe_dense, None),
    "moe-dense-blocks": (moe_dense, remat_blocks),
    "cap1.0": (cap(1.0), None),
    "micro16": (None, micro(16)),
    "micro16-blocks": (None, chain(micro(16), remat_blocks)),
    "moe-dense-micro8": (moe_dense, micro(8)),
    "moe-dense-micro8-blocks": (moe_dense, chain(micro(8), remat_blocks)),
    "blocks-micro8": (None, chain(micro(8), remat_blocks)),
    "moe-dense-bshard": (chain(moe_dense, bshard), None),
    "bshard": (bshard, None),
    "moe-dense-bshard-blocks": (chain(moe_dense, bshard), remat_blocks),
    "bshard-micro16": (bshard, micro(16)),
    "bshard-blocks": (bshard, remat_blocks),
    "bshard-cap1": (chain(cap(1.0), bshard), None),
    "bshard-micro16-blocks": (bshard, chain(micro(16), remat_blocks)),
    "bshard-micro4": (bshard, micro(4)),
    "blocks": (None, remat_blocks),
    "dots": (None, remat_dots),
}


def variant_line(tag: str, info: Dict) -> str:
    """The reference's line for one finished variant."""
    return (f"{tag}: compute={info['compute_s']:.3f}s "
            f"memory={info['memory_s']:.3f}s "
            f"collective={info['collective_s']:.3f}s dom={info['dominant']} "
            f"frac={info['roofline_fraction']:.3f} "
            f"util={info['model_flops_util']:.3f} [{info['wall_s']:.0f}s]")


def hillclimb_spec(arch: str, shape: str, names: Sequence[str],
                   out_dir: str = DEFAULT_OUT) -> StudySpec:
    """The sweep of ``names`` over the cell ``arch:shape``: each variant's
    dry run is written to ``out_dir`` and reported as soon as it ends."""
    def evaluate(ctx):
        variant = ctx.point["variant"]
        cfg_t, plan_t = VARIANTS[variant]
        t0 = time.monotonic()
        _, info = dryrun.lower_cell(arch, shape, multi_pod=False,
                                    cfg_transform=cfg_t,
                                    plan_transform=plan_t)
        info["variant"] = variant
        info["wall_s"] = time.monotonic() - t0
        tag = f"{arch}_{shape}_{variant}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(info, f, indent=1, default=str)
        print(variant_line(tag, info), flush=True)
        return info

    return StudySpec(name=f"hillclimb:{arch}:{shape}",
                     axes=[Axis("variant", tuple(names))], evaluate=evaluate)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="named variants of one cell through the port's dry run")
    ap.add_argument("cell", help="arch:shape, e.g. smollm-135m:train_4k")
    ap.add_argument("variants", help="comma-separated variant names")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    names = args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        sys.exit(f"unknown variant(s) {unknown}; available: "
                 f"{sorted(VARIANTS)}")
    os.makedirs(args.out, exist_ok=True)
    return run_study(hillclimb_spec(arch, shape, names, args.out),
                     device="cpu")


if __name__ == "__main__":
    main()
