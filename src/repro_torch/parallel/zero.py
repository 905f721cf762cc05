"""ZeRO optimizer-state sharding (paper §IV-B: ZeRO-DP os+g default).

Counterpart of ``src/repro/parallel/zero.py``. Optimizer states (Adam m/v +
optional fp32 master) follow the parameter's spec and are *additionally*
sharded over the intra-pod "data" axis (ZeRO-1). Under ZeRO-3 the parameter
spec already carries the data axis, so states simply inherit it. The
sharded step (``train.train_step.sharded_train_step``) makes the implied
collectives explicit: a reduce-scatter of the gradients onto the state's
shards and an all-gather of the updated parameters — the paper's "no extra
communication volume vs. plain all-reduce" property.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.mesh import Mesh, dp_axes, fsdp_axes, mesh_spec
from repro_torch.parallel.policy import MemoryPlan
from repro_torch.parallel.sharding import (
    Placement,
    Spec,
    all_gather_dim,
    entry_axes,
    leaf_placements,
    param_spec,
    reduce_scatter_dim,
)


def opt_state_spec(cfg: ModelConfig, path: Tuple[str, ...],
                   shape: Tuple[int, ...], mesh: Mesh,
                   plan: MemoryPlan) -> Spec:
    mesh = mesh_spec(mesh)
    base = param_spec(cfg, path, shape, mesh, fsdp=plan.fsdp)
    if plan.fsdp:
        return base  # already data-sharded
    fax = fsdp_axes(mesh)
    if not fax:
        return base
    fsize = int(np.prod([mesh.shape[a] for a in fax]))
    spec = list(base) + [None] * (len(shape) - len(base))
    cands = [(shape[d], d) for d in range(len(shape))
             if spec[d] is None and fsize > 1 and shape[d] % fsize == 0]
    if cands:
        _, d = max(cands)
        spec[d] = fax if len(fax) > 1 else fax[0]
    return tuple(spec)


def opt_state_shardings(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                        mesh: Mesh, plan: MemoryPlan
                        ) -> Dict[str, Placement]:
    """The placement of each optimizer-state leaf (m, v or master) of the
    port's parameters ``params`` (keyed by their names)."""
    return leaf_placements(
        cfg, params, mesh,
        lambda path, shape: opt_state_spec(cfg, path, shape, mesh, plan))


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` forward; the gradient summed over the group
    and split back along ``dim`` (a reduce-scatter) backward."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group), None, None


class _GatherOnUse(nn.Module):
    """A parametrization: the whole tensor over the data axis from this
    rank's piece, each time the module reads it."""

    def __init__(self, gathers):
        super().__init__()
        self.gathers = gathers          # (dim, group), innermost axis first

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        for dim, group in self.gathers:
            shard = _GatherDim.apply(shard, dim, group)
        return shard


def gather_on_use(model: nn.Module, placements: Mapping[str, Placement],
                  mesh) -> None:
    """ZeRO-3 on a model whose parameters are this rank's pieces under
    ``placements``: each parameter divided over a data axis is gathered
    whole over it where the model reads it, layer by layer, and its gradient
    reduce-scattered back to the piece (``torch.nn.utils.parametrize``; the
    parameter object stays the piece, so the caller's dictionary of
    parameters stays valid). Dims divided over the model axis stay
    divided."""
    data = set(dp_axes(mesh))
    for name, pl in placements.items():
        if pl.owner is not None:
            raise NotImplementedError(
                f"{name}: ZeRO-3 of a layer held whole by one rank (the "
                "rule sharded the stacked layer axis) waits for its slice "
                "(ROADMAP Queue 1)")
        gathers = [(d, mesh.get_group(a)) for d, e in enumerate(pl.spec)
                   for a in reversed(entry_axes(e)) if a in data]
        if gathers:
            owner, _, attr = name.rpartition(".")
            parametrize.register_parametrization(
                model.get_submodule(owner), attr, _GatherOnUse(gathers),
                unsafe=True)
