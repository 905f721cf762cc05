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

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.distributed as dist
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


class _FromHolder(torch.autograd.Function):
    """A layer held whole by one rank of ``group`` (``Placement.owner``):
    the holder's tensor broadcast to every rank forward (the others pass an
    empty piece and allocate ``shape``); the gradient summed onto the
    holder backward, the others left with an empty piece, as
    ``train_step._reduce_grad``'s owner branch leaves them."""

    @staticmethod
    def forward(ctx, piece, shape, holder, group):
        ctx.holder, ctx.group = holder, group
        ctx.mine = dist.get_rank(group) == holder
        out = (piece.contiguous().clone() if ctx.mine
               else piece.new_empty(shape))
        dist.broadcast(out, dist.get_global_rank(group, holder), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.reduce(grad, dist.get_global_rank(ctx.group, ctx.holder),
                    group=ctx.group)
        if not ctx.mine:
            grad = grad.narrow(0, 0, 0)
        return grad, None, None, None


class _GatherOnUse(nn.Module):
    """A parametrization: the whole tensor over the data axis from this
    rank's piece, each time the module reads it."""

    def __init__(self, gathers, owner=None):
        super().__init__()
        self.gathers = gathers          # (dim, group), innermost axis first
        self.owner = owner              # (shape, holder, group) or None

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        for dim, group in self.gathers:
            shard = _GatherDim.apply(shard, dim, group)
        if self.owner is not None:
            shard = _FromHolder.apply(shard, *self.owner)
        return shard


def gather_on_use(model: nn.Module, placements: Mapping[str, Placement],
                  mesh) -> None:
    """ZeRO-3 on a model whose parameters are this rank's pieces under
    ``placements``: each parameter divided over a data axis is gathered
    whole over it where the model reads it, layer by layer, and its gradient
    reduce-scattered back to the piece (``torch.nn.utils.parametrize``; the
    parameter object stays the piece, so the caller's dictionary of
    parameters stays valid). A layer the rules give whole to one rank of a
    data axis (``Placement.owner``) is broadcast from that rank where it is
    read, and its gradient summed onto it. Dims divided over the model axis
    stay divided."""
    data = set(dp_axes(mesh))
    sizes = mesh_spec(mesh).shape
    for name, pl in placements.items():
        gathers = [(d, mesh.get_group(a)) for d, e in enumerate(pl.spec)
                   for a in reversed(entry_axes(e)) if a in data]
        owner = None
        if pl.owner is not None:
            axis, holder = pl.owner
            shape = tuple(n // math.prod(sizes[a] for a in entry_axes(e)
                                         if a not in data)
                          for n, e in zip(pl.shape, pl.spec))
            owner = (shape, holder, mesh.get_group(axis))
        if gathers or owner:
            module, _, attr = name.rpartition(".")
            parametrize.register_parametrization(
                model.get_submodule(module), attr,
                _GatherOnUse(gathers, owner), unsafe=True)
