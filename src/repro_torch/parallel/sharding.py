"""Per-family parameter/activation/cache sharding rules, and the placement of
the port's tensors on a mesh.

Counterpart of ``src/repro/parallel/sharding.py``; the rules are its own,
copied as data and logic. Megatron-style tensor parallelism over the "model"
axis:
  column-parallel: wq/wk/wv, FFN up/gate, SSM z/x projections, vocab embed
  row-parallel:    wo, FFN down, SSM out_proj, LM head (vocab dim)
MoE: experts axis over "model" (EP) when divisible, else each expert's d_ff
     over "model" (expert-TP) — granite's 40 experts on 16 ranks.
GQA: KV projections shard by kv-head only when kv_heads % tp == 0, else
     replicate (standard GQA-TP practice; chatglm kv=2, llama4 40 q-heads).

The universal fallback is REPLICATE-IF-NOT-DIVISIBLE, applied per tensor —
smollm's 9 heads simply replicate attention while its FFN still shards.

FSDP (ZeRO-3) additionally shards each parameter's largest replicated dim
over the intra-pod "data" axis.

A spec is a tuple with one entry per dim: None, an axis name, or a tuple of
axis names (the reference's ``PartitionSpec`` entries). The rules are
evaluated on the reference's tree, whose layers are stacked on a leading
axis; the port keeps one tensor a layer. ``param_shardings`` maps each of
the port's names to the reference's path and stacked shape
(``convert.reference_leaf``), evaluates the rule there and drops the layer
axis. Where the rule shards the layer axis itself (the FSDP/ZeRO rule's
"largest divisible dim" can pick it: mamba2's and zamba2's per-layer head
vectors and conv/norm leaves), the port gives whole layers to the ranks
along that axis, as the stacked array's blocks would lie: layer ``i`` of
``L`` on the coordinate ``i // (L / n)``, the other ranks holding an empty
piece (``Placement.owner``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    dp_axes,
    fsdp_axes,
    mesh_spec,
    mp_size,
)

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# Leaf-name classification -----------------------------------------------
# (matched on the final dict key of the parameter path)
_COLUMN_LAST = {"wq", "wk", "wv", "wg", "wu", "wz", "wx", "conv_wx",
                "norm_g"}       # shard LAST dim over model
_ROW_PENULT = {"wo", "wd", "out_proj"}  # shard dim -2 over model
_REPLICATED = {"ln", "ln1", "ln2", "lnx", "ln_f", "ln_enc", "ln_ffn",
               "wB", "wC", "wdt", "conv_wB", "conv_wC", "conv_b",
               "router", "b", "dt_bias"}
_HEAD_VEC = {"A_log", "D"}      # (..., H) vectors: shard last over model
_EXPERT = {"we_up", "we_gate", "we_down"}


def _divisible(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def _model_dim_ok(cfg: ModelConfig, name: str, shape: Tuple[int, ...],
                  tp: int) -> bool:
    """Column shards must also respect head boundaries for attention."""
    if name in ("wq", "wo"):
        return _divisible(cfg.num_heads, tp)
    if name in ("wk", "wv"):
        return _divisible(cfg.num_kv_heads, tp)
    return True


def param_spec(cfg: ModelConfig, path: Tuple[str, ...],
               shape: Tuple[int, ...], mesh: Mesh,
               fsdp: bool = False) -> Spec:
    """Spec for one parameter leaf of the reference's tree (``path``, its
    stacked ``shape``)."""
    mesh = mesh_spec(mesh)
    tp = mp_size(mesh)
    name = path[-1]
    spec = [None] * len(shape)

    def try_model(dim: int) -> bool:
        if _divisible(shape[dim], tp):
            spec[dim] = MODEL_AXIS
            return True
        return False

    if name == "embed":
        try_model(0)                       # vocab-parallel (padded)
    elif name == "head":
        try_model(len(shape) - 1)
    elif name in _EXPERT:
        # (L', E, D, F): EP over experts if divisible, else expert-TP.
        e_dim = len(shape) - 3
        if not try_model(e_dim):
            ff_dim = (len(shape) - 1 if name in ("we_up", "we_gate")
                      else len(shape) - 2)
            try_model(ff_dim)
    elif name in _COLUMN_LAST:
        if _model_dim_ok(cfg, name, shape, tp):
            try_model(len(shape) - 1)
    elif name in _ROW_PENULT and len(shape) >= 2:
        if _model_dim_ok(cfg, name, shape, tp):
            try_model(len(shape) - 2)
    elif name in _HEAD_VEC:
        try_model(len(shape) - 1)
    elif name in _REPLICATED:
        pass
    # (unknown names stay replicated — safe default)

    if fsdp:
        fax = fsdp_axes(mesh)
        if fax:
            fsize = int(np.prod([mesh.shape[a] for a in fax]))
            # largest still-unsharded divisible dim
            cands = [(shape[d], d) for d in range(len(shape))
                     if spec[d] is None and _divisible(shape[d], fsize)]
            if cands:
                _, d = max(cands)
                spec[d] = fax if len(fax) > 1 else fax[0]
    return tuple(spec)


# ----------------------------------------------------------------------- #
# The port's tensors on a mesh
# ----------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one of the port's tensors lies on a mesh. ``spec``: one entry
    per dim of the tensor; ``shape``: the whole tensor's; ``owner``: for a
    layer whose stacked axis the rule sharded, (that axis, the coordinate
    along it that holds the layer), else None."""

    spec: Spec
    shape: Tuple[int, ...]
    owner: Optional[Tuple[str, int]] = None

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis this placement divides the tensor over."""
        out = [a for e in self.spec for a in entry_axes(e)]
        if self.owner is not None:
            out.append(self.owner[0])
        return tuple(out)


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _unstacked(spec: Spec, shape: Tuple[int, ...], layer, mesh: Mesh
               ) -> Placement:
    """A stacked leaf's spec -> the placement of one layer's tensor."""
    if layer is None:
        return Placement(spec, tuple(shape))
    (layers, i), head = layer, spec[0]
    owner = None
    if head is not None:
        (axis,) = entry_axes(head)        # the fsdp axis, one name
        owner = (axis, i // (layers // mesh_spec(mesh).shape[axis]))
    return Placement(tuple(spec[1:]), tuple(shape), owner)


def leaf_placements(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                    mesh: Mesh, rule) -> Dict[str, Placement]:
    """Each of the port's tensors placed by ``rule(path, stacked shape)``,
    a rule of the reference's tree."""
    from repro_torch.convert import reference_leaf   # convert imports models
    out = {}
    for name, t in params.items():
        path, layer = reference_leaf(cfg, name)
        shape = tuple(t.shape)
        stacked = shape if layer is None else (layer[0],) + shape
        out[name] = _unstacked(rule(path, stacked), shape, layer, mesh)
    return out


def param_shardings(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                    mesh: Mesh, fsdp: bool = False) -> Dict[str, Placement]:
    """The placement of each of the port's parameters (a dict keyed by its
    names, of whole tensors or anything with their ``shape``)."""
    return leaf_placements(
        cfg, params, mesh,
        lambda path, shape: param_spec(cfg, path, shape, mesh, fsdp))


# ----------------------------------------------------------------------- #
# Batch / activation / cache shardings
# ----------------------------------------------------------------------- #

SEQ_AXIS = "data"
# The entry of a sharded cache (a model's ``init_cache`` dictionary) whose
# caches hold this rank's block of their sequence: a ``SeqSplit``.
SEQ_SPLIT = "seq_split"


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """The caches of a cache (``names``) that hold this rank's block of
    their sequence, and the data axis's ``group`` they are split over: the
    one record of the split, which the models read (``models.common.
    kv_view``)."""
    names: Tuple[str, ...]
    group: object


@dataclasses.dataclass(frozen=True)
class SeqBlock:
    """This rank's block of every row of a sequence split along its length
    over the data axis: the axis's ``group`` and the block's ``first`` row
    (rank r of n holds rows ``[r S / n, (r + 1) S / n)`` of a sequence of
    S). ``prefix``: rows ahead of the split tokens (the VLM's patches) that
    rank 0's block holds as well, so that it holds rows ``[0, P + S / n)``
    and rank r > 0 rows ``[P + r S / n, P + (r + 1) S / n)`` of P + S. The
    one record of a train step's or a prefill's split, which the models
    read (``models.common.attention_block``, ``moe_block``, ``models.
    mamba.mamba_layer``)."""
    group: object
    first: int
    prefix: int = 0

    def total(self, rows: int) -> int:
        """The whole sequence's rows, from this rank's block of ``rows``."""
        own = rows - (self.prefix if self.first == 0 else 0)
        return dist.get_world_size(self.group) * own + self.prefix


def rows_divide(mesh: Mesh, rows: int) -> bool:
    """Whether ``rows`` batch rows divide over the data-parallel axes, the
    rule of ``batch_spec`` and ``kv_cache_spec``."""
    mesh = mesh_spec(mesh)
    axes = dp_axes(mesh)
    dp = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    return bool(axes) and rows % dp == 0 and rows >= dp


def sequence_split(mesh: Mesh, rows: int, seq: int) -> bool:
    """Whether a cache of ``rows`` batch rows and ``seq`` positions splits
    its sequence over the data axis (``SEQ_AXIS``): where the rows do not
    divide over the data-parallel axes and the data axis divides ``seq``
    (long_500k's one row). Such a batch runs whole on every data rank. The
    rule of ``kv_cache_spec``, which the models read through the sharded
    cache's ``SEQ_SPLIT`` entry (``split_caches``)."""
    mesh = mesh_spec(mesh)
    return (not rows_divide(mesh, rows) and SEQ_AXIS in mesh.axis_names
            and seq % mesh.shape[SEQ_AXIS] == 0)


def batch_spec(mesh: Mesh, shape: Tuple[int, ...],
               seq_shard: bool = False) -> Spec:
    """(B, S, ...) batches: B over the DP axes when divisible; tiny batches
    (long_500k's B=1) shard S over data instead when S divides."""
    mesh = mesh_spec(mesh)
    axes = dp_axes(mesh)
    spec = [None] * len(shape)
    if rows_divide(mesh, shape[0]):
        spec[0] = axes if len(axes) > 1 else axes[0]
    elif seq_shard and len(shape) > 1 and sequence_split(mesh, shape[0],
                                                         shape[1]):
        spec[1] = SEQ_AXIS
    return tuple(spec)


def batch_shardings(mesh: Mesh, batch: Mapping[str, torch.Tensor],
                    cfg: ModelConfig) -> Dict[str, Spec]:
    return {k: batch_spec(mesh, tuple(v.shape), seq_shard=(k == "tokens"))
            for k, v in batch.items()}


KV_CACHES = ("k", "v", "attn_k", "attn_v", "self_k", "self_v", "cross_k",
             "cross_v")


def kv_cache_spec(cfg: ModelConfig, mesh: Mesh, name: str,
                  shape: Tuple[int, ...]) -> Spec:
    """Decode caches. KV: (L, B, S, Hkv, hd) — B over DP when divisible,
    heads over model when divisible; B=1 long-context caches shard S over
    the data axis instead. SSM states: (L, B, H, p, n) — H over model."""
    mesh = mesh_spec(mesh)
    tp = mp_size(mesh)
    axes = dp_axes(mesh)
    rows = axes if len(axes) > 1 else (axes[0] if axes else None)
    spec = [None] * len(shape)
    if name in KV_CACHES:
        if rows_divide(mesh, shape[1]):
            spec[1] = rows
        elif sequence_split(mesh, shape[1], shape[2]):
            spec[2] = SEQ_AXIS
        if _divisible(shape[3], tp):
            spec[3] = MODEL_AXIS
    elif name == "ssm":
        if rows_divide(mesh, shape[1]):
            spec[1] = rows
        if _divisible(shape[2], tp):
            spec[2] = MODEL_AXIS
    elif name == "conv":
        if rows_divide(mesh, shape[1]):
            spec[1] = rows
    return tuple(spec)


def cache_shardings(cfg: ModelConfig, mesh: Mesh,
                    cache: Mapping[str, torch.Tensor]) -> Dict[str, Spec]:
    """The port's cache (``init_cache``: stacked tensors in the reference's
    layout) -> a spec per entry; the clock ``pos`` is replicated."""
    return {name: (() if name == "pos" or t.dim() == 0
                   else kv_cache_spec(cfg, mesh, name, tuple(t.shape)))
            for name, t in cache.items() if name != SEQ_SPLIT}


def split_caches(mesh: Mesh, specs: Mapping[str, Spec]) -> dict:
    """``{SEQ_SPLIT: SeqSplit}`` naming the caches whose ``specs``
    (``cache_shardings``'s) split their sequence over a data axis of more
    than one rank, with that axis's group; ``{}`` where none does. The
    entry a sharded cache carries."""
    size = mesh_spec(mesh).shape.get(SEQ_AXIS, 1)
    names = tuple(name for name, spec in specs.items()
                  if size > 1 and len(spec) > 2 and spec[2] == SEQ_AXIS)
    return {SEQ_SPLIT: SeqSplit(names, mesh.get_group(SEQ_AXIS))} if names \
        else {}


def shard_cache(cfg: ModelConfig, mesh, cache: Mapping[str, torch.Tensor]
                ) -> dict:
    """This rank's pieces of a whole cache (copies), as ``cache_shardings``
    lays them out, the clock as ``batch_spec`` lays out the rows; with the
    ``SEQ_SPLIT`` entry where a cache is split along its sequence
    (``split_caches``)."""
    specs = cache_shardings(cfg, mesh, cache)
    specs["pos"] = batch_spec(mesh, tuple(cache["pos"].shape))
    out = {name: local_shard(t, specs[name], mesh).clone()
           for name, t in cache.items() if name != SEQ_SPLIT}
    out.update(split_caches(mesh, specs))
    return out


# ----------------------------------------------------------------------- #
# This rank's piece of a tensor, and the whole tensor back
# ----------------------------------------------------------------------- #

def _as_placement(spec, shape=()) -> Placement:
    return spec if isinstance(spec, Placement) else Placement(tuple(spec),
                                                              tuple(shape))


def _coordinate(mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's index, the count) over ``axes`` taken together, the
    first outermost."""
    shape = mesh_spec(mesh).shape
    index, count = 0, 1
    for a in axes:
        index = index * shape[a] + mesh.get_local_rank(a)
        count *= shape[a]
    return index, count


def local_shard(tensor: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's piece of a whole ``tensor`` under ``spec`` (a spec or a
    ``Placement``) on a device mesh: a view of it. A rank that does not own
    an owned layer gets an empty view (its first dim 0)."""
    pl = _as_placement(spec, tensor.shape)
    out = tensor
    for d, entry in enumerate(pl.spec):
        axes = entry_axes(entry)
        if axes:
            index, count = _coordinate(mesh, axes)
            size = out.shape[d] // count
            out = out.narrow(d, index * size, size)
    if pl.owner is not None:
        axis, holder = pl.owner
        if mesh.get_local_rank(axis) != holder:
            out = out.narrow(0, 0, 0)
    return out


def all_gather_stacked(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors of ``t``'s shape stacked in rank order, (n, ...)
    (gathered flat: gloo takes only a concatenation on dim 0)."""
    n = dist.get_world_size(group)
    buf = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(buf, t.reshape(-1).contiguous(), group=group)
    return buf.view((n,) + tuple(t.shape))


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the group's pieces along ``dim``, in the group's rank
    order."""
    return all_gather_stacked(t, group).movedim(0, dim).flatten(dim, dim + 1)


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum ``t`` over the group and keep this rank's block of ``dim`` (the
    inverse of ``all_gather_dim``'s layout)."""
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def gather_full(shard: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``local_shard`` under ``spec`` (a
    spec or a ``Placement``; an owned layer needs the ``Placement``, whose
    shape the other ranks allocate): a new tensor on every rank."""
    pl = _as_placement(spec)
    out = shard
    for d, entry in enumerate(pl.spec):
        for a in reversed(entry_axes(entry)):       # innermost first
            if out.numel() or pl.owner is None:
                out = all_gather_dim(out, d, mesh.get_group(a))
    if pl.owner is not None:
        axis, holder = pl.owner
        group = mesh.get_group(axis)
        if mesh.get_local_rank(axis) != holder:
            out = torch.empty(pl.shape, dtype=shard.dtype,
                              device=shard.device)
        else:
            out = out.contiguous()
        dist.broadcast(out, dist.get_global_rank(group, holder), group=group)
    return out


def shard_shape(pl: Placement, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of a rank's piece under ``pl`` (an owner's; the others'
    first dim is 0)."""
    shape = mesh_spec(mesh).shape
    return tuple(n // math.prod(shape[a] for a in entry_axes(e))
                 for n, e in zip(pl.shape, pl.spec))
