"""Megatron-style tensor parallelism on the "model" axis's process group.

The port's own module: in the reference GSPMD partitions the compute from
the sharding specs; here it is explicit. A column-parallel product (wq/wk/wv,
the FFN's up and gate, a Mamba2 block's wz/wx) takes its input through
``copy_to_region`` (identity forward, all-reduce of the gradient backward)
and a row-parallel one (wo, the FFN's down, out_proj) gives its output
through ``reduce_from_region`` (all-reduce forward, identity backward), so
that every rank of the group holds the same activations between blocks.
The embedding and the logits are split over the vocabulary:
``vocab_parallel_embed`` looks up the rank's rows and sums over the group;
``vocab_parallel_cross_entropy`` all-reduces the rows' maximum and the sum
of their exponentials. Every rank computes the same loss from
the same replicated values, so each backward gives its rank the gradient of
its own shards.

A MoE layer splits its experts over the group where their count divides
(expert parallelism, EP: each rank holds whole experts), else each expert's
hidden layer (expert-TP, as an FFN); ``models.common.moe_block`` runs
either. Under data parallelism a MoE layer routes the global microbatch, as
the reference's one program does (``route_over``): the capacity pick reads
every data rank's combine matrix, and the auxiliary loss's statistics are
summed over the data ranks through ``sum_over_group``, whose backward sums
the gradients too.

Serving a batch that does not divide over the data ranks (long_500k's one
row) runs it whole on every data rank, each holding one block of every
attention cache's sequence (``parallel.sharding.sequence_split``): a rank
attends over its block alone (the kernels' partial route) and
``combine_attention`` sums the ranks' partial rows by their log-sum-exp,
the same bits on every rank.

A train step or a prefill whose rows do not divide over the data ranks
splits each row's sequence over the data axis instead (``parallel.
sharding.SeqBlock``): what a rank's block needs of the other blocks (the
keys and values, the conv's halo, the SSD blocks' states) comes through
``gather_dim`` / ``gather_stacked``, all-gathers whose backward
reduce-scatters the gradient back to the rank that sent each piece.

A Transformer's attention that the rules replicate over the model axis (its
query heads do not divide over it) splits its batch over the axis instead
where the config sets ``attn_batch_shard``, as the reference's constraint
on q, k and v does: ``split_rows`` gives each rank its block of the rows
and ``gather_rows`` gathers the blocks' outputs back onto every rank. The
replicated weights enter through ``copy_to_region``, so each rank's
gradient of them, from its rows alone, is summed over the axis. Without
it, the attention's replicated projections run on every rank whole, and
each rank computes their weights' gradient for its block of their rows
alone (``project``), the blocks all-gathered, as the reference's
partitioner splits that product.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import MODEL_AXIS
from repro_torch.parallel.sharding import all_gather_dim, all_gather_stacked


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherStacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_stacked(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        # every rank's gradient of each rank's piece, summed on its owner
        out = torch.empty(grad[0].numel(), dtype=grad.dtype,
                          device=grad.device)
        dist.reduce_scatter_tensor(out, grad.contiguous().reshape(-1),
                                   group=ctx.group)
        return out.view(grad.shape[1:]), None


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        rows = x.shape[0] // dist.get_world_size(group)
        return x.narrow(0, dist.get_rank(group) * rows, rows).clone()

    @staticmethod
    def backward(ctx, grad):
        # every rank's block of the gradient, so each holds it whole
        return all_gather_stacked(grad.contiguous(), ctx.group).flatten(
            0, 1), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_stacked(x.contiguous(), group).flatten(0, 1)

    @staticmethod
    def backward(ctx, grad):
        # every rank holds the same gradient of the whole: its own block,
        # not a sum
        rows = grad.shape[0] // dist.get_world_size(ctx.group)
        return grad.narrow(0, dist.get_rank(ctx.group) * rows,
                           rows).contiguous(), None


class _SplitWeightGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return x @ w

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        rows = w.shape[0] // dist.get_world_size(ctx.group)
        first = dist.get_rank(ctx.group) * rows
        x2 = x.reshape(-1, x.shape[-1]).narrow(1, first, rows)
        dw = x2.t() @ grad.reshape(-1, grad.shape[-1])
        return grad @ w.t(), all_gather_dim(dw, 0, ctx.group), None


def split_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the rows (dim 0) of ``x``, which every rank of
    ``group`` holds equal, rank r rows ``[r b / n, (r + 1) b / n)``;
    backward, the blocks' gradients all-gathered: every rank gets the
    whole gradient."""
    return _SplitRows.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's blocks of rows concatenated in rank order, on every
    rank (``split_rows``'s inverse); backward, the rank's own block of the
    gradient, which every rank holds equal."""
    return _GatherRows.apply(x, group)


def project(x: torch.Tensor, w: torch.Tensor, wgrad_group=None
            ) -> torch.Tensor:
    """``x @ w``. With ``wgrad_group``, where ``w`` is whole on every rank
    of the group and ``x`` the same on each, the backward computes the
    weight's gradient x^T dy for this rank's block of ``w``'s rows alone
    and all-gathers the blocks, as the reference's partitioner splits that
    product over the model axis; the input's gradient is whole on every
    rank. Rows that do not divide over the group take the plain product."""
    if (wgrad_group is None
            or w.shape[0] % dist.get_world_size(wgrad_group)):
        return x @ w
    return _SplitWeightGrad.apply(x, w, wgrad_group)


def gather_stacked(x: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors of ``x``'s shape stacked in rank order, (n, ...),
    on every rank; backward, each piece's gradient summed over the group on
    the rank that gave it."""
    return _GatherStacked.apply(x, group)


def gather_dim(x: torch.Tensor, dim: int, group,
               lead: int = 0) -> torch.Tensor:
    """The group's pieces concatenated along ``dim`` in rank order (a
    sequence split over the group, whole on every rank); backward, the
    gradient reduce-scattered back onto each rank's piece. ``lead``: rank
    0's piece is that many rows longer than the others' (a ``SeqBlock``'s
    ``prefix``); the all-gather takes equal pieces, so the others' are
    padded to rank 0's length and the pads dropped from the result."""
    if not lead:
        return gather_stacked(x, group).movedim(0, dim).flatten(dim, dim + 1)
    pad = 0 if dist.get_rank(group) == 0 else lead
    rows = x.shape[dim] + pad - lead                  # the others' pieces
    zeros = x.new_zeros(x.shape[:dim] + (pad,) + x.shape[dim + 1:])
    pieces = gather_stacked(torch.cat([x, zeros], dim), group)
    rest = pieces[1:].narrow(dim + 1, 0, rows)
    return torch.cat([pieces[0], rest.movedim(0, dim).flatten(dim, dim + 1)],
                     dim)


def copy_to_region(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward."""
    return _CopyToRegion.apply(x, group)


def reduce_from_region(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward; the gradient as it is backward."""
    return _ReduceFromRegion.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward, and the gradients summed over it
    backward: for a sum of every rank's part that each rank then uses whole
    (``jax.lax.psum``'s transpose), so that each part's gradient counts
    every rank's use."""
    return copy_to_region(reduce_from_region(x, group), group)


def _vocab_range(local_rows: int, group):
    lo = dist.get_rank(group) * local_rows
    return lo, lo + local_rows


def vocab_parallel_embed(embed: torch.Tensor, tokens: torch.Tensor,
                         group) -> torch.Tensor:
    """This rank's vocabulary rows ``embed`` (V / tp, d), a contiguous block
    in rank order: each token's row from the rank that holds it."""
    lo, hi = _vocab_range(embed.shape[0], group)
    mine = (tokens >= lo) & (tokens < hi)
    x = embed[torch.where(mine, tokens - lo, 0)]
    return reduce_from_region(torch.where(mine[..., None], x, 0), group)


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 group, ignore_id: int = -1) -> torch.Tensor:
    """``models.common.cross_entropy_loss`` over logits split on the
    vocabulary: this rank's (..., V / tp), a contiguous block in rank
    order."""
    logits = logits.float()
    lo, hi = _vocab_range(logits.shape[-1], group)
    top = logits.detach().amax(dim=-1)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    sumexp = torch.exp(logits - top[..., None]).sum(dim=-1)
    logz = torch.log(reduce_from_region(sumexp, group)) + top
    mine = (targets >= lo) & (targets < hi)
    picks = torch.where(mine, targets - lo, 0).long()
    gold = torch.gather(logits, -1, picks[..., None])[..., 0]
    gold = reduce_from_region(torch.where(mine, gold, 0.0), group)
    maskf = (targets != ignore_id).float()
    return ((logz - gold) * maskf).sum() / maskf.sum().clamp(min=1.0)


def apply_tensor_parallel(model, placements, group) -> None:
    """Point a model whose parameters are this rank's pieces under
    ``placements`` (``parallel.sharding.param_shardings``) at the model
    axis's ``group``: each block whose weights the rules split over the
    axis runs on its shards, the others stay replicated (the rules'
    replicate-if-not-divisible), and so does the vocabulary. A
    ``Transformer``'s attention and FFN, or its MoE (its experts split as
    ``we_up`` is: over the experts, EP, or over their hidden layers,
    expert-TP; its shared expert as an FFN); an ``EncDec``'s encoder and
    decoder layers' (the decoder's self- and cross-attention); a
    ``Mamba``'s layers (their SSD heads) and, for the hybrid, its shared
    block's attention and FFN. An attention that stays replicated takes
    ``group`` as its ``wgrad_group``, a ``Transformer``'s as its
    ``batch_group`` instead where the config sets ``attn_batch_shard``.
    Raises, naming the attention, where a rank's query heads would
    straddle KV groups."""
    def split(name: str):
        return group if MODEL_AXIS in placements[name].axes() else None

    def point(name: str, block) -> None:
        """An attention or FFN at ``name``, by its first column-parallel
        weight's placement."""
        attn = hasattr(block, "wq")
        block.tp_group = split(f"{name}.{'wq' if attn else 'wu'}")
        if not attn:
            return
        if block.tp_group is None:
            # replicated: the weights' gradient split over the axis
            if dist.get_world_size(group) > 1:
                block.wgrad_group = group
            return
        cfg, tp = block.cfg, dist.get_world_size(group)
        per_kv = cfg.num_heads // cfg.num_kv_heads
        if cfg.num_kv_heads % tp and per_kv % (cfg.num_heads // tp):
            raise NotImplementedError(
                f"{name}: {cfg.num_heads // tp} query heads a rank "
                f"straddle KV groups of {per_kv}")

    model.vocab_group = split("embed")
    if hasattr(model, "encoder"):
        for i, layer in enumerate(model.encoder):
            point(f"encoder.{i}.attn", layer.attn)
            point(f"encoder.{i}.ffn", layer.ffn)
        for i, layer in enumerate(model.decoder):
            for part in ("self_attn", "cross_attn", "ffn"):
                point(f"decoder.{i}.{part}", getattr(layer, part))
        return
    for i, layer in enumerate(model.layers):
        if hasattr(layer, "attn"):
            point(f"layers.{i}.attn", layer.attn)
            # a Transformer's replicated attention splits its batch instead
            # where the config asks (the heads' split is kept where it holds)
            if layer.attn.tp_group is None and model.cfg.attn_batch_shard:
                layer.attn.batch_group = group
                layer.attn.wgrad_group = None
            if hasattr(layer, "ffn"):
                point(f"layers.{i}.ffn", layer.ffn)
                continue
            moe = layer.moe
            moe.tp_group = split(f"layers.{i}.moe.we_up")
            if hasattr(moe, "shared"):
                point(f"layers.{i}.moe.shared", moe.shared)
            continue
        layer.tp_group = split(f"layers.{i}.A_log")
        cut = split(f"layers.{i}.wx")
        if cut is not layer.tp_group or (
                cut is not None and model.cfg.ssm.ngroups > 1):
            raise NotImplementedError(
                f"layer {i}: its {layer.heads} SSD heads in "
                f"{model.cfg.ssm.ngroups} groups do not split over "
                f"{dist.get_world_size(group)} ranks with its "
                f"{layer.d_inner} channels")
    shared = getattr(model, "shared_attn", None)
    if shared is not None:
        point("shared_attn.attn", shared.attn)
        point("shared_attn.ffn", shared.ffn)


def route_over(model, groups) -> None:
    """Point a model's MoE layers at the data-parallel ``groups``
    (outermost axis first): each routes the global batch, its rows being
    this rank's block of it in the groups' rank order."""
    for layer in getattr(model, "layers", ()):
        if hasattr(layer, "moe"):
            layer.moe.route_groups = tuple(groups)


def combine_partials(outs: torch.Tensor, lses: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Rows of attention from the partials of the ``n`` blocks their keys
    are split into: ``outs`` (n, b, h, sq, d), each normalised over its
    block's keys, and ``lses`` (n, b, h, sq), their log-sum-exp, +inf where
    a row sees none of a block's keys (that block then weighs 0). Summed in
    block order in fp32, each weighted by exp(lse - the rows' largest),
    divided by the weights' sum and rounded once into ``dtype``; a row that
    no block sees gives zeros."""
    outs, lses = outs.float(), lses.float()
    lses = torch.where(lses == math.inf, -math.inf, lses)
    top = lses.amax(0)
    top = torch.where(torch.isfinite(top), top, 0.0)
    weights = torch.exp(lses - top)
    acc, total = outs[0] * weights[0, ..., None], weights[0]
    for i in range(1, outs.shape[0]):
        acc = acc + outs[i] * weights[i, ..., None]
        total = total + weights[i]
    return (acc / total.clamp(min=1e-30)[..., None]).to(dtype)


def combine_attention(out: torch.Tensor, lse: torch.Tensor, group,
                      dtype: torch.dtype) -> torch.Tensor:
    """Rows of attention whose keys are split over ``group``, from this
    rank's partial (``ops.flash_attention_partial``: ``out`` (b, h, sq, d)
    and ``lse`` (b, h, sq), fp32): every rank's, all-gathered in one
    collective (each row's output beside its log-sum-exp), combined in rank
    order (``combine_partials``). Every rank sums the same numbers in the
    same order, so the ranks' rows are bitwise equal. Serving only: no
    gradient."""
    packed = torch.cat([out.float(), lse.float()[..., None]], dim=-1)
    parts = all_gather_stacked(packed.contiguous(), group)
    return combine_partials(parts[..., :-1], parts[..., -1], dtype)
