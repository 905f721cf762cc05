"""Shared model layers: RMSNorm, RoPE, GQA attention (uncached, with a KV
cache, and cross-attention over a source or a frozen cross K/V), FFN, the
MoE block, the token cross-entropy.

Counterpart of ``src/repro/models/common.py``. Plain
functions on tensors; parameters arrive as mappings from the JAX package's
leaf names (``wq``, ``wk``, ...) to tensors laid out ``(d_in, d_out)`` and
applied as ``x @ w``, so weights carry across without a transpose.

Attention and RMSNorm go through ``repro_torch.kernels.ops``: the hand-written
CUDA kernels for tensors on the GPU, their plain versions for tensors on the
CPU, forward and (when an input requires grad) backward. The other products
(projections, FFN, the experts' batched products, logits) are
``torch.matmul`` / ``torch.bmm``, as the JAX package leaves them to XLA.

Tensor parallelism is explicit (the reference leaves it to GSPMD):
``attention_block`` and ``ffn_block`` take the ``model`` axis's process
group when their weights are shards of it (``parallel/tensor.py``'s region
ops around the column- and row-parallel products), and the local head
counts; ``split_rms_norm`` normalises a row whose columns lie on the
group's ranks; the LMs' vocabulary (``embed_tokens``, ``lm_logits``,
``serving_logits``, ``lm_cross_entropy``) takes the group where the
embedding holds a block of the vocabulary. A batch that does not divide over
the data ranks is served whole on each of them, every attention cache split
along its sequence over the data axis (``attention_block``'s
``seq_group``, which ``kv_view`` reads from the cache's ``SEQ_SPLIT``); a
train step or a prefill of such a batch splits each row's sequence over the
data axis (``attention_block``'s ``seq``, a ``parallel.sharding.SeqBlock``):
a rank's queries attend over every rank's keys, gathered.
``layer_norm`` is not ported: no model of the reference calls it.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.parallel.sharding import (
    SEQ_SPLIT,
    SeqBlock,
    all_gather_dim,
    all_gather_stacked,
)
from repro_torch.parallel.tensor import (
    combine_attention,
    copy_to_region,
    gather_dim,
    reduce_from_region,
    sum_over_group,
    vocab_parallel_cross_entropy,
    vocab_parallel_embed,
)

DEFAULT_DTYPE = torch.bfloat16


# --------------------------------------------------------------------- #
# Initializers
# --------------------------------------------------------------------- #

def init_generator(device: torch.device,
                   generator: Optional[torch.Generator] = None
                   ) -> Optional[torch.Generator]:
    """The generator a model's weights are drawn from: the caller's, else a
    CPU one seeded with 0; None for a model on ``meta``, whose weights are
    then empty ``meta`` tensors (``dense_init``, ``embed_init``): nothing
    is drawn or allocated, whatever the model's size."""
    if device.type == "meta":
        return None
    if generator is None:
        return torch.Generator(device="cpu").manual_seed(0)
    return generator


def dense_init(generator: Optional[torch.Generator], shape,
               dtype=DEFAULT_DTYPE,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal truncated at two standard deviations, fan-in scaled. Drawn on
    the generator's device in fp32 by inverting the normal CDF; an empty
    ``meta`` tensor when ``generator`` is None (``init_generator``)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    u = lo + u * (1.0 - 2.0 * lo)
    x = math.sqrt(2.0) * torch.erfinv((2.0 * u - 1.0).clamp_(-1 + 1e-7,
                                                             1 - 1e-7))
    return (x.clamp_(-2.0, 2.0) * std).to(dtype)


def embed_init(generator: Optional[torch.Generator], shape,
               dtype=DEFAULT_DTYPE) -> torch.Tensor:
    if generator is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (x * 0.02).to(dtype)


# --------------------------------------------------------------------- #
# Norm
# --------------------------------------------------------------------- #

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """fp32 arithmetic, one rounding into ``x.dtype``. The kernel takes
    contiguous rows, so a strided ``x`` is copied first."""
    return ops.rmsnorm(x.contiguous(), gamma, eps)


def split_rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float,
                   width: int, group) -> torch.Tensor:
    """``rms_norm`` of rows of ``width`` whose columns are split over
    ``group``: x (..., width / tp) and gamma hold this rank's. Each rank sums
    its columns' squares in fp32 and the sums are all-reduced (b·s values,
    not the rows); the gradient of that sum is all-reduced too, since each
    rank's columns give only their part of it. Plain PyTorch: the kernel
    takes whole rows."""
    xf = x.float()
    total = sum_over_group(xf.square().sum(dim=-1, keepdim=True), group)
    return (xf * torch.rsqrt(total / width + eps) * gamma.float()).to(x.dtype)


# --------------------------------------------------------------------- #
# RoPE (with partial-rotary support for chatglm3's "2d RoPE")
# --------------------------------------------------------------------- #

def rope_frequencies(head_dim: int, fraction: float, theta: float,
                     positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the rotary fraction of the head dim.

    positions: (..., seq) integer. Returns (..., seq, rot_dim//2) fp32 each."""
    rot_dim = int(head_dim * fraction)
    rot_dim -= rot_dim % 2
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=positions.device) / rot_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions[..., None].to(torch.float32) * inv_freq
    return torch.cos(angles), torch.sin(angles)


def rope_positions(seq: int, offset: Optional[torch.Tensor],
                   device, start: int = 0) -> torch.Tensor:
    """Positions of ``seq`` new tokens: (1, seq) from ``start``, or (b, seq)
    from each sequence's own clock ``offset`` (b,) plus ``start``. ``start``:
    the first row of a rank's block of a sequence split along its length
    (``SeqBlock.first``)."""
    base = torch.arange(start, start + seq, device=device)[None, :]
    return base if offset is None else base + offset[:, None]


def block_offset(seq: Optional[SeqBlock], b: int, device
                 ) -> Optional[torch.Tensor]:
    """The attention kernels' ``q_offset`` (b,) int32 of a rank's block of
    query rows (``seq``'s first row), or None without a split."""
    if seq is None:
        return None
    return torch.full((b,), seq.first, dtype=torch.int32, device=device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (batch, seq, heads, head_dim); cos/sin: (batch, seq, rot//2).

    Pairs are interleaved (even with the following odd element), and cos/sin
    are cast to ``x.dtype`` before the multiply, as in the reference."""
    rot = 2 * cos.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    c = cos[..., None, :].to(x.dtype)  # broadcast over heads
    s = sin[..., None, :].to(x.dtype)
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y, x_pass], dim=-1) if x_pass.shape[-1] else y


# --------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------- #

def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """(b, s, kv_heads, d) -> (b, s, q_heads, d) by group broadcast."""
    kv_heads = k.shape[-2]
    if kv_heads == num_q_heads:
        return k
    return k.repeat_interleave(num_q_heads // kv_heads, dim=-2)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Reference attention, the literal translation of the JAX package's.
    q: (b, sq, h, d), k/v: (b, skv, h_kv, d). Tests hold ``attention``
    against it; the model does not call it."""
    b, sq, h, d = q.shape
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              q_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (b, sq, h, d), k/v: (b, skv, h_kv, d) -> (b, sq, h, d).

    Hands the flash-attention wrapper transposed views: no copy, and no
    repeat of the KV heads. ``q_offset``: optional int32 (b,), the position
    of each sequence's first query row."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal, q_offset=q_offset)
    return out.transpose(1, 2)


def split_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, q_offset: Optional[torch.Tensor],
                    group) -> torch.Tensor:
    """``attention`` of rows whose keys are split over ``group``: k/v (b,
    skv, h_kv, d) hold this rank's block, ``q_offset`` (b,) the rows'
    position in it (negative before it). Each rank's partial (the kernels'
    partial route) and the ranks' combine by log-sum-exp
    (``combine_attention``): the whole rows, the same on every rank."""
    out, lse = ops.flash_attention_partial(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
        q_offset=q_offset)
    return combine_attention(out, lse, group, q.dtype).transpose(1, 2)


def prompt_block(tokens: torch.Tensor, group, min_rows: int = 1
                 ) -> Tuple[torch.Tensor, Optional[SeqBlock]]:
    """A prompt of a batch served whole on every data rank (``group``, the
    data axis's, or None): this rank's block of its rows and the
    ``SeqBlock`` of the split where the prompt's length divides the group
    into blocks of at least ``min_rows``, else the prompt whole and None."""
    s = tokens.shape[1]
    if group is None or s <= 1:
        return tokens, None
    n = dist.get_world_size(group)
    rows = s // n
    if n <= 1 or s % n or rows < min_rows:
        return tokens, None
    first = dist.get_rank(group) * rows
    return tokens[:, first:first + rows], SeqBlock(group, first)


def prefix_block(prefix: Optional[torch.Tensor], seq: Optional[SeqBlock]
                 ) -> Tuple[Optional[torch.Tensor], Optional[SeqBlock]]:
    """Rows (b, p, d) ahead of a sequence split over the data axis (the
    VLM's patches, whole on every rank): rank 0's block holds them. This
    rank's of them (none on the others) and the ``SeqBlock`` that counts
    them (``prefix``); without a split, ``prefix`` and ``seq`` as given."""
    if prefix is None or seq is None:
        return prefix, seq
    p, first = prefix.shape[1], seq.first
    return (prefix[:, :p if first == 0 else 0],
            SeqBlock(seq.group, first + p if first else 0, p))


def last_row(x: torch.Tensor, seq: Optional[SeqBlock]) -> torch.Tensor:
    """The sequence's last row of ``x`` (b, s, d), (b, 1, d): under ``seq``
    the last rank's, all-gathered, so that every rank holds the same
    bits."""
    if seq is None:
        return x[:, -1:]
    return all_gather_stacked(x[:, -1:].contiguous(), seq.group)[-1]


def kv_view(cache: dict, k: str, v: str, i: int, clock: bool = True
            ) -> dict:
    """``attention_block``'s ``kv_cache`` of entry ``i`` of a model's
    cache ``k`` / ``v`` (a layer's, a group's), with the clock unless
    ``clock`` is False (a frozen cross K/V), and ``seq_group`` where the
    cache holds this rank's block of the sequence (named in the cache's
    ``SEQ_SPLIT`` entry, ``parallel.sharding.split_caches``)."""
    out = {"k": cache[k][i], "v": cache[v][i]}
    if clock:
        out["pos"] = cache["pos"]
    split = cache.get(SEQ_SPLIT)
    if split is not None and k in split.names:
        out["seq_group"] = split.group
    return out


def attention_block(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,                   # (b, s, d_in)
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_fraction: float = 1.0,
    rope_theta: float = 10_000.0,
    causal: bool = True,
    kv_cache: Optional[dict] = None,   # {"k","v": (b, max_s, hkv, d), "pos",
                                       #  "seq_group" where split}
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    xkv: Optional[torch.Tensor] = None,   # cross-attention source (b, src, d)
    precomputed_kv: bool = False,      # kv_cache holds frozen cross K/V
    group=None,                        # the model axis, weights its shards
    seq: Optional[SeqBlock] = None,    # x holds this rank's block of rows
) -> torch.Tensor:
    """GQA attention. With ``kv_cache`` the new keys and values are
    written into ``kv_cache["k"]`` / ``["v"]`` IN PLACE (the JAX package
    returns a new cache; here the caller's tensors are updated) and
    ``kv_cache["pos"]``, the per-sequence (b,) clock, is only read: the
    caller advances it once for all layers. ``rope``: the (cos, sin) tables
    of ``rope_positions`` + ``rope_frequencies`` if the caller has them
    already (they are the same for every layer of one forward pass).

    Cross-attention, as the reference's: ``xkv`` gives the keys and values
    (the encoder output) and ``precomputed_kv`` says that ``kv_cache``
    holds them already projected, frozen and whole (``k``, ``v``: (b, src,
    hkv, d)); either way no RoPE is applied on either side, the attention
    is not causal, and nothing is written.

    With ``group``, ``wq``/``wk``/``wv`` hold this rank's heads' columns
    and ``wo`` their rows, ``num_heads``/``num_kv_heads`` count this rank's
    heads, the inputs enter through ``copy_to_region`` and the output is
    summed over the group (``reduce_from_region``).

    With ``kv_cache["seq_group"]`` (the data axis's group, ``kv_view``) the
    cache's ``k``/``v`` hold this rank's block of ``S / n`` rows of a
    sequence of ``S``, rank r rows ``[r S / n, (r + 1) S / n)``, and ``x``
    is the whole batch on every rank. A prefill writes the prompt's rows
    that fall in the block (none where the prompt ends before it) and
    attends over the prompt whole; a decode step writes its row on the rank
    that owns it, the idle slot's clamp being the global last row (on the
    last rank), and attends over each rank's block with the kernels'
    partial route, the ranks' rows combined by log-sum-exp
    (``split_attention``); so does a cross-attention over a frozen cross
    K/V split along its source. Serving only.

    With ``seq`` (a ``SeqBlock``: a train step or a prefill whose rows are
    split along the sequence over the data axis) ``x`` holds this rank's
    block of every row, from row ``seq.first``: the rotary positions start
    there (``rope``, where given, holds them already), the block's keys and
    values are all-gathered along the sequence over ``seq.group``
    (``gather_dim``: the backward reduce-scatters their gradient back) and
    its queries attend causally over every row's keys with ``q_offset`` =
    ``seq.first``. A prefill then writes the rows of its cache block from
    the gathered keys and values. Self-attention only. Rank 0's block may
    hold ``seq.prefix`` rows more than the others' (``prefix_block``)."""
    b, s, _ = x.shape
    seq_group = None if kv_cache is None else kv_cache.get("seq_group")
    if group is not None:
        x = copy_to_region(x, group)
        if xkv is not None:
            xkv = copy_to_region(xkv, group)

    def project_out(out: torch.Tensor) -> torch.Tensor:
        y = out.reshape(b, s, num_heads * head_dim) @ params["wo"]
        return y if group is None else reduce_from_region(y, group)

    q = (x @ params["wq"]).reshape(b, s, num_heads, head_dim)
    if precomputed_kv:
        if kv_cache is None:
            raise ValueError("precomputed_kv needs the cross K/V in kv_cache")
        kc, vc = kv_cache["k"].to(q.dtype), kv_cache["v"].to(q.dtype)
        if seq_group is not None:
            return project_out(split_attention(q, kc, vc, False, None,
                                               seq_group))
        return project_out(attention(q, kc, vc, causal=False))
    src = x if xkv is None else xkv
    k = (src @ params["wk"]).reshape(b, src.shape[1], num_kv_heads, head_dim)
    v = (src @ params["wv"]).reshape(b, src.shape[1], num_kv_heads, head_dim)
    if xkv is not None:
        return project_out(attention(q, k, v, causal=False))

    offset = None
    if kv_cache is not None:
        offset = kv_cache["pos"]
        if offset.dim() == 0:
            offset = offset.expand(b)
    if rope_fraction > 0:
        if rope is None:
            rope = rope_frequencies(
                head_dim, rope_fraction, rope_theta,
                rope_positions(s, offset, x.device,
                               0 if seq is None else seq.first))
        # One pass over the q and k heads together: the rotation is per
        # element, and eager PyTorch pays for every launch.
        qk = apply_rope(torch.cat([q, k], dim=2), *rope)
        q, k = qk[:, :, :num_heads], qk[:, :, num_heads:]

    if kv_cache is None:
        if seq is not None:
            k = gather_dim(k, 1, seq.group, seq.prefix)
            v = gather_dim(v, 1, seq.group, seq.prefix)
        return project_out(attention(q, k, v, causal=causal,
                                     q_offset=block_offset(seq, b, x.device)))
    return project_out(_cache_step(q, k, v, kv_cache, offset, seq_group,
                                   seq))


def _cache_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_cache: dict, offset: torch.Tensor, group,
                seq: Optional[SeqBlock] = None) -> torch.Tensor:
    """``attention_block``'s prefill or decode step over its cache, which
    it writes in place; the attention's output. With ``group`` the cache
    holds this rank's block of the sequence, with ``seq`` the prompt's rows
    are this rank's block of it (see there)."""
    kc, vc = kv_cache["k"], kv_cache["v"]
    b, s = q.shape[:2]
    rows = kc.shape[1]                       # this block's
    rank, ranks = ((0, 1) if group is None
                   else (dist.get_rank(group), dist.get_world_size(group)))
    first, total = rank * rows, ranks * rows
    if s > 1:
        # Prefill: fresh cache, every sequence starts at 0. The reference
        # attends over the whole zero-filled cache under the causal mask; the
        # masked positions weigh exp(-1e30) = 0, so attending over the prompt
        # alone is the same sum. The prompt's rows in this block are written.
        if seq is not None:
            k = gather_dim(k, 1, seq.group, seq.prefix)
            v = gather_dim(v, 1, seq.group, seq.prefix)
        prompt = k.shape[1]
        if prompt > total:
            raise ValueError(f"a prompt of {prompt} rows, a cache of {total}")
        n = max(0, min(prompt - first, rows))
        kc[:, :n] = k[:, first:first + n].to(kc.dtype)
        vc[:, :n] = v[:, first:first + n].to(vc.dtype)
        return attention(q, k, v, causal=True,
                         q_offset=block_offset(seq, b, q.device))
    # Decode: each sequence writes at its own position and attends over the
    # cache up to it. A slot that no request owns keeps ticking and may run
    # past the cache: its position is clamped to the (global) last row,
    # where the write and the mask stay in range. No active sequence is
    # touched, since submit() keeps every request below max_seq.
    at = offset.clamp(max=total - 1).to(torch.int32)
    knew, vnew = k[:, 0].to(kc.dtype), v[:, 0].to(vc.dtype)
    if group is not None:
        # The row in this block's own index; a rank that does not own it
        # rewrites its row as it was (no sync, no branch).
        at = at - first
        mine = ((at >= 0) & (at < rows))[:, None, None]
        idx = (torch.arange(b, device=q.device), at.clamp(0, rows - 1).long())
        knew, vnew = (torch.where(mine, knew, kc[idx]),
                      torch.where(mine, vnew, vc[idx]))
    else:
        idx = (torch.arange(b, device=q.device), at.long())
    kc[idx] = knew
    vc[idx] = vnew
    kc, vc = kc.to(q.dtype), vc.to(q.dtype)
    if group is None:
        return attention(q, kc, vc, causal=True, q_offset=at)
    return split_attention(q, kc, vc, True, at, group)


# --------------------------------------------------------------------- #
# FFN
# --------------------------------------------------------------------- #

def init_ffn_params(generator: torch.Generator, d_model: int, d_ff: int,
                    activation: str, dtype=DEFAULT_DTYPE) -> dict:
    p = {}
    if activation == "swiglu":
        p["wg"] = dense_init(generator, (d_model, d_ff), dtype)
    p["wu"] = dense_init(generator, (d_model, d_ff), dtype)
    p["wd"] = dense_init(generator, (d_ff, d_model), dtype)
    return p


def ffn_block(params: Mapping[str, torch.Tensor], x: torch.Tensor,
              activation: str, group=None) -> torch.Tensor:
    """With ``group``, ``wg``/``wu`` hold this rank's columns of the hidden
    layer and ``wd`` its rows: the input enters through ``copy_to_region``
    and the output is summed over the group."""
    if group is not None:
        x = copy_to_region(x, group)
    if activation == "swiglu":
        y = (F.silu(x @ params["wg"]) * (x @ params["wu"])) @ params["wd"]
    else:
        # jax.nn.gelu defaults to the tanh approximation
        y = F.gelu(x @ params["wu"], approximate="tanh") @ params["wd"]
    return y if group is None else reduce_from_region(y, group)


# --------------------------------------------------------------------- #
# MoE block (capacity-based top-k routing)
# --------------------------------------------------------------------- #

def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    num_experts: int, activation: str, shared_d_ff: int = 0,
                    dtype=DEFAULT_DTYPE) -> dict:
    """The reference's leaves: ``router`` (d, e) in fp32 whatever ``dtype``,
    the experts' ``we_up`` / ``we_gate`` (e, d, f) and ``we_down`` (e, f, d)
    stacked on a leading experts axis, and the ``shared`` expert's FFN."""
    p = {
        "router": dense_init(generator, (d_model, num_experts), torch.float32),
        "we_up": dense_init(generator, (num_experts, d_model, d_ff), dtype),
        "we_down": dense_init(generator, (num_experts, d_ff, d_model), dtype),
    }
    if activation == "swiglu":
        p["we_gate"] = dense_init(generator, (num_experts, d_model, d_ff),
                                  dtype)
    if shared_d_ff:
        p["shared"] = init_ffn_params(generator, d_model, shared_d_ff,
                                      activation, dtype)
    return p


def stable_top_k(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis, largest first, equal
    values lowest index first: ``jax.lax.top_k``'s order. ``torch.topk``
    promises no order among ties, and ties are common here (every gate is
    1.0 at top-1; an expert's unrouted tokens all weigh 0), so this is a
    stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_ffn(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                activation: str) -> torch.Tensor:
    """Every expert on its own rows: x (e, n, d) -> (e, n, d)."""
    if activation == "swiglu":
        h = F.silu(torch.bmm(x, params["we_gate"])) * torch.bmm(
            x, params["we_up"])
    else:
        h = F.gelu(torch.bmm(x, params["we_up"]), approximate="tanh")
    return torch.bmm(h, params["we_down"])


def _combine(gate_vals: torch.Tensor, gate_idx: torch.Tensor,
             e: int) -> torch.Tensor:
    """The (t, e) combine matrix: each token's top-k gates renormalised to
    sum to one at their experts, zero elsewhere."""
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return torch.zeros((gate_vals.shape[0], e), dtype=torch.float32,
                       device=gate_vals.device).scatter(1, gate_idx, gate_vals)


def _coordinate(groups) -> Tuple[int, int]:
    """(this rank's index, the count) over ``groups`` taken together, the
    first outermost."""
    index, count = 0, 1
    for g in groups:
        index = index * dist.get_world_size(g) + dist.get_rank(g)
        count *= dist.get_world_size(g)
    return index, count


def _capacity(t: int, top_k: int, capacity_factor: float, e: int) -> int:
    return min(t, max(1, int(t * top_k * capacity_factor / e)))


def _gathered(routed: torch.Tensor, route_groups,
              seq_rows: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's combine matrix over ``route_groups`` (outermost first)
    in the reference's (b, s) token order, and the rank (its index over the
    groups, ``_coordinate``'s) that holds each token. Where the ranks hold
    rows, rank order is that order; where each holds a block of the
    positions of ``seq_rows`` rows (a ``SeqBlock``), the gathered (rank,
    row, position) is put in (row, rank, position)."""
    t, count = routed.shape[0], _coordinate(route_groups)[1]
    whole = routed.detach()
    for g in reversed(route_groups):                # innermost first
        whole = all_gather_dim(whole, 0, g)
    owner = torch.arange(t * count, device=whole.device) // t
    if seq_rows is not None:
        whole, owner = (z.view((count, seq_rows, -1) + z.shape[1:])
                        .transpose(0, 1).reshape(z.shape)
                        for z in (whole, owner))
    return whole, owner


def _pick(routed: torch.Tensor, t: int, top_k: int, capacity_factor: float,
          decode: bool, lo: int, n: int, route_groups,
          seq_rows: Optional[int] = None):
    """Experts ``lo .. lo + n``'s tokens within capacity: (gates (n, c),
    token rows (n, c), which slots are kept (n, c) or None for all). A
    decode step's expert keeps all ``t``. Alone, each expert's top ``cap``
    of the ``t`` tokens. Over ``route_groups``, its top ``cap`` of the
    global microbatch, ``cap`` from the global count: every rank's combine
    matrix in the reference's token order (``_gathered``), then the rank's
    own of the picks, which are its local top ``n_j`` by the same order (a
    rank's tokens keep their global order among themselves)."""
    e = routed.shape[1]
    if decode:
        return (*stable_top_k(routed.T[lo:lo + n], t), None)
    if not route_groups:
        cap = _capacity(t, top_k, capacity_factor, e)
        return (*stable_top_k(routed.T[lo:lo + n], cap), None)
    index, count = _coordinate(route_groups)
    cap = _capacity(t * count, top_k, capacity_factor, e)
    whole, owner = _gathered(routed, route_groups, seq_rows)
    _, picked = stable_top_k(whole.T[lo:lo + n], cap)
    mine = (owner[picked] == index).sum(1)
    c = min(cap, t)
    vals, idx = stable_top_k(routed.T[lo:lo + n], c)
    return vals, idx, torch.arange(c, device=idx.device) < mine[:, None]


def moe_block(params: Mapping, x: torch.Tensor, *, top_k: int,
              capacity_factor: float, activation: str,
              aux_loss_weight: float = 0.0, dispatch: str = "gather",
              group=None, shared_group=None, route_groups=(),
              stats: Optional[dict] = None, seq: Optional[SeqBlock] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x: (b, s, d) -> (y (b, s, d), the Switch auxiliary loss).

    The router is fp32; each token's top-k gates are renormalised to sum to
    one (the reference's ``combine`` matrix). ``dispatch="gather"``: each
    expert keeps its top ``cap`` tokens by gate and drops the overflow,
    ``cap = t`` for one-token decode steps (serving never drops), else
    ``min(t, max(1, int(t * top_k * capacity_factor / e)))``.
    ``dispatch="dense"``: every expert on every token, weighted by the
    combine matrix. Both add the shared expert.

    The combine is deterministic on every device: each token gathers its
    k experts' outputs in ascending expert order and sums them, a reduction
    of fixed shape with no atomics (the reference scatter-adds; a token's
    dropped experts are exact zeros in the sum).

    ``group``: the model axis's group where the experts are split over it,
    by experts (EP: ``we_up`` holds ``n`` of the ``e`` experts, this rank's
    ``rank * n ..``) or else by their hidden layers (expert-TP: all ``e``,
    each as ``ffn_block`` under a group). Every rank routes its tokens
    over all ``e`` experts (the router is replicated), runs its part of the
    experts through ``copy_to_region`` and sums its partial ``y`` over the
    group: the token's experts in ascending order on each rank, then the
    ranks' sum, so the result is the one-process result to fp32 rounding,
    not bit for bit. The gates the experts read enter through
    ``copy_to_region`` too, so the router's gradient from the dispatch sums
    every rank's experts; the auxiliary loss, the same on every rank, reads
    them as they are and counts once. ``shared_group``: the shared expert's
    group where it is split.

    ``route_groups``: the data-parallel groups (outermost first) when this
    rank's tokens are its block of a global microbatch: with ``s > 1`` each
    expert's capacity pick and the auxiliary loss's density and router
    probability are the global microbatch's, as the reference's one
    program computes them (``_pick``; the sums through ``sum_over_group``,
    whose backward sums every rank's gradient of the global loss). A decode
    step keeps every token alone, and its auxiliary loss, which serving
    drops, is the rank's own.

    ``seq``: x holds this rank's block of the positions of every row of a
    sequence split over the data axis (a ``SeqBlock``, equal blocks): the
    tokens are routed over ``seq.group`` alone, whatever ``route_groups``
    says (the pod axis's ranks hold the same positions), in the
    reference's (b, s) order (``_pick``), as a step of ``s > 1`` rows
    even where the block holds one.

    ``stats``: where given, receives this call's ``routed`` (token, expert)
    pairs and those ``kept`` within capacity, on this rank's tokens and
    experts, as tensors."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    t = b * s
    xt = x.reshape(t, d)
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)   # (t, e)
    gate_vals, gate_idx = stable_top_k(probs, top_k)              # (t, k)
    combine = _combine(gate_vals, gate_idx, e)
    routed, xe = combine, xt
    if group is not None:
        routed = _combine(copy_to_region(probs, group).gather(1, gate_idx),
                          gate_idx, e)
        xe = copy_to_region(xt, group)
    n = params["we_up"].shape[0]                  # the experts this rank runs
    lo = dist.get_rank(group) * n if n < e else 0
    decode = s == 1 and seq is None
    if seq is not None:
        spread = (seq.group,)
    else:
        spread = () if decode else tuple(route_groups)
    order, _ = torch.sort(gate_idx, dim=-1)                       # (t, k)
    local = order - lo
    inside = (local >= 0) & (local < n)
    local = local.clamp(0, n - 1)

    if dispatch == "dense":
        ye = _expert_ffn(params, xe[None].expand(n, t, d), activation)
        cw = routed[:, lo:lo + n].to(xt.dtype).T[..., None]       # (n, t, 1)
        y = (ye * cw).sum(0)
        kept = inside
    else:
        sel_val, sel_idx, keep = _pick(
            routed, t, top_k, capacity_factor, decode, lo, n, spread,
            None if seq is None else b)                           # (n, c)
        c = sel_idx.shape[1]
        ye = _expert_ffn(params, xe[sel_idx], activation)         # (n, c, d)
        ye = ye * sel_val[..., None].to(ye.dtype)
        # Inverse index: the slot of each (expert, token), -1 if not kept.
        slots = torch.arange(c, device=x.device).expand(n, c)
        if keep is not None:
            slots = torch.where(keep, slots, -1)
        slot = torch.full((n, t), -1, dtype=torch.long, device=x.device)
        slot.scatter_(1, sel_idx, slots)
        at = slot[local, torch.arange(t, device=x.device)[:, None]]  # (t, k)
        at = torch.where(inside, at, -1)
        part = ye[local, at.clamp(min=0)]                         # (t, k, d)
        kept = at >= 0
        y = torch.where(kept[..., None], part, 0).sum(1)
    if stats is not None:
        stats["routed"], stats["kept"] = inside.sum(), kept.sum()
    if group is not None:
        y = reduce_from_region(y, group)
    if "shared" in params:
        y = y + ffn_block(params["shared"], xt, activation, shared_group)
    # Load-balancing aux loss (Switch-style).
    if spread:
        sums = torch.stack([combine.sum(0), probs.sum(0)])
        for g in spread:
            sums = sum_over_group(sums, g)
        density, router_prob = (sums / (t * _coordinate(spread)[1])).unbind()
    else:
        density, router_prob = combine.mean(dim=0), probs.mean(dim=0)
    aux = aux_loss_weight * e * torch.sum(density * router_prob)
    return y.reshape(b, s, d), aux


# --------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------- #

def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 group=None) -> torch.Tensor:
    """The tokens' rows of ``embed``; with ``group``, ``embed`` holds this
    rank's block of the vocabulary and every rank gets every row."""
    if group is None:
        return embed[tokens]
    return vocab_parallel_embed(embed, tokens, group)


def lm_logits(x: torch.Tensor, gamma: torch.Tensor, head: torch.Tensor,
              eps: float, group=None) -> torch.Tensor:
    """The final norm and the head: logits over the vocabulary, or over
    this rank's block of it when ``head`` is split over ``group``."""
    x = rms_norm(x, gamma, eps)
    if group is not None:
        x = copy_to_region(x, group)
    return x @ head


def serving_logits(logits: torch.Tensor, group=None) -> torch.Tensor:
    """Logits over the whole vocabulary on every rank: under ``group`` the
    ranks' blocks are all-gathered, as the reference's serving steps return
    their logits replicated."""
    if group is None:
        return logits
    return all_gather_dim(logits, logits.dim() - 1, group)


def lm_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                     group=None) -> torch.Tensor:
    """``cross_entropy_loss``, or its vocab-parallel form over logits split
    over ``group``."""
    if group is None:
        return cross_entropy_loss(logits, targets)
    return vocab_parallel_cross_entropy(logits, targets, group)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean token NLL in fp32 over the targets that are not ``ignore_id``
    (divided by at least 1). logits: (..., V), targets: (...) integer.

    The reference picks the gold logit by an iota compare (for the sake of
    a vocab-sharded axis); one device needs no such care, so it is a
    gather here. A target outside [0, V) picks nothing there: here it must
    be ``ignore_id``, whose pick is masked out."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    mask = targets != ignore_id
    picks = torch.where(mask, targets, 0).long()
    gold = torch.gather(logits, -1, picks[..., None])[..., 0]
    maskf = mask.float()
    return ((logz - gold) * maskf).sum() / maskf.sum().clamp(min=1.0)
