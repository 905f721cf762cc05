"""Mamba2 (SSD, state-space duality) language model, ``ssm`` family, and
the Zamba2-style ``hybrid``.

Counterpart of ``src/repro/models/mamba.py``. The module tree carries the
JAX package's leaf names: ``embed``, ``layers[i].{ln, wz, wx, wB, wC, wdt,
conv_wx, conv_wB, conv_wC, conv_b, A_log, D, dt_bias, norm_g, out_proj}``,
``ln_f``; embeddings are tied when the config says so. ``A_log``, ``D`` and
``dt_bias`` stay fp32 whatever the model's type, as in the reference.

The hybrid (zamba2) adds ONE shared attention block, ``shared_attn.{ln,
attn.{wq, wk, wv, wo}, ln_ffn, ffn.*}``: after every ``attn_every``-th layer
the same weights run attention and an FFN on ``rms_norm(concat(h, emb0))``,
emb0 being the token embeddings (reference ``_shared_attn``). Each of its
``num_layers // attn_every`` applications has its own slice of the cache's
``attn_k`` / ``attn_v`` (n_groups, b, max_seq, hkv, hd).

Prefill runs each layer's scan through ``ops.ssd_scan`` (the hand-written
kernel on the GPU), the shared block's attention through
``ops.flash_attention`` and every norm through ``ops.rmsnorm``. The causal
conv and the one-token decode recurrence have no Pallas kernel in the
reference and stay plain PyTorch. Decode updates the cache's conv and ssm
state and writes the shared block's K/V IN PLACE (the JAX package returns a
new cache).

``loss`` is the reference's. A loss takes ``ops.ssd_scan``'s training
route on every device: its forward keeps the chunks' scores, cumsums and
incoming states, and its backward is the SSD backward's kernels on the card
(the closed form on the CPU). Under the ``dots`` remat policy each layer's
scan is recomputed just before its backward, so that scratch lives for one
layer.

Tensor parallelism (``parallel.tensor.apply_tensor_parallel``) follows the
reference's rules, which GSPMD partitions there: a layer under its
``tp_group`` runs on this rank's ``h / tp`` SSD heads (``wz``, ``wx``,
``conv_wx``, ``A_log``, ``D``, ``norm_g`` its pieces, ``out_proj``
row-parallel) with B, C and dt's projections replicated
(``MambaLayer.weights``); the gated norm's row is split, so it is
``split_rms_norm``. In decode the ``ssm`` cache holds the rank's heads and
the ``conv`` cache stays whole on every rank, each new row's x channels
all-gathered before it is written. The vocabulary and the shared block
split as the transformer's do.

A loss or a prefill may run a rank's block of each row's sequence, split
over the data axis (``seq_block``, set by ``train.sharded_train_step``;
``prompt_group``, set by ``train.shard_model`` for a batch served whole on
every data rank; a ``parallel.sharding.SeqBlock``): the conv takes the
previous block's last ``conv_width - 1`` raw rows as its halo (zeros on the
first block), the scan starts from the state the earlier blocks leave
(``split_ssd_scan``) and the shared block attends over every rank's keys
(``models.common.attention_block``'s ``seq``). Every data rank's gradient
reaches the blocks it read: the halos' and the states' through the
all-gathers' reduce-scatters.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (
    DEFAULT_DTYPE,
    dense_init,
    embed_init,
    embed_tokens,
    init_generator,
    init_ffn_params,
    kv_view,
    last_row,
    lm_cross_entropy,
    lm_logits,
    prompt_block,
    rms_norm,
    rope_frequencies,
    rope_positions,
    serving_logits,
    split_rms_norm,
)
from repro_torch.models.transformer import FFN, Attention, _param, apply_remat
from repro_torch.parallel.sharding import SeqBlock, all_gather_dim
from repro_torch.parallel.tensor import (
    copy_to_region,
    gather_stacked,
    reduce_from_region,
)


def _dims(cfg: ModelConfig):
    ssm = cfg.ssm
    gn = ssm.ngroups * ssm.state_dim
    return ssm, cfg.d_inner, cfg.ssm_heads, gn, cfg.d_inner + 2 * gn


# The leaves the rules keep whole on every rank of the model axis.
_REPLICATED = ("wB", "wC", "wdt", "conv_wB", "conv_wC", "conv_b", "dt_bias")
_LEAVES = ("wz", "wx", "wB", "wC", "wdt", "conv_wx", "conv_wB", "conv_wC",
           "conv_b", "A_log", "D", "dt_bias", "norm_g", "out_proj")


class MambaLayer(nn.Module):
    """One Mamba2 block's parameters; ``mamba_layer`` and
    ``mamba_decode_step`` apply them. ``tp_group``: the model axis's group
    where the rules split the block's heads over it, else None."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        ssm, di, heads, gn, conv_ch = _dims(cfg)
        d, w = cfg.d_model, ssm.conv_width
        conv_scale = 1.0 / math.sqrt(w)
        f32 = torch.float32
        self.ln = _param(torch.ones(d, dtype=dtype), device)
        self.wz = _param(dense_init(generator, (d, di), dtype), device)
        self.wx = _param(dense_init(generator, (d, di), dtype), device)
        self.wB = _param(dense_init(generator, (d, gn), dtype), device)
        self.wC = _param(dense_init(generator, (d, gn), dtype), device)
        self.wdt = _param(dense_init(generator, (d, heads), dtype), device)
        self.conv_wx = _param(dense_init(generator, (w, di), dtype,
                                         scale=conv_scale), device)
        self.conv_wB = _param(dense_init(generator, (w, gn), dtype,
                                         scale=conv_scale), device)
        self.conv_wC = _param(dense_init(generator, (w, gn), dtype,
                                         scale=conv_scale), device)
        self.conv_b = _param(torch.zeros(conv_ch, dtype=dtype), device)
        self.A_log = _param(torch.log(torch.linspace(1.0, 16.0, heads,
                                                     dtype=f32)), device)
        self.D = _param(torch.ones(heads, dtype=f32), device)
        self.dt_bias = _param(torch.zeros(heads, dtype=f32), device)
        self.norm_g = _param(torch.ones(di, dtype=dtype), device)
        self.out_proj = _param(dense_init(generator, (di, d), dtype), device)
        self.d_inner, self.heads, self.bc_channels = di, heads, 2 * gn
        self.tp_group = None

    def _rank_range(self, n: int) -> Tuple[int, int]:
        """This rank's block of ``n`` things split over ``tp_group``."""
        k = n // dist.get_world_size(self.tp_group)
        r = dist.get_rank(self.tp_group)
        return r * k, (r + 1) * k

    def weights(self) -> Dict[str, torch.Tensor]:
        """The weights as this rank applies them, each parameter read once;
        ``conv_w`` (width, channels) holds the conv's x, B and C columns.

        Under ``tp_group``, ``wz``, ``wx``, ``conv_wx``, ``A_log``, ``D``,
        ``norm_g`` and ``out_proj`` are this rank's heads already. Each
        replicated leaf enters through ``copy_to_region`` (its gradient
        summed over the group, as ``Attention``'s shared KV heads') and is
        narrowed to what the rank uses: its heads of ``wdt`` and
        ``dt_bias``, its x channels of ``conv_b`` beside the B and C ones."""
        w = {n: getattr(self, n) for n in _LEAVES}
        if self.tp_group is not None:
            for n in _REPLICATED:
                w[n] = copy_to_region(w[n], self.tp_group)
            lo, hi = self._rank_range(self.heads)
            w["wdt"] = w["wdt"][:, lo:hi]
            w["dt_bias"] = w["dt_bias"][lo:hi]
            w["conv_b"] = self.rank_channels(w["conv_b"])
        w["conv_w"] = torch.cat([w.pop("conv_wx"), w.pop("conv_wB"),
                                 w.pop("conv_wC")], dim=-1)
        return w

    def rank_channels(self, t: torch.Tensor) -> torch.Tensor:
        """(..., conv_ch) whole -> this rank's x channels and B, C."""
        if self.tp_group is None:
            return t
        lo, hi = self._rank_range(self.d_inner)
        return torch.cat([t[..., lo:hi], t[..., self.d_inner:]], dim=-1)

    def whole_channels(self, t: torch.Tensor) -> torch.Tensor:
        """(..., this rank's conv channels) -> (..., conv_ch): the x
        channels all-gathered over ``tp_group``."""
        if self.tp_group is None:
            return t
        di = t.shape[-1] - self.bc_channels
        x = all_gather_dim(t[..., :di].contiguous(), t.dim() - 1,
                           self.tp_group)
        return torch.cat([x, t[..., di:]], dim=-1)


# --------------------------------------------------------------------- #
# Mamba2 layer (full sequence and single-step decode)
# --------------------------------------------------------------------- #

def _project(w: Dict[str, torch.Tensor], x: torch.Tensor):
    """x: (..., d) -> (z, xbc_raw, dt) with xbc_raw = concat(x', B, C)."""
    z = x @ w["wz"]
    xbc = torch.cat([x @ w["wx"], x @ w["wB"], x @ w["wC"]], dim=-1)
    return z, xbc, x @ w["wdt"]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d as the reference writes it: ``width`` shifted
    multiply-adds (no cuDNN, so fp32 stays fp32). xbc: (batch, s, ch),
    w: (width, ch); ``halo``: the (batch, width - 1, ch) raw rows before
    xbc's first (a split sequence's previous block), zeros where None."""
    width, s = w.shape[0], xbc.shape[1]
    pad = (F.pad(xbc, (0, 0, width - 1, 0)) if halo is None
           else torch.cat([halo.to(xbc.dtype), xbc], dim=1))
    out = pad[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + b)


def _gated_out(lp: MambaLayer, cfg: ModelConfig, w: Dict[str, torch.Tensor],
               y: torch.Tensor, xi: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """D skip, then rms_norm(y * silu(z)) and the out projection.
    y, xi: (..., h, p); z: (..., d_inner). Under ``tp_group`` the norm's
    row is split over the group and the projection's output summed."""
    y = y + xi * w["D"][:, None].to(xi.dtype)
    y = y.flatten(-2) * F.silu(z)
    group = lp.tp_group
    if group is None:
        return rms_norm(y, w["norm_g"], cfg.norm_eps) @ w["out_proj"]
    y = split_rms_norm(y, w["norm_g"], cfg.norm_eps, cfg.d_inner, group)
    return reduce_from_region(y @ w["out_proj"], group)


def split_ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, chunk: int, group
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops.ssd_scan`` of this rank's block of a sequence split along its
    length over ``group`` (rank r of n holds block r): (y of the block, the
    whole sequence's final state, the same on every rank).

    Each rank scans its block from zero for its final state and takes its
    total log decay sum(dt A); both are all-gathered (``gather_stacked``),
    and every rank forms its incoming state from the earlier blocks',
    S_r = sum_(j < r) e^(decay_(j+1) + ... + decay_(r-1)) final_j, then
    scans its block from S_r (the kernels' ``init_state``). The scan is
    linear in its starting state, so that is the whole sequence's scan.
    Backward, the cotangent of S_r (the kernels' ``dinit``) flows to the
    earlier blocks' finals and decays, and the gathers' reduce-scatters
    hand each rank its blocks' share: the gradient reaches every block a
    rank's output read. Every rank builds the same graph (rank 0's weights
    are zeros, not a missing term), so that every rank's backward issues
    its collectives in the same order. The block is scanned twice (from
    zero, for its final state, and from S_r), each with its backward."""
    _, final = ops.ssd_scan(x, dt, A, B, C, chunk)
    finals = gather_stacked(final, group)                    # (n, b, h, p, n)
    decays = gather_stacked((dt * A).sum(1), group)           # (n, b, h)
    n = finals.shape[0]
    # cum[i]: the log decay of blocks 0 .. i - 1
    cum = torch.cat([torch.zeros_like(decays[:1]), decays.cumsum(0)])
    rank = dist.get_rank(group)
    ends = torch.tensor([rank, n], device=x.device)          # S_r, S_n
    j = torch.arange(n, device=x.device)
    logw = cum[ends][:, None] - cum[1:][None]                 # (2, n, b, h)
    logw = torch.where((j[None] < ends[:, None])[..., None, None], logw,
                       -math.inf)
    start, whole = torch.einsum("enbh,nbhpk->ebhpk", torch.exp(logw), finals)
    y, _ = ops.ssd_scan(x, dt, A, B, C, chunk, start.contiguous())
    return y, whole


def mamba_layer(lp: MambaLayer, cfg: ModelConfig, x: torch.Tensor,
                seq: Optional[SeqBlock] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 block from a zero state. x: (b, s, d).

    Returns (out, final ssm state (b, h, p, n) fp32, conv tail): the tail is
    the last (width - 1) raw xbc rows, left-padded with zeros for a prompt
    shorter than that — the decode conv state (this rank's channels under
    ``tp_group``, and h its heads).

    With ``seq`` x holds this rank's block of each row (see the module; a
    block of at least width - 1 rows): the out of the block, and the final
    state and the tail of the whole sequence, the same on every rank."""
    ssm = cfg.ssm
    gn = ssm.ngroups * ssm.state_dim
    w = lp.weights()
    if lp.tp_group is not None:
        x = copy_to_region(x, lp.tp_group)
    heads, di = w["A_log"].shape[0], w["wx"].shape[1]
    z, xbc_raw, dt = _project(w, x)
    keep = ssm.conv_width - 1
    halo = None
    if seq is None:
        tail = xbc_raw[:, -keep:]
        if tail.shape[1] < keep:
            tail = F.pad(tail, (0, 0, keep - tail.shape[1], 0))
    else:
        if xbc_raw.shape[1] < keep:
            raise ValueError(
                f"a block of {xbc_raw.shape[1]} rows is shorter than the "
                f"conv's halo of {keep}")
        # every block's last raw rows: the next block's halo
        # (rank 0's halo is the last block's times 0: every rank builds the
        # same graph, see split_ssd_scan)
        tails = gather_stacked(xbc_raw[:, -keep:], seq.group)
        rank = dist.get_rank(seq.group)
        halo = tails[rank - 1] * (rank > 0)
        tail = tails[-1]
    xbc = _causal_conv(xbc_raw, w["conv_w"], w["conv_b"], halo)
    # Views of the conv output in the kernel's layout: no copy.
    xi = xbc[..., :di].unflatten(-1, (heads, ssm.head_dim))
    B = xbc[..., di:di + gn].unflatten(-1, (ssm.ngroups, ssm.state_dim))
    C = xbc[..., di + gn:].unflatten(-1, (ssm.ngroups, ssm.state_dim))
    # softplus in fp32; F.softplus returns its input above 20, where the
    # exact value differs from it by less than 1e-8
    dt = F.softplus(dt.float() + w["dt_bias"])
    A = -torch.exp(w["A_log"])
    if seq is None:
        y, state = ops.ssd_scan(xi, dt, A, B, C, ssm.chunk_size)
    else:
        y, state = split_ssd_scan(xi, dt, A, B, C, ssm.chunk_size, seq.group)
    return _gated_out(lp, cfg, w, y, xi, z), state, tail


def mamba_decode_step(lp: MambaLayer, cfg: ModelConfig, x: torch.Tensor,
                      conv_state: torch.Tensor,
                      ssm_state: torch.Tensor) -> torch.Tensor:
    """One-token recurrent step. x: (b, 1, d); conv_state: (b, width - 1,
    conv_ch) and ssm_state: (b, h, p, n) fp32 are views into the cache and
    are advanced IN PLACE. Returns the block's output (b, 1, d). Under
    ``tp_group`` h counts this rank's heads; conv_state stays whole."""
    ssm = cfg.ssm
    gn = ssm.ngroups * ssm.state_dim
    w = lp.weights()
    if lp.tp_group is not None:
        x = copy_to_region(x, lp.tp_group)
    heads, di = w["A_log"].shape[0], w["wx"].shape[1]
    g, r = ssm.ngroups, heads // ssm.ngroups
    z, xbc, dt = _project(w, x[:, 0])
    window = torch.cat([lp.rank_channels(conv_state).to(xbc.dtype),
                        xbc[:, None]], dim=1)
    conv_state.copy_(torch.cat([
        conv_state[:, 1:],
        lp.whole_channels(xbc[:, None]).to(conv_state.dtype)], dim=1))
    xbc = F.silu((window * w["conv_w"]).sum(dim=1) + w["conv_b"])
    b = x.shape[0]
    xi = xbc[:, :di].reshape(b, g, r, ssm.head_dim)
    B = xbc[:, di:di + gn].reshape(b, g, ssm.state_dim).float()
    C = xbc[:, di + gn:].reshape(b, g, ssm.state_dim).float()
    dt = F.softplus(dt.float() + w["dt_bias"])                   # (b, h)
    decay = torch.exp(dt * -torch.exp(w["A_log"]))               # (b, h)
    dtx = (xi * dt.reshape(b, g, r, 1).to(xi.dtype)).float()     # (b, g, r, p)
    # The heads of group k read B[:, k] and C[:, k] by broadcast.
    state = ssm_state.view(b, g, r, ssm.head_dim, ssm.state_dim)
    state.mul_(decay.reshape(b, g, r, 1, 1))
    state.add_(dtx[..., None] * B[:, :, None, None, :])
    y = torch.einsum("bgn,bgrpn->bgrp", C, state).to(xi.dtype)
    return _gated_out(lp, cfg, w, y.reshape(b, heads, -1),
                      xi.reshape(b, heads, -1), z)[:, None]


# --------------------------------------------------------------------- #
# Shared attention block (zamba2)
# --------------------------------------------------------------------- #

class SharedAttn(nn.Module):
    """The hybrid's one attention block: ``ln`` over its input (2 d_model
    wide with ``attn_concat_embedding``), ``attn`` (MHA or GQA, causal,
    RoPE), ``ln_ffn`` and ``ffn``."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        d_in = (2 * cfg.d_model if cfg.hybrid.attn_concat_embedding
                else cfg.d_model)
        self.ln = _param(torch.ones(d_in, dtype=dtype), device)
        self.attn = Attention(cfg, generator, dtype, device, d_in=d_in)
        self.ln_ffn = _param(torch.ones(cfg.d_model, dtype=dtype), device)
        self.ffn = FFN(init_ffn_params(generator, cfg.d_model, cfg.d_ff,
                                       cfg.activation, dtype),
                       cfg.activation, device)
        self.cfg = cfg

    def forward(self, h: torch.Tensor, emb0: torch.Tensor,
                kv_cache: Optional[dict], rope,
                seq: Optional[SeqBlock] = None) -> torch.Tensor:
        """h, emb0: (b, s, d) -> h after attention and the FFN, each with
        its residual. ``kv_cache``: this application's {k, v, pos}, written
        in place; ``rope``: the pass's (cos, sin) tables; ``seq``: h holds
        this rank's block of a split sequence."""
        cfg = self.cfg
        a_in = torch.cat([h, emb0], dim=-1) if (
            cfg.hybrid.attn_concat_embedding) else h
        h = h + self.attn(rms_norm(a_in, self.ln, cfg.norm_eps), kv_cache,
                          rope, seq)
        return h + self.ffn(rms_norm(h, self.ln_ffn, cfg.norm_eps))


# --------------------------------------------------------------------- #
# Model
# --------------------------------------------------------------------- #

class Mamba(nn.Module):
    """Mamba2 LM, pure (``ssm``) or with zamba2's shared attention block
    (``hybrid``). Weights are drawn from ``generator`` (a fresh one seeded
    with 0 if none is given), on its device, and are trainable. Same
    constructor as ``Transformer``."""

    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype = DEFAULT_DTYPE,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family not in ("ssm", "hybrid"):
            raise ValueError(
                f"Mamba builds the ssm and hybrid families, not {cfg.family!r}")
        if cfg.family == "hybrid" and cfg.num_layers % cfg.hybrid.attn_every:
            raise ValueError(f"{cfg.num_layers} layers do not split into "
                             f"groups of {cfg.hybrid.attn_every}")
        device = resolve_device(device)
        generator = init_generator(device, generator)
        self.cfg = cfg
        self.embed = _param(embed_init(
            generator, (cfg.padded_vocab, cfg.d_model), dtype), device)
        self.layers = nn.ModuleList(
            MambaLayer(cfg, generator, dtype, device)
            for _ in range(cfg.num_layers))
        self.ln_f = _param(torch.ones(cfg.d_model, dtype=dtype), device)
        if not cfg.tie_embeddings:
            self.head = _param(dense_init(
                generator, (cfg.d_model, cfg.padded_vocab), dtype), device)
        if cfg.family == "hybrid":
            self.shared_attn = SharedAttn(cfg, generator, dtype, device)
        # The model axis's group where ``embed`` holds this rank's block of
        # the vocabulary (parallel.tensor), as the transformer's; the
        # sequence split of a loss and of a prefill, as the transformer's.
        self.vocab_group = None
        self.seq_block = None
        self.prompt_group = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    # ------------------------------------------------------------------ #
    @property
    def attn_every(self) -> int:
        """Layers a group: the shared block follows each group (hybrid);
        0 for the pure SSM, which has none."""
        return self.cfg.hybrid.attn_every if self.cfg.family == "hybrid" else 0

    def _group(self, first: int, x: torch.Tensor, emb0: torch.Tensor,
               cache: Optional[dict], rope,
               seq: Optional[SeqBlock] = None) -> torch.Tensor:
        """Layers [first, first + group) from a zero state, then (hybrid)
        the shared block. With a cache, each layer's conv tail and final
        state OVERWRITE the cache's (never start from them) and the shared
        block writes its K/V. ``seq``: x holds this rank's block of a split
        sequence."""
        cfg = self.cfg
        every = self.attn_every
        for i in range(first, first + max(every, 1)):
            lp = self.layers[i]
            y, state, tail = mamba_layer(lp, cfg, rms_norm(x, lp.ln,
                                                           cfg.norm_eps),
                                         seq)
            x = x + y
            if cache is not None:
                cache["ssm"][i].copy_(state)
                cache["conv"][i].copy_(lp.whole_channels(tail))
        if every:
            kv = None
            if cache is not None:
                kv = kv_view(cache, "attn_k", "attn_v", first // every)
            x = self.shared_attn(x, emb0, kv, rope, seq)
        return x

    def _rope(self, s: int, cache: Optional[dict], device, start: int = 0):
        """The shared block's rotary tables for this pass (once, not once a
        group), from position ``start`` on, or None."""
        cfg = self.cfg
        if not self.attn_every or cfg.rope_fraction <= 0:
            return None
        return rope_frequencies(
            cfg.resolved_head_dim, cfg.rope_fraction, cfg.rope_theta,
            rope_positions(s, None if cache is None else cache["pos"],
                           device, start))

    def _trunk(self, tokens: torch.Tensor, cache: Optional[dict],
               remat: Optional[str] = None,
               seq: Optional[SeqBlock] = None) -> torch.Tensor:
        """Embedding and all layers from a zero state. tokens: (b, s) ->
        (b, s, d). With a cache the groups fill it (see ``_group``) and the
        clock advances by the whole sequence. ``remat``: the policy each
        group runs under (none with a cache), as the reference's. ``seq``:
        tokens are this rank's block of a split sequence."""
        x = embed_tokens(self.embed, tokens, self.vocab_group)
        emb0 = x
        rope = self._rope(tokens.shape[1], cache, x.device,
                          0 if seq is None else seq.first)
        group = apply_remat(self._group, None if cache is not None else remat)
        every = max(self.attn_every, 1)
        for first in range(0, self.cfg.num_layers, every):
            x = group(first, x, emb0, cache, rope, seq)
        if cache is not None:
            rows = tokens.shape[1] * (1 if seq is None
                                      else dist.get_world_size(seq.group))
            cache["pos"] = cache["pos"] + rows
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits over the vocabulary, or over this rank's block of it
        under ``vocab_group``."""
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return lm_logits(x, self.ln_f, head, self.cfg.norm_eps,
                         self.vocab_group)

    def _serving_logits(self, x: torch.Tensor) -> torch.Tensor:
        return serving_logits(self._logits(x), self.vocab_group)

    def forward(self, tokens: torch.Tensor, cache: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Full-sequence forward. tokens: (b, s) integer. Returns (logits
        (b, s, padded_vocab), cache); a given cache is filled as by a
        prefill (the caller's dict, updated in place)."""
        return self._serving_logits(self._trunk(tokens, cache)), cache

    def loss(self, batch: Dict[str, torch.Tensor], remat: Optional[str] = "dots"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {tokens, targets} (b, s) integer -> (total, {ce, aux}): the
        mean token cross-entropy in fp32 (targets of -1 ignored); aux is 0,
        as in the reference."""
        x = self._trunk(batch["tokens"], None, remat, self.seq_block)
        ce = lm_cross_entropy(self._logits(x), batch["targets"],
                              self.vocab_group)
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + aux, {"ce": ce, "aux": aux}

    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None) -> dict:
        """conv (L, b, width - 1, conv_ch) in ``dtype``, ssm (L, b, h, p, n)
        fp32, pos (b,); the pure SSM's is O(1) in the context. The hybrid
        adds the shared block's attn_k / attn_v (n_groups, b, max_seq, hkv,
        hd) in ``dtype``, the batch on axis 1 like the others."""
        cfg = self.cfg
        ssm, _, heads, _, conv_ch = _dims(cfg)
        L = cfg.num_layers
        dtype = dtype or self.dtype
        cache = {"conv": torch.zeros((L, batch, ssm.conv_width - 1, conv_ch),
                                     dtype=dtype, device=self.device),
                 "ssm": torch.zeros((L, batch, heads, ssm.head_dim,
                                     ssm.state_dim), dtype=torch.float32,
                                    device=self.device),
                 "pos": torch.zeros((batch,), dtype=torch.int32,
                                    device=self.device)}
        if self.attn_every:
            shape = (L // self.attn_every, batch, max_seq, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            cache["attn_k"] = torch.zeros(shape, dtype=dtype,
                                          device=self.device)
            cache["attn_v"] = torch.zeros_like(cache["attn_k"])
        return cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict
                ) -> Tuple[torch.Tensor, dict]:
        """Fill the cache from the prompt; logits of the last position,
        (b, 1, padded_vocab). Only that position goes through the final norm
        and the head. Under ``prompt_group`` this rank runs its block of a
        prompt whose length divides the group into blocks of at least the
        conv's halo (``prompt_block``); every rank gets the whole prompt's
        states and the last row's logits, bitwise the same."""
        tokens, seq = prompt_block(tokens, self.prompt_group,
                                   self.cfg.ssm.conv_width - 1)
        x = self._trunk(tokens, cache, seq=seq)
        return self._serving_logits(last_row(x, seq)), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, dict]:
        """tokens: (b, 1), one new token per sequence. Advances the cache's
        conv and ssm state in place; the hybrid's shared block writes its K/V
        at each sequence's position and attends over its cache."""
        cfg = self.cfg
        x = embed_tokens(self.embed, tokens, self.vocab_group)
        emb0 = x
        every = self.attn_every
        rope = self._rope(1, cache, x.device)
        for i, lp in enumerate(self.layers):
            x = x + mamba_decode_step(lp, cfg, rms_norm(x, lp.ln, cfg.norm_eps),
                                      cache["conv"][i], cache["ssm"][i])
            if every and (i + 1) % every == 0:
                x = self.shared_attn(x, emb0, kv_view(
                    cache, "attn_k", "attn_v", i // every), rope)
        cache["pos"] = cache["pos"] + 1
        return self._serving_logits(x), cache
