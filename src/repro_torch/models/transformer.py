"""Decoder-only transformer LM: dense GQA, interleaved MoE, and the VLM
backbone.

Counterpart of ``src/repro/models/transformer.py``: the dense configs
(internlm2, chatglm3, minitron, smollm), the MoE family (granite: MoE in
every layer; llama4-maverick: MoE every ``moe_every`` layers with a shared
expert, dense FFNs between) and the VLM backbone (internvl2: precomputed
patch embeddings prepended to the token stream). The module tree carries the
JAX package's leaf names: ``embed``, ``layers[i].ln1``,
``layers[i].attn.{wq,wk,wv,wo}``, ``layers[i].ln2``, then
``layers[i].ffn.{wg,wu,wd}`` or, at the last position of each super-block of
``moe_every`` layers, ``layers[i].moe.{router,we_gate,we_up,we_down,
shared.*}``; ``ln_f`` and, for untied embeddings, ``head``
(``convert.py`` maps them to the reference's stacked tree). A Python loop
over the layers takes the place of ``lax.scan`` over stacked parameters.

Trainable: ``loss`` is the reference's (the MoE layers' auxiliary losses
summed into ``aux``), with its remat policies (``apply_remat``) on
``torch.utils.checkpoint``; attention and RMSNorm run their kernels in both
directions on the GPU. Serving (``prefill``, ``decode_step``) runs under
``torch.no_grad()``; a decode step ignores the auxiliary loss.

The loss and the prefill run a rank's block of each row's sequence where
the caller splits it over the data axis (``seq_block``, set by
``train.sharded_train_step``; ``prompt_group``, set by ``train.
shard_model`` for a batch served whole on every data rank): the rotary
positions start at the block's first row, each attention gathers every
rank's keys (``models.common.attention_block``'s ``seq``) and each MoE
layer routes the blocks as one microbatch in the reference's token order
(``moe_block``'s ``seq``). The VLM's patches belong to rank 0's block
(``prefix_block``), so its block is the longer by their rows.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    DEFAULT_DTYPE,
    attention_block,
    dense_init,
    embed_init,
    embed_tokens,
    init_generator,
    ffn_block,
    init_ffn_params,
    init_moe_params,
    kv_view,
    last_row,
    lm_cross_entropy,
    lm_logits,
    moe_block,
    prefix_block,
    prompt_block,
    rms_norm,
    rope_frequencies,
    rope_positions,
    serving_logits,
)
from repro_torch.parallel.tensor import copy_to_region


def _param(t: torch.Tensor, device: torch.device) -> nn.Parameter:
    return nn.Parameter(t.to(device))


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of the unbatched matrix products (the projections,
    the FFN), recompute the rest: ``dots_with_no_batch_dims_saveable``.
    The kernels reach this policy as the ``repro_torch.*`` dispatcher
    operators (``kernels/ops.py``: ``flash_attention_lse``, ``rmsnorm``,
    ``ssd_scan_train``, ...); they are recomputed, as are attention's
    batched products, since only ``aten.mm`` / ``aten.addmm`` are saved."""
    if op in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def apply_remat(fn: Callable, policy: Optional[str]) -> Callable:
    """``fn`` wrapped in the remat ``policy``, as the reference's:

    * ``none`` (or None): ``fn`` itself, every activation kept;
    * ``full``: nothing inside ``fn`` kept, all recomputed in the backward;
    * ``dots``: the outputs of ``aten.mm`` / ``aten.addmm`` kept;
    * ``blocks``: the reference keeps the attention and FFN outputs it tags
      ``block_out``. Here the trunk checkpoints the attention and the FFN
      sub-blocks each on its own (``full`` on each), so what is kept is
      the residual stream between them: as many bytes, the same gradients;
      each sub-block's last projection is recomputed as well."""
    if policy is None or policy == "none":
        return fn
    if policy in ("full", "blocks"):
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"unknown remat policy {policy!r}")


class Attention(nn.Module):
    """The leaves of the reference's ``init_attention_params``: ``wq``,
    ``wk``, ``wv`` (d_in, heads * head_dim) and ``wo`` (h * head_dim,
    d_model); ``d_in`` is d_model unless given (zamba2's shared block reads
    concat(h, emb0), twice as wide). ``forward`` is the self-attention of
    the transformer's layers; ``attend`` takes other options (the
    encoder-decoder's non-causal and cross-attention).

    ``tp_group``: the model axis's process group where the weights are
    shards of it (set by ``parallel.tensor.apply_tensor_parallel``): ``wq``
    and ``wo`` hold this rank's heads; ``wk``/``wv`` hold its KV heads, or,
    where the KV heads do not divide over the group, all of them, and the
    rank takes the one its query heads share."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device,
                 d_in: Optional[int] = None):
        super().__init__()
        hd = cfg.resolved_head_dim
        d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        d_in = d_in or d
        self.wq = _param(dense_init(generator, (d_in, h * hd), dtype), device)
        self.wk = _param(dense_init(generator, (d_in, hkv * hd), dtype),
                         device)
        self.wv = _param(dense_init(generator, (d_in, hkv * hd), dtype),
                         device)
        self.wo = _param(dense_init(generator, (h * hd, d), dtype,
                                    scale=1.0 / (h * hd) ** 0.5), device)
        self.cfg = cfg
        self.tp_group = None

    def params(self) -> Dict[str, torch.Tensor]:
        return {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}

    def _local_heads(self, params: Dict[str, torch.Tensor]
                     ) -> Tuple[int, int, Optional[int]]:
        """This rank's (query heads, KV heads, the KV head it takes, or None
        where the KV heads divide over ``tp_group``); narrows replicated
        ``wk``/``wv`` in ``params`` to the KV head its query heads share."""
        cfg, group = self.cfg, self.tp_group
        hd, tp = cfg.resolved_head_dim, dist.get_world_size(group)
        heads = cfg.num_heads // tp
        if cfg.num_kv_heads % tp == 0:
            return heads, cfg.num_kv_heads // tp, None
        # query heads a KV head; a rank's never straddle two KV groups
        # (apply_tensor_parallel refuses that)
        per_kv = cfg.num_heads // cfg.num_kv_heads
        kv = dist.get_rank(group) * heads // per_kv
        for name in ("wk", "wv"):
            # every rank's grads of the replicated weight, summed
            w = copy_to_region(params[name], group)
            params[name] = w[:, kv * hd:(kv + 1) * hd]
        return heads, 1, kv

    def attend(self, x: torch.Tensor, kv_cache: Optional[dict] = None,
               **kw) -> torch.Tensor:
        """``attention_block`` on this module's weights, over this rank's
        heads under ``tp_group``; ``kw`` are its options (``causal``,
        ``rope``, ``xkv``, ...). A cache (the self K/V, or a frozen cross
        K/V) holds the rank's KV heads, or every KV head where the rules
        replicate them, and then the rank reads and writes its own."""
        cfg = self.cfg
        params = self.params()
        heads, kv_heads = cfg.num_heads, cfg.num_kv_heads
        if self.tp_group is not None:
            heads, kv_heads, kv = self._local_heads(params)
            if kv is not None and kv_cache is not None:
                kv_cache = {**kv_cache, "k": kv_cache["k"].narrow(2, kv, 1),
                            "v": kv_cache["v"].narrow(2, kv, 1)}
        kw.setdefault("rope_fraction", cfg.rope_fraction)
        return attention_block(
            params, x, num_heads=heads, num_kv_heads=kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            kv_cache=kv_cache, group=self.tp_group, **kw)

    def forward(self, x: torch.Tensor, kv_cache: Optional[dict],
                rope=None, seq=None) -> torch.Tensor:
        return self.attend(x, kv_cache, causal=True, rope=rope, seq=seq)


class FFN(nn.Module):
    """A dense FFN's leaves (``init_ffn_params``) as parameters; under
    ``tp_group`` (as ``Attention``'s) this rank's columns of the hidden
    layer. The leaves are read as attributes, as ZeRO-3's gather-on-use
    (``parallel.zero.gather_on_use``) needs."""

    def __init__(self, params: Dict[str, torch.Tensor], activation: str,
                 device):
        super().__init__()
        for name, t in params.items():
            setattr(self, name, _param(t, device))
        self.leaves = tuple(params)
        self.activation = activation
        self.tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ffn_block({n: getattr(self, n) for n in self.leaves}, x,
                         self.activation, self.tp_group)


class MoE(nn.Module):
    """A MoE block's leaves (``init_moe_params``): the fp32 router, the
    stacked experts and, where the config has one, the shared expert.

    Set by ``parallel.tensor``: ``tp_group``, the model axis's group where
    the experts are split over it (by experts, EP, where ``we_up`` holds
    fewer than all; else by their hidden layers); ``route_groups``, the
    data-parallel groups whose ranks' tokens are routed as one microbatch
    (``moe_block``). ``stats``: a dictionary the caller may set, which each
    call fills with its routed and kept (token, expert) pairs.
    ``forward``'s ``seq``: the split (a ``SeqBlock``) x is a block of
    (``moe_block``)."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        m = cfg.moe
        p = init_moe_params(generator, cfg.d_model, m.d_ff, m.num_experts,
                            cfg.activation,
                            m.shared_d_ff if m.shared_expert else 0, dtype)
        shared = p.pop("shared", None)
        for name, t in p.items():
            setattr(self, name, _param(t, device))
        self.leaves = tuple(p)
        if shared is not None:
            self.shared = FFN(shared, cfg.activation, device)
        self.cfg = cfg
        self.tp_group = None
        self.route_groups = ()
        self.stats = None

    def forward(self, x: torch.Tensor, seq=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        m = self.cfg.moe
        params = {n: getattr(self, n) for n in self.leaves}
        shared_group = None
        if hasattr(self, "shared"):
            params["shared"] = {n: getattr(self.shared, n)
                                for n in self.shared.leaves}
            shared_group = self.shared.tp_group
        return moe_block(params, x, top_k=m.top_k,
                         capacity_factor=m.capacity_factor,
                         activation=self.cfg.activation,
                         aux_loss_weight=m.aux_loss_weight,
                         dispatch=m.dispatch, group=self.tp_group,
                         shared_group=shared_group,
                         route_groups=self.route_groups, stats=self.stats,
                         seq=seq)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, dtype, device,
                 is_moe: bool):
        super().__init__()
        self.ln1 = _param(torch.ones(cfg.d_model, dtype=dtype), device)
        self.attn = Attention(cfg, generator, dtype, device)
        self.ln2 = _param(torch.ones(cfg.d_model, dtype=dtype), device)
        if is_moe:
            self.moe = MoE(cfg, generator, dtype, device)
        else:
            self.ffn = FFN(init_ffn_params(generator, cfg.d_model, cfg.d_ff,
                                           cfg.activation, dtype),
                           cfg.activation, device)


def is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    """MoE at the last position of each super-block of ``moe_every``."""
    return cfg.moe is not None and i % cfg.moe.moe_every == cfg.moe.moe_every - 1


class Transformer(nn.Module):
    """Dense, MoE or VLM decoder. Weights are drawn from ``generator`` (a
    fresh one seeded with 0 if none is given), on its device, and are
    trainable."""

    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype = DEFAULT_DTYPE,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1)")
        if cfg.moe is not None and cfg.num_layers % cfg.moe.moe_every:
            raise ValueError(f"{cfg.num_layers} layers do not split into "
                             f"super-blocks of {cfg.moe.moe_every}")
        device = resolve_device(device)
        generator = init_generator(device, generator)
        self.cfg = cfg
        self.embed = _param(embed_init(
            generator, (cfg.padded_vocab, cfg.d_model), dtype), device)
        self.layers = nn.ModuleList(
            Block(cfg, generator, dtype, device, is_moe_layer(cfg, i))
            for i in range(cfg.num_layers))
        self.ln_f = _param(torch.ones(cfg.d_model, dtype=dtype), device)
        if not cfg.tie_embeddings:
            self.head = _param(dense_init(
                generator, (cfg.d_model, cfg.padded_vocab), dtype), device)
        # The model axis's group where ``embed`` (and ``head``) hold this
        # rank's block of the vocabulary (parallel.tensor): the loss then
        # runs on the block's logits, serving all-gathers them.
        self.vocab_group = None
        # A loss's split of each row's sequence over the data axis (a
        # parallel.sharding.SeqBlock), and the data axis's group over which a
        # prefill of a batch served whole splits its prompt: see the module.
        self.seq_block = None
        self.prompt_group = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    # ------------------------------------------------------------------ #
    def _attn_part(self, layer: "Block", x: torch.Tensor,
                   kv: Optional[dict] = None, rope=None, seq=None
                   ) -> torch.Tensor:
        return layer.attn(rms_norm(x, layer.ln1, self.cfg.norm_eps), kv, rope,
                          seq)

    def _ffn_part(self, layer: "Block", x: torch.Tensor, seq=None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The FFN sub-block's output and, for a MoE layer, its aux loss."""
        h = rms_norm(x, layer.ln2, self.cfg.norm_eps)
        if hasattr(layer, "moe"):
            return layer.moe(h, seq)
        return layer.ffn(h), None

    def _block(self, layer: "Block", x: torch.Tensor,
               kv: Optional[dict] = None, rope=None, seq=None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = x + self._attn_part(layer, x, kv, rope, seq)
        y, aux = self._ffn_part(layer, x, seq)
        return x + y, aux

    def _embed(self, tokens: torch.Tensor,
               patches: Optional[torch.Tensor]) -> torch.Tensor:
        """Token embeddings (b, s, d), behind the VLM's patch embeddings
        (b, p, d) when there are any."""
        x = embed_tokens(self.embed, tokens, self.vocab_group)
        if patches is not None:
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        return x

    def _trunk(self, x: torch.Tensor, cache: Optional[dict],
               remat: Optional[str] = None, seq=None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """All layers over the embedded sequence x (b, s, d) -> (x, the MoE
        layers' summed aux loss, fp32, or None without a MoE layer: a dense
        pass makes no tensor for it). Writes the cache's K/V in place and
        advances its clock (by the whole sequence). ``remat``: the policy
        each layer runs under (none with a cache). ``seq``: x holds this
        rank's block of a sequence split over the data axis."""
        cfg = self.cfg
        if cache is not None:
            remat = None
        aux = None
        # The rotary tables depend on the positions only: once per pass, not
        # once per layer (eager PyTorch folds nothing).
        rope = None
        if cfg.rope_fraction > 0:
            rope = rope_frequencies(
                cfg.resolved_head_dim, cfg.rope_fraction, cfg.rope_theta,
                rope_positions(x.shape[1],
                               None if cache is None else cache["pos"],
                               x.device, 0 if seq is None else seq.first))
        if remat == "blocks":
            attn_part = apply_remat(self._attn_part, remat)
            ffn_part = apply_remat(self._ffn_part, remat)
            for layer in self.layers:
                x = x + attn_part(layer, x, None, rope, seq)
                y, layer_aux = ffn_part(layer, x, seq)
                x = x + y
                if layer_aux is not None:
                    aux = layer_aux if aux is None else aux + layer_aux
            return x, aux
        block = apply_remat(self._block, remat)
        for i, layer in enumerate(self.layers):
            kv = None
            if cache is not None:
                kv = kv_view(cache, "k", "v", i)
            x, layer_aux = block(layer, x, kv, rope, seq)
            if layer_aux is not None:
                aux = layer_aux if aux is None else aux + layer_aux
        if cache is not None:
            rows = x.shape[1] if seq is None else seq.total(x.shape[1])
            cache["pos"] = cache["pos"] + rows
        return x, aux

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits over the vocabulary, or over this rank's block of it under
        ``vocab_group``."""
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return lm_logits(x, self.ln_f, head, self.cfg.norm_eps,
                         self.vocab_group)

    def _serving_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits over the whole vocabulary on every rank."""
        return serving_logits(self._logits(x), self.vocab_group)

    def forward(self, tokens: torch.Tensor, cache: Optional[dict] = None,
                patches: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """tokens: (b, s) integer; patches: (b, p, d) for the VLM. Returns
        (logits (b, p + s, padded_vocab), cache). The cache is the caller's
        own dict, updated in place."""
        x, _ = self._trunk(self._embed(tokens, patches), cache)
        return self._serving_logits(x), cache

    def loss(self, batch: Dict[str, torch.Tensor], remat: Optional[str] = "dots"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {tokens, targets} (b, s) integer, and ``patches`` (b, p, d)
        for the VLM -> (total, {ce, aux}): the mean token cross-entropy in
        fp32 (targets of -1 ignored) over the token positions (the patches'
        are dropped), and the MoE layers' summed aux loss (0 without MoE)."""
        patches, seq = prefix_block(batch.get("patches"), self.seq_block)
        x, aux = self._trunk(self._embed(batch["tokens"], patches), None,
                             remat, seq)
        n_patch = 0 if patches is None else patches.shape[1]
        logits = self._logits(x[:, n_patch:])
        ce = lm_cross_entropy(logits, batch["targets"], self.vocab_group)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + aux, {"ce": ce, "aux": aux}

    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None) -> dict:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dtype = dtype or self.dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device)}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict,
                patches: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, dict]:
        """Fill a fresh cache from the prompt (behind ``patches`` for the
        VLM); logits of the last position, (b, 1, padded_vocab). Only that
        position goes through the final norm and the head: the others'
        logits are not needed to serve. Under ``prompt_group`` this rank
        runs its block of a prompt whose length divides the group
        (``prompt_block``; the patches on rank 0); every rank gets the last
        row's logits, bitwise the same."""
        tokens, seq = prompt_block(tokens, self.prompt_group)
        patches, seq = prefix_block(patches, seq)
        x, _ = self._trunk(self._embed(tokens, patches), cache, seq=seq)
        return self._serving_logits(last_row(x, seq)), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, dict]:
        """tokens: (b, 1) — one new token per sequence."""
        return self.forward(tokens, cache)
