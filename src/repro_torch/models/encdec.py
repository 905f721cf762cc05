"""Encoder-decoder backbone (seamless-m4t-large-v2), ``encdec`` family.

Counterpart of ``src/repro/models/encdec.py``. The audio frontend is a stub,
as there: the model consumes precomputed frame embeddings ``frames`` (b,
src_len, d_model). The module tree carries the JAX package's leaf names:
``embed``, ``encoder[i].{ln1, attn.{wq, wk, wv, wo}, ln2, ffn.*}``,
``decoder[i].{ln1, self_attn.*, lnx, cross_attn.*, ln2, ffn.*}``,
``ln_enc``, ``ln_f``, ``head`` (``convert.py`` maps them to the reference's
stacked trees). The encoder's self-attention is not causal, the decoder's
is; both rotate q and k. Cross-attention takes its keys and values from the
encoder output with no RoPE and no causal mask.

Serving: ``prefill`` encodes the source, projects every decoder layer's
cross K/V once into the cache, and runs the decoder over the prompt;
``decode_step`` runs the decoder one token at a time against the frozen
cross K/V. Every attention goes through ``ops.flash_attention`` and every
norm through ``ops.rmsnorm``. The cache is updated IN PLACE, so unlike the
reference (whose ``init_cache`` makes a cross K/V of length 0 that the
prefill replaces) ``init_cache`` sizes the cross K/V at ``src_len`` and the
prefill fills it.

Tensor parallelism (``parallel.tensor.apply_tensor_parallel``): every
attention runs on its ``Attention``'s heads of this rank (``tp_group``), the
FFNs on their columns, and the vocabulary is split as the transformer's
(``vocab_group``). The cross K/V cache then holds the rank's KV heads where
they divide over the model axis, else every KV head, each rank reading the
one its query heads share: as ``kv_cache_spec`` lays out ``cross_k`` /
``cross_v``.

The loss and the prefill run a rank's block of each row's target sequence
where the caller splits it over the data axis (``seq_block``,
``prompt_group``: as the transformer's). The encoder runs on the whole
source on every rank; the decoder's self-attention gathers every rank's
keys, its cross-attention reads the whole encoder output. A rank's backward
reaches the encoder through its own block's loss alone, so the data axis's
sum of the gradients is the whole gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
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
    prompt_block,
    rms_norm,
    rope_frequencies,
    rope_positions,
    serving_logits,
)
from repro_torch.models.transformer import FFN, Attention, _param, apply_remat
from repro_torch.parallel.sharding import SEQ_SPLIT
from repro_torch.parallel.tensor import copy_to_region


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        self.ln1 = _param(torch.ones(cfg.d_model, dtype=dtype), device)
        self.attn = Attention(cfg, generator, dtype, device)
        self.ln2 = _param(torch.ones(cfg.d_model, dtype=dtype), device)
        self.ffn = FFN(init_ffn_params(generator, cfg.d_model, cfg.d_ff,
                                       cfg.activation, dtype),
                       cfg.activation, device)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        self.ln1 = _param(torch.ones(cfg.d_model, dtype=dtype), device)
        self.self_attn = Attention(cfg, generator, dtype, device)
        self.lnx = _param(torch.ones(cfg.d_model, dtype=dtype), device)
        self.cross_attn = Attention(cfg, generator, dtype, device)
        self.ln2 = _param(torch.ones(cfg.d_model, dtype=dtype), device)
        self.ffn = FFN(init_ffn_params(generator, cfg.d_model, cfg.d_ff,
                                       cfg.activation, dtype),
                       cfg.activation, device)


class EncDec(nn.Module):
    """Encoder-decoder LM. Weights are drawn from ``generator`` (a fresh one
    seeded with 0 if none is given), on its device, and are trainable. Same
    constructor as ``Transformer``."""

    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype = DEFAULT_DTYPE,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDec builds the encdec family, not "
                             f"{cfg.family!r}")
        device = resolve_device(device)
        generator = init_generator(device, generator)
        self.cfg = cfg
        self.embed = _param(embed_init(
            generator, (cfg.padded_vocab, cfg.d_model), dtype), device)
        self.encoder = nn.ModuleList(
            EncoderLayer(cfg, generator, dtype, device)
            for _ in range(cfg.encdec.encoder_layers))
        self.decoder = nn.ModuleList(
            DecoderLayer(cfg, generator, dtype, device)
            for _ in range(cfg.encdec.decoder_layers))
        self.ln_enc = _param(torch.ones(cfg.d_model, dtype=dtype), device)
        self.ln_f = _param(torch.ones(cfg.d_model, dtype=dtype), device)
        self.head = _param(dense_init(
            generator, (cfg.d_model, cfg.padded_vocab), dtype), device)
        # The model axis's group where ``embed`` and ``head`` hold this
        # rank's block of the vocabulary, as the transformer's; the
        # sequence split's records, as the transformer's (see the module).
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
    def _rope(self, s: int, offset: Optional[torch.Tensor], device,
              start: int = 0):
        cfg = self.cfg
        if cfg.rope_fraction <= 0:
            return None
        return rope_frequencies(cfg.resolved_head_dim, cfg.rope_fraction,
                                cfg.rope_theta,
                                rope_positions(s, offset, device, start))

    def _encoder_layer(self, layer: EncoderLayer, x: torch.Tensor,
                       rope) -> torch.Tensor:
        cfg = self.cfg
        x = x + layer.attn.attend(rms_norm(x, layer.ln1, cfg.norm_eps),
                                  causal=False, rope=rope)
        return x + layer.ffn(rms_norm(x, layer.ln2, cfg.norm_eps))

    def encode(self, frames: torch.Tensor, remat: Optional[str] = None
               ) -> torch.Tensor:
        """frames (b, src, d) -> the encoder output (b, src, d), after
        ``ln_enc``. ``remat``: the policy each layer runs under."""
        x = frames.to(self.dtype)
        rope = self._rope(x.shape[1], None, x.device)
        layer_fn = apply_remat(self._encoder_layer, remat)
        for layer in self.encoder:
            x = layer_fn(layer, x, rope)
        return rms_norm(x, self.ln_enc, self.cfg.norm_eps)

    def _decoder_layer(self, i: int, x: torch.Tensor,
                       enc_out: Optional[torch.Tensor],
                       cache: Optional[dict], rope, seq=None) -> torch.Tensor:
        cfg = self.cfg
        layer = self.decoder[i]
        self_kv = cross_kv = None
        if cache is not None:
            self_kv = kv_view(cache, "self_k", "self_v", i)
            cross_kv = kv_view(cache, "cross_k", "cross_v", i, clock=False)
        x = x + layer.self_attn.attend(rms_norm(x, layer.ln1, cfg.norm_eps),
                                       self_kv, causal=True, rope=rope,
                                       seq=seq)
        x = x + layer.cross_attn.attend(
            rms_norm(x, layer.lnx, cfg.norm_eps), cross_kv,
            rope_fraction=0.0, causal=False, xkv=enc_out,
            precomputed_kv=cross_kv is not None)
        return x + layer.ffn(rms_norm(x, layer.ln2, cfg.norm_eps))

    def decode_stack(self, x: torch.Tensor, enc_out: Optional[torch.Tensor],
                     cache: Optional[dict] = None,
                     remat: Optional[str] = None, seq=None) -> torch.Tensor:
        """The decoder over embedded tokens x (b, s, d), after ``ln_f``.
        Either ``enc_out`` (training: the cross K/V projected on the fly) or
        ``cache`` (serving: the self K/V, written in place at each
        sequence's position, and the frozen cross K/V) is given; with a
        cache the clock advances by the whole sequence. ``remat`` applies
        without a cache. ``seq``: x holds this rank's block of a sequence
        split over the data axis (a ``SeqBlock``)."""
        rope = self._rope(x.shape[1], None if cache is None else cache["pos"],
                          x.device, 0 if seq is None else seq.first)
        layer_fn = apply_remat(self._decoder_layer,
                               None if cache is not None else remat)
        for i in range(len(self.decoder)):
            x = layer_fn(i, x, enc_out, cache, rope, seq)
        if cache is not None:
            rows = x.shape[1] if seq is None else seq.total(x.shape[1])
            cache["pos"] = cache["pos"] + rows
        return rms_norm(x, self.ln_f, self.cfg.norm_eps)

    def precompute_cross_kv(self, enc_out: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every decoder layer's cross K/V of the encoder output: (L, b,
        src, hkv, hd) each, of the KV heads ``wk`` / ``wv`` hold (under
        tensor parallelism this rank's, or all of them where the rules
        replicate them)."""
        b, src, _ = enc_out.shape
        shape = (b, src, -1, self.cfg.resolved_head_dim)
        ks = [(enc_out @ layer.cross_attn.wk).reshape(shape)
              for layer in self.decoder]
        vs = [(enc_out @ layer.cross_attn.wv).reshape(shape)
              for layer in self.decoder]
        return torch.stack(ks), torch.stack(vs)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_tokens(self.embed, tokens, self.vocab_group)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head over ``decode_stack``'s output: logits over the
        vocabulary, or over this rank's block of it under ``vocab_group``."""
        if self.vocab_group is not None:
            x = copy_to_region(x, self.vocab_group)
        return x @ self.head

    # ------------------------------------------------------------------ #
    def forward(self, tokens: torch.Tensor, frames: torch.Tensor
                ) -> Tuple[torch.Tensor, None]:
        """tokens (b, s) integer, frames (b, src, d) -> (logits (b, s,
        padded_vocab), None)."""
        x = self.decode_stack(self._embed(tokens), self.encode(frames))
        return serving_logits(self._logits(x), self.vocab_group), None

    def loss(self, batch: Dict[str, torch.Tensor], remat: Optional[str] = "dots"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {tokens, targets} (b, s) integer and frames (b, src, d) ->
        (total, {ce, aux}): the mean token cross-entropy in fp32 (targets of
        -1 ignored); aux is 0, as in the reference."""
        enc_out = self.encode(batch["frames"], remat)
        x = self.decode_stack(self._embed(batch["tokens"]), enc_out,
                              remat=remat, seq=self.seq_block)
        ce = lm_cross_entropy(self._logits(x), batch["targets"],
                              self.vocab_group)
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + aux, {"ce": ce, "aux": aux}

    def init_cache(self, batch: int, max_seq: int, src_len: int,
                   dtype: Optional[torch.dtype] = None) -> dict:
        """self_k / self_v (L, b, max_seq, hkv, hd), cross_k / cross_v (L,
        b, src_len, hkv, hd), all in ``dtype``, and pos (b,). The cross K/V
        is sized here and filled by ``prefill``."""
        cfg = self.cfg
        L, hkv, hd = len(self.decoder), cfg.num_kv_heads, cfg.resolved_head_dim
        dtype = dtype or self.dtype
        new = lambda s: torch.zeros((L, batch, s, hkv, hd), dtype=dtype,
                                    device=self.device)
        return {"self_k": new(max_seq), "self_v": new(max_seq),
                "cross_k": new(src_len), "cross_v": new(src_len),
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device)}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict, frames: torch.Tensor
                ) -> Tuple[torch.Tensor, dict]:
        """Encode ``frames`` into the cache's cross K/V, then fill the self
        K/V from the prompt; logits of the last position, (b, 1,
        padded_vocab). A cross cache split along the source
        (``SEQ_SPLIT``) takes this rank's block of the frames. Under
        ``prompt_group`` this rank runs its block of a prompt whose length
        divides the group (``prompt_block``), its cross-attention over the
        whole source; every rank gets the last row's logits, bitwise the
        same."""
        rows = src = cache["cross_k"].shape[2]
        split = cache.get(SEQ_SPLIT)
        rank = 0
        if split is not None and "cross_k" in split.names:
            rank = dist.get_rank(split.group)
            src *= dist.get_world_size(split.group)
        if src != frames.shape[1]:
            raise ValueError(
                f"the cache holds a source of {src} frames, the prefill "
                f"gives {frames.shape[1]}")
        ck, cv = self.precompute_cross_kv(self.encode(frames))
        first = rank * rows
        cache["cross_k"].copy_(ck[:, :, first:first + rows])
        cache["cross_v"].copy_(cv[:, :, first:first + rows])
        tokens, seq = prompt_block(tokens, self.prompt_group)
        view = cache
        if seq is not None and src != rows:
            # this rank's block of the prompt attends over every frame:
            # the whole cross K/V for the prefill, the cache its block
            dtype = cache["cross_k"].dtype
            view = {**cache, "cross_k": ck.to(dtype), "cross_v": cv.to(dtype),
                    SEQ_SPLIT: dataclasses.replace(split, names=tuple(
                        n for n in split.names if not n.startswith("cross")))}
        x = self.decode_stack(self._embed(tokens), None, cache=view, seq=seq)
        cache["pos"] = view["pos"]
        return (serving_logits(self._logits(last_row(x, seq)),
                               self.vocab_group), cache)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, dict]:
        """tokens: (b, 1), one new token per sequence."""
        x = self.decode_stack(self._embed(tokens), None, cache=cache)
        return serving_logits(self._logits(x), self.vocab_group), cache
