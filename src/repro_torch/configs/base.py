"""Config dataclasses for model architectures and input shapes.

The PyTorch package's own copy of the JAX package's ``ModelConfig`` and its
sub-configs: same fields, same defaults, same ``reduced()`` rule, so a config
with one ``arch_id`` describes the same model on both sides and weights carry
across leaf for leaf. ``repro_torch.models`` builds the modules from it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# The embedding and the logits span the vocabulary rounded up to this unit.
# It is the JAX package's unit, kept so that its weights load unchanged.
VOCAB_PAD_UNIT = 2048


def pad_vocab(vocab_size: int, unit: int = VOCAB_PAD_UNIT) -> int:
    return int(math.ceil(vocab_size / unit) * unit)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts block parameters."""

    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    moe_every: int = 1             # MoE block every k-th layer (others dense)
    shared_expert: bool = False    # Llama4-style always-on shared expert
    shared_expert_d_ff: int = 0    # 0 -> same as d_ff
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    # "gather": capacity-based top-C gather/scatter dispatch (EP-friendly).
    # "dense": run every expert on every token, weight by the combine matrix
    #          — no dispatch collectives; profitable for fine-grained experts
    #          under expert-TP where E*d_ff is small (granite: 40 x 512).
    dispatch: str = "gather"

    @property
    def shared_d_ff(self) -> int:
        return self.shared_expert_d_ff or self.d_ff


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD (state-space duality) block parameters."""

    state_dim: int                 # N: per-head SSM state size
    head_dim: int = 64             # P: channels per SSD head
    expand: int = 2                # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256          # SSD chunk length
    ngroups: int = 1               # B/C groups (GQA-like for SSM)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder split (seamless-m4t style)."""

    encoder_layers: int
    decoder_layers: int
    # Ratio of encoder source length to decoder target length for a given
    # shape's seq_len budget (audio encoders see long frame sequences).
    source_frac: float = 0.5


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    """Modality frontend stub: input_specs() supplies precomputed embeddings."""

    num_patches: int = 256         # vision prefix length (per image)
    patch_embed_dim: int = 0       # 0 -> d_model


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: SSM trunk + shared (reused) attention block."""

    attn_every: int = 6            # shared attention block applied every k layers
    attn_concat_embedding: bool = True  # block input = concat(h, initial_emb)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: (seq_len, global_batch, kind).

    ``num_microbatches`` is the pipeline-parallel microbatch count used
    when a strategy has pp > 1 (0 = auto: the decomposition defaults to
    4 * pp, capped at the per-replica batch)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"
    num_microbatches: int = 0

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description.

    ``family`` is one of: dense | moe | ssm | hybrid | encdec | vlm.
    Unused fields for a family are left at their defaults.
    """

    arch_id: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # Attention / positional details
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0     # chatglm3 "2d RoPE": rotary on half the head dim
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    activation: str = "swiglu"     # swiglu | gelu
    # Sharding hint of the JAX package's mesh rules; carried so configs stay
    # field-for-field equal, read by nothing until the parallel slice.
    attn_batch_shard: bool = False
    # Sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    vision: Optional[VisionStubConfig] = None
    hybrid: Optional[HybridConfig] = None
    # Bookkeeping
    source: str = ""               # provenance note ([arXiv/hf; tier])
    notes: str = ""

    # ------------------------------------------------------------------ #
    # Derived quantities
    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> long_500k is runnable."""
        return self.family in ("ssm", "hybrid")

    def applicable_shapes(self) -> tuple:
        """Which of the four assigned shapes this arch runs (the others are
        the reference's documented skips)."""
        names = ["train_4k", "prefill_32k", "decode_32k"]
        if self.supports_long_context:
            names.append("long_500k")
        return tuple(names)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.head_dim

    # ------------------------------------------------------------------ #
    # Parameter counting (used for MODEL_FLOPS = 6*N*D and footprints)
    # ------------------------------------------------------------------ #
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        q = self.d_model * self.num_heads * hd
        kv = 2 * self.d_model * self.num_kv_heads * hd
        o = self.num_heads * hd * self.d_model
        return q + kv + o

    def _dense_ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.activation == "swiglu" else 2
        return mult * self.d_model * d_ff

    def _ssm_params(self) -> int:
        assert self.ssm is not None
        di, ng, n = self.d_inner, self.ssm.ngroups, self.ssm.state_dim
        nheads = self.ssm_heads
        in_proj = self.d_model * (2 * di + 2 * ng * n + nheads)
        conv = self.ssm.conv_width * (di + 2 * ng * n)
        out_proj = di * self.d_model
        head_extra = 2 * nheads  # A_log, D
        return in_proj + conv + out_proj + head_extra

    def _layer_params(self, layer_idx: int) -> int:
        """Parameter count of one trunk layer (by family)."""
        norms = 2 * self.d_model
        if self.family == "ssm":
            return self._ssm_params() + self.d_model  # single pre-norm
        if self.family == "hybrid":
            # SSM trunk layer; the shared attention block is counted once
            # globally in param_count().
            return self._ssm_params() + self.d_model
        attn = self._attn_params()
        if self.family == "moe":
            assert self.moe is not None
            if (layer_idx % self.moe.moe_every) == (self.moe.moe_every - 1):
                ffn = self.moe.num_experts * self._dense_ffn_params(self.moe.d_ff)
                ffn += self.d_model * self.moe.num_experts  # router
                if self.moe.shared_expert:
                    ffn += self._dense_ffn_params(self.moe.shared_d_ff)
            else:
                ffn = self._dense_ffn_params(self.d_ff)
            return attn + ffn + norms
        # dense / vlm backbone / encdec trunk layer
        return attn + self._dense_ffn_params(self.d_ff) + norms

    def _shared_attn_params(self) -> int:
        """Zamba2 shared attention block (input dim 2*d_model)."""
        assert self.hybrid is not None
        d_in = 2 * self.d_model if self.hybrid.attn_concat_embedding else self.d_model
        hd = self.resolved_head_dim
        q = d_in * self.num_heads * hd
        kv = 2 * d_in * self.num_kv_heads * hd
        o = self.num_heads * hd * self.d_model
        ffn = self._dense_ffn_params(self.d_ff) if self.d_ff else 0
        return q + kv + o + ffn + 2 * d_in

    def param_count(self) -> int:
        """Total parameters (with padded vocab)."""
        emb = self.padded_vocab * self.d_model
        head = 0 if self.tie_embeddings else self.padded_vocab * self.d_model
        total = emb + head + self.d_model  # final norm
        if self.family == "encdec":
            assert self.encdec is not None
            for i in range(self.encdec.encoder_layers):
                total += self._layer_params(i)
            for i in range(self.encdec.decoder_layers):
                total += self._layer_params(i) + self._attn_params() + self.d_model  # + cross-attn
        else:
            for i in range(self.num_layers):
                total += self._layer_params(i)
            if self.family == "hybrid":
                total += self._shared_attn_params()
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        assert self.moe is not None
        total = self.param_count()
        # Subtract inactive experts.
        n_moe_layers = sum(
            1 for i in range(self.num_layers)
            if (i % self.moe.moe_every) == (self.moe.moe_every - 1)
        )
        per_expert = self._dense_ffn_params(self.moe.d_ff)
        inactive = n_moe_layers * (self.moe.num_experts - self.moe.top_k) * per_expert
        return total - inactive

    # ------------------------------------------------------------------ #
    # Reduced config for CPU smoke tests
    # ------------------------------------------------------------------ #
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config: few layers, narrow width, small vocab."""
        kw: dict = dict(
            arch_id=self.arch_id + "-reduced",
            family=self.family,
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 2,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            rope_theta=self.rope_theta,
            rope_fraction=self.rope_fraction,
            tie_embeddings=self.tie_embeddings,
            activation=self.activation,
            source=self.source,
            notes="reduced smoke-test variant",
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2), d_ff=64,
                shared_expert_d_ff=64 if self.moe.shared_expert else 0)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk_size=32)
        if self.encdec is not None:
            kw["encdec"] = dataclasses.replace(
                self.encdec, encoder_layers=2, decoder_layers=2)
        if self.vision is not None:
            kw["vision"] = dataclasses.replace(self.vision, num_patches=8)
        if self.hybrid is not None:
            kw["hybrid"] = dataclasses.replace(self.hybrid, attn_every=2)
        return ModelConfig(**kw)
