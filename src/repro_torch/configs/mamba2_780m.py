"""mamba2-780m — attention-free SSD (state-space duality). [arXiv:2405.21060; unverified]"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,      # attention-free
    num_kv_heads=0,
    d_ff=0,           # a Mamba2 block has no separate FFN
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(
        state_dim=128,
        head_dim=64,   # d_inner = 2 * 1536 = 3072 -> 48 SSD heads
        expand=2,
        conv_width=4,
        chunk_size=256,
        ngroups=1,
    ),
    source="[arXiv:2405.21060; unverified]",
    notes="Sub-quadratic: decode carries a (conv, ssm) state per layer and no "
          "KV cache. vocab padded 50280 -> 51200.",
)

REDUCED = CONFIG.reduced()
