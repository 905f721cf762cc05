"""zamba2-2.7b — hybrid: Mamba2 trunk + shared attention block. [arXiv:2411.15242; hf]"""

from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,  # shared attention block is MHA
    head_dim=160,     # block operates on concat(h, emb) = 2*d_model = 5120
    d_ff=10240,       # shared block's FFN
    vocab_size=32000,
    tie_embeddings=True,
    ssm=SSMConfig(
        state_dim=64,
        head_dim=64,   # d_inner = 2*2560 = 5120 -> 80 SSD heads
        expand=2,
        conv_width=4,
        chunk_size=256,
        ngroups=1,
    ),
    hybrid=HybridConfig(attn_every=6, attn_concat_embedding=True),
    source="[arXiv:2411.15242; hf]",
    notes="One set of attention weights REUSED at layers 6,12,...,54 on "
          "concat(h, initial_emb); sub-quadratic trunk -> runs long_500k. "
          "vocab padded 32000 -> 32768.",
)

REDUCED = CONFIG.reduced()
