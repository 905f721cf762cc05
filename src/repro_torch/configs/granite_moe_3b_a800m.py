"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,  # per-expert hidden dim (fine-grained experts)
    vocab_size=49155,
    rope_theta=10_000.0,
    tie_embeddings=True,
    activation="swiglu",
    moe=MoEConfig(
        num_experts=40,
        top_k=8,
        d_ff=512,
        moe_every=1,
        shared_expert=False,
        capacity_factor=1.5,
    ),
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
    notes="MoE in every layer, 40 experts of d_ff 512, top-8; tied "
          "embeddings; vocab padded 49155 -> 51200.",
)

REDUCED = CONFIG.reduced()
