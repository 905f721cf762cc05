"""llama4-maverick-400b-a17b — interleaved MoE, 128 experts top-1, shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

MoE every other layer (a dense FFN of 2 x the expert d_ff between), with an
always-on shared expert: ~400B total / ~17B active parameters, as the name
says. The source is the [unverified] tier.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,  # dense (non-MoE) interleaved layers use 2*expert d_ff
    vocab_size=202048,
    rope_theta=500_000.0,
    activation="swiglu",
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff=8192,
        moe_every=2,
        shared_expert=True,
        shared_expert_d_ff=8192,
        capacity_factor=1.25,
    ),
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
    notes="MoE every 2nd layer, 128 experts top-1 plus a shared expert; "
          "vocab padded 202048 -> 202752.",
)

REDUCED = CONFIG.reduced()
