"""smollm-135m — llama-arch small dense GQA. [hf:HuggingFaceTB/SmolLM-135M; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    rope_theta=10_000.0,
    tie_embeddings=True,
    activation="swiglu",
    source="[hf:HuggingFaceTB/SmolLM-135M; hf]",
    notes="GQA group 3; tied embeddings; d_model 576 is not a power of two.",
)

REDUCED = CONFIG.reduced()
