"""internvl2-76b — VLM: vision frontend (stub) + LLaMA-3-70B-class backbone.
[arXiv:2404.16821; unverified]

The vision frontend is a stub: the caller hands precomputed patch embeddings
(batch, num_patches, d_model), which are prepended to the token embeddings.
Only the language backbone is modelled.
"""

from repro_torch.configs.base import ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    arch_id="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    activation="swiglu",
    vision=VisionStubConfig(num_patches=256),
    source="[arXiv:2404.16821; unverified]",
    notes="~76B dense backbone behind 256 patch embeddings; vocab padded "
          "128256 -> 129024.",
)

REDUCED = CONFIG.reduced()
