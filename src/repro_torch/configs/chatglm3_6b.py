"""chatglm3-6b — dense GQA with 2d (partial) RoPE. [arXiv:2406.12793; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope_theta=10_000.0,
    rope_fraction=0.5,  # GLM "2d RoPE": rotary applied to half the head dim
    activation="swiglu",
    source="[arXiv:2406.12793; hf]",
    notes="kv=2 (group 16); rotary on half the head dim; vocab padded 65024 -> 65536.",
)

REDUCED = CONFIG.reduced()
