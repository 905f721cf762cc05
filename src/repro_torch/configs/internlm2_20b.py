"""internlm2-20b — dense GQA decoder-only LM. [arXiv:2403.17297; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1_000_000.0,
    activation="swiglu",
    source="[arXiv:2403.17297; hf]",
    notes="GQA kv=8; vocab padded 92544 -> 94208.",
)

REDUCED = CONFIG.reduced()
