"""minitron-8b — width-pruned Nemotron-4, dense GQA. [arXiv:2407.14679; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    rope_theta=10_000.0,
    activation="gelu",  # Nemotron uses squared-ReLU-family; modeled as gelu (2-matrix FFN)
    source="[arXiv:2407.14679; hf]",
    notes="Large 256k vocab (already 2048-aligned); pruned-teacher arch.",
)

REDUCED = CONFIG.reduced()
