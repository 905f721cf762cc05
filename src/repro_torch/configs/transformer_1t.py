"""Transformer-1T — the paper's §V-B case-study model (Megatron-LM 1T).

Megatron-LM's published 1T configuration: 128 layers, hidden 25600, 160 heads,
d_ff = 4*hidden, seq 2048 [arXiv:2104.04473 Table 1]. 12*L*h^2 ~= 1.007e12.
The port's copy of the JAX package's config. It feeds the analytic
evaluator (``repro_torch.core``); it is not one of the assigned
architectures.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="transformer-1t",
    family="dense",
    num_layers=128,
    d_model=25600,
    num_heads=160,
    num_kv_heads=160,  # paper predates GQA: MHA
    head_dim=160,
    d_ff=102400,
    vocab_size=51200,
    activation="gelu",
    source="[arXiv:2104.04473; paper §V-B]",
    notes="COMET case-study workload; trained seq=2048, mini-batch per paper sweep.",
)

# Paper's training shape: Megatron-LM 1T uses sequence length 2048.
SEQ_LEN = 2048
MICRO_BATCH = 1

REDUCED = CONFIG.reduced()
