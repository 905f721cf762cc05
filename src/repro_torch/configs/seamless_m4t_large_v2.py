"""seamless-m4t-large-v2 — enc-dec multimodal (audio) backbone. [arXiv:2308.11596; hf]

The modality frontend (speech feature extractor / w2v-BERT conv stack) is a
STUB per the assignment: ``input_specs()`` provides precomputed frame
embeddings of shape (batch, src_len, d_model). Only the transformer
encoder-decoder backbone is modeled.
"""

from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="encdec",
    num_layers=48,  # 24 encoder + 24 decoder (brief: 24L per stack)
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,  # MHA
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    rope_theta=10_000.0,
    activation="gelu",
    encdec=EncDecConfig(encoder_layers=24, decoder_layers=24, source_frac=0.5),
    source="[arXiv:2308.11596; hf]",
    notes="Audio frontend stubbed (precomputed frame embeddings). "
          "vocab padded 256206 -> 258048. Decode shapes run on the decoder "
          "with self-attn KV cache + precomputed cross-attn KV.",
)

REDUCED = CONFIG.reduced()
