"""Model registry: family -> constructor.

``get_model(cfg)`` returns the class that builds the model for ``cfg``; every
model offers ``forward``, ``loss``, ``init_cache``, ``prefill`` and
``decode_step``: the dense, MoE and VLM families (``Transformer``), the
pure-SSM and hybrid families (``Mamba``) and the encoder-decoder
(``EncDec``, whose forward, loss and prefill also take the source
``frames``). The DLRM, which has its own config, is
``repro_torch.models.dlrm.DLRM``.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.mamba import Mamba
from repro_torch.models.transformer import Transformer


def get_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return Transformer
    if cfg.family in ("ssm", "hybrid"):
        return Mamba
    if cfg.family == "encdec":
        return EncDec
    raise ValueError(f"unknown family {cfg.family!r}")
