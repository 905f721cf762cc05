"""Model registry: family -> constructor.

``get_model(cfg)`` returns the class that builds the model for ``cfg``; every
model offers ``forward``, ``init_cache``, ``prefill`` and ``decode_step``.
Ported so far: the dense, MoE and VLM families (``Transformer``) and the
pure-SSM family (``Mamba``). The DLRM, which has its own config, is
``repro_torch.models.dlrm.DLRM``.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba import HYBRID_PENDING, Mamba
from repro_torch.models.transformer import Transformer

_PENDING = {
    "hybrid": HYBRID_PENDING,
    "encdec": "ROADMAP Queue 1: models/encdec.py",
}


def get_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return Transformer
    if cfg.family == "ssm":
        return Mamba
    if cfg.family in _PENDING:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet ({_PENDING[cfg.family]})")
    raise ValueError(f"unknown family {cfg.family!r}")
