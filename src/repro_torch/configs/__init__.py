"""Architecture registry of the PyTorch package.

``get_config("smollm-135m")`` -> full ModelConfig
``get_config("smollm-135m", reduced=True)`` -> small test variant

Registered: every assigned architecture of the JAX package: the dense
family, the MoE family (granite-moe, llama4-maverick), the VLM backbone
(internvl2), mamba2 (``ssm``), zamba2 (``hybrid``) and seamless-m4t
(``encdec``); and the paper's case-study model transformer-1t, which feeds
the analytic evaluator (``repro_torch.core``) and is not one of the
assigned architectures. The DLRM has a config of its own:
``get_dlrm_config()``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    SHAPES,
    EncDecConfig,
    HybridConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    VisionStubConfig,
    pad_vocab,
)

# arch-id -> module name under repro_torch.configs
_ARCH_MODULES: Dict[str, str] = {
    "internlm2-20b": "internlm2_20b",
    "chatglm3-6b": "chatglm3_6b",
    "minitron-8b": "minitron_8b",
    "smollm-135m": "smollm_135m",
    "mamba2-780m": "mamba2_780m",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "internvl2-76b": "internvl2_76b",
    "zamba2-2.7b": "zamba2_2p7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    # the paper's case-study model (analytic path; not an assigned arch)
    "transformer-1t": "transformer_1t",
}

ASSIGNED_ARCHS: List[str] = [a for a in _ARCH_MODULES if a != "transformer-1t"]


def list_configs() -> List[str]:
    return sorted(_ARCH_MODULES)


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.REDUCED if reduced else mod.CONFIG


def get_dlrm_config(reduced: bool = False):
    """The DLRM's own config (``DLRMConfig`` is not a ``ModelConfig``, so
    ``get_config`` does not know it)."""
    from repro_torch.configs import dlrm_1p2t
    return dlrm_1p2t.REDUCED if reduced else dlrm_1p2t.CONFIG


def all_cells() -> List[tuple]:
    """Every (arch_id, shape_name) cell, including documented skips:
    (arch_id, shape_name, runnable, skip_reason), as the reference's."""
    cells = []
    for arch_id in ASSIGNED_ARCHS:
        runnable = set(get_config(arch_id).applicable_shapes())
        for shape_name in SHAPES:
            if shape_name in runnable:
                cells.append((arch_id, shape_name, True, ""))
            else:
                cells.append((arch_id, shape_name, False,
                              "long_500k skipped: full quadratic attention at "
                              "512k context is mis-provisioned"))
    return cells
