"""``meta``-device input stand-ins for every (arch x shape) cell.

Counterpart of ``src/repro/launch/specs.py``. No allocation anywhere:
batches, parameters and decode caches are ``meta`` tensors (the port's
``ShapeDtypeStruct``), and a model built on ``meta`` draws nothing
(``models.common.init_generator``), so the dry run (``launch/dryrun.py``)
can trace a full-size model on one host.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import get_model

I32 = torch.int32
BF16 = torch.bfloat16


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(d) for d in shape), dtype=dtype,
                       device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Model inputs for one cell (modality frontends stubbed as embeddings)."""
    gb, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {"tokens": _sds((gb, s), I32), "targets": _sds((gb, s), I32)}
        if cfg.family == "vlm":
            batch["patches"] = _sds((gb, cfg.vision.num_patches, cfg.d_model),
                                    BF16)
        if cfg.family == "encdec":
            src = int(s * cfg.encdec.source_frac)
            batch["tokens"] = _sds((gb, s - src), I32)
            batch["targets"] = _sds((gb, s - src), I32)
            batch["frames"] = _sds((gb, src, cfg.d_model), BF16)
        return batch
    if shape.kind == "prefill":
        out = {"tokens": _sds((gb, s), I32)}
        if cfg.family == "vlm":
            out["patches"] = _sds((gb, cfg.vision.num_patches, cfg.d_model),
                                  BF16)
        if cfg.family == "encdec":
            src = int(s * cfg.encdec.source_frac)
            out["tokens"] = _sds((gb, s - src), I32)
            out["frames"] = _sds((gb, src, cfg.d_model), BF16)
        return out
    # decode: one new token against a seq_len-deep cache
    return {"tokens": _sds((gb, 1), I32)}


def abstract_model(cfg: ModelConfig, dtype=BF16) -> torch.nn.Module:
    """The model on ``meta``: every parameter an empty meta tensor."""
    return get_model(cfg)(cfg, dtype=dtype, device="meta")


def abstract_params(cfg: ModelConfig, dtype=BF16) -> Dict[str, torch.Tensor]:
    """The port's parameters by name (``convert.to_jax_params`` gives the
    reference's tree of them), on ``meta``."""
    return dict(abstract_model(cfg, dtype).named_parameters())


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig, dtype=BF16,
                   model=None) -> Dict[str, torch.Tensor]:
    """The whole decode cache of a serving cell, on ``meta``: the prompt
    (behind the VLM's patches) and, for a decode step, one more row; the
    encoder-decoder's self cache holds its target part, its cross cache the
    source frames."""
    model = model if model is not None else abstract_model(cfg, dtype)
    gb, s = shape.global_batch, shape.seq_len
    max_seq = s + (cfg.vision.num_patches if cfg.family == "vlm" else 0)
    if shape.kind == "decode":
        max_seq += 1
    kw = {}
    if cfg.family == "encdec":
        kw["src_len"] = int(s * cfg.encdec.source_frac)
        max_seq = s - kw["src_len"] + 1
    return model.init_cache(gb, max_seq, dtype=dtype, **kw)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D for inference forward passes
    (N = active params, D = tokens processed this step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: 1 token per sequence
