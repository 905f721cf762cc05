"""Carries parameters and caches between the JAX package's trees and the
port's modules, as numpy arrays: neither side imports the other.

The JAX tree stacks the layers on a leading axis (``layers.ln1`` is
``(L, d)``, ``layers.attn.wq`` is ``(L, d, h*hd)``, ``dense_ffn.wg`` is
``(L, d, d_ff)``; for mamba2 ``layers.wz`` is ``(L, d, d_inner)``); the
port's state dict has one entry per layer (``layers.3.attn.wq``,
``layers.3.wz``). Matrices keep their ``(d_in, d_out)`` layout, so the
conversion is a copy. The DLRM's tree has no stacked layers: its MLPs are
lists, whose entries become ``bottom.0.w`` and so on.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _to_tensor(arr) -> torch.Tensor:
    """numpy -> torch, bfloat16 included: numpy knows bf16 only as an
    extension type, so its 16 bits are reinterpreted."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_jax_params(params: Mapping, cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` of
    the JAX dense transformer or mamba2) -> a state dict for
    ``load_state_dict`` of the model ``get_model(cfg)`` builds."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1)")
    state = {"embed": _to_tensor(params["embed"]),
             "ln_f": _to_tensor(params["ln_f"])}
    if "head" in params:
        state["head"] = _to_tensor(params["head"])
    layers = params["layers"]
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            for name, stacked in layers.items():
                state[f"layers.{i}.{name}"] = _to_tensor(stacked[i])
        return state
    ffn = params["dense_ffn"]
    for i in range(cfg.num_layers):
        state[f"layers.{i}.ln1"] = _to_tensor(layers["ln1"][i])
        state[f"layers.{i}.ln2"] = _to_tensor(layers["ln2"][i])
        for name, stacked in layers["attn"].items():
            state[f"layers.{i}.attn.{name}"] = _to_tensor(stacked[i])
        for name, stacked in ffn.items():
            state[f"layers.{i}.ffn.{name}"] = _to_tensor(stacked[i])
    return state


def from_jax_dlrm_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX DLRM's tree of numpy arrays (``tables`` and the lists
    ``bottom`` / ``top`` of ``{w, b}``) -> a state dict for ``DLRM``."""
    state = {"tables": _to_tensor(params["tables"])}
    for mlp in ("bottom", "top"):
        for i, layer in enumerate(params[mlp]):
            for name in ("w", "b"):
                state[f"{mlp}.{i}.{name}"] = _to_tensor(layer[name])
    return state


def cache_to_numpy(cache: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's cache as numpy arrays in the JAX package's layout (dense:
    ``k``/``v`` (L, b, S, hkv, d); mamba2: ``conv`` (L, b, width - 1,
    conv_ch), ``ssm`` (L, b, h, p, n); ``pos`` (b,)); bf16 widens to fp32.
    The arrays are copies: the port updates its cache in place, so a view
    would change under the caller at the next decode step."""
    out = {}
    for name, t in cache.items():
        t = t.detach().cpu()
        out[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return out
