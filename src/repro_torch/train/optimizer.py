"""AdamW with the JAX package's state dtypes and master-weight modes.

Counterpart of ``src/repro/train/optimizer.py``. Modes:
  * fp32 Adam: bf16 params + fp32 master + fp32 m/v (16 B/param),
  * bf16 moments, no master, stochastic rounding of the bf16 update,
  * fp32 params without master (``use_master=False``): 16 B/param with
    m and v, and nothing redundant.

Parameters, gradients and moments are dictionaries of tensors keyed by leaf
name. Unlike the reference, which returns new trees, ``apply_updates``
works IN PLACE, because the largest leaf may be most of the card (a DLRM's
tables): parameters, master copies and moments are updated where they lie,
and each gradient is consumed (scaled by the clip factor and reused as
scratch). The operations and their order are the reference's: clip by the
global norm, bias-corrected moments, decay only where ``ndim >= 2`` in the
reference's tree, then the master and bf16 paths. fp32 temporaries are made only for leaves that are not
fp32. The step counter is a host integer tensor, so the learning rate and the
bias corrections are host numbers and a step never waits for the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"       # "float32" | "bfloat16"
    use_master: bool = True
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup + cosine decay."""
    step = float(step)
    warm = min(1.0, step / max(cfg.warmup_steps, 1))
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = min(max(prog, 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_state(params: Tree, cfg: AdamWConfig) -> dict:
    sdt = _STATE_DTYPES[cfg.state_dtype]
    state = {
        "m": {k: torch.zeros_like(p, dtype=sdt) for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=sdt) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32),
    }
    if cfg.use_master:
        state["master"] = {k: p.detach().float().clone()
                           for k, p in params.items()}
    return state


def _stochastic_round(x: torch.Tensor, generator: Optional[torch.Generator],
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Unbiased fp32 -> bf16 rounding (replaces the master copy).

    The one-ulp neighbour is taken by stepping the bf16 bit pattern toward x
    (fp32 nextafter would round back to the same bf16); int16 arithmetic
    wraps as the reference's uint16 does, so the bits are the same."""
    y = x.to(dtype)                          # round-to-nearest baseline
    yf = y.float()
    bits = y.view(torch.int16)
    toward_up = x > yf
    delta = torch.where(toward_up == (yf >= 0), 1, -1).to(torch.int16)
    neighbor = (bits + delta).view(dtype)
    nf = neighbor.float()
    span = (nf - yf).abs()
    frac = torch.where(span > 0, (x - yf).abs() / span, 0.0)
    r = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(r < frac, neighbor, y)


def _sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    """A leaf's sum of squares in fp32: its dot product with itself, which
    makes no temporary of the leaf's size for a contiguous fp32 leaf.
    (``torch.linalg.vector_norm`` on the CPU was seen 3.5e-5 relative off
    the reference's ``sum(g ** 2)`` for a (2048, 64) gradient.)"""
    flat = g.float().reshape(-1)
    return torch.dot(flat, flat)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(_sum_of_squares(g) for g in tree.values()))


@torch.no_grad()
def apply_updates(params: Tree, grads: Tree, state: dict, cfg: AdamWConfig,
                  generator: Optional[torch.Generator] = None,
                  grad_norm: Optional[torch.Tensor] = None
                  ) -> Tuple[Tree, dict, dict]:
    """Returns (params, state, metrics): the caller's own dictionaries,
    updated in place. ``generator`` draws the stochastic rounding of bf16
    parameters without a master copy (the reference's ``rng``).
    ``grad_norm``: the global norm, where ``grads`` are one rank's pieces
    of a larger tree (``train_step.sharded_train_step``); else
    ``global_norm(grads)``.

    Weight decay takes the reference's rule on the reference's leaves: a
    leaf of two or more dimensions there. The reference stacks a model's
    layers, so a leaf under ``layers.`` carries one dimension more than the
    port's (the per-layer norm gains are decayed, ``ln_f`` is not)."""
    step = int(state["step"]) + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.grad_clip > 0 else None)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    use_master = cfg.use_master and "master" in state

    for name, p in params.items():
        g = grads[name].float()          # the gradient itself when fp32
        if scale is not None:
            g.mul_(scale)
        m, v = state["m"][name], state["v"][name]
        m2, v2 = m.float(), v.float()    # the moments themselves when fp32
        m2.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v2.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        # upd = (m2 / b1c) / (sqrt(v2 / b2c) + eps), built in g's storage
        upd = torch.div(v2, b2c, out=g).sqrt_().add_(cfg.eps)
        upd = torch.div(m2, upd, out=upd).div_(b1c)
        base = state["master"][name] if use_master else p.float()
        decayed = p.dim() + name.startswith("layers.") >= 2
        if cfg.weight_decay > 0 and decayed:
            upd.add_(base, alpha=cfg.weight_decay)
        base.add_(upd, alpha=-lr)        # base is now the new value
        if p.dtype == torch.bfloat16 and not use_master and generator is not None:
            p.copy_(_stochastic_round(base, generator))
        elif base is not p:
            p.copy_(base)
        if m2 is not m:
            m.copy_(m2)
        if v2 is not v:
            v.copy_(v2)
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return params, state, {"lr": lr, "grad_norm": gnorm}
