"""The training step: loss -> backward (accumulated over microbatches) ->
AdamW.

Counterpart of ``src/repro/train/train_step.py`` on one device.
``make_train_step`` binds (config, memory plan, optimizer config) into a
``(state, batch, generator) -> (state, metrics)`` function, as the
reference's does with a JAX key in place of the generator. The state is
``{"model", "params", "opt"}``: the module that computes the loss, its
parameters by leaf name (the module's own tensors) and the optimizer state.
The step updates them IN PLACE and returns the same dictionary.

Gradient accumulation as the reference's: ``plan.microbatches`` slices of
the batch along its first axis, each gradient cast to the accumulator type
(``bfloat16`` when the plan concedes bf16 moments, else fp32) and divided by
the count before it is added; the loss and its parts are averaged the same
way. The gradients reach the optimizer in fp32. ``state_shardings`` and
``jit_train_step`` wait for the port's ``parallel`` layer.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.parallel.policy import MemoryPlan
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_state


def _default_opt(plan: MemoryPlan) -> AdamWConfig:
    return AdamWConfig(state_dtype=plan.opt_dtype, use_master=plan.use_master)


def make_train_step(cfg: ModelConfig, plan: MemoryPlan,
                    opt_cfg: Optional[AdamWConfig] = None) -> Callable:
    """(state, batch, generator) -> (state, metrics); metrics ``loss``,
    ``ce``, ``aux``, ``lr`` and ``grad_norm`` (``lr`` a host number, the
    others fp32 tensors on the device). ``generator`` draws the stochastic
    rounding of bf16 parameters that have no master copy."""
    opt_cfg = opt_cfg or _default_opt(plan)
    m = max(1, plan.microbatches)
    acc_dtype = (torch.bfloat16 if plan.opt_dtype == "bfloat16"
                 else torch.float32)

    def train_step(state: dict, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        model, params = state["model"], state["params"]
        if m <= 1:
            loss, parts = model.loss(batch, remat=plan.remat)
            loss.backward()
            grads = {n: p.grad.float() for n, p in params.items()}
            loss = loss.detach()
            parts = {k: v.detach() for k, v in parts.items()}
        else:
            device = next(iter(params.values())).device
            loss = torch.zeros((), dtype=torch.float32, device=device)
            parts = {"ce": torch.zeros_like(loss), "aux": torch.zeros_like(loss)}
            grads = {n: torch.zeros(p.shape, dtype=acc_dtype, device=device)
                     for n, p in params.items()}
            for i in range(m):
                mb = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
                      for k, v in batch.items()}
                mb_loss, mb_parts = model.loss(mb, remat=plan.remat)
                mb_loss.backward()
                for n, p in params.items():
                    grads[n].add_(p.grad.to(acc_dtype) / m)
                    p.grad = None
                loss = loss + mb_loss.detach() / m
                parts = {k: parts[k] + mb_parts[k].detach() / m for k in parts}
            grads = {n: g.float() for n, g in grads.items()}
        for p in params.values():
            p.grad = None
        _, _, opt_metrics = apply_updates(params, grads, state["opt"], opt_cfg,
                                          generator)
        return state, {"loss": loss, **parts, **opt_metrics}

    return train_step


def init_train_state(cfg: ModelConfig, plan: MemoryPlan,
                     generator: Optional[torch.Generator] = None,
                     opt_cfg: Optional[AdamWConfig] = None,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> dict:
    """The model drawn from ``generator`` (on its device, then moved to
    ``device``, the GPU unless the caller names another) and a fresh
    optimizer state for it."""
    opt_cfg = opt_cfg or _default_opt(plan)
    model = get_model(cfg)(cfg, dtype=dtype, device=device,
                           generator=generator)
    params = dict(model.named_parameters())
    return {"model": model, "params": params,
            "opt": init_state(params, opt_cfg)}
