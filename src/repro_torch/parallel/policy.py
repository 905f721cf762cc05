"""Memory planner: COMET's footprint model applied to the runtime.

Counterpart of ``src/repro/parallel/policy.py``, the port's own copy (the
port imports nothing of the JAX package). Before the training state is
built, ``plan_memory`` runs the model-state accounting against the mesh and
the device memory and picks:

  * the ZeRO stage (1 = optimizer states over DP; 3 = params+grads too),
  * the optimizer state dtype (fp32 Adam, or bf16 moments + stochastic
    rounding when even ZeRO-3 fp32 states exceed the memory),
  * the number of microbatches and the remat policy.

The arithmetic is the reference's; the default capacity is one H100's
80 GB instead of a TPU v5e's.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

H100_HBM_BYTES = 80e9   # one H100 SXM's device memory (NVIDIA's data sheet)


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    zero_stage: int                # 1 or 3 (param fsdp)
    opt_dtype: str                 # "float32" | "bfloat16"
    use_master: bool               # fp32 master copy of bf16 params
    remat: str                     # "none" | "dots" | "full"
    est_bytes_per_chip: float
    microbatches: int = 1          # gradient-accumulation steps
    notes: str = ""

    @property
    def fsdp(self) -> bool:
        return self.zero_stage >= 3


def _state_bytes(params: float, tp: int, dp: int, zero: int,
                 opt_bytes: float) -> float:
    """Per-device bytes: bf16 params + bf16 grads + optimizer states."""
    p_shard = params / tp
    if zero >= 3:
        return (2 + 2 + opt_bytes) * p_shard / dp
    return (2 + 2) * p_shard + opt_bytes * p_shard / dp


def _activation_plan(cfg: ModelConfig, shape, dp: int,
                     act_budget: float) -> tuple:
    """(microbatches, remat) so remat-saved residuals fit the budget.

    Under per-layer remat the live activation set is dominated by the saved
    layer inputs: L * b_micro * seq * d_model * 2 bytes (SSM blocks carry a
    wider d_inner working set -> family factor). ``shape``: anything with
    ``kind``, ``global_batch`` and ``seq_len`` (a training shape), or None."""
    if shape is None or shape.kind != "train":
        return 1, "dots"
    b_local = max(1, shape.global_batch // max(dp, 1))
    seq = shape.seq_len
    if cfg.family == "vlm" and cfg.vision is not None:
        seq += cfg.vision.num_patches
    factor = {"ssm": 3.0, "hybrid": 3.5}.get(cfg.family, 1.5)
    layers = cfg.num_layers
    if cfg.family == "encdec" and cfg.encdec is not None:
        layers = cfg.encdec.encoder_layers + 2 * cfg.encdec.decoder_layers

    def saved(b_micro: int) -> float:
        return layers * b_micro * seq * cfg.d_model * 2 * factor

    m = 1
    while saved(-(-b_local // m)) > act_budget and m < b_local:
        m *= 2
    # "dots" (saves projection outputs too, ~4x) only when it still fits
    remat = "dots" if saved(-(-b_local // m)) * 4 <= act_budget else "full"
    return m, remat


def plan_memory(cfg: ModelConfig, tp: int, dp: int,
                hbm_bytes: float = H100_HBM_BYTES,
                shape=None) -> MemoryPlan:
    """Pick the cheapest configuration that fits.

    State preference order (cheapest communication first): ZeRO-1 fp32 ->
    ZeRO-3 fp32 -> ZeRO-3 bf16 moments (+ stochastic rounding, no master).
    Then size gradient accumulation + remat so activations fit the rest."""
    params = float(cfg.param_count())
    budget = hbm_bytes * 0.75
    candidates = [
        (1, "float32", True, 12.0,
         "ZeRO-1: fp32 Adam (m, v, master) sharded over DP"),
        (3, "float32", True, 12.0,
         "ZeRO-3: params+grads+states sharded over DP (FSDP)"),
        (3, "bfloat16", False, 4.0,
         "ZeRO-3 + bf16 moments, no master (stochastic rounding)"),
    ]
    chosen = None
    for zero, dtype, master, opt_bytes, note in candidates:
        est = _state_bytes(params, tp, dp, zero, opt_bytes)
        # grad accumulators during the microbatch loop (bf16 when the plan
        # already concedes bf16 moments)
        acc_bytes = 2.0 if dtype == "bfloat16" else 4.0
        est += acc_bytes * params / tp / (dp if zero >= 3 else 1)
        if est <= budget:
            chosen = (zero, dtype, master, est, note)
            break
    if chosen is None:
        est = _state_bytes(params, tp, dp, 3, 4.0)
        return MemoryPlan(3, "bfloat16", False, "full", est, 1,
                          "over budget even at ZeRO-3/bf16 — needs more "
                          "chips or host offload (COMET Eqn 3 territory)")
    zero, dtype, master, est, note = chosen
    act_budget = max(hbm_bytes - est - 2e9, 2e9)
    micro, remat = _activation_plan(cfg, shape, dp, act_budget)
    return MemoryPlan(zero, dtype, master, remat, est, micro, note)
