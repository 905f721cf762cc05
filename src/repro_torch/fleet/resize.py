"""The fleet's resize and preemption cost formula.

The port's copy of the JAX package's ``fleet/resize.py``. An elastic resize
restores the latest checkpoint onto a different mesh: every state leaf goes
through checkpoint storage unsharded, then is laid out under the new mesh
over the training interconnect. Hence:

    resize_delay = state_bytes / checkpoint_bw + state_bytes / reshard_bw

Preemption pays only the storage half per direction (write on preempt, read
on restore).

``instance_state_bytes`` sizes the payload for a workload the way the
checkpointer does: one unsharded copy of the model states (fp16 weights +
fp16 grads + fp32 Adam master/moments, ZeRO's 16 bytes a parameter),
activations excluded. The closed-form reliability columns
(:mod:`repro_torch.reliability`) price a checkpoint write with it.
"""

from __future__ import annotations

from repro_torch.core.memory import FP16, GRAD, OPTIM
from repro_torch.core.workload import Workload


def checkpoint_delay(state_bytes: float, checkpoint_bw: float) -> float:
    """One direction through checkpoint storage (preempt writes it,
    restore reads it back)."""
    if checkpoint_bw <= 0:
        raise ValueError(f"checkpoint_bw must be > 0, got {checkpoint_bw}")
    return state_bytes / checkpoint_bw


def remesh_delay(state_bytes: float, checkpoint_bw: float,
                 reshard_bw: float) -> float:
    """Elastic resize cost: checkpoint bytes through storage plus the
    reshard onto the new mesh."""
    if reshard_bw <= 0:
        raise ValueError(f"reshard_bw must be > 0, got {reshard_bw}")
    return checkpoint_delay(state_bytes, checkpoint_bw) \
        + state_bytes / reshard_bw


def instance_state_bytes(workload: Workload) -> float:
    """Checkpoint payload for one instance of ``workload``: the unsharded
    model states, 16 bytes a parameter (fp16 weights/grads + fp32 Adam
    states) over every layer the instance owns, replicas excluded (one copy
    is written whatever the DP degree). ``layers`` holds the per-MP-shard
    view, so the unsharded payload scales back up by ``mp``."""
    shard = sum(ly.weight_bytes * ly.repeat for ly in workload.layers) / FP16
    params = shard * max(1, workload.mp)
    return (FP16 + GRAD + OPTIM) * params


__all__ = ["checkpoint_delay", "instance_state_bytes", "remesh_delay"]
