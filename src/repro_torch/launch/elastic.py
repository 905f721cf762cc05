"""Elastic restart.

Counterpart of ``src/repro/launch/elastic.py``. A restart after a node
failure may come up with a different number of healthy devices. The pieces
that make this work:

  * checkpoint/checkpointer.py — leaves stored whole, in the reference's
    format, whatever mesh wrote them,
  * train/train_step.py — ``state_shardings`` of the new mesh and
    ``shard_train_state``, which keeps this rank's pieces,
  * train/trainer.py — straggler watchdog + preemption flush.

``remesh_state`` is the one-call wrapper a launcher uses.
"""

from __future__ import annotations

from repro_torch.checkpoint import CheckpointManager, Stacked
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import to_jax_train_state
from repro_torch.parallel.policy import MemoryPlan
from repro_torch.train.train_step import shard_train_state


def remesh_state(cfg: ModelConfig, plan: MemoryPlan,
                 manager: CheckpointManager, state_template: dict, new_mesh):
    """Restore the latest checkpoint onto a different mesh: into the whole
    ``state_template`` (a train state of the checkpoint's shapes, e.g. from
    ``init_train_state``), then this rank's pieces under ``new_mesh``.
    Returns (sharded state, the checkpoint's ``extra``, its placements).
    Raises FileNotFoundError when there is no checkpoint: never a silent
    cold start."""
    _, extra = manager.restore_latest(
        target=to_jax_train_state(state_template, stack=Stacked))
    state = shard_train_state(cfg, plan, state_template, new_mesh)
    return state, extra, state["shardings"]
