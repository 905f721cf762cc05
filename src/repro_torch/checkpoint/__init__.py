"""Atomic/async checkpointing with retention, in the JAX package's on-disk
format (``src/repro/checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer, CheckpointManager, Stacked)
