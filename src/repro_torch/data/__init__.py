"""Deterministic synthetic data pipeline (resumable, shardable)."""
from repro_torch.data.pipeline import DataConfig, DataIterator, dlrm_batch, lm_batch  # noqa: F401
