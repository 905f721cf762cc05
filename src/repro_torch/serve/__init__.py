"""Serving: continuous-batching engine over the cached decode path."""
from repro_torch.serve.engine import Engine, EngineConfig, Request  # noqa: F401
