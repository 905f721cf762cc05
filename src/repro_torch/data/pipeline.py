"""Deterministic, resumable, sharded synthetic data pipeline.

Counterpart of ``src/repro/data/pipeline.py``. A batch is a pure function of
``(seed, step, shard)`` and of ``num_shards`` (which sets the local batch):
a ``torch.Generator`` seeded from those three numbers, no filesystem. So any
step is reproducible and resuming needs only the step counter. As in the
reference's code (not its docstring), the shard is folded into the seed: a
re-sharded stream draws new batches, it does not split the old global batch
differently. ``torch.Generator`` is not ``jax.random``: the port's batches
follow the reference's distributions, not its bits.

Batches are drawn on the device the caller names, else the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import torch

from repro_torch import resolve_device

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_dense: int = 0             # DLRM dense features
    num_tables: int = 0            # DLRM sparse tables
    lookups: int = 0
    rows: int = 0


def _mix(x: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _generator(cfg: DataConfig, step: int, shard: int,
               device: torch.device) -> torch.Generator:
    """The key of ``fold_in(fold_in(PRNGKey(seed), step), shard)``: each
    number folded into the running hash in turn."""
    key = _mix(cfg.seed & _MASK64)
    for value in (step, shard):
        key = _mix(key ^ (value & _MASK64))
    return torch.Generator(device=device).manual_seed(key)


def _local_batch(cfg: DataConfig, num_shards: int) -> int:
    if num_shards <= 0 or cfg.global_batch % num_shards:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"into {num_shards} shards")
    return cfg.global_batch // num_shards


def lm_batch(cfg: DataConfig, step: int, shard: int = 0, num_shards: int = 1,
             device=None) -> dict:
    """One LM batch shard: {tokens, targets} int32 of (B/num_shards, S).
    Zipf-ish marginals (a squared uniform scaled to the vocabulary); every
    even position repeats the previous token's bucket, so the stream is
    learnable."""
    device = resolve_device(device)
    b_local = _local_batch(cfg, num_shards)
    gen = _generator(cfg, step, shard, device)
    u = torch.rand((b_local, cfg.seq_len + 1), generator=gen, device=device)
    base = (u.square() * cfg.vocab_size).to(torch.int32)
    even = (torch.arange(cfg.seq_len + 1, device=device) % 2 == 0)[None, :]
    toks = torch.where(even, torch.roll(base, 1, dims=1), base)
    toks = toks.clamp(0, cfg.vocab_size - 1)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def dlrm_batch(cfg: DataConfig, step: int, shard: int = 0,
               num_shards: int = 1, device=None) -> dict:
    """One DLRM batch shard: dense (b, num_dense) fp32 ~ N(0, 1), sparse
    (b, tables, lookups) int32 uniform in [0, rows), labels (b,) int32 =
    1 where dense.sum(-1) + N(0, 0.25) > 0, so they can be learned."""
    device = resolve_device(device)
    b_local = _local_batch(cfg, num_shards)
    gen = _generator(cfg, step, shard, device)
    dense = torch.randn((b_local, cfg.num_dense), generator=gen, device=device)
    sparse = torch.randint(0, cfg.rows, (b_local, cfg.num_tables, cfg.lookups),
                           generator=gen, device=device, dtype=torch.int32)
    noise = torch.randn((b_local,), generator=gen, device=device)
    labels = (dense.sum(-1) + 0.5 * noise > 0).to(torch.int32)
    return {"dense": dense, "sparse": sparse, "labels": labels}


@dataclasses.dataclass
class DataIterator:
    """Stateful wrapper; ``state()`` / ``restore()`` round-trip the cursor
    through a checkpoint. ``kind``: "lm" or "dlrm"; ``device``: where the
    batches are drawn (the GPU when None)."""

    cfg: DataConfig
    step: int = 0
    shard: int = 0
    num_shards: int = 1
    kind: str = "lm"
    device: Optional[str] = None

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        fn = lm_batch if self.kind == "lm" else dlrm_batch
        batch = fn(self.cfg, self.step, self.shard, self.num_shards,
                   device=self.device)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])

    def reshard(self, shard: int, num_shards: int) -> "DataIterator":
        """Restart onto another data-parallel degree: the same cursor, a new
        split. The shard is part of each batch's seed, so the new shards'
        batches are new draws (the reference's code does the same)."""
        return dataclasses.replace(self, shard=shard, num_shards=num_shards)
