"""DLRM-1.2T — the paper's §V-C case-study model (Rashidi et al. [56] Table V).

A copy of the JAX package's config, held equal to it by a test. The DLRM does
not fit :class:`ModelConfig`, so it has its own dataclass, built by
``repro_torch.models.dlrm.DLRM``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    arch_id: str
    emb_dim: int
    num_tables: int
    rows_per_table: int            # uniform proxy for the published table mix
    lookups_per_table: int         # pooled multi-hot lookups per sample
    num_dense_features: int
    bottom_mlp: Tuple[int, ...]
    top_mlp: Tuple[int, ...]

    def embedding_params(self) -> int:
        return self.num_tables * self.rows_per_table * self.emb_dim

    def top_in(self) -> int:
        """Width of the top MLP's input: the pairwise interactions of the
        T + 1 features and the bottom MLP's output."""
        n_feat = self.num_tables + 1
        return n_feat * (n_feat - 1) // 2 + self.bottom_mlp[-1]

    def mlp_params(self) -> int:
        total = 0
        for dims in ((self.num_dense_features,) + self.bottom_mlp,
                     (self.top_in(),) + self.top_mlp):
            for a, b in zip(dims[:-1], dims[1:]):
                total += a * b + b
        return total

    def param_count(self) -> int:
        return self.embedding_params() + self.mlp_params()


# ~1.2T parameters: 64 tables x 146.5M rows x 128 dims = 1.2e12.
CONFIG = DLRMConfig(
    arch_id="dlrm-1.2t",
    emb_dim=128,
    num_tables=64,
    rows_per_table=146_484_375,
    lookups_per_table=32,
    num_dense_features=13,
    bottom_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
)

# Reduced, runnable variant for tests.
REDUCED = DLRMConfig(
    arch_id="dlrm-reduced",
    emb_dim=16,
    num_tables=4,
    rows_per_table=1000,
    lookups_per_table=32,
    num_dense_features=13,
    bottom_mlp=(32, 16),
    top_mlp=(32, 16, 1),
)
