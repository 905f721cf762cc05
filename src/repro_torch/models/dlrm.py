"""DLRM — the paper's §V-C case-study model, trainable.

Counterpart of ``src/repro/models/dlrm.py``: bottom MLP over the dense
features, pooled embedding-bag lookups over the sparse ones, pairwise feature
interaction, top MLP -> CTR logit, and the fp32 binary cross-entropy. The
module tree carries the JAX package's leaf names: ``tables`` (T, R, E),
``bottom.{i}.w`` / ``bottom.{i}.b`` and ``top.{i}.w`` / ``top.{i}.b``, the
matrices laid out ``(d_in, d_out)`` and applied as ``x @ w + b``.

The lookup goes through ``ops.embedding_bag``: the hand-written CUDA kernels,
forward and backward, for tensors on the GPU; their plain versions for
tensors on the CPU. The interaction's batched product is ``torch.bmm`` and the
MLPs are ``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.dlrm_1p2t import DLRMConfig
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, embed_init


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` (d_in, d_out): the reference's ``{w, b}``,
    in the type JAX promotes the operands to (an fp32 activation against
    bf16 weights computes in fp32)."""

    def __init__(self, generator: torch.Generator, d_in: int, d_out: int,
                 dtype: torch.dtype):
        super().__init__()
        self.w = nn.Parameter(dense_init(generator, (d_in, d_out), dtype))
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype,
                                          device=generator.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.w.dtype)
        return x.to(dtype) @ self.w.to(dtype) + self.b.to(dtype)


def _mlp(generator, dims, dtype) -> nn.ModuleList:
    return nn.ModuleList(Linear(generator, a, b, dtype)
                         for a, b in zip(dims[:-1], dims[1:]))


def _run_mlp(layers: nn.ModuleList, x: torch.Tensor,
             final_linear: bool = False) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = layer(x)
        if not (final_linear and i == len(layers) - 1):
            x = torch.relu(x)
    return x


class DLRM(nn.Module):
    """Trainable DLRM. Parameters are drawn on ``device`` (the GPU unless
    ``device="cpu"`` is asked for) from a generator seeded with ``seed``:
    the tables first, then the bottom and the top MLP."""

    def __init__(self, cfg: DLRMConfig, seed: int = 0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
        self.cfg = cfg
        self.tables = nn.Parameter(embed_init(
            generator, (cfg.num_tables, cfg.rows_per_table, cfg.emb_dim),
            dtype))
        self.bottom = _mlp(generator,
                           (cfg.num_dense_features,) + cfg.bottom_mlp, dtype)
        self.top = _mlp(generator, (cfg.top_in(),) + cfg.top_mlp, dtype)
        n_feat = cfg.num_tables + 1
        self.register_buffer(
            "_pairs", torch.triu_indices(n_feat, n_feat, 1, device=device),
            persistent=False)

    def forward(self, dense: torch.Tensor,
                sparse: torch.Tensor) -> torch.Tensor:
        """dense: (b, num_dense); sparse: (b, T, L) int32 -> logits (b,).
        Types promote as in the reference: fp32 ``dense`` keeps the MLPs,
        the interaction and the logits in fp32 over bf16 parameters."""
        bot = _run_mlp(self.bottom, dense)                            # (b, E)
        emb = ops.embedding_bag(self.tables, sparse)                  # (b, T, E)
        # cat promotes a bf16 ``emb`` to fp32, as jnp.concatenate does
        feats = torch.cat([bot[:, None, :], emb], dim=1)              # (b, T+1, E)
        inter = torch.bmm(feats, feats.transpose(1, 2))
        # the strict upper triangle, row-major as jnp.triu_indices orders it
        inter_flat = inter[:, self._pairs[0], self._pairs[1]]         # (b, nC2)
        top_in = torch.cat([inter_flat, bot], dim=-1)
        return _run_mlp(self.top, top_in, final_linear=True)[:, 0]

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {dense, sparse, labels (b,) in {0, 1}} -> the mean binary
        cross-entropy in fp32, written out as the reference writes it."""
        logits = self(batch["dense"], batch["sparse"]).float()
        labels = batch["labels"].float()
        bce = torch.mean(torch.clamp(logits, min=0) - logits * labels
                         + torch.log1p(torch.exp(-logits.abs())))
        return bce, {"bce": bce}
