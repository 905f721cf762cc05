"""Public wrappers around the CUDA kernels.

Counterpart of ``src/repro/kernels/ops.py``. The device of the input decides
the route and nothing else does: a tensor on a CUDA device goes to the
hand-written kernel (or the call raises), a tensor on the CPU goes to the
plain PyTorch version, which is how the CPU tests run. There is no switch and
no fall-back.

Each wrapper counts its kernel launches in ``<wrapper>.launches``, a plain
integer raised where the kernel is launched and nowhere else, so a run can
show that it went through the kernels. ``embedding_bag`` has a gradient: its
backward counts in ``embedding_bag.backward_launches``, one a call of its
kernels (``backward_kernels_per_call`` of them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.embedding_bag import (
    EmbeddingBagPlain,
    embedding_bag_backward_cuda,
    embedding_bag_cuda,
)
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plain
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    kv_len: Optional[torch.Tensor] = None,
                    q_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (b, h, sq, d), k/v: (b, hkv, skv, d) -> (b, h, sq, d).

    ``kv_len`` / ``q_offset``: optional int32 (b,), see
    ``repro_torch.kernels.flash_attention``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, kv_len, q_offset)
    out = flash_attention_cuda(q, k, v, causal, kv_len, q_offset)
    flash_attention.launches += 1
    return out


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); gamma: (d,)."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, gamma, eps)
    out = rmsnorm_cuda(x, gamma, eps)
    rmsnorm.launches += 1
    return out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, h, p), dt: (b, s, h) fp32, A: (h,) fp32, B/C: (b, s, g, n)
    -> (y (b, s, h, p), final state (b, h, p, n) fp32); see
    ``repro_torch.kernels.ssd_scan``."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    out = ssd_scan_cuda(x, dt, A, B, C, chunk)
    ssd_scan.launches += 1
    return out


class _EmbeddingBagKernel(torch.autograd.Function):
    """Both directions through the CUDA kernels, each counted where it is
    launched."""

    @staticmethod
    def forward(ctx, tables, indices):
        ctx.save_for_backward(indices)
        ctx.num_rows = tables.shape[1]
        out = embedding_bag_cuda(tables, indices)
        embedding_bag.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        (indices,) = ctx.saved_tensors
        dtables = embedding_bag_backward_cuda(dout, indices, ctx.num_rows)
        embedding_bag.backward_launches += 1
        return dtables, None


def embedding_bag(tables: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """tables: (T, R, E), indices: (B, T, L) int32 -> (B, T, E), with a
    gradient for ``tables``; see ``repro_torch.kernels.embedding_bag``.
    ``embedding_bag.launches`` counts the forward kernel's launches,
    ``embedding_bag.backward_launches`` the backward's calls."""
    if tables.device.type == "cpu":
        return EmbeddingBagPlain.apply(tables, indices)
    return _EmbeddingBagKernel.apply(tables, indices)


flash_attention.launches = 0
rmsnorm.launches = 0
ssd_scan.launches = 0
embedding_bag.launches = 0
embedding_bag.backward_launches = 0
