"""Public wrappers around the CUDA kernels.

Counterpart of ``src/repro/kernels/ops.py``. The device of the input decides
the route and nothing else does: a tensor on a CUDA device goes to the
hand-written kernel (or the call raises), a tensor on the CPU goes to the
plain PyTorch version, which is how the CPU tests run. There is no switch and
no fall-back.

Each wrapper counts its kernel launches in ``<wrapper>.launches``, a plain
integer raised where the kernel is launched and nowhere else, so a run can
show that it went through the kernels. ``embedding_bag``, ``flash_attention``
and ``rmsnorm`` have gradients (``torch.autograd.Function``s whose backward
is a kernel too on the card, the plain backward on the CPU): the backward
counts in ``<wrapper>.backward_launches``, one a call of its kernels. A
forward that a remat policy recomputes during the backward is launched, and
counted, again. ``ssd_scan`` has no backward kernel: on the card it refuses
a call that wants a gradient.
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
    flash_attention_backward_cuda,
    flash_attention_backward_plain,
    flash_attention_cuda,
    flash_attention_forward_plain,
    flash_attention_lse_cuda,
    flash_attention_plain,
    rows_aligned,
)
from repro_torch.kernels.rmsnorm import (
    rmsnorm_backward_cuda,
    rmsnorm_backward_plain,
    rmsnorm_cuda,
    rmsnorm_plain,
)
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FlashAttention(torch.autograd.Function):
    """The training route: the forward also keeps each row's log-sum-exp,
    the backward recomputes the probabilities from it."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            out, lse = flash_attention_forward_plain(q, k, v, causal)
        else:
            out, lse = flash_attention_lse_cuda(q, k, v, causal)
            flash_attention.launches += 1
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_attention_backward_plain(q, k, v, out, lse, dout,
                                                   ctx.causal)
        else:
            if not rows_aligned(dout):
                dout = dout.contiguous()
            grads = flash_attention_backward_cuda(q, k, v, out, lse, dout,
                                                  ctx.causal)
            flash_attention.backward_launches += 1
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    kv_len: Optional[torch.Tensor] = None,
                    q_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (b, h, sq, d), k/v: (b, hkv, skv, d) -> (b, h, sq, d).

    ``kv_len`` / ``q_offset``: optional int32 (b,), see
    ``repro_torch.kernels.flash_attention``. When an input requires grad
    (and grad mode is on) the call takes the training route, with a
    backward, which takes neither."""
    if _wants_grad(q, k, v):
        if kv_len is not None or q_offset is not None:
            raise ValueError(
                "flash attention: the training route (an input requires "
                "grad) takes neither kv_len nor q_offset")
        return _FlashAttention.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, kv_len, q_offset)
    out = flash_attention_cuda(q, k, v, causal, kv_len, q_offset)
    flash_attention.launches += 1
    return out


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, eps):
        if x.device.type == "cpu":
            out = rmsnorm_plain(x, gamma, eps)
        else:
            out = rmsnorm_cuda(x, gamma, eps)
            rmsnorm.launches += 1
        ctx.eps = eps
        ctx.save_for_backward(x, gamma)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dgamma = rmsnorm_backward_plain(x, gamma, dy, ctx.eps)
        else:
            dx, dgamma = rmsnorm_backward_cuda(x, gamma, dy.contiguous(),
                                               ctx.eps)
            rmsnorm.backward_launches += 1
        return dx, dgamma, None


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); gamma: (d,). With a gradient when either requires it."""
    if _wants_grad(x, gamma):
        return _RMSNorm.apply(x, gamma, eps)
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
    ``repro_torch.kernels.ssd_scan``.

    The kernels have no backward: on the card a call that wants a gradient
    (an input requires grad and grad mode is on) raises rather than return
    a result that would drop it. On the CPU autograd runs through the plain
    version."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    if _wants_grad(x, dt, A, B, C):
        raise NotImplementedError(
            "ssd_scan: the CUDA kernels have no backward yet (ROADMAP "
            "Queue 2, SSD scan backward); call under torch.no_grad() on "
            "the card, or on CPU tensors for a gradient")
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
flash_attention.backward_launches = 0
rmsnorm.launches = 0
rmsnorm.backward_launches = 0
ssd_scan.launches = 0
embedding_bag.launches = 0
embedding_bag.backward_launches = 0
