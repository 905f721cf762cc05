"""RMSNorm: the plain PyTorch version and the launch of the CUDA kernel.

Counterpart of ``src/repro/kernels/rmsnorm.py``. Both functions compute
``x * rsqrt(mean(x^2, -1) + eps) * gamma`` in fp32 and round once into
``x.dtype``. The backward (for training; the JAX package has no Pallas
backward, ``jax.grad`` of ``models/common.py``'s ``rms_norm`` is its oracle)
gives ``dx`` and ``dgamma`` in fp32, each rounded once into its type.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW_BYTES = 232448 // 4   # four rows share one block's shared memory
# The backward: four warps a block each sum dgamma over their rows into an
# fp32 row of shared memory; the grid is at most 8 blocks an SM of an H100.
_BWD_WARPS = 4
_BWD_MAX_BLOCKS = 8 * 132
BACKWARD_KERNELS_PER_CALL = 2   # the rows' pass, then the dgamma reduction


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); gamma: (d,). Plain PyTorch, any device; fp32 inside
    (fp64 for fp64 inputs)."""
    wt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(wt)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.to(wt)).to(x.dtype)


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. Raises on anything
    the kernel does not take; never computes the result another way."""
    if not (x.is_cuda and gamma.is_cuda and x.device == gamma.device):
        raise ValueError(
            f"rmsnorm kernel: x on {x.device}, gamma on {gamma.device}; "
            "both must lie on one CUDA device")
    if x.dtype not in _DTYPE_CODE or gamma.dtype != x.dtype:
        raise TypeError(
            f"rmsnorm kernel takes float32 or bfloat16 with gamma of the same "
            f"type, got x {x.dtype}, gamma {gamma.dtype}")
    if x.dim() < 1 or gamma.shape != x.shape[-1:]:
        raise ValueError(
            f"rmsnorm kernel: gamma {tuple(gamma.shape)} does not match the "
            f"last dim of x {tuple(x.shape)}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and gamma")
    d = x.shape[-1]
    if d == 0 or d * x.element_size() > _MAX_ROW_BYTES:
        raise ValueError(
            f"rmsnorm kernel: a row of {d} x {x.dtype} does not fit the "
            f"{_MAX_ROW_BYTES} bytes of shared memory a warp has")
    rows = x.numel() // d
    if rows == 0:
        raise ValueError("rmsnorm kernel: x has no rows")
    out = torch.empty_like(x)
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _build.lib().repro_rmsnorm(
            x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows, d,
            float(eps), _DTYPE_CODE[x.dtype], stream)
    _build.check(code, "rmsnorm kernel launch")
    return out


def rmsnorm_backward_plain(x: torch.Tensor, gamma: torch.Tensor,
                           dy: torch.Tensor, eps: float = 1e-5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dgamma), plain PyTorch, any device: with x^ = x * rstd and
    g = dy * gamma, dx = rstd * (g - x^ * mean(g * x^)) and dgamma = the
    sum over rows of dy * x^, in fp32 (fp64 for fp64 inputs), each rounded
    once into its input's type."""
    wt = torch.promote_types(x.dtype, torch.float32)
    d = x.shape[-1]
    xf = x.to(wt)
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xh = xf * rstd
    dyf = dy.to(wt)
    g = dyf * gamma.to(wt)
    dx = rstd * (g - xh * (g * xh).mean(dim=-1, keepdim=True))
    dgamma = (dyf * xh).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dgamma.to(gamma.dtype)


def rmsnorm_backward_blocks(rows: int) -> int:
    """Blocks of the backward's first kernel, each writing one partial row
    of dgamma: a function of the row count alone, so that every call sums
    in the same order."""
    return max(1, min(-(-rows // _BWD_WARPS), _BWD_MAX_BLOCKS))


def rmsnorm_backward_cuda(x: torch.Tensor, gamma: torch.Tensor,
                          dy: torch.Tensor, eps: float = 1e-5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward's two kernels on PyTorch's current stream:
    (dx, dgamma). Deterministic (no atomics; partial sums per block, then
    one reduction in a fixed order). Raises on anything the kernels do not
    take; never computes the result another way."""
    if not (x.is_cuda and gamma.device == x.device and dy.device == x.device):
        raise ValueError(
            f"rmsnorm backward: x on {x.device}, gamma on {gamma.device}, "
            f"dy on {dy.device}; all must lie on one CUDA device")
    if x.dtype not in _DTYPE_CODE or gamma.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(
            f"rmsnorm backward takes float32 or bfloat16, one type for x, "
            f"gamma and dy; got {x.dtype}, {gamma.dtype}, {dy.dtype}")
    if x.dim() < 1 or gamma.shape != x.shape[-1:] or dy.shape != x.shape:
        raise ValueError(
            f"rmsnorm backward: x {tuple(x.shape)}, gamma "
            f"{tuple(gamma.shape)}, dy {tuple(dy.shape)} do not fit")
    if not (x.is_contiguous() and gamma.is_contiguous() and dy.is_contiguous()):
        raise ValueError("rmsnorm backward takes contiguous x, gamma and dy")
    d = x.shape[-1]
    if d == 0 or _BWD_WARPS * d * 4 > 4 * _MAX_ROW_BYTES:
        raise ValueError(
            f"rmsnorm backward: {_BWD_WARPS} fp32 rows of {d} do not fit a "
            "block's shared memory")
    rows = x.numel() // d
    if rows == 0:
        raise ValueError("rmsnorm backward: x has no rows")
    blocks = rmsnorm_backward_blocks(rows)
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _build.lib().repro_rmsnorm_backward(
            x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dgamma.data_ptr(), part.data_ptr(), rows, d, float(eps), blocks,
            _DTYPE_CODE[x.dtype], stream)
    _build.check(code, "rmsnorm backward launch")
    return dx, dgamma
