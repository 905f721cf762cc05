"""RMSNorm: the plain PyTorch version and the launch of the CUDA kernel.

Counterpart of ``src/repro/kernels/rmsnorm.py``. Both functions compute
``x * rsqrt(mean(x^2, -1) + eps) * gamma`` in fp32 and round once into
``x.dtype``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW_BYTES = 232448 // 4   # four rows share one block's shared memory


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); gamma: (d,). Plain PyTorch, any device."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


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
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad):
        raise RuntimeError(
            "rmsnorm kernel has no backward yet; call it under torch.no_grad()")
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
