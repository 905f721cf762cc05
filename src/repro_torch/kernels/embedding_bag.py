"""Pooled (sum) embedding-bag lookup, forward and backward: the plain PyTorch
versions and the launches of the CUDA kernels.

Counterpart of ``src/repro/kernels/embedding_bag.py`` and
``ref.embedding_bag_ref``:

    tables (T, R, E), indices (B, T, L) int32 -> out (B, T, E)
    out[b, t] = sum over l of tables[t, indices[b, t, l]]

summed in fp32 and rounded once into the table's type. The backward takes
``dout`` (B, T, E) to a dense ``dtables`` (T, R, E) of the same type.

Index semantics, those of the JAX package (its jnp gather and ``jax.grad`` of
it): a negative index wraps by +R; in the forward an index still outside
[0, R) is clamped into it, in the backward it is dropped (adds nothing).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2 ** 31 - 1


def _wrapped(indices: torch.Tensor, num_rows: int) -> torch.Tensor:
    idx = indices.long()
    return torch.where(idx < 0, idx + num_rows, idx)


def embedding_bag_plain(tables: torch.Tensor,
                        indices: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch, any device: gather (B, T, L, E), sum in fp32."""
    t, r, _ = tables.shape
    rows = _wrapped(indices, r).clamp_(0, r - 1)
    gathered = tables[torch.arange(t, device=tables.device)[None, :, None], rows]
    return gathered.float().sum(dim=2).to(tables.dtype)


def embedding_bag_backward_plain(dout: torch.Tensor, indices: torch.Tensor,
                                 num_rows: int) -> torch.Tensor:
    """Plain PyTorch, any device: ``index_add_`` of ``dout`` into an fp32
    (T, R, E), dropped indices left out, rounded once into ``dout.dtype``."""
    b, t, e = dout.shape
    lookups = indices.shape[2]
    rows = _wrapped(indices, num_rows)
    keep = ((rows >= 0) & (rows < num_rows)).flatten()
    flat = (rows + num_rows * torch.arange(t, device=rows.device)[None, :, None])
    source = dout.float()[:, :, None, :].expand(b, t, lookups, e).reshape(-1, e)
    dtables = torch.zeros((t * num_rows, e), dtype=torch.float32,
                          device=dout.device)
    dtables.index_add_(0, flat.flatten()[keep], source[keep])
    return dtables.view(t, num_rows, e).to(dout.dtype)


class EmbeddingBagPlain(torch.autograd.Function):
    """The plain versions under autograd, on any device: what the port runs
    for CPU tensors, and what a run on the card holds the kernels against."""

    @staticmethod
    def forward(ctx, tables, indices):
        ctx.save_for_backward(indices)
        ctx.num_rows = tables.shape[1]
        return embedding_bag_plain(tables, indices)

    @staticmethod
    def backward(ctx, dout):
        (indices,) = ctx.saved_tensors
        return embedding_bag_backward_plain(dout, indices, ctx.num_rows), None


def _check_indices(indices: torch.Tensor, device: torch.device, what: str):
    if indices.device != device:
        raise ValueError(f"{what}: indices on {indices.device}, expected "
                         f"{device}")
    if indices.dtype != torch.int32 or indices.dim() != 3:
        raise TypeError(f"{what} takes int32 indices (B, T, L), got "
                        f"{indices.dtype} {tuple(indices.shape)}")


def _check_sizes(what: str, b: int, t: int, lookups: int, r: int, e: int):
    if b * t == 0 or e == 0 or r == 0:
        raise ValueError(f"{what}: empty input (B {b}, T {t}, R {r}, E {e})")
    if max(b, t, lookups, r, e) > _INT32_MAX:
        raise ValueError(f"{what}: a size exceeds the kernel's int32 counts")


def embedding_bag_cuda(tables: torch.Tensor,
                       indices: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on PyTorch's current stream. Tables and
    indices are taken by their strides (the table's last dim must be
    contiguous). Raises on anything the kernel does not take; never computes
    the result another way."""
    what = "embedding_bag kernel"
    if not tables.is_cuda:
        raise ValueError(f"{what}: tables on {tables.device}; they must lie "
                         "on a CUDA device")
    _check_indices(indices, tables.device, what)
    if tables.dtype not in _DTYPE_CODE or tables.dim() != 3:
        raise TypeError(f"{what} takes float32 or bfloat16 tables (T, R, E), "
                        f"got {tables.dtype} {tuple(tables.shape)}")
    t, r, e = tables.shape
    b, t2, lookups = indices.shape
    if t2 != t:
        raise ValueError(f"{what}: indices {tuple(indices.shape)} do not "
                         f"match tables {tuple(tables.shape)}")
    _check_sizes(what, b, t, lookups, r, e)
    if tables.stride(2) != 1:
        raise ValueError(f"{what}: the last dim of the tables is not "
                         "contiguous")
    out = torch.empty((b, t, e), dtype=tables.dtype, device=tables.device)
    with _build.on_device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        code = _build.lib().repro_embedding_bag(
            tables.data_ptr(), indices.data_ptr(), out.data_ptr(),
            b, t, lookups, r, e, tables.stride(0), tables.stride(1),
            *indices.stride(), _DTYPE_CODE[tables.dtype], stream)
    _build.check(code, "embedding_bag kernel launch")
    return out


def embedding_bag_backward_cuda(dout: torch.Tensor, indices: torch.Tensor,
                                num_rows: int) -> torch.Tensor:
    """Launch the backward kernel: a dense ``dtables`` (T, num_rows, E) of
    ``dout.dtype``, zero-filled here, then the atomics (fp32 into the result
    itself, or into fp32 scratch rounded once for bf16). ``dout`` is taken
    by its strides (last dim contiguous). Raises on anything the kernel does
    not take."""
    what = "embedding_bag backward kernel"
    if not dout.is_cuda:
        raise ValueError(f"{what}: dout on {dout.device}; it must lie on a "
                         "CUDA device")
    _check_indices(indices, dout.device, what)
    if dout.dtype not in _DTYPE_CODE or dout.dim() != 3:
        raise TypeError(f"{what} takes float32 or bfloat16 dout (B, T, E), "
                        f"got {dout.dtype} {tuple(dout.shape)}")
    b, t, e = dout.shape
    lookups = indices.shape[2]
    if indices.shape[:2] != (b, t):
        raise ValueError(f"{what}: indices {tuple(indices.shape)} do not "
                         f"match dout {tuple(dout.shape)}")
    r = int(num_rows)
    _check_sizes(what, b, t, lookups, r, e)
    if dout.stride(2) != 1:
        raise ValueError(f"{what}: the last dim of dout is not contiguous")
    acc = torch.zeros((t, r, e), dtype=torch.float32, device=dout.device)
    dtables = acc if dout.dtype == torch.float32 else torch.empty(
        (t, r, e), dtype=dout.dtype, device=dout.device)
    with _build.on_device(dout.device):
        stream = torch.cuda.current_stream(dout.device).cuda_stream
        code = _build.lib().repro_embedding_bag_backward(
            dout.data_ptr(), indices.data_ptr(), acc.data_ptr(),
            dtables.data_ptr(), b, t, lookups, r, e, dout.stride(0),
            dout.stride(1), *indices.stride(), _DTYPE_CODE[dout.dtype],
            stream)
    _build.check(code, "embedding_bag backward kernel launch")
    return dtables
