"""Flash attention forward: the plain PyTorch version and the launch of the
CUDA kernel.

Counterpart of ``src/repro/kernels/flash_attention.py``. Layout as there:
``q (b, h, sq, d)``, ``k, v (b, hkv, skv, d)`` -> ``(b, h, sq, d)``, with
``h % hkv == 0`` and query head ``i`` reading KV head ``i // (h // hkv)``.

The causal mask is top-left aligned like the reference kernel's
(``kpos <= qpos``). Serving adds two optional per-sequence int32 ``(b,)``
tensors: ``kv_len`` masks keys at ``kpos >= kv_len[b]`` and ``q_offset``
shifts the diagonal to ``kpos <= qpos + q_offset[b]``. A query row that may
see no key at all gives zeros.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
NEG_INF = -1e30
# Decode (sq <= 8): each (batch, KV head) splits its keys over a thread block
# cluster of one of these sizes (4 unless the caller picks another).
DECODE_CLUSTERS = (1, 2, 4, 8)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          kv_len: Optional[torch.Tensor] = None,
                          q_offset: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch, any device. Scores and softmax in fp32; probabilities
    are rounded to ``q.dtype`` before ``P @ V``, as in the kernel."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * (1.0 / math.sqrt(d))
    kpos = torch.arange(skv, device=q.device)
    allowed = torch.ones((b, 1, sq, skv), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        allowed = allowed & (kpos < kv_len.view(b, 1, 1, 1))
    if causal:
        qpos = torch.arange(sq, device=q.device).view(1, sq).expand(b, sq)
        if q_offset is not None:
            qpos = qpos + q_offset.view(b, 1)
        allowed = allowed & (kpos.view(1, 1, 1, skv) <= qpos.view(b, 1, sq, 1))
    scores = torch.where(allowed, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(allowed, probs, 0.0)     # a row with no key: zeros
    return torch.matmul(probs.to(q.dtype), v)


def _check_index_vector(name: str, t: torch.Tensor, b: int,
                        device: torch.device) -> None:
    if (t.device != device or t.dtype != torch.int32 or t.shape != (b,)
            or not t.is_contiguous()):
        raise ValueError(
            f"flash attention kernel: {name} must be a contiguous int32 "
            f"({b},) tensor on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         kv_len: Optional[torch.Tensor] = None,
                         q_offset: Optional[torch.Tensor] = None,
                         decode_cluster: Optional[int] = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. Inputs are taken by
    their strides (transposed views are fine; only the last dim must be
    contiguous and every row 16-byte aligned). ``decode_cluster``: blocks a
    (batch, KV head) splits its keys over when ``sq <= 8`` (one of
    ``DECODE_CLUSTERS``; None for the kernel's default). Raises on anything
    the kernel does not take; never computes the result another way."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"flash attention kernel: q, k, v on {q.device}, {k.device}, "
            f"{v.device}; all must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            "flash attention kernel takes float32 or bfloat16, one type for "
            f"q, k and v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash attention kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}; want (b,h,sq,d) and two (b,hkv,skv,d)")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv != 0:
        raise ValueError(
            f"flash attention kernel: q {tuple(q.shape)} and k "
            f"{tuple(k.shape)} do not fit (batch, head_dim, h % hkv)")
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if b > 65535 or h > 65535:
        raise ValueError("flash attention kernel: batch and heads <= 65535")
    if 0 in (b, h, sq, skv):
        raise ValueError(
            f"flash attention kernel: empty input, q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(
                f"flash attention kernel: last dim of {name} not contiguous")
        pitches = [s * t.element_size() for s in t.stride()[:3]]
        if t.data_ptr() % 16 or any(p % 16 for p in pitches):
            raise ValueError(
                f"flash attention kernel: rows of {name} not 16-byte aligned")
    if kv_len is not None:
        _check_index_vector("kv_len", kv_len, b, q.device)
    if q_offset is not None:
        _check_index_vector("q_offset", q_offset, b, q.device)
    if decode_cluster is not None and decode_cluster not in DECODE_CLUSTERS:
        raise ValueError(
            f"flash attention kernel: decode_cluster {decode_cluster} not in "
            f"{DECODE_CLUSTERS}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash attention kernel has no backward yet; call it under "
            "torch.no_grad()")
    # Allocated as (b, sq, h, d) and returned transposed, so the caller's
    # transpose back to the model's layout is a view of contiguous memory.
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    out = out.transpose(1, 2)
    with _build.on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = _build.lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(),
            None if q_offset is None else q_offset.data_ptr(),
            b, h, hkv, sq, skv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            1.0 / math.sqrt(d), int(bool(causal)), decode_cluster or 0,
            _DTYPE_CODE[q.dtype], stream)
    _build.check(code, "flash attention kernel launch")
    return out
