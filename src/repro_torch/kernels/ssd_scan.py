"""Mamba2 SSD chunked scan: the plain PyTorch version and the launch of the
CUDA kernel.

Counterpart of ``src/repro/kernels/ssd_scan.py``: the same function (fp32
inside, ``y`` rounded to ``x.dtype``, the final state in fp32, positions past
``s`` acting as ``dt = 0``), in the model's layout rather than the Pallas
kernel's:

    x  (b, s, h, p)    dt (b, s, h) fp32, already softplus-ed
    A  (h,) fp32 < 0   B, C (b, s, g, n), head i reading group i // (h // g)
    -> y (b, s, h, p), final state (b, h, p, n) fp32

so that the model hands over views of its conv output and nothing is
transposed, repeated or padded on the way. The scan starts from a zero state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (16, 32, 64, 128)
P_TILES = (16, 32, 64)
P_TILE = 32          # columns of p per block: the fastest of P_TILES at the
                     # main prefill on the H100 (chip_smoke.py's p_tile_ms)
MAX_CHUNK = 1024


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, chunk: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch, any device: the Pallas kernel's chunk loop, one chunk
    at a time with the state carried, in fp32. The last chunk is simply
    shorter, which is what padding it with ``dt = 0`` computes. The heads of
    a group meet B and C through a broadcast over an (h // g) axis."""
    b, s, h, p = x.shape
    g, n = B.shape[-2], B.shape[-1]
    r = h // g
    q = min(chunk, s)
    xf = x.float().reshape(b, s, g, r, p)
    dtf = dt.float().reshape(b, s, g, r)
    Af = A.float().reshape(g, r)
    Bf, Cf = B.float(), C.float()
    state = torch.zeros((b, g, r, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, s, q):
        sl = slice(t0, min(t0 + q, s))
        xc, dtc, Bc, Cc = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        cs = torch.cumsum(dtc * Af, dim=1)                      # (b, q, g, r)
        ln = cs.shape[1]
        diff = cs[:, :, None] - cs[:, None, :]                  # (b, i, j, g, r)
        causal = torch.ones((ln, ln), dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None, None]
        decay = diff.masked_fill(~causal, float("-inf")).exp()  # 0 above the diagonal
        dtx = xc * dtc[..., None]                               # (b, q, g, r, p)
        scores = torch.einsum("bign,bjgn->bijg", Cc, Bc)[..., None] * decay
        y = torch.einsum("bijgr,bjgrp->bigrp", scores, dtx)
        y = y + cs.exp()[..., None] * torch.einsum("bign,bgrpn->bigrp",
                                                   Cc, state)
        ys.append(y)
        to_end = torch.exp(cs[:, -1:] - cs)                     # (b, q, g, r)
        state = (state * cs[:, -1].exp()[..., None, None]
                 + torch.einsum("bjgn,bjgrp->bgrpn", Bc,
                                dtx * to_end[..., None]))
    y = torch.cat(ys, dim=1).reshape(b, s, h, p).to(x.dtype)
    return y, state.reshape(b, h, p, n)


def _p_tile(p: int, p_tile: Optional[int]) -> int:
    if p_tile is not None:
        if p_tile not in P_TILES:
            raise ValueError(f"ssd_scan kernel: p_tile {p_tile} not in {P_TILES}")
        return p_tile
    # The smallest tile that holds p, at most P_TILE: a narrow head wastes
    # no lanes.
    return next(t for t in P_TILES if t >= min(p, P_TILE))


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int = 256,
                  p_tile: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream. x, B, C are taken
    by their strides (views of the conv output are fine; the last dim must be
    contiguous and every row 16-byte aligned). ``p_tile``: columns of p per
    block (16, 32 or 64; default: ``P_TILE``). Raises on anything the kernel
    does not take; never computes the result another way."""
    tensors = {"x": x, "dt": dt, "A": A, "B": B, "C": C}
    if not (x.is_cuda and all(t.device == x.device for t in tensors.values())):
        raise ValueError(
            "ssd_scan kernel: x, dt, A, B, C on "
            f"{', '.join(str(t.device) for t in tensors.values())}; all must "
            "lie on one CUDA device")
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(
            "ssd_scan kernel takes x, B, C of one type, float32 or bfloat16; "
            f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(
            f"ssd_scan kernel takes dt and A in float32, got {dt.dtype}, "
            f"{A.dtype}")
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(
            f"ssd_scan kernel: x {tuple(x.shape)}, B {tuple(B.shape)}, C "
            f"{tuple(C.shape)}; want (b,s,h,p) and two (b,s,g,n)")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (B.shape[:2] != (b, s) or dt.shape != (b, s, h) or A.shape != (h,)
            or g == 0 or h % g != 0):
        raise ValueError(
            f"ssd_scan kernel: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(B.shape)} do not fit (b, s, h % g)")
    if 0 in (b, s, h, p):
        raise ValueError(f"ssd_scan kernel: empty input x {tuple(x.shape)}")
    if n not in STATE_DIMS:
        raise ValueError(
            f"ssd_scan kernel takes state_dim n in {STATE_DIMS}, got {n}")
    if p % 8:
        raise ValueError(f"ssd_scan kernel takes head_dim p % 8 == 0, got {p}")
    if b > 65535 or h > 65535:
        raise ValueError("ssd_scan kernel: batch and heads <= 65535")
    q = min(int(chunk), s)
    if not 0 < q <= MAX_CHUNK:
        raise ValueError(
            f"ssd_scan kernel: chunk {chunk} not in [1, {MAX_CHUNK}]")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1:
            raise ValueError(f"ssd_scan kernel: last dim of {name} not contiguous")
        pitches = [st * t.element_size() for st in t.stride()[:3]]
        if t.data_ptr() % 16 or any(pt % 16 for pt in pitches):
            raise ValueError(
                f"ssd_scan kernel: rows of {name} not 16-byte aligned")
    if not A.is_contiguous():
        raise ValueError("ssd_scan kernel takes a contiguous A")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise RuntimeError(
            "ssd_scan kernel has no backward yet; call it under "
            "torch.no_grad()")
    tile = _p_tile(p, p_tile)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _build.lib().repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(),
            b, s, h, p, g, n, q, tile,
            *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
            *y.stride()[:3], _DTYPE_CODE[x.dtype], stream)
    _build.check(code, "ssd_scan kernel launch")
    return y, state
