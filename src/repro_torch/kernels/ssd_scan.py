"""Mamba2 SSD chunked scan: the plain PyTorch version, its stages, and the
launch of the CUDA kernels.

Counterpart of ``src/repro/kernels/ssd_scan.py``: the same function (fp32
inside, ``y`` rounded to ``x.dtype``, the final state in fp32, positions past
``s`` acting as ``dt = 0``), in the model's layout rather than the Pallas
kernel's:

    x  (b, s, h, p)    dt (b, s, h) fp32, already softplus-ed
    A  (h,) fp32 < 0   B, C (b, s, g, n), head i reading group i // (h // g)
    -> y (b, s, h, p), final state (b, h, p, n) fp32

so that the model hands over views of its conv output and nothing is
transposed, repeated or padded on the way. The scan starts from a zero state.

On the card one call runs ``STAGES``, one kernel each, in this order, through
scratch that the wrapper allocates (``ssd_buffers``); with ``q`` positions a
chunk, ``nc`` chunks and ``qp`` = ``q`` rounded up to ``TILE``:

    scores   G = C B^T once per (batch, group, chunk): ``scores``
             (b, g, nc, qp, qp) fp32, the TILE x TILE tiles on and below the
             diagonal (the others are never written or read)
    states   per (batch, head, chunk): cs, the inclusive cumsum of dt * A
             inside the chunk (``cs`` (b, h, nc, qp) fp32; past the chunk's
             last position it stays at that position's value), and the
             chunk's own state (x * dt e^(cs_last - cs))^T B (``states``
             (b, h, nc, p, n) fp32)
    pass     walks the chunks in order: S_in[c] = S; S = S e^(cs_last[c]) +
             states[c]; the incoming states overwrite ``states``; S at the
             end is the final state
    outputs  y_i = sum_{j <= i} (G_ij e^(cs_i - cs_j) dt_j) x_j
                   + e^(cs_i) C_i . S_in^T

The ``*_plain`` functions of the stages compute the same steps in PyTorch;
composed, they give ``ssd_scan_plain``, which stays the function the model
runs on the CPU.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 1024
TILE = 64                # rows and keys of a score tile; p columns a block
STAGES = ("scores", "states", "pass", "outputs")
KERNELS_PER_CALL = len(STAGES)  # CUDA kernels one ``ssd_scan_cuda`` launches


def work(b: int, s: int, h: int, p: int, n: int, g: int, chunk: int,
         dtype: torch.dtype) -> Tuple[int, int]:
    """(flops, bytes) of one call, each chunk as long as it is: C B^T on and
    below the diagonal once a group, then for each head G x, C S^T and the
    chunk's state; x, B, C read and y written once in ``dtype``, dt read
    and the final state written once in fp32, A read once."""
    q = min(chunk, s)
    lens = [min(q, s - t0) for t0 in range(0, s, q)]
    flops = sum(b * g * L * (L + 1) * n
                + b * h * (L * (L + 1) * p + 4 * L * p * n) for L in lens)
    nbytes = ((2 * b * s * h * p + 2 * b * s * g * n) * dtype.itemsize
              + 4 * (b * s * h + h + b * h * p * n))
    return flops, nbytes


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


# ------------------------------------------------------------------------- #
# The stages, plain: what each kernel computes, in fp32.
# ------------------------------------------------------------------------- #

def _chunks(t: torch.Tensor, q: int) -> torch.Tensor:
    """(b, s, ...) -> (b, nc, q, ...) in fp32, the last chunk padded with
    zeros (a padded position has dt = 0: it adds nothing and decays
    nothing)."""
    b, s = t.shape[:2]
    nc = -(-s // q)
    t = t.float()
    if nc * q != s:
        t = torch.cat([t, t.new_zeros((b, nc * q - s) + t.shape[2:])], dim=1)
    return t.reshape((b, nc, q) + t.shape[2:])


def ssd_chunk_scores_plain(B: torch.Tensor, C: torch.Tensor,
                           chunk: int) -> torch.Tensor:
    """Stage ``scores``: G = C B^T of each (batch, group, chunk), the whole
    q x q square -> (b, g, nc, q, q) fp32."""
    q = min(chunk, B.shape[1])
    return torch.einsum("bcign,bcjgn->bgcij", _chunks(C, q), _chunks(B, q))


def ssd_chunk_states_plain(x: torch.Tensor, dt: torch.Tensor,
                           A: torch.Tensor, B: torch.Tensor, chunk: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage ``states``: the in-chunk cumsum of dt * A, cs (b, h, nc, q),
    and each chunk's own state, (x * dt e^(cs_last - cs))^T B (b, h, nc, p,
    n), both fp32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    q = min(chunk, s)
    xf = _chunks(x, q).unflatten(3, (g, r))                  # (b, nc, q, g, r, p)
    dtf = _chunks(dt, q).unflatten(3, (g, r))                # (b, nc, q, g, r)
    cs = torch.cumsum(dtf * A.float().reshape(g, r), dim=2)
    w = dtf * torch.exp(cs[:, :, -1:] - cs)
    states = torch.einsum("bcjgrp,bcjgn->bgrcpn", xf * w[..., None],
                          _chunks(B, q))
    nc = cs.shape[1]
    return (cs.permute(0, 3, 4, 1, 2).reshape(b, h, nc, q),
            states.reshape(b, h, nc, p, n))


def ssd_state_pass_plain(states: torch.Tensor, cs: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage ``pass``: from a zero state, S_in[c] = S, S = S e^(cs_last[c])
    + states[c] -> (the incoming states (b, h, nc, p, n), the final state
    (b, h, p, n))."""
    decay = torch.exp(cs[..., -1])                            # (b, h, nc)
    incoming = torch.empty_like(states)
    S = torch.zeros_like(states[:, :, 0])
    for c in range(states.shape[2]):
        incoming[:, :, c] = S
        S = S * decay[:, :, c, None, None] + states[:, :, c]
    return incoming, S


def ssd_chunk_outputs_plain(x: torch.Tensor, dt: torch.Tensor,
                            cs: torch.Tensor, B: torch.Tensor,
                            C: torch.Tensor, incoming: torch.Tensor,
                            chunk: int) -> torch.Tensor:
    """Stage ``outputs``: y from the cumsums and the incoming states ->
    (b, s, h, p) in x's type."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    q = min(chunk, s)
    nc = cs.shape[2]
    G = ssd_chunk_scores_plain(B, C, chunk)                   # (b, g, nc, i, j)
    csr = cs.reshape(b, g, r, nc, q)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = (csr[..., :, None] - csr[..., None, :]).masked_fill(
        ~causal, float("-inf")).exp()                         # (b, g, r, nc, i, j)
    dtr = _chunks(dt, q).unflatten(3, (g, r)).permute(0, 3, 4, 1, 2)
    scores = G[:, :, None] * decay * dtr[..., None, :]
    xf = _chunks(x, q).unflatten(3, (g, r))                  # (b, nc, q, g, r, p)
    y = torch.einsum("bgrcij,bcjgrp->bcigrp", scores, xf)
    y = y + torch.exp(csr).permute(0, 3, 4, 1, 2)[..., None] * torch.einsum(
        "bcign,bgrcpn->bcigrp", _chunks(C, q),
        incoming.reshape(b, g, r, nc, p, n))
    return y.reshape(b, nc * q, h, p)[:, :s].to(x.dtype)


def ssd_scan_stages_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, chunk: int = 256
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stages composed as the kernels compose them: equal to
    ``ssd_scan_plain``."""
    cs, states = ssd_chunk_states_plain(x, dt, A, B, chunk)
    incoming, final = ssd_state_pass_plain(states, cs)
    return ssd_chunk_outputs_plain(x, dt, cs, B, C, incoming, chunk), final


# ------------------------------------------------------------------------- #
# The CUDA kernels.
# ------------------------------------------------------------------------- #

def _check(x, dt, A, B, C, chunk) -> int:
    """Raise on anything the kernels do not take; return the positions a
    chunk."""
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
    return q


def _buffer_specs(x: torch.Tensor, B: torch.Tensor, chunk: int) -> dict:
    """name -> (shape, dtype) of the outputs and of the stages' scratch."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(int(chunk), s)
    nc = -(-s // q)
    qp = -(-q // TILE) * TILE
    f32 = torch.float32
    return {"y": ((b, s, h, p), x.dtype), "state": ((b, h, p, n), f32),
            "scores": ((b, g, nc, qp, qp), f32), "cs": ((b, h, nc, qp), f32),
            "states": ((b, h, nc, p, n), f32)}


def ssd_buffers(x: torch.Tensor, B: torch.Tensor,
                chunk: int) -> Dict[str, torch.Tensor]:
    """The outputs ``y`` and ``state`` and the stages' scratch (``scores``,
    ``cs``, ``states``; see the module's docstring), uninitialised, on x's
    device."""
    return {name: torch.empty(shape, dtype=dtype, device=x.device)
            for name, (shape, dtype) in _buffer_specs(x, B, chunk).items()}


def _launch(x, dt, A, B, C, q: int, buffers: Dict[str, torch.Tensor],
            mask: int) -> None:
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = buffers["y"]
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _build.lib().repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), buffers["state"].data_ptr(),
            buffers["scores"].data_ptr(), buffers["cs"].data_ptr(),
            buffers["states"].data_ptr(), b, s, h, p, g, n, q,
            *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
            *y.stride()[:3], _DTYPE_CODE[x.dtype], mask, stream)
    _build.check(code, "ssd_scan kernel launch")


def ssd_stages_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int,
                    buffers: Dict[str, torch.Tensor], stages=STAGES) -> None:
    """Launch the named stage kernels, in ``STAGES``' order, on PyTorch's
    current stream, reading and writing ``buffers`` (as ``ssd_buffers``
    makes them): a stage reads what the stages before it wrote there. For
    the card's tests and timings of one stage."""
    q = _check(x, dt, A, B, C, chunk)
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise ValueError(f"ssd_scan kernel: no stage {sorted(unknown)}")
    specs = _buffer_specs(x, B, chunk)
    if set(buffers) != set(specs):
        raise ValueError(f"ssd_scan kernel: buffers {sorted(buffers)}; want "
                         f"{sorted(specs)}")
    for name, (shape, dtype) in specs.items():
        t = buffers[name]
        if (t.shape != shape or t.dtype != dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"ssd_scan kernel: buffer {name} "
                             f"{tuple(t.shape)} {t.dtype}; want {shape} "
                             f"{dtype}, contiguous, on x's device")
    _launch(x, dt, A, B, C, q, buffers,
            sum(1 << i for i, name in enumerate(STAGES) if name in stages))


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the ``KERNELS_PER_CALL`` stage kernels on PyTorch's current
    stream, with no synchronisation. x, B, C are taken by their strides
    (views of the conv output are fine; the last dim must be contiguous and
    every row 16-byte aligned). Raises on anything the kernels do not take;
    never computes the result another way."""
    q = _check(x, dt, A, B, C, chunk)
    buffers = ssd_buffers(x, B, chunk)
    _launch(x, dt, A, B, C, q, buffers, (1 << len(STAGES)) - 1)
    return buffers["y"], buffers["state"]
