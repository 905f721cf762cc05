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
transposed, repeated or padded on the way. The scan starts from a zero state
or from the caller's ``init_state`` (b, h, p, n) fp32, as the reference's
``ssd_chunked`` does: a rank's block of a sequence split along its length
over the data ranks starts from the state the earlier blocks leave. The
backward then also gives the initial state's cotangent ``dinit`` (b, h, p,
n) fp32: the D its state pass carries past chunk 0.

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
    pass     walks the chunks in order from S = the initial state (or 0):
             S_in[c] = S; S = S e^(cs_last[c]) + states[c]; the incoming
             states overwrite ``states``; S at the end is the final state
    outputs  y_i = sum_{j <= i} (G_ij e^(cs_i - cs_j) dt_j) x_j
                   + e^(cs_i) C_i . S_in^T

The ``*_plain`` functions of the stages compute the same steps in PyTorch;
composed, they give ``ssd_scan_plain``, which stays the function the model
runs on the CPU.

The training route's forward (``ssd_scan_train_cuda``) is the same four
kernels, handing back ``TRAIN_OUTPUTS``: y, the final state, and the
scratch the backward reads (``scores``, ``cs`` and the incoming states).
The backward (``ssd_scan_backward_cuda``, csrc/ssd_scan_backward.cu; no
Pallas counterpart) takes the cotangents dy (b, s, h, p) and, optionally,
dstate (b, h, p, n) fp32, and gives dx, ddt, dA, dB, dC, each in its
input's type. With E_ij = e^(cs_i - cs_j), M_ij = G_ij E_ij dt_j, P_ij =
dM_ij E_ij dt_j, w_j = dt_j e^(cs_last - cs_j), dM_ij = dy_i . x_j and SB_j
= dS B_j, it runs ``BACKWARD_STAGES``, one kernel each, through scratch that
``ssd_backward_buffers`` allocates, on the plan ``ssd_scan_backward_plan``
gives (``splits``: the blocks over which a group's heads are split):

    dstates  per (batch, head, chunk): U = sum_i e^(cs_i) dy_i (x) C_i,
             the cotangent the chunk's outputs send its incoming state
             (``dS`` (b, h, nc, p, n) fp32)
    dpass    walks the chunks from last to first: dS[c] = D; D = D
             e^(cs_last[c]) + U[c], D starting at dstate (or 0): each
             chunk's final state's cotangent overwrites U
    rows     per (64-row tile, batch, group, split, chunk), the split's
             heads in order: dC_i = sum_{j <= i} P_ij B_j + T_i, T_i =
             e^(cs_i) S_in^T dy_i, summed over the split's heads (``dC_part``
             (splits, b, s, g, n) fp32); cs's row terms sum_j G_ij P_ij + C_i
             . T_i (``dcs[:, :, :, 0]``, ``dcs`` (b, h, nc, 3, qp) fp32); and
             the chunk's e^(cs_last) <dS, S_in> (``dA_part[..., 0]``,
             ``dA_part`` (b, h, nc, 2) fp32)
    cols     per (64-column tile, batch, group, split, chunk), likewise:
             dx_j = sum_{i >= j} M_ij dy_i + w_j SB_j; dB_j = sum_{i >= j}
             P_ij C_i + w_j dS^T x_j, summed over the split's heads
             (``dB_part``); rs_j = sum_i G_ij E_ij dM_ij and x_j . SB_j
             (``dcs[:, :, :, 1]``, ``dcs[:, :, :, 2]``)
    finish   per (batch, head, chunk): cs's cotangent
               dcs_j = (row terms)_j - dt_j rs_j - w_j x_j . SB_j
             (the last position adds sum_j w_j x_j . SB_j + e^(cs_last)
             <dS, S_in>), rev its reverse in-chunk cumsum, ddt_j = rs_j +
             e^(cs_last - cs_j) x_j . SB_j + A rev_j, and the chunk's share
             of dA, sum_j dt_j rev_j (``dA_part[..., 1]``)
    reduce   dB, dC: the splits' partials summed in split order; dA: the
             shares summed over batch and chunks in a fixed order

With one split ``rows`` and ``cols`` write dC and dB themselves and the
partials are empty. ``ssd_scan_backward_plain`` computes the same closed
form chunk by chunk (not autograd) and is what the CPU runs; the stages'
``*_plain`` functions compose to it (``ssd_scan_backward_stages_plain``).

What bounds the backward on the card is its products (1.3e11 FLOP against
0.65 GB at mamba2-780m's training layer): every one runs on the tensor
cores (3xTF32 for fp32, bf16 for bf16; csrc/ssd_scan_backward.cu says how),
and the heads of a group are summed in registers, so the dB/dC scratch is
``splits`` partials of (b, s, g, n) and not one of (b, s, h, n).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 1024
TILE = 64                # rows and keys of a score tile; p columns a block
STAGES = ("scores", "states", "pass", "outputs")
KERNELS_PER_CALL = len(STAGES)  # CUDA kernels one ``ssd_scan_cuda`` launches
# what the training forward hands back: y, the final state and the scratch
# the backward reads (the incoming states are the ``states`` buffer)
TRAIN_OUTPUTS = ("y", "state", "scores", "cs", "states")
BACKWARD_OUTPUTS = ("dx", "ddt", "dA", "dB", "dC")
BACKWARD_STAGES = ("dstates", "dpass", "rows", "cols", "finish", "reduce")
BACKWARD_KERNELS_PER_CALL = len(BACKWARD_STAGES)
MAX_BACKWARD_HEAD_DIM = 64  # the backward holds a head's p columns in one tile
# `rows` and `cols` blocks the plan asks for: eight an SM (two fit at once),
# so that tiles of unequal work even out
BACKWARD_MIN_BLOCKS = 8 * 132


def work(b: int, s: int, h: int, p: int, n: int, g: int, chunk: int,
         dtype: torch.dtype, init: bool = False) -> Tuple[int, int]:
    """(flops, bytes) of one call, each chunk as long as it is: C B^T on and
    below the diagonal once a group, then for each head G x, C S^T and the
    chunk's state; x, B, C read and y written once in ``dtype``, dt read
    and the final state written once in fp32, A read once, and the initial
    state read once where there is one."""
    q = min(chunk, s)
    lens = [min(q, s - t0) for t0 in range(0, s, q)]
    flops = sum(b * g * L * (L + 1) * n
                + b * h * (L * (L + 1) * p + 4 * L * p * n) for L in lens)
    nbytes = ((2 * b * s * h * p + 2 * b * s * g * n) * dtype.itemsize
              + 4 * (b * s * h + h + (2 if init else 1) * b * h * p * n))
    return flops, nbytes


def backward_work(b: int, s: int, h: int, p: int, n: int, g: int,
                  chunk: int, dtype: torch.dtype, dstate: bool = False,
                  dinit: bool = False) -> Tuple[int, int]:
    """(flops, bytes) of one backward call, each chunk as long as it is:
    C B^T on and below the diagonal once a group; for each head dM = dy
    x^T, M^T dy and the two products of dM E dt with B and C on and below
    the diagonal, and the chunk's four state products (U, dS B, dS^T x,
    S_in^T dy); x, B, C, dy read and dx, dB, dC written once in ``dtype``,
    dt read and ddt written once in fp32, A read and dA written once, the
    final state's cotangent read once where there is one and the initial
    state's written once where it is asked for."""
    q = min(chunk, s)
    lens = [min(q, s - t0) for t0 in range(0, s, q)]
    flops = sum(b * g * L * (L + 1) * n
                + b * h * (2 * L * (L + 1) * (p + n) + 8 * L * p * n)
                for L in lens)
    nbytes = ((3 * b * s * h * p + 4 * b * s * g * n) * dtype.itemsize
              + 4 * (2 * b * s * h + 2 * h
                     + (b * h * p * n if dstate else 0)
                     + (b * h * p * n if dinit else 0)))
    return flops, nbytes


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain versions' working type: fp32, or float64 for float64
    inputs (the CPU tests' exact yardstick)."""
    return t if t.dtype == torch.float64 else t.float()


def _initial(init_state: Optional[torch.Tensor], like: torch.Tensor,
             shape) -> torch.Tensor:
    """The scan's starting state in the working type of ``like``, reshaped
    to ``shape``: the caller's, or zeros."""
    if init_state is None:
        return like.new_zeros(shape)
    return init_state.to(like.dtype).reshape(shape)


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, chunk: int = 256,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch, any device: the Pallas kernel's chunk loop, one chunk
    at a time with the state carried, in fp32 (float64 for float64 inputs),
    from ``init_state`` (b, h, p, n) or zero. The last chunk is simply
    shorter, which is what padding it with ``dt = 0`` computes. The heads
    of a group meet B and C through a broadcast over an (h // g) axis."""
    b, s, h, p = x.shape
    g, n = B.shape[-2], B.shape[-1]
    r = h // g
    q = min(chunk, s)
    xf = _wide(x).reshape(b, s, g, r, p)
    dtf = _wide(dt).reshape(b, s, g, r)
    Af = _wide(A).reshape(g, r)
    Bf, Cf = _wide(B), _wide(C)
    state = _initial(init_state, xf, (b, g, r, p, n))
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
# The stages, plain: what each kernel computes, in fp32 (float64 for
# float64 inputs).
# ------------------------------------------------------------------------- #

def _chunks(t: torch.Tensor, q: int) -> torch.Tensor:
    """(b, s, ...) -> (b, nc, q, ...) in fp32 (float64 for float64 inputs),
    the last chunk padded with zeros (a padded position has dt = 0: it adds
    nothing and decays nothing)."""
    b, s = t.shape[:2]
    nc = -(-s // q)
    t = _wide(t)
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
    cs = torch.cumsum(dtf * _wide(A).reshape(g, r), dim=2)
    w = dtf * torch.exp(cs[:, :, -1:] - cs)
    states = torch.einsum("bcjgrp,bcjgn->bgrcpn", xf * w[..., None],
                          _chunks(B, q))
    nc = cs.shape[1]
    return (cs.permute(0, 3, 4, 1, 2).reshape(b, h, nc, q),
            states.reshape(b, h, nc, p, n))


def ssd_state_pass_plain(states: torch.Tensor, cs: torch.Tensor,
                         init_state: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage ``pass``: from ``init_state`` (b, h, p, n) or a zero state,
    S_in[c] = S, S = S e^(cs_last[c]) + states[c] -> (the incoming states
    (b, h, nc, p, n), the final state (b, h, p, n))."""
    decay = torch.exp(cs[..., -1])                            # (b, h, nc)
    incoming = torch.empty_like(states)
    S = _initial(init_state, states, states[:, :, 0].shape)
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
                          B: torch.Tensor, C: torch.Tensor, chunk: int = 256,
                          init_state: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stages composed as the kernels compose them: equal to
    ``ssd_scan_plain``."""
    cs, states = ssd_chunk_states_plain(x, dt, A, B, chunk)
    incoming, final = ssd_state_pass_plain(states, cs, init_state)
    return ssd_chunk_outputs_plain(x, dt, cs, B, C, incoming, chunk), final


def ssd_scan_train_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor, chunk: int = 256,
                         init_state: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """The training forward in plain PyTorch: ``TRAIN_OUTPUTS`` (y, the
    final state, the scores, the cumsums, the incoming states, chunk 0's
    the initial state) in the kernels' layouts (``_buffer_specs``), from
    the stages: the q x q scores padded with zeros to qp x qp, the cumsums
    with their last value."""
    G = ssd_chunk_scores_plain(B, C, chunk)
    cs, states = ssd_chunk_states_plain(x, dt, A, B, chunk)
    incoming, final = ssd_state_pass_plain(states, cs, init_state)
    y = ssd_chunk_outputs_plain(x, dt, cs, B, C, incoming, chunk)
    q = cs.shape[-1]
    qp = -(-q // TILE) * TILE
    scores = G.new_zeros(G.shape[:-2] + (qp, qp))
    scores[..., :q, :q] = G
    cs = torch.cat([cs, cs[..., -1:].expand(cs.shape[:-1] + (qp - q,))],
                   dim=-1)
    return y.contiguous(), final, scores, cs, incoming


def ssd_scan_backward_plain(x: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, B: torch.Tensor,
                            C: torch.Tensor, dy: torch.Tensor,
                            dstate: Optional[torch.Tensor] = None,
                            chunk: int = 256,
                            init_state: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_scan_plain`` in closed form (the module's
    docstring), in fp32 (float64 for float64 inputs), chunk by chunk: a
    forward walk for each chunk's cumsums and incoming state (from
    ``init_state`` or zero), then the chunks from last to first with the
    final state's cotangent carried. dy: (b, s, h, p); dstate: (b, h, p, n)
    or None. -> (dx, ddt, dA, dB, dC), each in its input's type, and, with
    an ``init_state``, its cotangent ``dinit`` (b, h, p, n) fp32: the
    carried cotangent past chunk 0. The last chunk is simply shorter. Not
    autograd."""
    b, s, h, p = x.shape
    g, n = B.shape[-2], B.shape[-1]
    r = h // g
    q = min(chunk, s)
    xf = _wide(x).reshape(b, s, g, r, p)
    dyf = _wide(dy).reshape(b, s, g, r, p)
    dtf = _wide(dt).reshape(b, s, g, r)
    Af = _wide(A).reshape(g, r)
    Bf, Cf = _wide(B), _wide(C)
    slices = [slice(t0, min(t0 + q, s)) for t0 in range(0, s, q)]
    cums, incoming = [], []
    S = _initial(init_state, xf, (b, g, r, p, n))
    for sl in slices:
        cs = torch.cumsum(dtf[:, sl] * Af, dim=1)               # (b, L, g, r)
        w = dtf[:, sl] * torch.exp(cs[:, -1:] - cs)
        cums.append(cs)
        incoming.append(S)
        S = (S * cs[:, -1].exp()[..., None, None]
             + torch.einsum("bjgn,bjgrp->bgrpn", Bf[:, sl],
                            xf[:, sl] * w[..., None]))
    dx = torch.empty_like(xf)
    ddt = torch.empty_like(dtf)
    dB = torch.empty_like(Bf)
    dC = torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    D = (torch.zeros_like(S) if dstate is None
         else dstate.to(S.dtype).reshape(b, g, r, p, n))
    for k in reversed(range(len(slices))):
        sl, cs, S_in, dS = slices[k], cums[k], incoming[k], D
        xc, dyc, dtc = xf[:, sl], dyf[:, sl], dtf[:, sl]
        Bc, Cc = Bf[:, sl], Cf[:, sl]
        L = cs.shape[1]
        causal = torch.ones((L, L), dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None, None]
        E = (cs[:, :, None] - cs[:, None, :]).masked_fill(
            ~causal, float("-inf")).exp()                      # (b, i, j, g, r)
        G = torch.einsum("bign,bjgn->bijg", Cc, Bc)[..., None]
        dM = torch.einsum("bigrp,bjgrp->bijgr", dyc, xc)
        Edt = E * dtc[:, None]
        M, P, R = G * Edt, dM * Edt, G * E * dM
        ecs = cs.exp()
        f = torch.exp(cs[:, -1:] - cs)
        w = dtc * f
        SB = torch.einsum("bgrpn,bjgn->bjgrp", dS, Bc)
        T = torch.einsum("bgrpn,bigrp->bigrn", S_in, dyc) * ecs[..., None]
        xsb = (xc * SB).sum(-1)                                 # (b, L, g, r)
        dx[:, sl] = (torch.einsum("bijgr,bigrp->bjgrp", M, dyc)
                     + w[..., None] * SB)
        dC[:, sl] = (torch.einsum("bijgr,bjgn->bign", P, Bc)
                     + T.sum(3))
        dB[:, sl] = (torch.einsum("bijgr,bign->bjgn", P, Cc)
                     + torch.einsum("bjgr,bgrpn,bjgrp->bjgn", w, dS, xc))
        RD = R * dtc[:, None]
        dcs = (RD.sum(2) - RD.sum(1) + (Cc[:, :, :, None] * T).sum(-1)
               - w * xsb)
        dcs[:, -1] += ((w * xsb).sum(1)
                       + ecs[:, -1] * (dS * S_in).sum((-2, -1)))
        rev = dcs.flip(1).cumsum(1).flip(1)
        ddt[:, sl] = R.sum(1) + f * xsb + Af * rev
        dA += (dtc * rev).sum((0, 1))
        U = torch.einsum("bign,bigrp->bgrpn", Cc, dyc * ecs[..., None])
        D = D * ecs[:, -1][..., None, None] + U
    grads = (dx.reshape(b, s, h, p).to(x.dtype),
             ddt.reshape(b, s, h).to(dt.dtype), dA.reshape(h).to(A.dtype),
             dB.to(B.dtype), dC.to(C.dtype))
    if init_state is None:
        return grads
    return grads + (D.reshape(b, h, p, n).to(init_state.dtype),)


# ------------------------------------------------------------------------- #
# The backward's stages, plain: what each kernel computes, in fp32 (float64
# for float64 inputs), on the kernels' scratch layouts (cumsums and scores
# padded to ``qp`` are taken as they come).
# ------------------------------------------------------------------------- #

def ssd_bwd_dstates_plain(dy: torch.Tensor, C: torch.Tensor,
                          cs: torch.Tensor, chunk: int) -> torch.Tensor:
    """Stage ``dstates``: U = sum_i e^(cs_i) dy_i (x) C_i of each (batch,
    head, chunk) -> (b, h, nc, p, n) fp32."""
    b, s, h, p = dy.shape
    g = C.shape[2]
    q = min(chunk, s)
    nc = -(-s // q)
    ecs = _wide(cs[..., :q]).exp().reshape(b, g, h // g, nc, q)
    dyc = _chunks(dy, q).unflatten(3, (g, h // g))          # (b, c, q, g, r, p)
    U = torch.einsum("bgrci,bcigrp,bcign->bgrcpn", ecs, dyc, _chunks(C, q))
    return U.reshape(b, h, nc, p, C.shape[3])


def ssd_bwd_state_pass_plain(U: torch.Tensor, cs: torch.Tensor,
                             dstate: Optional[torch.Tensor] = None,
                             with_dinit: bool = False):
    """Stage ``dpass``: from D = dstate (or 0), the chunks from last to
    first, dS[c] = D, D = D e^(cs_last[c]) + U[c] -> each chunk's final
    state's cotangent (b, h, nc, p, n); with ``with_dinit``, also D past
    chunk 0, the initial state's cotangent (b, h, p, n)."""
    decay = torch.exp(_wide(cs[..., -1]))                    # (b, h, nc)
    dS = torch.empty_like(U)
    D = (torch.zeros_like(U[:, :, 0]) if dstate is None
         else _wide(dstate).clone())
    for c in reversed(range(U.shape[2])):
        dS[:, :, c] = D
        D = D * decay[:, :, c, None, None] + U[:, :, c]
    return (dS, D) if with_dinit else dS


def ssd_scan_backward_plan(b: int, s: int, h: int, g: int, n: int,
                           chunk: int) -> Tuple[int, int, int]:
    """(splits, kernels a call, scratch bytes of the dB/dC partials) of one
    backward call.

    ``splits``: the blocks over which the ``rows`` and ``cols`` kernels
    split a group's ``h // g`` heads, the smallest divisor of ``h // g``
    that gives each of them ``BACKWARD_MIN_BLOCKS`` blocks (one a 64-row
    tile, batch, group, split and chunk; the whole group when none does).
    A block sums its heads' dB and dC in registers, so the partials are
    ``(splits, b, s, g, n)`` fp32 each for dB and dC when ``splits > 1``,
    else none."""
    q = min(int(chunk), s)
    per_split = b * g * -(-s // q) * -(-q // TILE)
    r = h // g
    splits = next((k for k in range(1, r + 1)
                   if r % k == 0 and per_split * k >= BACKWARD_MIN_BLOCKS),
                  r)
    nbytes = 2 * splits * b * s * g * n * 4 if splits > 1 else 0
    return splits, BACKWARD_KERNELS_PER_CALL, nbytes


def _tile_terms(x, dt, B, C, dy, scores, cs, chunk):
    """What ``rows`` and ``cols`` each compute from the inputs and the
    training forward's scratch, every chunk at once, heads as (g, r): the
    chunks of x, dy (b, c, q, g, r, p), dt (b, c, q, g, r), B, C (b, c, q,
    g, n), the cumsums (b, c, q, g, r), E (0 above the diagonal), G (0
    there too) (b, c, i, j, g, r | 1) and dM (b, c, i, j, g, r)."""
    b, s, h, p = x.shape
    g = B.shape[2]
    r = h // g
    q = min(chunk, s)
    nc = -(-s // q)
    xc = _chunks(x, q).unflatten(3, (g, r))
    dyc = _chunks(dy, q).unflatten(3, (g, r))
    dtc = _chunks(dt, q).unflatten(3, (g, r))
    csc = _wide(cs[..., :q]).reshape(b, g, r, nc, q).permute(0, 3, 4, 1, 2)
    causal = torch.ones((q, q), dtype=torch.bool,
                        device=x.device).tril()[:, :, None, None]
    E = (csc[:, :, :, None] - csc[:, :, None, :]).masked_fill(
        ~causal, float("-inf")).exp()
    G = torch.where(causal[..., 0], _wide(scores[..., :q, :q]).permute(
        0, 2, 3, 4, 1), 0.0)[..., None]
    dM = torch.einsum("bcigrp,bcjgrp->bcijgr", dyc, xc)
    return xc, dyc, dtc, _chunks(B, q), _chunks(C, q), csc, E, G, dM


def _per_head(t: torch.Tensor, qp: int) -> torch.Tensor:
    """(b, c, q, g, r) -> the kernels' (b, h, nc, qp), zeros past q."""
    b, nc, q, g, r = t.shape
    t = t.permute(0, 3, 4, 1, 2).reshape(b, g * r, nc, q)
    return torch.nn.functional.pad(t, (0, qp - q))


def _split_sums(t: torch.Tensor, splits: int, s: int) -> torch.Tensor:
    """(b, c, q, g, r, n) per head -> (splits, b, s, g, n): each split's
    heads summed."""
    b, nc, q, g, r, n = t.shape
    t = t.unflatten(4, (splits, r // splits)).sum(5)   # (b, c, q, g, k, n)
    return t.permute(4, 0, 1, 2, 3, 5).reshape(splits, b, nc * q, g, n)[:, :, :s]


def ssd_bwd_rows_plain(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, dy: torch.Tensor, scores: torch.Tensor,
                       cs: torch.Tensor, incoming: torch.Tensor,
                       dS: torch.Tensor, chunk: int, splits: int
                       ) -> Tuple[torch.Tensor, ...]:
    """Stage ``rows``: every chunk at once -> (each split's dC, (splits, b,
    s, g, n) fp32; cs's row terms sum_j G_ij P_ij + C_i . T_i (b, h, nc,
    qp), T_i = e^(cs_i) S_in^T dy_i; each chunk's e^(cs_last) <dS, S_in>
    (b, h, nc))."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    nc = cs.shape[2]
    xc, dyc, dtc, Bc, Cc, csc, E, G, dM = _tile_terms(x, dt, B, C, dy,
                                                      scores, cs, chunk)
    P = dM * E * dtc[:, :, None]
    S_in = _wide(incoming).reshape(b, g, r, nc, p, n)
    T = (torch.einsum("bgrcpn,bcigrp->bcigrn", S_in, dyc)
         * csc.exp()[..., None])
    dC_h = torch.einsum("bcijgr,bcjgn->bcigrn", P, Bc) + T
    rows = (G * P).sum(3) + (Cc[:, :, :, :, None] * T).sum(-1)
    last = _wide(cs[..., -1]).exp() * (_wide(dS) * _wide(incoming)).sum(
        (-2, -1))
    return _split_sums(dC_h, splits, s), _per_head(rows, cs.shape[-1]), last


def ssd_bwd_cols_plain(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, dy: torch.Tensor, scores: torch.Tensor,
                       cs: torch.Tensor, dS: torch.Tensor, chunk: int,
                       splits: int) -> Tuple[torch.Tensor, ...]:
    """Stage ``cols``: every chunk at once -> (dx (b, s, h, p) in x's type;
    each split's dB (splits, b, s, g, n) fp32; rs_j = sum_i G_ij E_ij dM_ij
    and x_j . SB_j, each (b, h, nc, qp))."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    nc, qp = cs.shape[2], cs.shape[3]
    xc, dyc, dtc, Bc, Cc, csc, E, G, dM = _tile_terms(x, dt, B, C, dy,
                                                      scores, cs, chunk)
    Edt = E * dtc[:, :, None]
    M, P = G * Edt, dM * Edt
    dSc = _wide(dS).reshape(b, g, r, nc, p, n)
    w = dtc * torch.exp(csc[:, :, -1:] - csc)
    SB = torch.einsum("bgrcpn,bcjgn->bcjgrp", dSc, Bc)
    dx = torch.einsum("bcijgr,bcigrp->bcjgrp", M, dyc) + w[..., None] * SB
    dB_h = (torch.einsum("bcijgr,bcign->bcjgrn", P, Cc)
            + w[..., None] * torch.einsum("bgrcpn,bcjgrp->bcjgrn", dSc, xc))
    dx = dx.reshape(b, nc * dx.shape[2], h, p)[:, :s].to(x.dtype)
    return (dx, _split_sums(dB_h, splits, s),
            _per_head((G * E * dM).sum(2), qp),
            _per_head((xc * SB).sum(-1), qp))


def ssd_bwd_finish_plain(dcs: torch.Tensor, last: torch.Tensor,
                         dt: torch.Tensor, A: torch.Tensor, cs: torch.Tensor,
                         chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage ``finish``: from the terms ``rows`` and ``cols`` left (``dcs``
    (b, h, nc, 3, qp), ``last`` (b, h, nc)) -> (ddt (b, s, h) fp32, each
    chunk's share of dA (b, h, nc)). The last position's terms go to the
    chunk's last padded position: the reverse cumsum carries them down to
    its real positions all the same (a padded position has dt = 0)."""
    b, s, h = dt.shape
    q = min(chunk, s)
    nc = cs.shape[2]
    csq = _wide(cs[..., :q])
    dtq = _chunks(dt, q).permute(0, 3, 1, 2)                 # (b, h, nc, q)
    rows, rs, xsb = (dcs[..., k, :q] for k in range(3))
    f = torch.exp(csq[..., -1:] - csq)
    xw = dtq * f * xsb
    d = rows - dtq * rs - xw
    d[..., -1] += xw.sum(-1) + last
    rev = d.flip(-1).cumsum(-1).flip(-1)
    ddt = rs + f * xsb + _wide(A)[:, None, None] * rev
    ddt = ddt.permute(0, 2, 3, 1).reshape(b, nc * q, h)[:, :s]
    return ddt, (dtq * rev).sum(-1)


def ssd_bwd_reduce_plain(dB_part: torch.Tensor, dC_part: torch.Tensor,
                         share: torch.Tensor, dtype: torch.dtype
                         ) -> Tuple[torch.Tensor, ...]:
    """Stage ``reduce``: the splits' partials summed -> (dB, dC (b, s, g, n)
    in ``dtype``), and dA (h,) fp32 from the chunks' shares."""
    return (dB_part.sum(0).to(dtype), dC_part.sum(0).to(dtype),
            share.sum((0, 2)))


def ssd_scan_backward_stages_plain(x: torch.Tensor, dt: torch.Tensor,
                                   A: torch.Tensor, B: torch.Tensor,
                                   C: torch.Tensor, dy: torch.Tensor,
                                   dstate: Optional[torch.Tensor] = None,
                                   chunk: int = 256,
                                   init_state: Optional[torch.Tensor] = None
                                   ) -> Tuple[torch.Tensor, ...]:
    """The training forward's scratch and the backward's stages composed as
    the kernels compose them, on ``ssd_scan_backward_plan``'s splits: equal
    to ``ssd_scan_backward_plain``."""
    b, s, h, _ = x.shape
    g, n = B.shape[2], B.shape[3]
    splits = ssd_scan_backward_plan(b, s, h, g, n, chunk)[0]
    _, _, scores, cs, incoming = ssd_scan_train_plain(x, dt, A, B, C, chunk,
                                                      init_state)
    dS, dinit = ssd_bwd_state_pass_plain(
        ssd_bwd_dstates_plain(dy, C, cs, chunk), cs, dstate, with_dinit=True)
    dC_part, rows, last = ssd_bwd_rows_plain(x, dt, B, C, dy, scores, cs,
                                             incoming, dS, chunk, splits)
    dx, dB_part, rs, xsb = ssd_bwd_cols_plain(x, dt, B, C, dy, scores, cs,
                                              dS, chunk, splits)
    ddt, share = ssd_bwd_finish_plain(torch.stack([rows, rs, xsb], 3), last,
                                      dt, A, cs, chunk)
    dB, dC, dA = ssd_bwd_reduce_plain(dB_part, dC_part, share, B.dtype)
    grads = (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC)
    return grads if init_state is None else grads + (dinit,)


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
    return q


def _check_state(name: str, t: Optional[torch.Tensor], x: torch.Tensor,
                 B: torch.Tensor, what: str = "ssd_scan kernel") -> None:
    """Raise unless ``t`` (an initial state, or None) is a contiguous fp32
    (b, h, p, n) tensor on x's device."""
    if t is None:
        return
    b, _, h, p = x.shape
    shape = (b, h, p, B.shape[3])
    if (t.shape != shape or t.dtype != torch.float32 or t.device != x.device
            or not t.is_contiguous()):
        raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}; want a contiguous float32 {shape} on "
                         "x's device")


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
            mask: int, init: Optional[torch.Tensor] = None) -> None:
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = buffers["y"]
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _build.lib().repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if init is None else init.data_ptr(),
            y.data_ptr(), buffers["state"].data_ptr(),
            buffers["scores"].data_ptr(), buffers["cs"].data_ptr(),
            buffers["states"].data_ptr(), b, s, h, p, g, n, q,
            *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
            *y.stride()[:3], _DTYPE_CODE[x.dtype], mask, stream)
    _build.check(code, "ssd_scan kernel launch")


def _check_buffers(buffers: Dict[str, torch.Tensor], specs: dict,
                   device: torch.device, what: str) -> None:
    """Raise unless ``buffers`` are exactly ``specs``' (name -> (shape,
    dtype)), contiguous, on ``device``."""
    if set(buffers) != set(specs):
        raise ValueError(f"{what}: buffers {sorted(buffers)}; want "
                         f"{sorted(specs)}")
    for name, (shape, dtype) in specs.items():
        t = buffers[name]
        if (t.shape != shape or t.dtype != dtype or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: buffer {name} {tuple(t.shape)} "
                             f"{t.dtype}; want {shape} {dtype}, contiguous, "
                             "on x's device")


def ssd_stages_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int,
                    buffers: Dict[str, torch.Tensor], stages=STAGES,
                    init_state: Optional[torch.Tensor] = None) -> None:
    """Launch the named stage kernels, in ``STAGES``' order, on PyTorch's
    current stream, reading and writing ``buffers`` (as ``ssd_buffers``
    makes them): a stage reads what the stages before it wrote there; the
    pass starts from ``init_state`` or zero. For the card's tests and
    timings of one stage."""
    q = _check(x, dt, A, B, C, chunk)
    _check_state("init_state", init_state, x, B)
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise ValueError(f"ssd_scan kernel: no stage {sorted(unknown)}")
    _check_buffers(buffers, _buffer_specs(x, B, chunk), x.device,
                   "ssd_scan kernel")
    _launch(x, dt, A, B, C, q, buffers,
            sum(1 << i for i, name in enumerate(STAGES) if name in stages),
            init_state)


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int = 256,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the ``KERNELS_PER_CALL`` stage kernels on PyTorch's current
    stream, with no synchronisation. x, B, C are taken by their strides
    (views of the conv output are fine; the last dim must be contiguous and
    every row 16-byte aligned); ``init_state``: a contiguous fp32 (b, h, p,
    n) state the pass starts from, or None for zero. Raises on anything the
    kernels do not take; never computes the result another way."""
    q = _check(x, dt, A, B, C, chunk)
    _check_state("init_state", init_state, x, B)
    buffers = ssd_buffers(x, B, chunk)
    _launch(x, dt, A, B, C, q, buffers, (1 << len(STAGES)) - 1, init_state)
    return buffers["y"], buffers["state"]


def ssd_scan_train_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, chunk: int = 256,
                        init_state: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """The training route's forward: the same kernels as ``ssd_scan_cuda``,
    handing back ``TRAIN_OUTPUTS`` (y, the final state, and the scores,
    cumsums and incoming states the backward reads: chunk 0's is
    ``init_state``). Refuses, before it launches, a head_dim the backward
    does not take."""
    q = _check(x, dt, A, B, C, chunk)
    _check_backward_head_dim(x.shape[3])
    _check_state("init_state", init_state, x, B)
    buffers = ssd_buffers(x, B, chunk)
    _launch(x, dt, A, B, C, q, buffers, (1 << len(STAGES)) - 1, init_state)
    return tuple(buffers[name] for name in TRAIN_OUTPUTS)


# ------------------------------------------------------------------------- #
# The backward's CUDA kernels (csrc/ssd_scan_backward.cu).
# ------------------------------------------------------------------------- #

def _check_backward_head_dim(p: int) -> None:
    if p > MAX_BACKWARD_HEAD_DIM:
        raise ValueError(
            f"ssd_scan backward kernel takes head_dim p <= "
            f"{MAX_BACKWARD_HEAD_DIM}, got {p}")


def _check_backward(x, dt, A, B, C, dy, dstate, scores, cs, incoming,
                    chunk) -> int:
    """Raise on anything the backward's kernels do not take; return the
    positions a chunk."""
    q = _check(x, dt, A, B, C, chunk)
    _check_backward_head_dim(x.shape[3])
    if not (dy.device == x.device and dy.shape == x.shape
            and dy.dtype == x.dtype):
        raise ValueError(
            f"ssd_scan backward kernel: dy {tuple(dy.shape)} {dy.dtype} on "
            f"{dy.device}; want x's shape, type and device")
    pitches = [st * dy.element_size() for st in dy.stride()[:3]]
    if (dy.stride(3) != 1 or dy.data_ptr() % 16
            or any(pt % 16 for pt in pitches)):
        raise ValueError("ssd_scan backward kernel: rows of dy not "
                         "contiguous and 16-byte aligned")
    specs = _buffer_specs(x, B, chunk)
    b, _, h, p = x.shape
    named = {"scores": scores, "cs": cs, "states": incoming}
    wanted = {name: specs[name] for name in named}
    if dstate is not None:
        named["dstate"] = dstate
        wanted["dstate"] = ((b, h, p, B.shape[3]), torch.float32)
    _check_buffers(named, wanted, x.device, "ssd_scan backward kernel")
    return q


def _backward_buffer_specs(x: torch.Tensor, B: torch.Tensor,
                           chunk: int) -> dict:
    """name -> (shape, dtype) of the backward's outputs and scratch; the
    dB/dC partials have ``ssd_scan_backward_plan``'s splits, or none."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(int(chunk), s)
    nc, qp = -(-s // q), -(-q // TILE) * TILE
    splits = ssd_scan_backward_plan(b, s, h, g, n, chunk)[0]
    parts = ((splits if splits > 1 else 0, b, s, g, n), torch.float32)
    f32 = torch.float32
    return {"dx": ((b, s, h, p), x.dtype), "ddt": ((b, s, h), f32),
            "dA": ((h,), f32), "dB": ((b, s, g, n), B.dtype),
            "dC": ((b, s, g, n), B.dtype),
            "dS": ((b, h, nc, p, n), f32), "dcs": ((b, h, nc, 3, qp), f32),
            "dA_part": ((b, h, nc, 2), f32), "dB_part": parts,
            "dC_part": parts}


def ssd_backward_buffers(x: torch.Tensor, B: torch.Tensor,
                         chunk: int) -> Dict[str, torch.Tensor]:
    """The backward's outputs (``BACKWARD_OUTPUTS``, contiguous) and its
    scratch: ``dS`` (the chunks' U, then their final states' cotangents),
    ``dcs`` (cs's row terms, rs and x . SB, a head and position),
    ``dA_part`` (each chunk's e^(cs_last) <dS, S_in> and share of dA) and
    the splits' ``dB_part`` and ``dC_part`` (empty with one split);
    uninitialised, on x's device."""
    return {name: torch.empty(shape, dtype=dtype, device=x.device)
            for name, (shape, dtype) in _backward_buffer_specs(
                x, B, chunk).items()}


def _launch_backward(x, dt, A, B, C, dy, dstate, scores, cs, incoming, q,
                     buffers: Dict[str, torch.Tensor], mask: int,
                     dinit: Optional[torch.Tensor] = None) -> None:
    """``dinit``: where the forward started from an initial state (chunk
    0's incoming state), the tensor its cotangent goes to; else None."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    splits = ssd_scan_backward_plan(b, s, h, g, n, q)[0]
    ptr = lambda name: buffers[name].data_ptr()
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _build.lib().repro_ssd_scan_backward(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(),
            scores.data_ptr(), cs.data_ptr(), incoming.data_ptr(),
            int(dinit is not None),
            None if dinit is None else dinit.data_ptr(), ptr("dS"), ptr("dcs"), ptr("dA_part"), ptr("dB_part"),
            ptr("dC_part"), ptr("dx"), ptr("ddt"), ptr("dA"), ptr("dB"),
            ptr("dC"), b, s, h, p, g, n, q, splits, *x.stride()[:3],
            *dt.stride(), *B.stride()[:3], *C.stride()[:3], *dy.stride()[:3],
            _DTYPE_CODE[x.dtype], mask, stream)
    _build.check(code, "ssd_scan backward kernel launch")


def ssd_scan_backward_stages_cuda(x, dt, A, B, C, dy, dstate, scores, cs,
                                  incoming, chunk: int,
                                  buffers: Dict[str, torch.Tensor],
                                  stages=BACKWARD_STAGES,
                                  dinit: Optional[torch.Tensor] = None
                                  ) -> None:
    """Launch the named backward stage kernels, in ``BACKWARD_STAGES``'
    order, on PyTorch's current stream, reading and writing ``buffers`` (as
    ``ssd_backward_buffers`` makes them): a stage reads what the stages
    before it wrote there. ``dinit``: given where the forward started from
    an initial state (``incoming`` holds it as chunk 0's); ``dpass`` writes
    its cotangent there. For the card's tests and timings of one stage."""
    q = _check_backward(x, dt, A, B, C, dy, dstate, scores, cs, incoming,
                        chunk)
    _check_state("dinit", dinit, x, B, "ssd_scan backward kernel")
    unknown = set(stages) - set(BACKWARD_STAGES)
    if unknown:
        raise ValueError(f"ssd_scan backward kernel: no stage "
                         f"{sorted(unknown)}")
    _check_buffers(buffers, _backward_buffer_specs(x, B, chunk), x.device,
                   "ssd_scan backward kernel")
    _launch_backward(x, dt, A, B, C, dy, dstate, scores, cs, incoming, q,
                     buffers, sum(1 << i for i, name
                                  in enumerate(BACKWARD_STAGES)
                                  if name in stages), dinit)


def ssd_scan_backward_cuda(x: torch.Tensor, dt: torch.Tensor,
                           A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                           dy: torch.Tensor, dstate: Optional[torch.Tensor],
                           scores: torch.Tensor, cs: torch.Tensor,
                           incoming: torch.Tensor, chunk: int = 256,
                           init: bool = False) -> Tuple[torch.Tensor, ...]:
    """Launch the ``BACKWARD_KERNELS_PER_CALL`` kernels on PyTorch's current
    stream, with no synchronisation: the gradient of the scan from dy (x's
    shape and type, rows contiguous and 16-byte aligned), the final state's
    cotangent ``dstate`` (or None) and the training forward's ``scores``,
    ``cs`` and incoming states; ``init``: the forward started from an
    initial state (the incoming states hold it as chunk 0's). -> (dx, ddt,
    dA, dB, dC), contiguous, each in its input's type, and with ``init``
    the initial state's cotangent, fp32 (b, h, p, n).
    Deterministic: every value is written by one thread, every sum taken in
    a fixed order. Raises on anything the kernels do not take; never
    computes the result another way."""
    q = _check_backward(x, dt, A, B, C, dy, dstate, scores, cs, incoming,
                        chunk)
    buffers = ssd_backward_buffers(x, B, chunk)
    out = (torch.empty((x.shape[0], x.shape[2], x.shape[3], B.shape[3]),
                       dtype=torch.float32, device=x.device)
           if init else None)
    _launch_backward(x, dt, A, B, C, dy, dstate, scores, cs, incoming, q,
                     buffers, (1 << len(BACKWARD_STAGES)) - 1, out)
    grads = tuple(buffers[name] for name in BACKWARD_OUTPUTS)
    return grads if out is None else grads + (out,)
