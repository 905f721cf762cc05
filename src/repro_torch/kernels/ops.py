"""Public wrappers around the CUDA kernels, and the kernels as operators of
PyTorch's dispatcher.

Counterpart of ``src/repro/kernels/ops.py``. Every kernel entry is an
operator of the ``repro_torch`` namespace (``torch.ops.repro_torch.*``,
defined with ``torch.library.Library``) with three implementations, one a
dispatch key:

  * ``CUDA``: the hand-written kernel (or the call raises);
  * ``CPU``: the plain PyTorch version, which is how the CPU tests run;
  * ``Meta`` (``torch.library.register_fake``): shapes, strides and dtypes
    only, for ``meta`` and fake tensors.

So the device of the input decides the route and nothing else does: there
is no switch and no fall-back, and a ``meta`` tensor never reaches a kernel.
The outputs of all three share the kernels' layout (attention's outputs are
allocated (b, s, heads, d) and handed back transposed), so that what runs
after an operator does the same work on every device. A dispatch mode (the
op counter, ``core/op_counter.py``) sees each operator as one op; its work,
(flops, bytes) from shapes and dtype, is the kernel module's formula
(``WORK``; the FLOPs are registered with ``torch.utils.flop_counter`` too).

Each wrapper counts its kernel launches in ``<wrapper>.launches``, a plain
integer raised in the CUDA implementation, where the kernel is launched,
and nowhere else, so a run can show that it went through the kernels.
Every wrapper has a gradient (``torch.autograd.Function``s whose forward
and backward call the operators): the backward counts in
``<wrapper>.backward_launches``, one a call of its kernels. A forward that
a remat policy recomputes during the backward is launched, and counted,
again. Attention and the SSD scan take a training forward of their own
(``flash_attention_lse``, ``ssd_scan_train``) that also hands back what
the backward reads: attention's takes ``q_offset`` and the SSD scan's an
``init_state``, whose cotangent its backward returns (a rank's block of a
sequence split along its length over the data ranks). Attention also takes
the partial route
(``flash_attention_partial``, counted in ``flash_attention_partial.
launches``): serving over a cache split along its sequence, a block of
the keys in, the rows' fp32 output and log-sum-exp out, no gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import embedding_bag as bag_module
from repro_torch.kernels import flash_attention as attn_module
from repro_torch.kernels import rmsnorm as norm_module
from repro_torch.kernels import ssd_scan as ssd_module
from repro_torch.kernels.embedding_bag import (
    embedding_bag_backward_cuda,
    embedding_bag_backward_plain,
    embedding_bag_cuda,
    embedding_bag_plain,
)
from repro_torch.kernels.flash_attention import (
    _new_like_heads,
    flash_attention_backward_cuda,
    flash_attention_backward_plain,
    flash_attention_cuda,
    flash_attention_forward_plain,
    flash_attention_lse_cuda,
    flash_attention_partial_cuda,
    flash_attention_plain,
    rows_aligned,
)
from repro_torch.kernels.rmsnorm import (
    rmsnorm_backward_cuda,
    rmsnorm_backward_plain,
    rmsnorm_cuda,
    rmsnorm_plain,
)
from repro_torch.kernels.ssd_scan import (
    ssd_scan_backward_cuda,
    ssd_scan_backward_plain,
    ssd_scan_cuda,
    ssd_scan_plain,
    ssd_scan_train_cuda,
    ssd_scan_train_plain,
)

NAMESPACE = "repro_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")

# op -> (flops, bytes) of one call, from the call's arguments
WORK: Dict[object, Callable[..., Tuple[int, int]]] = {}


def _define(schema: str, cpu: Callable, cuda: Callable, fake: Callable,
            work: Callable[..., Tuple[int, int]]):
    """Define ``repro_torch::<schema>`` with its CPU, CUDA and fake
    implementations and its work formula; return the operator. The CPU
    implementations look the plain versions up in this module when called,
    so a test may wrap one here to count its calls."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    op = getattr(getattr(torch.ops, NAMESPACE), name)
    WORK[op] = work
    register_flop_formula(op, get_raw=True)(
        lambda *args, out_val=None, **kwargs: work(*args, **kwargs)[0])
    return op


def _heads_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` (b, heads, s, d) in the kernels' layout: allocated (b, s,
    heads, d), handed back transposed."""
    b, heads, s, d = t.shape
    return _new_like_heads(b, s, heads, d, t).copy_(t)


# ----------------------------------------------------------------------- #
# Attention: the serving route, the training forward, the backward
# ----------------------------------------------------------------------- #

def _attention_work(q, k, v, causal, kv_len=None, q_offset=None):
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if kv_len is None and q_offset is None:
        return attn_module.forward_work(b, h, hkv, sq, skv, d, q.dtype, causal)
    # The masks' data decides the pairs; a count from shapes alone takes
    # every key as seen by every query (what the kernel may read at most).
    return attn_module.forward_work(b, h, hkv, sq, skv, d, q.dtype, causal,
                                    pairs=b * sq * skv, kv_rows=b * skv)


def _attention_cuda(q, k, v, causal, kv_len=None, q_offset=None):
    out = flash_attention_cuda(q, k, v, causal, kv_len, q_offset)
    flash_attention.launches += 1
    return out


_attention_op = _define(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
    "Tensor? kv_len, Tensor? q_offset) -> Tensor",
    lambda q, k, v, causal, kv_len=None, q_offset=None: _heads_layout(
        flash_attention_plain(q, k, v, causal, kv_len, q_offset)),
    _attention_cuda,
    lambda q, k, v, causal, kv_len=None, q_offset=None: _new_like_heads(
        q.shape[0], q.shape[2], q.shape[1], q.shape[3], q),
    _attention_work)


def _attention_lse_cpu(q, k, v, causal, q_offset=None):
    out, lse = flash_attention_forward_plain(q, k, v, causal, None, q_offset)
    return _heads_layout(out), lse


def _attention_lse_cuda(q, k, v, causal, q_offset=None):
    out = flash_attention_lse_cuda(q, k, v, causal, q_offset)
    flash_attention.launches += 1
    return out


def _attention_lse_fake(q, k, v, causal, q_offset=None):
    b, h, sq, d = q.shape
    return (_new_like_heads(b, sq, h, d, q),
            q.new_empty((b, h, sq),
                        dtype=torch.promote_types(q.dtype, torch.float32)))


def _offset_wide(q, k, q_offset) -> dict:
    """A call's pairs where ``q_offset`` shifts its mask: from shapes alone,
    every key as seen by every query (what the kernel may read at most)."""
    if q_offset is None:
        return {}
    b, sq, skv = q.shape[0], q.shape[2], k.shape[2]
    return {"pairs": b * sq * skv, "kv_rows": b * skv}


def _attention_lse_work(q, k, v, causal, q_offset=None):
    b, h, sq, d = q.shape
    return attn_module.forward_work(b, h, k.shape[1], sq, k.shape[2], d,
                                    q.dtype, causal, lse=True,
                                    **_offset_wide(q, k, q_offset))


_attention_lse_op = _define(
    "flash_attention_lse(Tensor q, Tensor k, Tensor v, bool causal, "
    "Tensor? q_offset=None) -> (Tensor, Tensor)",
    _attention_lse_cpu, _attention_lse_cuda, _attention_lse_fake,
    _attention_lse_work)


def _attention_backward_cpu(q, k, v, o, lse, do, causal, q_offset=None):
    return tuple(_heads_layout(g) for g in flash_attention_backward_plain(
        q, k, v, o, lse, do, causal, q_offset))


def _attention_backward_cuda(q, k, v, o, lse, do, causal, q_offset=None):
    grads = flash_attention_backward_cuda(q, k, v, o, lse, do, causal,
                                          q_offset)
    flash_attention.backward_launches += 1
    return grads


def _attention_backward_fake(q, k, v, o, lse, do, causal, q_offset=None):
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    return (_new_like_heads(b, sq, h, d, q), _new_like_heads(b, skv, hkv, d, k),
            _new_like_heads(b, skv, hkv, d, v))


def _attention_backward_work(q, k, v, o, lse, do, causal, q_offset=None):
    b, h, sq, d = q.shape
    pairs = _offset_wide(q, k, q_offset).get("pairs")
    return attn_module.backward_work(b, h, k.shape[1], sq, k.shape[2], d,
                                     q.dtype, causal, pairs)


def _attention_partial_cpu(q, k, v, causal, kv_len=None, q_offset=None):
    out, lse = flash_attention_forward_plain(q, k, v, causal, kv_len,
                                             q_offset, unrounded=True)
    return _heads_layout(out), lse


def _attention_partial_cuda(q, k, v, causal, kv_len=None, q_offset=None):
    out = flash_attention_partial_cuda(q, k, v, causal, kv_len, q_offset)
    flash_attention_partial.launches += 1
    return out


def _attention_partial_fake(q, k, v, causal, kv_len=None, q_offset=None):
    b, h, sq, d = q.shape
    wt = torch.promote_types(q.dtype, torch.float32)
    return (q.new_empty((b, sq, h, d), dtype=wt).transpose(1, 2),
            q.new_empty((b, h, sq), dtype=wt))


def _attention_partial_work(q, k, v, causal, kv_len=None, q_offset=None):
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    wide = {} if kv_len is None and q_offset is None else {
        "pairs": b * sq * skv, "kv_rows": b * skv}
    return attn_module.forward_work(b, h, hkv, sq, skv, d, q.dtype, causal,
                                    lse=True, out_itemsize=4, **wide)


_attention_partial_op = _define(
    "flash_attention_partial(Tensor q, Tensor k, Tensor v, bool causal, "
    "Tensor? kv_len, Tensor? q_offset) -> (Tensor, Tensor)",
    _attention_partial_cpu, _attention_partial_cuda,
    _attention_partial_fake, _attention_partial_work)


_attention_backward_op = _define(
    "flash_attention_backward(Tensor q, Tensor k, Tensor v, Tensor o, "
    "Tensor lse, Tensor do, bool causal, Tensor? q_offset=None) "
    "-> (Tensor, Tensor, Tensor)",
    _attention_backward_cpu, _attention_backward_cuda,
    _attention_backward_fake, _attention_backward_work)


# ----------------------------------------------------------------------- #
# RMSNorm
# ----------------------------------------------------------------------- #

def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1]


def _rmsnorm_cuda(x, gamma, eps):
    out = rmsnorm_cuda(x, gamma, eps)
    rmsnorm.launches += 1
    return out


_rmsnorm_op = _define(
    "rmsnorm(Tensor x, Tensor gamma, float eps) -> Tensor",
    lambda x, gamma, eps: rmsnorm_plain(x, gamma, eps), _rmsnorm_cuda,
    lambda x, gamma, eps: torch.empty_like(x),
    lambda x, gamma, eps: norm_module.forward_work(_rows(x), x.shape[-1],
                                                   x.dtype))


def _rmsnorm_backward_cuda(x, gamma, dy, eps):
    grads = rmsnorm_backward_cuda(x, gamma, dy, eps)
    rmsnorm.backward_launches += 1
    return grads


_rmsnorm_backward_op = _define(
    "rmsnorm_backward(Tensor x, Tensor gamma, Tensor dy, float eps) "
    "-> (Tensor, Tensor)",
    lambda x, gamma, dy, eps: rmsnorm_backward_plain(x, gamma, dy, eps),
    _rmsnorm_backward_cuda,
    lambda x, gamma, dy, eps: (torch.empty_like(x), torch.empty_like(gamma)),
    lambda x, gamma, dy, eps: norm_module.backward_work(
        _rows(x), x.shape[-1], x.dtype))


# ----------------------------------------------------------------------- #
# SSD scan
# ----------------------------------------------------------------------- #

def _ssd_cuda(x, dt, A, B, C, chunk, init=None):
    out = ssd_scan_cuda(x, dt, A, B, C, chunk, init)
    ssd_scan.launches += 1
    return out


def _ssd_fake(x, dt, A, B, C, chunk, init=None):
    b, _, h, p = x.shape
    return (x.new_empty(x.shape),
            x.new_empty((b, h, p, B.shape[-1]), dtype=torch.float32))


def _ssd_work(x, dt, A, B, C, chunk, init=None):
    b, s, h, p = x.shape
    return ssd_module.work(b, s, h, p, B.shape[-1], B.shape[-2], chunk,
                           x.dtype, init is not None)


_ssd_op = _define(
    "ssd_scan(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, int chunk, "
    "Tensor? init=None) -> (Tensor, Tensor)",
    lambda x, dt, A, B, C, chunk, init=None: ssd_scan_plain(
        x, dt, A, B, C, chunk, init),
    _ssd_cuda, _ssd_fake, _ssd_work)


def _ssd_train_cuda(x, dt, A, B, C, chunk, init=None):
    out = ssd_scan_train_cuda(x, dt, A, B, C, chunk, init)
    ssd_scan.launches += 1
    return out


def _ssd_train_fake(x, dt, A, B, C, chunk, init=None):
    specs = ssd_module._buffer_specs(x, B, chunk)
    return tuple(x.new_empty(specs[name][0], dtype=specs[name][1])
                 for name in ssd_module.TRAIN_OUTPUTS)


_ssd_train_op = _define(
    "ssd_scan_train(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, "
    "int chunk, Tensor? init=None) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    lambda x, dt, A, B, C, chunk, init=None: ssd_scan_train_plain(
        x, dt, A, B, C, chunk, init),
    _ssd_train_cuda, _ssd_train_fake, _ssd_work)


def _ssd_backward_cpu(x, dt, A, B, C, dy, dstate, scores, cs, incoming,
                      chunk, init=None):
    grads = ssd_scan_backward_plain(x, dt, A, B, C, dy, dstate, chunk, init)
    if init is None:
        grads = grads + (x.new_empty((0,), dtype=torch.float32),)
    return grads


def _ssd_backward_cuda(x, dt, A, B, C, dy, dstate, scores, cs, incoming,
                       chunk, init=None):
    grads = ssd_scan_backward_cuda(x, dt, A, B, C, dy, dstate, scores, cs,
                                   incoming, chunk, init=init is not None)
    ssd_scan.backward_launches += 1
    if init is None:
        grads = grads + (x.new_empty((0,), dtype=torch.float32),)
    return grads


def _ssd_backward_fake(x, dt, A, B, C, dy, dstate, scores, cs, incoming,
                       chunk, init=None):
    specs = ssd_module._backward_buffer_specs(x, B, chunk)
    return tuple(x.new_empty(specs[name][0], dtype=specs[name][1])
                 for name in ssd_module.BACKWARD_OUTPUTS) + (
        x.new_empty((0,) if init is None else init.shape,
                    dtype=torch.float32),)


def _ssd_backward_work(x, dt, A, B, C, dy, dstate, scores, cs, incoming,
                       chunk, init=None):
    b, s, h, p = x.shape
    return ssd_module.backward_work(b, s, h, p, B.shape[-1], B.shape[-2],
                                    chunk, x.dtype, dstate is not None,
                                    init is not None)


# ``init``: the forward's initial state, which the plain version reads (it
# recomputes the forward) and the kernels do not (the incoming states carry
# it); the last output is its cotangent, empty without one.
_ssd_backward_op = _define(
    "ssd_scan_backward(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, "
    "Tensor dy, Tensor? dstate, Tensor scores, Tensor cs, Tensor incoming, "
    "int chunk, Tensor? init=None) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    _ssd_backward_cpu, _ssd_backward_cuda, _ssd_backward_fake,
    _ssd_backward_work)


# ----------------------------------------------------------------------- #
# Embedding bag
# ----------------------------------------------------------------------- #

def _bag_cuda(tables, indices):
    out = embedding_bag_cuda(tables, indices)
    embedding_bag.launches += 1
    return out


_bag_op = _define(
    "embedding_bag(Tensor tables, Tensor indices) -> Tensor",
    lambda tables, indices: embedding_bag_plain(tables, indices), _bag_cuda,
    lambda tables, indices: tables.new_empty(
        (indices.shape[0], indices.shape[1], tables.shape[2])),
    lambda tables, indices: bag_module.forward_work(
        indices.shape[0], indices.shape[1], indices.shape[2],
        tables.shape[2], tables.dtype))


def _bag_backward_cuda(dout, indices, num_rows):
    out = embedding_bag_backward_cuda(dout, indices, num_rows)
    embedding_bag.backward_launches += 1
    return out


_bag_backward_op = _define(
    "embedding_bag_backward(Tensor dout, Tensor indices, int num_rows) "
    "-> Tensor",
    lambda dout, indices, num_rows: embedding_bag_backward_plain(
        dout, indices, num_rows),
    _bag_backward_cuda,
    lambda dout, indices, num_rows: dout.new_empty(
        (dout.shape[1], num_rows, dout.shape[2])),
    lambda dout, indices, num_rows: bag_module.backward_work(
        dout.shape[0], dout.shape[1], indices.shape[2], num_rows,
        dout.shape[2], dout.dtype))


# ----------------------------------------------------------------------- #
# The wrappers the models call
# ----------------------------------------------------------------------- #

def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FlashAttention(torch.autograd.Function):
    """The training route: the forward also keeps each row's log-sum-exp,
    the backward recomputes the probabilities from it. ``q_offset``: the
    rows' first position, for a block of them over the whole sequence's
    keys (the keys no row sees get zero gradients)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        out, lse = _attention_lse_op(q, k, v, causal, q_offset)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_offset = ctx.saved_tensors
        if dout.is_cuda and not rows_aligned(dout):
            dout = dout.contiguous()
        grads = _attention_backward_op(q, k, v, out, lse, dout, ctx.causal,
                                       q_offset)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    kv_len: Optional[torch.Tensor] = None,
                    q_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (b, h, sq, d), k/v: (b, hkv, skv, d) -> (b, h, sq, d).

    ``kv_len`` / ``q_offset``: optional int32 (b,), see
    ``repro_torch.kernels.flash_attention``. When an input requires grad
    (and grad mode is on) the call takes the training route, with a
    backward, which takes ``q_offset`` and not ``kv_len``."""
    if _wants_grad(q, k, v):
        if kv_len is not None:
            raise ValueError(
                "flash attention: the training route (an input requires "
                "grad) takes no kv_len")
        return _FlashAttention.apply(q, k, v, causal, q_offset)
    return _attention_op(q, k, v, causal, kv_len, q_offset)


def flash_attention_partial(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            kv_len: Optional[torch.Tensor] = None,
                            q_offset: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (b, h, sq, d), k/v: (b, hkv, skv, d), a block of the keys ->
    (this block's output (b, h, sq, d) in fp32, each row's log-sum-exp
    (b, h, sq) fp32, +inf where the row sees none of the block's keys):
    the partial route, for serving over a cache split along its sequence
    (``parallel.tensor.combine_attention`` sums the blocks). Serving only:
    no gradient."""
    if _wants_grad(q, k, v):
        raise ValueError("flash attention: the partial route serves only; "
                         "it has no backward")
    return _attention_partial_op(q, k, v, causal, kv_len, q_offset)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, gamma)
        return _rmsnorm_op(x, gamma, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma = _rmsnorm_backward_op(x, gamma, dy.contiguous(), ctx.eps)
        return dx, dgamma, None


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); gamma: (d,). With a gradient when either requires it."""
    if _wants_grad(x, gamma):
        return _RMSNorm.apply(x, gamma, eps)
    return _rmsnorm_op(x, gamma, eps)


class _SSDScan(torch.autograd.Function):
    """The training route: the forward keeps the chunks' scores, cumsums
    and incoming states; the backward reads them. A final state that the
    loss does not use sends no cotangent (None), and costs nothing. An
    initial state gets its cotangent from the backward's state pass."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk, init):
        y, state, scores, cs, incoming = _ssd_train_op(x, dt, A, B, C, chunk,
                                                       init)
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B, C, scores, cs, incoming, init)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, scores, cs, incoming, init = ctx.saved_tensors
        dy = x.new_zeros(x.shape) if dy is None else dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        *grads, dinit = _ssd_backward_op(x, dt, A, B, C, dy, dstate, scores,
                                         cs, incoming, ctx.chunk, init)
        return (*grads, None, None if init is None else dinit)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 256,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, h, p), dt: (b, s, h) fp32, A: (h,) fp32, B/C: (b, s, g, n)
    -> (y (b, s, h, p), final state (b, h, p, n) fp32); see
    ``repro_torch.kernels.ssd_scan``. ``init_state``: (b, h, p, n) fp32,
    contiguous, the state the scan starts from (zero when None). When an
    input requires grad (and grad mode is on) the call takes the training
    route, with a backward, on every device; an ``init_state`` then gets
    its cotangent."""
    extra = () if init_state is None else (init_state,)
    if _wants_grad(x, dt, A, B, C, *extra):
        return _SSDScan.apply(x, dt, A, B, C, chunk, init_state)
    return _ssd_op(x, dt, A, B, C, chunk, init_state)


class _EmbeddingBag(torch.autograd.Function):
    """Both directions through the operators."""

    @staticmethod
    def forward(ctx, tables, indices):
        ctx.save_for_backward(indices)
        ctx.num_rows = tables.shape[1]
        return _bag_op(tables, indices)

    @staticmethod
    def backward(ctx, dout):
        (indices,) = ctx.saved_tensors
        return _bag_backward_op(dout, indices, ctx.num_rows), None


def embedding_bag(tables: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """tables: (T, R, E), indices: (B, T, L) int32 -> (B, T, E), with a
    gradient for ``tables``; see ``repro_torch.kernels.embedding_bag``.
    ``embedding_bag.launches`` counts the forward kernel's launches,
    ``embedding_bag.backward_launches`` the backward's calls."""
    return _EmbeddingBag.apply(tables, indices)


flash_attention.launches = 0
flash_attention.backward_launches = 0
flash_attention_partial.launches = 0
rmsnorm.launches = 0
rmsnorm.backward_launches = 0
ssd_scan.launches = 0
ssd_scan.backward_launches = 0
embedding_bag.launches = 0
embedding_bag.backward_launches = 0
