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

Training adds the backward (``csrc/flash_attention_backward.cu``; the JAX
package has no Pallas backward, ``jax.grad`` differentiates its attention):
the forward then also returns each query row's log-sum-exp ``lse`` (fp32
``(b, h, sq)``), from which the backward recomputes the probabilities. The
training route takes ``q_offset`` (not ``kv_len``): a rank's block of the
query rows of a sequence split along its length over the data ranks attends
over the whole sequence's keys, its rows at positions ``q_offset[b] + i``;
the backward writes zeros for the keys no row sees. A backward call is
three or four kernels (``flash_attention_backward_plan``);
``flash_attention_backward_stages_plain`` is their decomposition in plain
PyTorch.

Serving over a cache split along its sequence (each data-parallel rank
holding one block of the keys) takes the partial route: one rank's output
over its own keys in fp32, not rounded, and each row's log-sum-exp, with
``kv_len`` and ``q_offset`` (``flash_attention_partial_cuda``, the decode
kernels at ``sq <= 8``); the ranks' partials are then combined by their
log-sum-exp (``parallel.tensor.combine_attention``). Every route gives a row
that sees no key zeros and a log-sum-exp of +inf.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Every route (serving, partial, training): 16 is the reduced configs', 160
# zamba2's shared attention block.
HEAD_DIMS = (16, 64, 128, 160)
NEG_INF = -1e30
# Decode (sq <= 8): each (batch, KV head) splits its keys over a thread block
# cluster of one of these sizes (4 unless the caller picks another) whose
# shared memory fits a block (``decode_cluster_fits``).
DECODE_CLUSTERS = (1, 2, 4, 8)
DECODE_DEFAULT_CLUSTER = 4

# The decode kernels' shared memory as csrc/flash_attention.cu reckons it
# (``dm_smem_bytes``, ``decode_f32_smem_bytes``, ``merge_slot_floats``);
# a CPU test holds these constants to the source's.
SMEM_PER_BLOCK = 232_448     # the most a block of an H100 may opt in to
DECODE_TILE = 32             # kDecodeTile
DM_ROWS, DM_WARPS = 16, 4    # bf16 decode
DEC_WARPS, DEC_ROWS, DEC_PITCH_PAD = 4, 4, 4     # fp32 decode

# The backward's streamed tiles as csrc/flash_attention_backward.cu sets
# them: beside a block's own 64 rows (``BACKWARD_KEY_TILE``), the rows of the
# tiles it streams (queries for dK/dV, keys for dQ) in a ring of stages: the
# forward's tile (``tile_rows``: 64, 32 at d 128) and ``ring_stages`` (one
# stage for fp32 at d 128, else two) up to d 128, and at d 160 the
# backward's own (kF32Rows160, kF32Stages160, kBf16Rows160, kBf16Stages160).
# A CPU test holds these to the source's.
BACKWARD_D160_TILE = {torch.float32: (16, 1), torch.bfloat16: (32, 2)}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          kv_len: Optional[torch.Tensor] = None,
                          q_offset: Optional[torch.Tensor] = None,
                          unrounded: bool = False) -> torch.Tensor:
    """Plain PyTorch, any device. Scores and softmax in fp32 (fp64 for fp64
    inputs); probabilities are rounded to ``q.dtype`` before ``P @ V``, as
    in the kernel. ``unrounded``: ``P @ V`` summed and returned in the work
    type (the partial route's output), else in ``q.dtype``."""
    b, h, sq, _ = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    allowed = _allowed(b, sq, skv, causal, q.device, kv_len, q_offset)
    scores = torch.where(allowed, _scores(q, k), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(allowed, probs, 0.0)     # a row with no key: zeros
    v = v.repeat_interleave(h // hkv, dim=1)
    if unrounded:
        wt = _work_dtype(q.dtype)
        return torch.matmul(probs.to(q.dtype).to(wt), v.to(wt))
    return torch.matmul(probs.to(q.dtype), v)


def _allowed(b: int, sq: int, skv: int, causal: bool, device,
             kv_len: Optional[torch.Tensor] = None,
             q_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, 1, sq, skv) bool: the (query, key) pairs the masks let through."""
    kpos = torch.arange(skv, device=device)
    allowed = torch.ones((b, 1, sq, skv), dtype=torch.bool, device=device)
    if kv_len is not None:
        allowed = allowed & (kpos < kv_len.view(b, 1, 1, 1))
    if causal:
        qpos = torch.arange(sq, device=device).view(1, sq).expand(b, sq)
        if q_offset is not None:
            qpos = qpos + q_offset.view(b, 1)
        allowed = allowed & (kpos.view(1, 1, 1, skv) <= qpos.view(b, 1, sq, 1))
    return allowed


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for fp32 and bf16 inputs; fp64 stays fp64 (the tests' exact
    arithmetic)."""
    return torch.promote_types(dtype, torch.float32)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Scaled scores (b, h, sq, skv) in the work type, K's heads repeated
    over their query heads."""
    h, hkv, d = q.shape[1], k.shape[1], q.shape[3]
    wt = _work_dtype(q.dtype)
    k = k.to(wt).repeat_interleave(h // hkv, dim=1)
    return torch.matmul(q.to(wt), k.transpose(-1, -2)) * (1.0 / math.sqrt(d))


def flash_attention_forward_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool = True,
                                  kv_len: Optional[torch.Tensor] = None,
                                  q_offset: Optional[torch.Tensor] = None,
                                  unrounded: bool = False
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with the log-sum-exp, plain PyTorch, any device: the
    output of ``flash_attention_plain`` and each row's log-sum-exp of its
    visible scaled scores, fp32 ``(b, h, sq)`` (+inf for a row that sees no
    key). The training route's (no ``kv_len``) and, with ``unrounded``
    output, the partial route's."""
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    out = flash_attention_plain(q, k, v, causal, kv_len, q_offset, unrounded)
    allowed = _allowed(b, sq, skv, causal, q.device, kv_len, q_offset)
    scores = torch.where(allowed, _scores(q, k), -math.inf)
    lse = torch.logsumexp(scores, dim=-1)
    lse = torch.where(allowed.any(-1), lse, math.inf)
    return out, lse.to(_work_dtype(q.dtype))


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   lse: torch.Tensor, do: torch.Tensor,
                                   causal: bool = True,
                                   q_offset: Optional[torch.Tensor] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """(dq, dk, dv), plain PyTorch, any device; the kernel's arithmetic.

    The probabilities are recomputed from ``lse``; dV takes them rounded to
    ``q.dtype`` as the forward's ``P @ V`` did; ``D = rowsum(dO * O)``; the
    rest in fp32 (fp64 for fp64 inputs, where this equals autograd through
    ``flash_attention_plain``). A KV head's gradients sum over the query
    heads of its group. ``q_offset``: the forward's."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    wt = _work_dtype(q.dtype)
    allowed = _allowed(b, sq, skv, causal, q.device, None, q_offset)
    probs = torch.where(allowed, torch.exp(_scores(q, k) - lse[..., None]), 0.0)
    g = do.to(wt)
    dv = torch.matmul(probs.to(q.dtype).to(wt).transpose(-1, -2), g)
    dp = torch.matmul(g, v.to(wt).repeat_interleave(group, dim=1)
                      .transpose(-1, -2))
    delta = (g * o.to(wt)).sum(-1, keepdim=True)
    ds = probs * (dp - delta) * (1.0 / math.sqrt(d))
    dq = torch.matmul(ds, k.to(wt).repeat_interleave(group, dim=1))
    dk = torch.matmul(ds.transpose(-1, -2), q.to(wt))
    dk = dk.view(b, hkv, group, skv, d).sum(2)
    dv = dv.view(b, hkv, group, skv, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def causal_pairs(sq: int, skv: int) -> int:
    """The (query, key) pairs of one head a top-left causal mask allows:
    query ``i`` sees keys ``0 .. min(i, skv - 1)``."""
    m = min(sq, skv)
    return m * (m + 1) // 2 + (sq - m) * skv


def offset_pairs(sq: int, skv: int, offsets) -> Tuple[int, int]:
    """(the (query, key) pairs of one head, the key rows some query sees),
    each summed over the batch, that a causal mask shifted by each
    sequence's ``offsets`` (ints) allows: query ``i`` sees keys ``0 ..
    min(i + offset, skv - 1)``, none where ``i + offset < 0``."""
    pairs = rows = 0
    for off in offsets:
        lo = min(sq, max(0, -off))                 # rows before: no key
        hi = min(sq, max(lo, skv - off - 1))       # rows after: every key
        pairs += ((hi - lo) * (lo + hi - 1) // 2 + (hi - lo) * (off + 1)
                  + (sq - hi) * skv)
        rows += min(skv, max(0, sq + off))
    return pairs, rows


def forward_work(b: int, h: int, hkv: int, sq: int, skv: int, d: int,
                 dtype: torch.dtype, causal: bool = True, lse: bool = False,
                 pairs: Optional[int] = None,
                 kv_rows: Optional[int] = None,
                 out_itemsize: Optional[int] = None) -> Tuple[int, int]:
    """(flops, bytes) of one forward call: the useful work, which the bound
    of ``chip_smoke.py`` and the op counter (``core/op_counter.py``) read.
    Two products of ``2 d`` flops for each (batch, query, key) triple the
    masks allow, over the ``h`` query heads; q read and o written once, the
    K/V rows that at least one query sees read once; with ``lse`` the rows'
    fp32 log-sum-exp written too. ``pairs`` / ``kv_rows``: what the call's
    data allows (``kv_len`` / ``q_offset``), summed over the batch; by
    default what the plain causal (top-left) or full mask allows.
    ``out_itemsize``: bytes of an output element where it is not of
    ``dtype`` (the partial route's fp32)."""
    if pairs is None:
        pairs = b * (causal_pairs(sq, skv) if causal else sq * skv)
    if kv_rows is None:
        kv_rows = b * (min(sq, skv) if causal else skv)
    out_itemsize = out_itemsize or dtype.itemsize
    nbytes = ((b * h * sq * d + 2 * kv_rows * hkv * d) * dtype.itemsize
              + b * h * sq * d * out_itemsize)
    if lse:
        nbytes += 4 * b * h * sq
    return 4 * pairs * h * d, nbytes


def backward_work(b: int, h: int, hkv: int, sq: int, skv: int, d: int,
                  dtype: torch.dtype, causal: bool = True,
                  pairs: Optional[int] = None) -> Tuple[int, int]:
    """(flops, bytes) of one backward call: five products of ``2 d`` flops
    for each (query, key) pair the mask allows; q, o, dO, k, v and the fp32
    log-sum-exp read once, dq, dk, dv written once. ``pairs``: what the
    call's data allows (``q_offset``: ``offset_pairs``), summed over the
    batch; by default what the plain causal or full mask allows."""
    if pairs is None:
        pairs = b * (causal_pairs(sq, skv) if causal else sq * skv)
    nbytes = ((4 * b * h * sq * d + 4 * b * hkv * skv * d) * dtype.itemsize
              + 4 * b * h * sq)
    return 10 * pairs * h * d, nbytes


def _check_index_vector(name: str, t: torch.Tensor, b: int,
                        device: torch.device) -> None:
    if (t.device != device or t.dtype != torch.int32 or t.shape != (b,)
            or not t.is_contiguous()):
        raise ValueError(
            f"flash attention kernel: {name} must be a contiguous int32 "
            f"({b},) tensor on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *more: Tuple[str, torch.Tensor]) -> None:
    """Raise on what the kernels do not take. ``more``: further (name,
    tensor) pairs of q's shape (the backward's o, dO), held to the same type
    and layout rules."""
    tensors = (("q", q), ("k", k), ("v", v), *more)
    if not all(t.is_cuda and t.device == q.device for _, t in tensors):
        raise ValueError(
            "flash attention kernel: " + ", ".join(
                f"{n} on {t.device}" for n, t in tensors)
            + "; all must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for _, t in tensors):
        raise TypeError(
            "flash attention kernel takes float32 or bfloat16, one type for "
            "all its inputs; got " + ", ".join(f"{n} {t.dtype}"
                                               for n, t in tensors))
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
    for name, t in more:
        if t.shape != q.shape:
            raise ValueError(
                f"flash attention kernel: {name} {tuple(t.shape)} is not q's "
                f"shape {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if b > 65535 or h > 65535:
        raise ValueError("flash attention kernel: batch and heads <= 65535")
    if 0 in (b, h, sq, skv):
        raise ValueError(
            f"flash attention kernel: empty input, q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}")
    for name, t in tensors:
        if not rows_aligned(t):
            raise ValueError(
                f"flash attention kernel: the last dim of {name} is not "
                "contiguous or its rows are not 16-byte aligned")


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether the kernels take ``t`` by its strides: the last dim
    contiguous, the start and every row 16-byte aligned."""
    pitches = [s * t.element_size() for s in t.stride()[:-1]]
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(p % 16 == 0 for p in pitches))


def _new_like_heads(b: int, s: int, heads: int, d: int,
                    like: torch.Tensor) -> torch.Tensor:
    """(b, heads, s, d) allocated as (b, s, heads, d) and returned
    transposed, so the caller's transpose back to the model's layout is a
    view of contiguous memory."""
    out = torch.empty((b, s, heads, d), dtype=like.dtype, device=like.device)
    return out.transpose(1, 2)


def decode_smem_bytes(d: int, dtype: torch.dtype, group_rows: int,
                      cluster: int) -> int:
    """Bytes of shared memory a decode block takes at head_dim ``d``:
    the kernel's own, then one merge slot for each block of the cluster.
    ``group_rows``: the query rows of a KV head, ``h // hkv * sq`` (the fp32
    kernel holds one row a block when it is 1, else ``DEC_ROWS``)."""
    def slot_floats(rows):
        return rows * d + (2 * rows + 3) // 4 * 4
    if dtype == torch.bfloat16:
        stages = 4 if d == 64 else 2
        own = (DM_ROWS * (d + 8)
               + DM_WARPS * stages * 2 * DECODE_TILE * (d + 8)) * 2
        rows = DM_ROWS
    else:
        rows = 1 if group_rows == 1 else DEC_ROWS
        stages = 2 if d * 4 <= 256 else 1
        own = 4 * (DEC_WARPS * stages * 2 * DECODE_TILE * (d + DEC_PITCH_PAD)
                   + rows * d + DEC_WARPS * rows * DECODE_TILE)
    return own + cluster * slot_floats(rows) * 4


def backward_tile(d: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(rows, stages) of the backward's streamed tiles at head_dim ``d``."""
    if d == 160:
        return BACKWARD_D160_TILE[dtype]
    return (32 if d == 128 else 64,
            1 if dtype == torch.float32 and d == 128 else 2)


def backward_smem_bytes(d: int, dtype: torch.dtype) -> Tuple[int, int]:
    """Bytes of shared memory a block of the dK/dV kernel and of the dQ
    kernel takes at head_dim ``d`` (``dkdv_smem_bytes``, ``dq_smem_bytes``):
    the block's own 64 rows of two inputs and the stages of two streamed
    tiles, rows padded by 16 bytes; the dK/dV kernel also stages each
    streamed row's log-sum-exp and D."""
    rows, stages = backward_tile(d, dtype)
    row_bytes = d * dtype.itemsize + 16
    dq = (2 * BACKWARD_KEY_TILE + stages * 2 * rows) * row_bytes
    return dq + stages * 2 * rows * 4, dq


def decode_cluster_fits(d: int, dtype: torch.dtype, group_rows: int,
                        cluster: int) -> bool:
    """Whether a decode cluster of ``cluster`` blocks fits a block's shared
    memory (at d 160, bf16, a cluster of 8 does not; at d 16 every one
    does)."""
    return decode_smem_bytes(d, dtype, group_rows, cluster) <= SMEM_PER_BLOCK


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
    ``DECODE_CLUSTERS`` that ``decode_cluster_fits``; None for the kernel's
    default). Raises on anything the kernel does not take; never computes
    the result another way."""
    _check_inputs(q, k, v)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if kv_len is not None:
        _check_index_vector("kv_len", kv_len, b, q.device)
    if q_offset is not None:
        _check_index_vector("q_offset", q_offset, b, q.device)
    _check_cluster(q, k, decode_cluster)
    out = _new_like_heads(b, sq, h, d, q)
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


def _check_cluster(q: torch.Tensor, k: torch.Tensor,
                   decode_cluster: Optional[int]) -> None:
    """Raise for a decode cluster the kernels do not take (sq <= 8)."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    if decode_cluster is not None and decode_cluster not in DECODE_CLUSTERS:
        raise ValueError(
            f"flash attention kernel: decode_cluster {decode_cluster} not in "
            f"{DECODE_CLUSTERS}")
    cluster = decode_cluster or DECODE_DEFAULT_CLUSTER
    if sq <= 8 and not decode_cluster_fits(d, q.dtype, h // hkv * sq,
                                           cluster):
        raise ValueError(
            f"flash attention kernel: a decode cluster of {cluster} blocks at "
            f"head_dim {d}, {q.dtype}, needs "
            f"{decode_smem_bytes(d, q.dtype, h // hkv * sq, cluster)} bytes "
            f"of shared memory a block, more than {SMEM_PER_BLOCK}")


def flash_attention_partial_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, causal: bool = True,
                                 kv_len: Optional[torch.Tensor] = None,
                                 q_offset: Optional[torch.Tensor] = None,
                                 decode_cluster: Optional[int] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial route on the card: this rank's output over the keys it
    holds, fp32 whatever the inputs' type (allocated (b, sq, h, d), returned
    transposed), and each row's log-sum-exp, fp32 ``(b, h, sq)``, +inf for
    a row that sees no key (a negative ``q_offset``, a ``kv_len`` of 0).
    The decode kernels at ``sq <= 8`` (their cluster merge writes the
    log-sum-exp), else the prefill kernels. Inputs, ``kv_len``,
    ``q_offset`` and ``decode_cluster`` as ``flash_attention_cuda``'s;
    raises as it does."""
    _check_inputs(q, k, v)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if kv_len is not None:
        _check_index_vector("kv_len", kv_len, b, q.device)
    if q_offset is not None:
        _check_index_vector("q_offset", q_offset, b, q.device)
    _check_cluster(q, k, decode_cluster)
    out = torch.empty((b, sq, h, d), dtype=torch.float32,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with _build.on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = _build.lib().repro_flash_attention_partial(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(),
            None if q_offset is None else q_offset.data_ptr(),
            b, h, hkv, sq, skv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            1.0 / math.sqrt(d), int(bool(causal)), decode_cluster or 0,
            _DTYPE_CODE[q.dtype], stream)
    _build.check(code, "flash attention partial launch")
    return out, lse


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             q_offset: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training route's forward on the card: the output and each row's
    log-sum-exp (fp32 ``(b, h, sq)``), from the prefill kernels at any
    length (a row of at most 8 queries too: the decode kernels write it on
    the partial route alone); ``q_offset`` as ``flash_attention_cuda``'s.
    Raises as ``flash_attention_cuda``."""
    _check_inputs(q, k, v)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q_offset is not None:
        _check_index_vector("q_offset", q_offset, b, q.device)
    out = _new_like_heads(b, sq, h, d, q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with _build.on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = _build.lib().repro_flash_attention_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), None if q_offset is None else q_offset.data_ptr(),
            b, h, hkv, sq, skv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            1.0 / math.sqrt(d), int(bool(causal)), _DTYPE_CODE[q.dtype],
            stream)
    _build.check(code, "flash attention kernel launch")
    return out, lse


# The backward's dK/dV kernel takes 64 keys a block; a GQA group's query
# heads are split over blocks when the grid would be smaller than about two
# blocks for each of the H100's 132 SMs.
BACKWARD_KEY_TILE = 64
BACKWARD_MIN_BLOCKS = 2 * 132


def flash_attention_backward_plan(b: int, h: int, hkv: int, skv: int,
                                  d: int) -> Tuple[int, int, int]:
    """(splits, kernels a call, scratch bytes) of one backward call.

    ``splits``: the blocks over which each (batch, KV head, key tile) splits
    the query heads of its group, the smallest divisor of ``h // hkv`` that
    gives the dK/dV kernel ``BACKWARD_MIN_BLOCKS`` blocks (the whole group
    when none does). Kernels: D = rowsum(dO * O), dK and dV, their partials'
    sum when ``splits > 1``, then dQ. Scratch: the fp32 partial dK and dV,
    ``(2, b, hkv, splits, skv, d)``, when ``splits > 1``, else none."""
    group = h // hkv
    blocks = -(-skv // BACKWARD_KEY_TILE) * hkv * b
    splits = next((s for s in range(1, group + 1)
                   if group % s == 0 and blocks * s >= BACKWARD_MIN_BLOCKS),
                  group)
    if splits == 1:
        return 1, 3, 0
    return splits, 4, 2 * b * hkv * splits * skv * d * 4


def flash_attention_backward_stages_plain(q: torch.Tensor, k: torch.Tensor,
                                          v: torch.Tensor, o: torch.Tensor,
                                          lse: torch.Tensor, do: torch.Tensor,
                                          causal: bool, splits: int,
                                          q_offset: Optional[torch.Tensor]
                                          = None
                                          ) -> Tuple[torch.Tensor,
                                                     torch.Tensor,
                                                     torch.Tensor]:
    """The kernels' decomposition in plain PyTorch, any device: D =
    rowsum(dO * O); for each of ``splits`` consecutive slices of a group's
    query heads, the partial dK and dV (unscaled dK) in the work type; the
    partials summed in split order, dK scaled, rounded once; dQ. Equals
    ``flash_attention_backward_plain`` up to the order of the sums over the
    group. ``q_offset``: the forward's."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    if splits <= 0 or group % splits:
        raise ValueError(f"splits {splits} does not divide the group {group}")
    wt = _work_dtype(q.dtype)
    scale = 1.0 / math.sqrt(d)
    allowed = _allowed(b, sq, skv, causal, q.device, None, q_offset)
    probs = torch.where(allowed, torch.exp(_scores(q, k) - lse[..., None]), 0.0)
    g = do.to(wt)
    delta = (g * o.to(wt)).sum(-1, keepdim=True)
    dp = torch.matmul(g, v.to(wt).repeat_interleave(group, dim=1)
                      .transpose(-1, -2))
    ds = probs * (dp - delta)
    part_k = torch.matmul(ds.transpose(-1, -2), q.to(wt))
    part_v = torch.matmul(probs.to(q.dtype).to(wt).transpose(-1, -2), g)
    # (b, hkv, splits, heads of a split, skv, d): each split's heads summed
    # in order, then the splits in order.
    part_k = part_k.view(b, hkv, splits, group // splits, skv, d).sum(3)
    part_v = part_v.view(b, hkv, splits, group // splits, skv, d).sum(3)
    dk, dv = part_k[:, :, 0], part_v[:, :, 0]
    for sp in range(1, splits):
        dk, dv = dk + part_k[:, :, sp], dv + part_v[:, :, sp]
    dq = torch.matmul(ds, k.to(wt).repeat_interleave(group, dim=1)) * scale
    return dq.to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool = True,
                                  q_offset: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Launch the backward's kernels on PyTorch's current stream, as
    ``flash_attention_backward_plan`` splits the call: (dq, dk, dv), each
    allocated in the model's (b, s, heads, d) layout and returned
    transposed like the forward's output. ``o`` and ``lse`` are the
    forward's (``flash_attention_lse_cuda``), ``do`` the output's gradient;
    all taken by their strides. Deterministic: the same inputs give the same
    bits. ``q_offset``: the forward's. Keys no row sees get zero
    gradients. Raises on anything the kernels do not take."""
    _check_inputs(q, k, v, ("o", o), ("do", do))
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q_offset is not None:
        _check_index_vector("q_offset", q_offset, b, q.device)
    if (not lse.is_cuda or lse.device != q.device
            or lse.dtype != torch.float32 or lse.shape != (b, h, sq)
            or not lse.is_contiguous()):
        raise ValueError(
            f"flash attention backward: lse must be a contiguous float32 "
            f"({b}, {h}, {sq}) tensor on {q.device}, got {lse.dtype} "
            f"{tuple(lse.shape)} on {lse.device}")
    splits, _, scratch_bytes = flash_attention_backward_plan(b, h, hkv, skv,
                                                             d)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    part = (torch.empty(scratch_bytes // 4, dtype=torch.float32,
                        device=q.device) if scratch_bytes else None)
    dq = _new_like_heads(b, sq, h, d, q)
    dk = _new_like_heads(b, skv, hkv, d, q)
    dv = _new_like_heads(b, skv, hkv, d, q)
    with _build.on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = _build.lib().repro_flash_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(),
            None if q_offset is None else q_offset.data_ptr(), delta.data_ptr(),
            None if part is None else part.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, skv, d, splits,
            *(st for t in (q, k, v, o, do, dq, dk, dv)
              for st in t.stride()[:3]),
            1.0 / math.sqrt(d), int(bool(causal)), _DTYPE_CODE[q.dtype],
            stream)
    _build.check(code, "flash attention backward launch")
    return dq, dk, dv
