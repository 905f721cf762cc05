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

On the card the backward runs ``BACKWARD_STAGES``, a few kernels each,
through scratch that the wrapper allocates (``embedding_bag_backward_buffers``),
with n = B * T * L lookups in (B, T, L) order:

    sort    key t * R + wrap(idx) per lookup (the sentinel T * R where
            the index is dropped), payload b; a stable radix sort of the pairs,
            RADIX_BITS a pass, into ``keys`` / ``vals`` (n,) int32
            (``keys_tmp``, ``vals_tmp``, ``hist``: the passes' scratch)
    pieces  for each piece of PIECE consecutive sorted entries (the last
            may be shorter): the fp32 sums, in order, of its first key's
            entries (``head``, their count in ``head_len``) and of its last
            key's (``tail``); (ceil(n / PIECE), E) fp32 each
    write   every row of ``dtables`` once: a segment inside one piece summed
            entry by entry in order, one that crosses from piece a to piece
            z as tail[a] + head[a + 1] + ... + head[z]; zeros for a row that
            no lookup names

so the result is bitwise the same from run to run. The ``*_plain`` functions
of the stages compute the same steps in PyTorch; composed, they give
``embedding_bag_backward_sorted_plain``, which the tests hold against
``jax.grad``. ``embedding_bag_backward_plain`` (``index_add_``) stays the
function the port runs for CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2 ** 31 - 1
RADIX_BITS = 8
SORT_TILE = 2048         # keys a block of the sort ranks
PIECE = 128              # sorted entries of a piece
BACKWARD_STAGES = ("sort", "pieces", "write")


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
    (T, R, E) (fp64 for fp64 ``dout``), dropped indices left out, rounded
    once into ``dout.dtype``."""
    b, t, e = dout.shape
    lookups = indices.shape[2]
    acc = torch.float64 if dout.dtype == torch.float64 else torch.float32
    rows = _wrapped(indices, num_rows)
    keep = ((rows >= 0) & (rows < num_rows)).flatten()
    flat = (rows + num_rows * torch.arange(t, device=rows.device)[None, :, None])
    source = dout.to(acc)[:, :, None, :].expand(b, t, lookups, e).reshape(-1, e)
    dtables = torch.zeros((t * num_rows, e), dtype=acc, device=dout.device)
    dtables.index_add_(0, flat.flatten()[keep], source[keep])
    return dtables.view(t, num_rows, e).to(dout.dtype)


def backward_kernels_per_call(b: int, t: int, lookups: int, r: int) -> int:
    """CUDA kernels one ``embedding_bag_backward_cuda`` call launches: three a
    sort pass (counts, scan, scatter; enough RADIX_BITS passes for the
    sentinel T * R), the pieces, the writer. Fixed by the shapes (11 at
    T * R = 12.8 M)."""
    passes = -(-(t * r).bit_length() // RADIX_BITS)
    return (3 * passes + 1 if b * t * lookups else 0) + 1


def embedding_bag_backward_keys_plain(indices: torch.Tensor, num_rows: int
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage ``sort``'s input: (key, payload) int32 (n,) in lookup order.
    Key t * R + wrap(idx), the sentinel T * R for a dropped index;
    payload b."""
    b, t, lookups = indices.shape
    rows = _wrapped(indices, num_rows)
    keep = (rows >= 0) & (rows < num_rows)
    table = num_rows * torch.arange(t, device=rows.device)[None, :, None]
    keys = torch.where(keep, rows + table, t * num_rows)
    payload = torch.arange(b, device=rows.device)[:, None, None].expand(
        b, t, lookups)
    return keys.flatten().int(), payload.flatten().int()


def embedding_bag_backward_sort_plain(indices: torch.Tensor, num_rows: int
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage ``sort``: the pairs stably sorted by key. A stable sort's output
    is unique, so the kernel's must equal it exactly."""
    keys, payload = embedding_bag_backward_keys_plain(indices, num_rows)
    order = torch.sort(keys, stable=True).indices
    return keys[order], payload[order]


def _sorted_rows(dout: torch.Tensor, keys: torch.Tensor, payload: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """dout[payload, key // R] in fp32 for each sorted entry (n, E); the
    sentinel's entries read table 0 and are never used."""
    t = dout.shape[1]
    table = torch.where(keys < t * num_rows, keys // num_rows, 0)
    return dout.float()[payload.long(), table.long()]


def embedding_bag_backward_links(keys: torch.Tensor, num_rows: int,
                                 num_tables: int) -> torch.Tensor:
    """(ceil(n / PIECE) - 1,) bool: entry k is True where a segment (not the
    sentinel's) crosses the boundary between piece k and piece k + 1."""
    starts = keys[PIECE::PIECE]
    return (starts == keys[PIECE - 1:-1:PIECE][:starts.numel()]) & (
        starts < num_tables * num_rows)


def embedding_bag_backward_pieces_plain(dout: torch.Tensor, keys: torch.Tensor,
                                        payload: torch.Tensor, num_rows: int
                                        ) -> Dict[str, torch.Tensor]:
    """Stage ``pieces``: ``head`` and ``tail`` (ceil(n / PIECE), E) fp32, the
    sums of each piece's first key's and last key's entries, and
    ``head_len``, the count of the first; zeros where the key is the
    sentinel (the kernel leaves those unwritten)."""
    n, (t, e) = keys.numel(), dout.shape[1:]
    pieces = -(-n // PIECE)
    pad = pieces * PIECE - n
    rows = _sorted_rows(dout, keys, payload, num_rows)
    rows = torch.cat([rows, rows.new_zeros((pad, e))]).view(pieces, PIECE, e)
    k = torch.cat([keys, keys.new_full((pad,), -1)]).view(pieces, PIECE)
    first = k[:, 0]
    last = keys[torch.clamp(torch.arange(1, pieces + 1, device=keys.device)
                            * PIECE, max=n) - 1]
    valid = t * num_rows
    in_head = (k == first[:, None]) & (first < valid)[:, None]
    in_tail = (k == last[:, None]) & (last < valid)[:, None]
    return {"head": (rows * in_head[..., None]).sum(1),
            "tail": (rows * in_tail[..., None]).sum(1),
            "head_len": in_head.sum(1).int()}


def embedding_bag_backward_write_plain(dout: torch.Tensor, keys: torch.Tensor,
                                       payload: torch.Tensor,
                                       pieces: Dict[str, torch.Tensor],
                                       num_rows: int) -> torch.Tensor:
    """Stage ``write``: entries of a segment inside one piece added one by
    one, a segment that crosses pieces a .. z taken as tail[a] + head[a + 1]
    + ... + head[z]; rounded once into ``dout.dtype``; a dense (T, R, E)."""
    t, e = dout.shape[1], dout.shape[2]
    valid = keys < t * num_rows
    _, inverse, counts = torch.unique_consecutive(
        keys, return_inverse=True, return_counts=True)
    ends = torch.cumsum(counts, 0)
    crossing = (ends - counts) // PIECE != (ends - 1) // PIECE
    single = valid & ~crossing[inverse]
    links = embedding_bag_backward_links(keys, num_rows, t)
    linked = torch.nonzero(links).flatten()          # piece k links to k + 1
    crossed = keys[(linked + 1) * PIECE]
    # tail[k] where piece k is the segment's first piece, head[k + 1] always
    into = torch.cat([links.new_zeros(1), links])    # piece k linked from k - 1
    first = ~(into[linked] & (keys[linked * PIECE] == crossed))
    dtables = torch.zeros((t * num_rows, e), dtype=torch.float32,
                          device=dout.device)
    rows = _sorted_rows(dout, keys, payload, num_rows)
    dtables.index_add_(0, keys[single].long(), rows[single])
    dtables.index_add_(0, crossed[first].long(),
                       pieces["tail"].float()[linked[first]])
    dtables.index_add_(0, crossed.long(), pieces["head"].float()[linked + 1])
    return dtables.view(t, num_rows, e).to(dout.dtype)


def embedding_bag_backward_sorted_plain(dout: torch.Tensor,
                                        indices: torch.Tensor,
                                        num_rows: int) -> torch.Tensor:
    """Plain PyTorch, any device: the backward kernels' stages composed
    (keys with the sentinel, a stable sort, the pieces' sums, the segmented
    sum);
    equal to ``embedding_bag_backward_plain`` within rounding."""
    keys, payload = embedding_bag_backward_sort_plain(indices, num_rows)
    pieces = embedding_bag_backward_pieces_plain(dout, keys, payload, num_rows)
    return embedding_bag_backward_write_plain(dout, keys, payload, pieces,
                                              num_rows)


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


def _check_backward(dout: torch.Tensor, indices: torch.Tensor,
                    num_rows: int) -> Tuple[int, int, int, int, int]:
    """Raise on anything the backward kernels do not take; return
    (B, T, L, R, E)."""
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
    if t * r + 1 > _INT32_MAX or b * t * lookups > _INT32_MAX:
        raise ValueError(f"{what}: T * R + 1 ({t * r + 1}) and B * T * L "
                         f"({b * t * lookups}) must fit the sort's int32 "
                         "keys; shard the tables")
    if dout.stride(2) != 1:
        raise ValueError(f"{what}: the last dim of dout is not contiguous")
    return b, t, lookups, r, e


def _backward_buffer_specs(dout: torch.Tensor, indices: torch.Tensor,
                           num_rows: int) -> dict:
    """name -> (shape, dtype) of the output and of the stages' scratch."""
    b, t, lookups = indices.shape
    e = dout.shape[2]
    n = b * t * lookups
    pieces = -(-n // PIECE)
    i32, f32 = torch.int32, torch.float32
    return {"dtables": ((t, num_rows, e), dout.dtype),
            "keys": ((n,), i32), "vals": ((n,), i32),
            "keys_tmp": ((n,), i32), "vals_tmp": ((n,), i32),
            "hist": ((256 * -(-n // SORT_TILE) + 256,), i32),
            "head": ((pieces, e), f32), "tail": ((pieces, e), f32),
            "head_len": ((pieces,), i32)}


def embedding_bag_backward_buffers(dout: torch.Tensor, indices: torch.Tensor,
                                   num_rows: int) -> Dict[str, torch.Tensor]:
    """The output ``dtables`` and the stages' scratch (see the module's
    docstring), uninitialised, on dout's device."""
    return {name: torch.empty(shape, dtype=dtype, device=dout.device)
            for name, (shape, dtype) in _backward_buffer_specs(
                dout, indices, num_rows).items()}


def _launch_backward(dout, indices, sizes, buffers: Dict[str, torch.Tensor],
                     mask: int) -> None:
    b, t, lookups, r, e = sizes
    ptr = {name: buf.data_ptr() for name, buf in buffers.items()}
    with _build.on_device(dout.device):
        stream = torch.cuda.current_stream(dout.device).cuda_stream
        code = _build.lib().repro_embedding_bag_backward(
            dout.data_ptr(), indices.data_ptr(), ptr["dtables"], ptr["keys"],
            ptr["vals"], ptr["keys_tmp"], ptr["vals_tmp"], ptr["hist"],
            ptr["head"], ptr["tail"], ptr["head_len"], b, t, lookups, r, e,
            dout.stride(0),
            dout.stride(1), *indices.stride(), _DTYPE_CODE[dout.dtype], mask,
            stream)
    _build.check(code, "embedding_bag backward kernel launch")


def embedding_bag_backward_stages_cuda(dout: torch.Tensor,
                                       indices: torch.Tensor, num_rows: int,
                                       buffers: Dict[str, torch.Tensor],
                                       stages=BACKWARD_STAGES) -> None:
    """Launch the named stages' kernels, in ``BACKWARD_STAGES``' order, on
    PyTorch's current stream, reading and writing ``buffers`` (as
    ``embedding_bag_backward_buffers`` makes them): a stage reads what the
    stages before it wrote there. For the card's tests and timings of one
    stage."""
    sizes = _check_backward(dout, indices, num_rows)
    unknown = set(stages) - set(BACKWARD_STAGES)
    if unknown:
        raise ValueError(f"embedding_bag backward kernel: no stage "
                         f"{sorted(unknown)}")
    specs = _backward_buffer_specs(dout, indices, num_rows)
    if set(buffers) != set(specs):
        raise ValueError(f"embedding_bag backward kernel: buffers "
                         f"{sorted(buffers)}; want {sorted(specs)}")
    for name, (shape, dtype) in specs.items():
        buf = buffers[name]
        if (buf.shape != shape or buf.dtype != dtype
                or buf.device != dout.device or not buf.is_contiguous()):
            raise ValueError(f"embedding_bag backward kernel: buffer {name} "
                             f"{tuple(buf.shape)} {buf.dtype}; want {shape} "
                             f"{dtype}, contiguous, on dout's device")
    _launch_backward(dout, indices, sizes, buffers,
                     sum(1 << i for i, name in enumerate(BACKWARD_STAGES)
                         if name in stages))


def embedding_bag_backward_cuda(dout: torch.Tensor, indices: torch.Tensor,
                                num_rows: int) -> torch.Tensor:
    """Launch the backward's ``backward_kernels_per_call`` kernels on
    PyTorch's current stream, with no synchronisation and no read back:
    a dense ``dtables`` (T, num_rows, E) of ``dout.dtype``, allocated with
    ``torch.empty`` and written once, row by row, by the kernels. ``dout``
    is taken by its strides (last dim contiguous), the indices too. Raises
    on anything the kernels do not take."""
    sizes = _check_backward(dout, indices, num_rows)
    buffers = embedding_bag_backward_buffers(dout, indices, sizes[3])
    _launch_backward(dout, indices, sizes, buffers,
                     (1 << len(BACKWARD_STAGES)) - 1)
    return buffers["dtables"]
