"""The op counter: FLOPs, HBM bytes, collective bytes and peak live bytes
of an eager PyTorch program, counted as PyTorch's dispatcher runs it.

Counterpart of ``src/repro/core/hlo_analyzer.py``. The reference walks the
HLO text of a compiled XLA program; the port has no such text, so the
counter is a ``TorchDispatchMode`` that sees every operator the program
runs and returns the reference's ``Cost(flops, bytes, coll)``, per device
(one process a device: the counts are this rank's).

* **FLOPs.** Matrix products and convolutions by
  ``torch.utils.flop_counter``'s registry, which holds the hand-written
  kernels' formulas too (``kernels/ops.py``: each kernel is one operator,
  its work the kernel module's formula, useful work only: causal attention
  counts the pairs its mask allows). Elementwise ops count one FLOP an
  output element and reductions one an input element, the reference's
  convention (``hlo_analyzer.py:287,359``); data movement (copies, casts,
  gathers, scatters, concatenation, factories) counts none.
* **Bytes.** Eager PyTorch runs each op as its own kernel, so every op that
  is not a view reads its tensor operands and writes its outputs: the
  counterpart of the reference's fusion-boundary rule. The hand-written
  kernels are charged by their formulas. A gather (``index``,
  ``index_select``, ``gather``, ``embedding``) moves the window it selects
  (read and written) and reads its indices, as the reference's
  slice/gather rule; an in-place write through an index (``index_put_``,
  ``scatter_``) is charged for the window it writes, and a copy into a
  slice for the slice.
* **Collectives.** The ``c10d`` operators as the dispatcher sees them (a
  real or a fake process group alike; ``torch.distributed`` is not
  patched), under the reference's opcode names, bytes of the output shape
  a call (``hlo.py:68-80``): ``allreduce_`` all-reduce; ``allgather_``,
  ``_allgather_base_`` all-gather; ``reduce_scatter_``,
  ``_reduce_scatter_base_`` reduce-scatter; ``alltoall_`` all-to-all;
  ``send`` / ``recv_`` collective-permute. ``broadcast_`` (one rank's
  block to all) is counted as an all-gather and ``reduce_`` (all blocks to
  one rank) as a reduce-scatter. Any other ``c10d`` operator raises.
* **Peak live bytes.** The storages alive inside the mode, the held
  arguments included (``hold``), summed after each op; the peak is the
  counterpart of ``memory_analysis``'s ``temp_size_in_bytes`` plus the
  arguments.
* **Loops.** Eager Python loops run every iteration, so the reference's
  trip-count multiplication (``known_trip_count``) comes for free: a loop
  of 10 products counts 10 products.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# Registers the kernels' operators and their FLOP formulas.
from repro_torch.kernels import ops as kernel_ops

aten = torch.ops.aten


@dataclasses.dataclass
class Cost:
    """The reference's: flops, HBM bytes, collective bytes by opcode."""

    flops: float = 0.0
    bytes: float = 0.0
    coll: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.coll is None:
            self.coll = {}


# Metadata queries: no work, and FlopCounterMode lets them through too.
# (Looked up by name: not every PyTorch release has all of them.)
_METADATA = {
    getattr(getattr(ns, name), overload)
    for ns, name, overload in (
        (aten, "sym_is_contiguous", "default"),
        (aten, "is_contiguous", "default"),
        (aten, "is_contiguous", "memory_format"),
        (aten, "is_strides_like_format", "default"),
        (aten, "is_non_overlapping_and_dense", "default"),
        (aten, "size", "default"), (aten, "sym_size", "default"),
        (aten, "stride", "default"), (aten, "sym_stride", "default"),
        (aten, "storage_offset", "default"),
        (aten, "sym_storage_offset", "default"),
        (aten, "numel", "default"), (aten, "sym_numel", "default"),
        (aten, "dim", "default"), (torch.ops.prim, "layout", "default"),
        (torch.ops.prim, "device", "default"))
    if hasattr(ns, name) and hasattr(getattr(ns, name), overload)
}

# No FLOPs: copies, casts, gathers, scatters, concatenation, factories.
_DATA_MOVEMENT = {
    "_to_copy", "copy_", "clone", "cat", "stack", "index", "_unsafe_index",
    "index_select", "gather", "index_put", "index_put_", "_index_put_impl_",
    "scatter", "scatter_", "slice_scatter", "select_scatter",
    "embedding", "repeat", "repeat_interleave", "constant_pad_nd", "flip",
    "roll", "narrow_copy", "expand_copy", "fill", "fill_", "zero_", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
    "new_ones", "new_full", "arange", "lift_fresh", "lift_fresh_copy",
    "scalar_tensor", "_local_scalar_dense", "tril", "triu",
}
# Allocate without writing: no bytes either.
_UNWRITTEN = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided"}
# One FLOP an input element.
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp", "var",
    "std", "var_mean", "std_mean", "linalg_vector_norm", "norm", "argmax",
    "argmin", "any", "all", "dot", "vdot", "count_nonzero",
}
# Gathers: read the window they select (and the indices), write it.
_GATHERS = {"index", "_unsafe_index", "index_select", "gather", "embedding"}
# An in-place write of these touches the window its source names only.
_WINDOW_WRITES = {"index_put_", "_index_put_impl_", "scatter_"}
# In-place ops that do not read what they overwrite.
_WRITE_ONLY = {"copy_", "fill_", "zero_"} | _WINDOW_WRITES

# c10d operator -> (the reference's opcode, whether it works in place on
# its first argument); the first argument always holds the output.
_C10D = {
    "allreduce_": ("all-reduce", True),
    "allreduce_coalesced_": ("all-reduce", True),
    "allgather_": ("all-gather", False),
    "_allgather_base_": ("all-gather", False),
    "allgather_into_tensor_coalesced_": ("all-gather", False),
    "reduce_scatter_": ("reduce-scatter", False),
    "_reduce_scatter_base_": ("reduce-scatter", False),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", False),
    "alltoall_": ("all-to-all", False),
    "alltoall_base_": ("all-to-all", False),
    "broadcast_": ("all-gather", True),
    "reduce_": ("reduce-scatter", True),
    "send": ("collective-permute", True),
    "recv_": ("collective-permute", True),
}
_C10D_FREE = {"barrier", "monitored_barrier_"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _storage(t: torch.Tensor):
    return t.untyped_storage()


class OpCounter(TorchDispatchMode):
    """``with OpCounter(hold=state) as c: step(...)`` -> ``c.cost`` (a
    ``Cost``), ``c.by_op`` (name -> calls, flops, bytes), ``c.peak_bytes``.

    ``hold``: a tree of the tensors the program starts from (its
    arguments); their storages count as live from the start
    (``argument_bytes``). ``memory(outputs)``: the reference's
    ``memory_analysis`` keys for a step that returned ``outputs``."""

    def __init__(self, hold=None):
        super().__init__()
        self.cost = Cost()
        self.by_op: Dict[str, List[float]] = {}
        self._live: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._track(_tensors(hold))
        self.argument_bytes = self.live_bytes
        self._held = set(self._live)

    # -- live storages -------------------------------------------------- #
    def _release(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _track(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            st = _storage(t)
            key = id(st)
            if key in self._live:
                continue
            nbytes = st.nbytes()
            self._live[key] = (weakref.ref(
                st, lambda _, key=key, n=nbytes: self._release(key, n)),
                nbytes)
            self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def memory(self, outputs=None) -> Dict[str, int]:
        """``argument_bytes`` (the held storages), ``output_bytes`` (the
        storages of ``outputs`` that are not held), ``temp_bytes`` (the
        peak above the arguments and outputs)."""
        seen, out_bytes = set(self._held), 0
        for t in _tensors(outputs):
            st = _storage(t)
            if id(st) not in seen:
                seen.add(id(st))
                out_bytes += st.nbytes()
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": max(0, self.peak_bytes - self.argument_bytes
                                  - out_bytes)}

    # -- charging --------------------------------------------------------- #
    def _charge(self, name: str, flops: float, nbytes: float,
                coll: Optional[tuple] = None) -> None:
        self.cost.flops += flops
        self.cost.bytes += nbytes
        if coll is not None:
            self.cost.coll[coll[0]] = self.cost.coll.get(coll[0], 0) + coll[1]
        row = self.by_op.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def _c10d(self, func, args) -> None:
        name = func.overloadpacket.__name__
        if name in _C10D_FREE:
            return
        if name not in _C10D:
            raise ValueError(f"op counter: no rule for the collective "
                             f"c10d.{name}")
        opcode, in_place = _C10D[name]
        out = _nbytes(_tensors(args[0]))
        read = out if in_place else _nbytes(_tensors(args[1]))
        self._charge(f"c10d.{name}", 0.0, read + out, (opcode, out))

    def _aten(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        name = packet.__name__
        label = f"{func.namespace}.{name}"
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if packet in kernel_ops.WORK:
            flops, nbytes = kernel_ops.WORK[packet](*args, **kwargs)
            self._charge(label, flops, nbytes)
            return
        written, write_only = [], set()
        by_name = dict(zip((a.name for a in func._schema.arguments), args))
        by_name.update(kwargs)
        for arg in func._schema.arguments:
            t = by_name.get(arg.name)
            if (isinstance(t, torch.Tensor) and arg.alias_info is not None
                    and arg.alias_info.is_write):
                written.append(t)
                if arg.name == "out" or name in _WRITE_ONLY:
                    write_only.add(id(t))
        in_storages = {id(_storage(t)) for t in ins}
        if not written and (func.is_view or (outs and all(
                id(_storage(t)) in in_storages for t in outs))):
            return                                   # a view: no traffic
        if name in _UNWRITTEN:
            return
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        elif name in _DATA_MOVEMENT:
            flops = 0
        elif name in _REDUCTIONS:
            flops = sum(t.numel() for t in ins)
        else:
            flops = sum(t.numel() for t in (written or outs))
        if name in _GATHERS:
            nbytes = _nbytes(ins[1:]) + 2 * _nbytes(outs)
        elif name in _WINDOW_WRITES:
            # reads the indices and the source, writes the source's window
            nbytes = _nbytes(ins[1:]) + _nbytes(ins[-1:])
        elif written:
            nbytes = (_nbytes(t for t in ins if id(t) not in write_only)
                      + _nbytes(written))
        else:
            nbytes = _nbytes(ins) + _nbytes(outs)
        self._charge(label, flops, nbytes)

    # -- the mode --------------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        if (func.namespace == "aten" and func.overloadpacket not in
                flop_registry):
            # as FlopCounterMode: an op that still decomposes is counted
            # through what it decomposes into
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        self._track(_tensors((args, kwargs)))
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._c10d(func, args)
        else:
            self._aten(func, args, kwargs, out)
        self._track(_tensors(out))
        return out

