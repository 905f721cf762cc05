"""Lower a decomposed :class:`~repro_torch.core.workload.Workload` to flat arrays.

The port's copy of the JAX package's ``core/compiled.py``: phase 1 of the
two-phase evaluator. :func:`compile_workload` walks the layer list once per
strategy and emits, per pipeline stage:

  * **delay classes** — distinct op-list rows: per-class FLOP totals,
    streaming-op base traffic, and every GEMM's operand sizes
    ``(u, v, w, batch)`` with a segment map back to its class row (the
    repeated blocks ``decompose`` stamps out share their op lists, so a
    514-layer stack collapses to about a dozen classes);
  * **deduplicated communication events** — one row per distinct
    (collective, bytes, scope) triple;
  * the two execution-ordered event streams (forward; interleaved IG/WG
    backward) with layer repeats unrolled;
  * the optimizer-update byte totals (dense / expert / sparse).

Phase 2 is :func:`repro_torch.core.simulator.time_compiled`, which times a
``CompiledWorkload`` against a batch of (node, topology) environments
through :mod:`repro_torch.core.torch_engine`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.gemm import ExplicitOp, Gemm
from repro_torch.core.workload import LayerSpec, Workload

PHASES = ("fp", "ig", "wg")

# Scope codes: the timeline's per-scope network streams.
SCOPES = ("mp", "dp", "ep", "pp", "edp")
_SCOPE_CODE = {s: i for i, s in enumerate(SCOPES)}


@dataclasses.dataclass
class CompiledPass:
    """One timeline pass (forward, or interleaved IG/WG backward) in
    execution order, repeats unrolled.

    ``seq`` lists delay-class rows in the order their compute runs; each
    communication event fires after ``ev_pos`` of those compute steps have
    executed (several events may share a position)."""

    seq: np.ndarray          # int64 (nseq,) rows into the delay matrix
    ev_pos: np.ndarray       # int64 (nev,) compute steps preceding the event
    ev_comm: np.ndarray      # int64 (nev,) rows into the stage comm table
    ev_blocking: np.ndarray  # bool  (nev,)
    ev_scope: np.ndarray     # int64 (nev,) index into SCOPES
    ev_phase: np.ndarray     # int64 (nev,) 0=fp 1=ig 2=wg


@dataclasses.dataclass
class CompiledStage:
    """Flat arrays for one pipeline stage's layer list.

    Rows are *delay classes*: one per distinct (layer, phase) op list
    (clones stamped out by ``decompose`` share op-list identity and
    collapse into one row)."""

    n_classes: int
    flops: np.ndarray          # (ncls,) op-FLOP totals (cell-independent)
    base_traffic: np.ndarray   # (ncls,) streaming-op bytes (sram-independent)
    counts: np.ndarray         # (3, ncls) repeat-weighted phase occurrences
    # GEMM table, ordered by class row (contiguous segments):
    gemm_u: np.ndarray         # (nops,) A-operand bytes  (m * k * bpe)
    gemm_v: np.ndarray         # (nops,) B-operand bytes  (k * n * bpe)
    gemm_w: np.ndarray         # (nops,) output bytes     (m * n * bpe)
    gemm_batch: np.ndarray     # (nops,)
    gemm_starts: np.ndarray    # (nseg,) first op index of each nonempty class
    gemm_cls: np.ndarray       # (nseg,) that segment's class row
    # Distinct communication events — one row per (kind, bytes, scope):
    comm_kinds: Tuple[str, ...]
    comm_scopes: Tuple[str, ...]
    comm_sizes: np.ndarray     # (ncomm,) bytes
    fwd: CompiledPass
    bwd: CompiledPass
    # Optimizer-update byte totals (simulator._optimizer_numer):
    dense_w: float             # dense fp16 weight bytes (excl. experts)
    expert_w: float            # EP-sharded expert weight bytes
    sparse: float              # optim_bytes overrides (embedding bags)


@dataclasses.dataclass
class CompiledWorkload:
    """A lowered workload: one :class:`CompiledStage` per pipeline stage
    (exactly one when ``pp == 1``), plus the source workload for the
    footprint / schedule metadata the simulator still reads."""

    workload: Workload
    stages: List[CompiledStage]

    @property
    def pp(self) -> int:
        return len(self.stages)


def _pass_arrays(seq, ev) -> CompiledPass:
    if ev:
        pos, comm, blocking, scope, phase = zip(*ev)
    else:
        pos = comm = blocking = scope = phase = ()
    return CompiledPass(
        seq=np.asarray(seq, dtype=np.int64),
        ev_pos=np.asarray(pos, dtype=np.int64),
        ev_comm=np.asarray(comm, dtype=np.int64),
        ev_blocking=np.asarray(blocking, dtype=bool),
        ev_scope=np.asarray(scope, dtype=np.int64),
        ev_phase=np.asarray(phase, dtype=np.int64),
    )


def _compile_stage(layers: List[LayerSpec]) -> CompiledStage:
    flops: List[float] = []
    base: List[float] = []
    cls_of: Dict[int, int] = {}        # id(op list) -> class row
    g_u: List[float] = []
    g_v: List[float] = []
    g_w: List[float] = []
    g_b: List[float] = []
    g_cls: List[int] = []
    comm_kinds: List[str] = []
    comm_scopes: List[str] = []
    comm_sizes: List[float] = []
    comm_of: Dict[tuple, int] = {}     # (kind, bytes, scope) -> comm row
    # Per layer: 3 class rows + per-phase compiled event triples.
    layer_cls: List[Tuple[int, int, int]] = []
    layer_ev: List[Tuple[list, list, list]] = []

    def classify(ops: list) -> int:
        c = cls_of.get(id(ops))
        if c is None:
            c = cls_of[id(ops)] = len(flops)
            f = 0.0
            b = 0.0
            for op in ops:
                if isinstance(op, Gemm):
                    bpe = op.bytes_per_element
                    g_u.append(op.m * op.k * bpe)
                    g_v.append(op.k * op.n * bpe)
                    g_w.append(op.m * op.n * bpe)
                    g_b.append(op.batch)
                    g_cls.append(c)
                    f += op.flops()
                elif isinstance(op, ExplicitOp):
                    b += op.bytes_moved
                    f += op.flops
                else:
                    raise TypeError(f"unknown op type {type(op)!r}")
            flops.append(f)
            base.append(b)
        return c

    def events(comm: list) -> list:
        out = []
        for e in comm:
            key = (e.collective, e.size_bytes, e.scope)
            row = comm_of.get(key)
            if row is None:
                row = comm_of[key] = len(comm_kinds)
                comm_kinds.append(e.collective)
                comm_scopes.append(e.scope)
                comm_sizes.append(e.size_bytes)
            out.append((row, e.blocking, _SCOPE_CODE[e.scope]))
        return out

    for layer in layers:
        layer_cls.append((classify(layer.fwd), classify(layer.ig),
                          classify(layer.wg)))
        layer_ev.append((events(layer.comm_fwd), events(layer.comm_ig),
                         events(layer.comm_wg)))

    ncls = len(flops)
    counts = np.zeros((3, ncls))
    for layer, (cf, ci, cw) in zip(layers, layer_cls):
        counts[0, cf] += layer.repeat
        counts[1, ci] += layer.repeat
        counts[2, cw] += layer.repeat

    fwd_seq: List[int] = []
    fwd_ev: List[tuple] = []
    for layer, (cf, _, _), (ef, _, _) in zip(layers, layer_cls, layer_ev):
        for _ in range(layer.repeat):
            fwd_seq.append(cf)
            for row, blocking, scope in ef:
                fwd_ev.append((len(fwd_seq), row, blocking, scope, 0))
    bwd_seq: List[int] = []
    bwd_ev: List[tuple] = []
    for layer, (_, ci, cw), (_, ei, ew) in zip(reversed(layers),
                                               reversed(layer_cls),
                                               reversed(layer_ev)):
        for _ in range(layer.repeat):
            bwd_seq.append(ci)
            for row, blocking, scope in ei:
                bwd_ev.append((len(bwd_seq), row, blocking, scope, 1))
            bwd_seq.append(cw)
            for row, blocking, scope in ew:
                bwd_ev.append((len(bwd_seq), row, blocking, scope, 2))

    g_cls_arr = np.asarray(g_cls, dtype=np.int64)
    if g_cls_arr.size:
        starts = np.flatnonzero(np.diff(g_cls_arr, prepend=-1))
        seg_cls = g_cls_arr[starts]
    else:
        starts = np.zeros(0, dtype=np.int64)
        seg_cls = np.zeros(0, dtype=np.int64)
    # Optimizer-update totals (mirrors simulator._optimizer_time's sums).
    dense_w = sum((ly.weight_bytes - ly.expert_bytes) * ly.repeat
                  for ly in layers if ly.optim_bytes is None)
    expert_w = sum(ly.expert_bytes * ly.repeat for ly in layers
                   if ly.optim_bytes is None)
    sparse = sum(ly.optim_bytes * ly.repeat for ly in layers
                 if ly.optim_bytes is not None)
    return CompiledStage(
        n_classes=ncls,
        flops=np.asarray(flops),
        base_traffic=np.asarray(base),
        counts=counts,
        gemm_u=np.asarray(g_u, dtype=float),
        gemm_v=np.asarray(g_v, dtype=float),
        gemm_w=np.asarray(g_w, dtype=float),
        gemm_batch=np.asarray(g_b, dtype=float),
        gemm_starts=starts,
        gemm_cls=seg_cls,
        comm_kinds=tuple(comm_kinds),
        comm_scopes=tuple(comm_scopes),
        comm_sizes=np.asarray(comm_sizes, dtype=float),
        fwd=_pass_arrays(fwd_seq, fwd_ev),
        bwd=_pass_arrays(bwd_seq, bwd_ev),
        dense_w=float(dense_w),
        expert_w=float(expert_w),
        sparse=float(sparse),
    )


def compile_workload(workload: Workload) -> CompiledWorkload:
    """Lower ``workload`` into flat arrays, one stage per pipeline stage.

    This is the strategy-dependent half of a study cell's cost: call it
    once per (strategy, workload_deps) key and reuse the result against
    every cluster cell (``Workload.compiled()`` memoizes exactly that)."""
    return CompiledWorkload(
        workload=workload,
        stages=[_compile_stage(layers) for layers in workload.stage_layers()],
    )


def pass_event_totals(stage: CompiledStage
                      ) -> Dict[Tuple[str, str], Tuple[int, float]]:
    """Occurrence counts and total bytes per (collective, scope) across a
    stage's two execution streams — what the timeline will actually issue
    per microbatch, with the (kind, bytes, scope) dedup expanded back out.
    The static analyzer (C102/C103, :mod:`repro_torch.analysis
    .rules_compiled`) compares this against the source layer list."""
    totals: Dict[Tuple[str, str], List[float]] = {}
    for p in (stage.fwd, stage.bwd):
        for row in p.ev_comm.tolist():
            key = (stage.comm_kinds[row], stage.comm_scopes[row])
            cell = totals.setdefault(key, [0, 0.0])
            cell[0] += 1
            cell[1] += float(stage.comm_sizes[row])
    return {k: (int(c), b) for k, (c, b) in totals.items()}


def stage_traffic(stage: CompiledStage, sram: np.ndarray) -> np.ndarray:
    """Per-delay-class memory traffic for a batch of on-chip buffer sizes:
    ``(ncls, nenv)`` bytes.  The §III-C2 tiling estimate
    (min{Psi1, Psi2} + W, see :func:`repro_torch.core.gemm.gemm_traffic_bytes`)
    vectorized over every GEMM and environment at once."""
    nenv = sram.shape[0]
    traffic = np.repeat(stage.base_traffic[:, None], nenv, axis=1)
    if stage.gemm_u.size:
        u = stage.gemm_u[:, None]
        v = stage.gemm_v[:, None]
        w = stage.gemm_w[:, None]
        s = sram[None, :]
        psi1 = np.ceil(u / s) * v + u
        psi2 = np.ceil(v / s) * u + v
        per = np.minimum(psi1, psi2) + w
        degenerate = (u == 0) | (v == 0)
        if degenerate.any():
            per = np.where(degenerate, u + v + w, per)
        contrib = stage.gemm_batch[:, None] * per
        traffic[stage.gemm_cls] += np.add.reduceat(contrib, stage.gemm_starts,
                                                   axis=0)
    return traffic
