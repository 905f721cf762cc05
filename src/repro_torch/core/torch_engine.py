"""The compiled evaluator's hot path in float64 PyTorch, on the GPU.

The port of the JAX package's ``core/jax_engine.py``.
:mod:`repro_torch.core.compiled` lowers each strategy to flat arrays once;
:func:`repro_torch.core.simulator.time_compiled` times them against a batch
of (node, topology) environments through :func:`stage_compute_exposed`,
which evaluates, for every environment at once:

* the delay-class roofline matrix (§III-C2 tiling traffic + Eqns (1)/(2));
* the ASTRA-lite timeline: a closed form of static count-matrix products
  when no scope interleaves non-blocking and blocking events
  (:func:`_stage_fn_fast`), else a walk over the events in which every step
  is a few ops on ``(nenv,)``-wide tensors (:func:`_stage_fn_scan`); the
  walk over the environment axis is what ``vmap`` was in the reference.

:func:`comm_matrix` prices the collectives over the environment axis in
NumPy, vectorized per structural topology family, outside the device call
that it feeds: its arithmetic is too small to pay for device launches.
Topology families outside the three built-ins fall back to their own
``collective_time_batch`` / ``collective_time``.

Every tensor is created as ``torch.float64`` on the requested device; the
process's default dtype is never touched, since the model stack shares the
process. The count matrices are integers held exactly in float64. The
device work takes a fixed order: the per-class sum of GEMM traffic is a
product with a static 0/1 matrix (no atomics), so repeated calls on the
card give the same bits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.collectives import CollectiveModel
from repro_torch.core.compiled import SCOPES
from repro_torch.core.topology import (
    _PAPER_ORDER,
    HierarchicalSwitch,
    SingleSwitch,
    Torus,
    _group_size,
)

F64 = torch.float64

# --------------------------------------------------------------------- #
# Collective formulas over environment-parameter arrays
# --------------------------------------------------------------------- #
# Mirror repro_torch.core.topology's *_batch helpers term for term, with
# the bandwidth / latency scalars promoted to arrays over the environment
# group: ``sizes`` is (nev, 1), parameters are (k,), results broadcast to
# (nev, k). Group sizes, pod layout and placement stay Python ints: they
# are part of the structural key that formed the group.

def _ring_allreduce(sizes, n: int, bw, lat):
    if n <= 1:
        return np.zeros(np.broadcast_shapes(np.shape(sizes),
                                              np.shape(bw)))
    t = 2 * (n - 1) / n * sizes / bw + 2 * (n - 1) * lat
    return np.where(sizes > 0, t, 0.0)


def _ring_allgather(sizes, n: int, bw, lat):
    if n <= 1:
        return np.zeros(np.broadcast_shapes(np.shape(sizes),
                                              np.shape(bw)))
    t = (n - 1) / n * sizes / bw + (n - 1) * lat
    return np.where(sizes > 0, t, 0.0)


def _all_to_all(sizes, n: int, bw, lat):
    if n <= 1:
        return np.zeros(np.broadcast_shapes(np.shape(sizes),
                                              np.shape(bw)))
    t = (n - 1) / n * sizes / bw + lat
    return np.where(sizes > 0, t, 0.0)


def _flat_time(collective: str, sizes, n: int, bw, lat):
    if collective == "all-reduce":
        return _ring_allreduce(sizes, n, bw, lat)
    if collective in ("all-gather", "reduce-scatter"):
        return _ring_allgather(sizes, n, bw, lat)
    if collective == "all-to-all":
        return _all_to_all(sizes, n, bw, lat)
    if collective == "p2p":
        return np.where(sizes > 0, sizes / bw + lat, 0.0)
    raise ValueError(f"unknown collective {collective!r}")


def _hier_time(collective: str, sizes, scope: str, mp: int, dp: int,
               pp: int, ep: int, order, pod_size: int,
               intra_bw, inter_bw, intra_lat, inter_lat):
    """HierarchicalSwitch.collective_time_batch over a parameter array."""
    if collective == "p2p":
        if not order.p2p_crosses_pod(mp, dp, pod_size, pp, ep):
            return np.where(sizes > 0, sizes / intra_bw + intra_lat, 0.0)
        return np.where(sizes > 0, sizes / inter_bw + inter_lat, 0.0)
    pl = order.group_placement(scope, mp, dp, pod_size, pp, ep)
    p, q = pl.intra, pl.inter
    if q <= 1:
        return _flat_time(collective, sizes, p, intra_bw, intra_lat)
    if p <= 1:
        return _flat_time(collective, sizes, q, inter_bw, inter_lat)
    if collective == "all-reduce":
        return 2 * _ring_allgather(sizes, p, intra_bw, intra_lat) \
            + _ring_allreduce(sizes / p, q, inter_bw, inter_lat)
    if collective in ("all-gather", "reduce-scatter"):
        return _ring_allgather(sizes, p, intra_bw, intra_lat) \
            + _ring_allgather(sizes / p, q, inter_bw, inter_lat)
    if collective == "all-to-all":
        n = p * q
        inter_frac = (n - p) / n
        intra_frac = (p - 1) / n
        t_inter = inter_frac * sizes / inter_bw + inter_lat
        t_intra = intra_frac * sizes / intra_bw + intra_lat
        return np.where(sizes > 0, np.maximum(t_inter, t_intra), 0.0)
    raise ValueError(f"unknown collective {collective!r}")


def _torus_sweep(collective: str, sizes, group: int,
                 dims_spec: Tuple[int, ...], pod: int, has_dcn: bool,
                 link_bw, lat, dcn_bw, dcn_lat):
    """Torus._time_batch over a parameter array (per-dim ring sweeps plus
    the DCN spill level)."""
    bw = 2 * link_bw
    if has_dcn and group > pod:
        q = math.ceil(group / pod)
        if collective == "all-reduce":
            t_in = _torus_sweep("reduce-scatter", sizes, pod, dims_spec,
                                pod, has_dcn, link_bw, lat, dcn_bw, dcn_lat) \
                + _torus_sweep("all-gather", sizes, pod, dims_spec, pod,
                               has_dcn, link_bw, lat, dcn_bw, dcn_lat)
            return t_in + _ring_allreduce(sizes / pod, q, dcn_bw, dcn_lat)
        t_in = _torus_sweep(collective, sizes, pod, dims_spec, pod,
                            has_dcn, link_bw, lat, dcn_bw, dcn_lat)
        return t_in + _flat_time(collective, sizes / pod, q, dcn_bw, dcn_lat)
    dims: List[int] = []
    rem = min(group, pod)
    for d in dims_spec:
        if rem <= 1:
            break
        use = min(d, rem)
        dims.append(use)
        rem = max(1, rem // use)
    if not dims:
        return np.zeros(np.broadcast_shapes(np.shape(sizes),
                                              np.shape(link_bw)))
    if collective == "all-reduce":
        t, s = 0.0, sizes
        for d in dims:
            t = t + _ring_allgather(s, d, bw, lat)
            s = s / d
        for d in reversed(dims):
            s = s * d
            t = t + _ring_allgather(s, d, bw, lat)
        return t
    if collective in ("all-gather", "reduce-scatter"):
        t, s = 0.0, sizes
        for d in dims:
            t = t + _ring_allgather(s, d, bw, lat)
            s = s / d
        return t
    if collective == "all-to-all":
        n = 1
        for d in dims:
            n *= d
        return _all_to_all(sizes, n, bw * len(dims), lat)
    raise ValueError(f"unknown collective {collective!r}")


def _torus_time(collective: str, sizes, scope: str, mp: int, dp: int,
                pp: int, ep: int, order, dims_spec: Tuple[int, ...],
                pod: int, has_dcn: bool, link_bw, lat, dcn_bw, dcn_lat):
    group = _group_size(scope, mp, dp, pp, ep)
    if collective == "p2p":
        if has_dcn and order.p2p_crosses_pod(mp, dp, pod, pp, ep):
            t = sizes / dcn_bw + dcn_lat
        else:
            t = sizes / link_bw + lat
        return np.where(sizes > 0, t, 0.0)
    return _torus_sweep(collective, sizes, group, dims_spec, pod, has_dcn,
                        link_bw, lat, dcn_bw, dcn_lat)


def _structural_key(topo) -> Optional[tuple]:
    """Environments whose topologies share a key differ only in bandwidth
    and latency scalars, so one vectorized formula prices them all."""
    if isinstance(topo, HierarchicalSwitch):
        return ("hier", topo.pod_size)
    if isinstance(topo, Torus):
        return ("torus", topo.dims, bool(topo.dcn_bw))
    if isinstance(topo, SingleSwitch):
        return ("switch",)
    return None


def comm_matrix(stage, envs, mp: int, dp: int, pp: int, ep: int,
                placement) -> np.ndarray:
    """Collective durations ``(ncomm, nenv)`` with the environment axis
    vectorized per structural topology family.

    Rows group by (collective, scope) and are zero when the scope's group
    size is <= 1; each (row group, structural key) is evaluated once over
    every matching environment column. ``placement`` resolves each
    group's hops (:mod:`repro_torch.core.placement`); None is the paper's
    rank order."""
    nenv = len(envs)
    out = np.zeros((len(stage.comm_kinds), nenv))
    if not stage.comm_kinds:
        return out
    order = placement if placement is not None else _PAPER_ORDER
    sizes_all = np.asarray(stage.comm_sizes, dtype=float)

    # Distinct topologies -> their environment columns (dict identity via
    # the frozen dataclasses' value hash).
    topo_cols: Dict[object, List[int]] = {}
    for e, (_, topo) in enumerate(envs):
        topo_cols.setdefault(topo, []).append(e)
    families: Dict[tuple, List[object]] = {}
    fallback: List[object] = []
    for topo in topo_cols:
        key = _structural_key(topo)
        if key is None:
            fallback.append(topo)
        else:
            families.setdefault(key, []).append(topo)

    row_groups: Dict[Tuple[str, str], List[int]] = {}
    for i, (c, s) in enumerate(zip(stage.comm_kinds, stage.comm_scopes)):
        row_groups.setdefault((c, s), []).append(i)

    for key, topos in families.items():
        cols = [topo_cols[t] for t in topos]
        if key[0] == "hier":
            params = tuple(
                np.asarray([getattr(t, f) for t in topos])
                for f in ("intra_bw", "inter_bw", "intra_latency",
                          "inter_latency"))
        elif key[0] == "torus":
            params = tuple(
                np.asarray([getattr(t, f) for t in topos])
                for f in ("link_bw", "latency", "dcn_bw", "dcn_latency"))
        else:
            params = tuple(np.asarray([getattr(t, f) for t in topos])
                           for f in ("bw", "latency"))
        for (c, scope), rows in row_groups.items():
            if _group_size(scope, mp, dp, pp, ep) <= 1:
                continue
            sizes = np.asarray(sizes_all[rows])[:, None]   # (nrow, 1)
            if key[0] == "hier":
                t = _hier_time(c, sizes, scope, mp, dp, pp, ep, order,
                               key[1], *params)
            elif key[0] == "torus":
                t = _torus_time(c, sizes, scope, mp, dp, pp, ep, order,
                                key[1], int(np.prod(key[1])), key[2],
                                *params)
            else:
                group = _group_size(scope, mp, dp, pp, ep)
                t = _flat_time(c, sizes, group, *params)
            t = np.asarray(t)                                # (nrow, k)
            for j, tcols in enumerate(cols):
                out[np.ix_(rows, tcols)] = t[:, j:j + 1]

    for topo in fallback:
        coll = CollectiveModel(topo, mp, dp, pp=pp, ep=ep,
                               placement=placement)
        col = coll.time_batch(stage.comm_kinds, stage.comm_sizes,
                              stage.comm_scopes)
        for e in topo_cols[topo]:
            out[:, e] = col
    return out


# --------------------------------------------------------------------- #
# The stage kernel: roofline delays + batched timeline
# --------------------------------------------------------------------- #

_SCOPE_COUNT = len(SCOPES)


def _prep_pass(p, ncomm: int, nseq: int, ncls: int) -> Dict[str, object]:
    """Static per-pass arrays with the tail-compute sentinel appended.

    The reference walk adds the compute remaining after the last event
    once the event loop ends; a final zero-duration non-blocking event at
    position ``nseq`` charges exactly that (scope 0's stream time becomes
    ``max(tc, tn[0])``, which never changes the exposed residue
    ``max(0, max(tn) - tc)``).

    The cumulative structure is folded into static count matrices, so
    nothing sequential survives into the closed form:

    * ``dcounts`` (``(nev+1, ncls)``, the walk) — ops of each delay class
      between consecutive events: every per-environment compute delta is
      one matrix product;
    * ``exp_cnt`` (closed form) — blocking exposure per (phase, comm
      kind): exposure is one small static-matrix product;
    * ``nb`` (closed form) — per scope with non-blocking events: one
      static matrix ``R`` whose product with the stacked
      ``[delays; comm_pad]`` gives each event's *residual margin* — the
      scope's final stream time minus the pass's final compute clock, as
      seen from that event. The counts are integers, so the
      chain-vs-compute subtraction happens exactly here and the device
      evaluates one short dot product per row instead of differencing two
      large totals (which would amplify rounding on near-zero residues).
      Within a repeated layer run the count rows advance by a constant
      increment, so the margin is affine in the event index and its max
      sits at a run endpoint: interior rows are pruned.

    ``mixed`` flags a pass where some scope sees a non-blocking event
    *before* a later blocking one — the only shape the closed form cannot
    price (the blocking event would have to wait on the pending
    transfer), so such a stage takes the walk.

    The walk also reads ``comm`` (each event's comm row, the sentinel's
    pointing at an appended zero row), ``block``, ``scope`` and ``phase``;
    they stay on the host and steer the walk's steps."""
    pos = np.append(p.ev_pos, nseq).astype(np.int64)
    prev = np.concatenate([[0], pos[:-1]]).astype(np.int64)
    comm = np.append(p.ev_comm, ncomm).astype(np.int64)  # -> padded zero row
    block = np.append(p.ev_blocking, False).astype(bool)
    scope = np.append(p.ev_scope, 0).astype(np.int64)
    phase = np.append(p.ev_phase, 0).astype(np.int64)
    seq = p.seq.astype(np.int64)
    onehot = np.zeros((nseq + 1, ncls))
    onehot[np.arange(nseq) + 1, seq] = 1.0
    prefix = np.cumsum(onehot, axis=0)           # (nseq+1, ncls)
    comm_oh = np.eye(ncomm + 1)[comm]            # (nev+1, ncomm+1)
    phase_oh = np.eye(3)[phase] * block[:, None]
    # Cumulative blocking-duration counts per comm kind at each event.
    bcc = np.cumsum(comm_oh * block[:, None], axis=0)
    nb: Dict[str, np.ndarray] = {}
    mixed = False
    for s in range(_SCOPE_COUNT):
        on = np.asarray(p.ev_scope) == s
        nb_idx = np.flatnonzero(on & ~np.asarray(p.ev_blocking))
        blk_idx = np.flatnonzero(on & np.asarray(p.ev_blocking))
        if nb_idx.size:
            oh = comm_oh[nb_idx]
            dafter = np.cumsum(oh[::-1], axis=0)[::-1]   # incl. own dur
            # Residual margin at event k: the chain's durations from k on
            # minus the ops (and blocking durations) still ahead of it.
            R = np.concatenate(
                [prefix[pos[nb_idx]] - prefix[nseq],
                 dafter + bcc[nb_idx] - bcc[-1]], axis=1)
            if R.shape[0] > 2:
                d = np.diff(R, axis=0)
                interior = np.all(d[1:] == d[:-1], axis=1)
                R = R[np.concatenate([[True], ~interior, [True]])]
            nb[str(s)] = R
            if blk_idx.size and nb_idx.min() < blk_idx.max():
                mixed = True
    return {
        "dcounts": prefix[pos] - prefix[prev],   # (nev+1, ncls)
        "comm": comm,
        "block": block,
        "scope": scope,
        "phase": phase,
        "exp_cnt": phase_oh.T @ comm_oh,         # (3, ncomm+1)
        "nb": nb,
        "mixed": mixed,
    }


def _prep(stage) -> Tuple[dict, bool]:
    """The stage's flat arrays in kernel form plus the closed-form
    eligibility flag, cached on the stage (one lowering per strategy,
    reused for every environment batch). Both paths' arrays are kept, so
    the walk can also be run on a stage the closed form prices."""
    cached = getattr(stage, "_torch_prep", None)
    if cached is not None:
        return cached["host"]
    ncomm = len(stage.comm_kinds)
    ncls = stage.flops.shape[0]
    P: dict = {
        "flops": np.asarray(stage.flops, dtype=float),
        "base": np.asarray(stage.base_traffic, dtype=float),
        "counts": np.asarray(stage.counts, dtype=float),
        "fwd": _prep_pass(stage.fwd, ncomm, stage.fwd.seq.size, ncls),
        "bwd": _prep_pass(stage.bwd, ncomm, stage.bwd.seq.size, ncls),
    }
    if stage.gemm_u.size:
        nops = stage.gemm_u.size
        lengths = np.diff(np.append(stage.gemm_starts, nops))
        op_cls = np.repeat(stage.gemm_cls, lengths).astype(np.int64)
        P["g_u"] = np.asarray(stage.gemm_u, dtype=float)
        P["g_v"] = np.asarray(stage.gemm_v, dtype=float)
        P["g_w"] = np.asarray(stage.gemm_w, dtype=float)
        P["g_b"] = np.asarray(stage.gemm_batch, dtype=float)
        # segment_sum as a fixed-order product: (ncls, nops) 0/1.
        seg = np.zeros((ncls, nops))
        seg[op_cls, np.arange(nops)] = 1.0
        P["seg"] = seg
    fast = not (P["fwd"].pop("mixed") or P["bwd"].pop("mixed"))
    stage._torch_prep = {"host": (P, fast), "device": {}}
    return P, fast


_HOST_KEYS = ("comm", "block", "scope", "phase")   # steer the walk: stay ints


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: (v if k in _HOST_KEYS else _to_device(v, device))
                for k, v in tree.items()}
    return torch.as_tensor(tree, dtype=F64, device=device)


def _device_prep(stage, device: torch.device) -> Tuple[dict, bool]:
    """:func:`_prep`'s arrays as float64 tensors on ``device``, cached on
    the stage per device (converted from their float64 numpy arrays, so
    the integer counts stay exact)."""
    P, fast = _prep(stage)
    per_device = stage._torch_prep["device"]
    T = per_device.get(str(device))
    if T is None:
        T = per_device[str(device)] = _to_device(P, device)
    return T, fast


def _delays(P: dict, sram, peak, mem_bw):
    """:func:`repro_torch.core.compiled.stage_traffic` + the roofline in one
    expression: ``(ncls, nenv)`` delays."""
    traffic = P["base"][:, None].expand(-1, sram.shape[0])
    if "g_u" in P:
        u = P["g_u"][:, None]
        v = P["g_v"][:, None]
        w = P["g_w"][:, None]
        s = sram[None, :]
        psi1 = torch.ceil(u / s) * v + u
        psi2 = torch.ceil(v / s) * u + v
        per = torch.minimum(psi1, psi2) + w
        per = torch.where((u == 0) | (v == 0), u + v + w, per)
        contrib = P["g_b"][:, None] * per
        traffic = traffic + P["seg"] @ contrib
    flops = P["flops"][:, None]
    oi = flops / traffic                        # inf when traffic == 0
    perf = torch.minimum(peak[None, :], oi * mem_bw[None, :])
    delays = flops / perf
    # Pure data movement (zero-FLOP rows): memory-bound transfer.
    mem_t = torch.where(traffic > 0, traffic / mem_bw[None, :], 0.0)
    return torch.where((P["flops"] == 0)[:, None], mem_t, delays)


def _pass_fast(pP: dict, comm_pad, stacked):
    """Closed-form timeline for a scope-disjoint pass, whole batch at once.

    With no non-blocking transfer pending when a blocking event fires
    (the ``mixed`` pre-check), every blocking event starts exactly at the
    compute clock — its exposure *is* its duration, one static-count
    matrix product. Each scope's non-blocking stream unrolls
    ``tn = max(tc, tn) + dur`` into a max over per-event residual
    margins (``R @ [delays; comm_pad]``, rows pruned to run endpoints),
    since only the final stream time past the final compute clock feeds
    the exposed residue. Returns ``(exposed (3, nenv), residual margin
    (nenv) or None)``."""
    exp = pP["exp_cnt"] @ comm_pad                       # (3, nenv)
    resid = None
    for s in sorted(pP["nb"]):
        m = torch.amax(pP["nb"][s] @ stacked, dim=0)     # (nenv,)
        resid = m if resid is None else torch.maximum(resid, m)
    return exp, resid


def _padded(comm):
    return torch.cat([comm, torch.zeros((1, comm.shape[1]), dtype=F64,
                                        device=comm.device)], dim=0)


def _stage_fn_fast(P: dict, sram, peak, mem_bw, comm):
    """The stage kernel, closed form: flat arrays in, (compute, exposed)
    out, every step a whole-batch matrix product or reduction."""
    delays = _delays(P, sram, peak, mem_bw)              # (ncls, nenv)
    compute = P["counts"] @ delays                        # (3, nenv)
    comm_pad = _padded(comm)
    stacked = torch.cat([delays, comm_pad], dim=0)
    exp_f, _ = _pass_fast(P["fwd"], comm_pad, stacked)
    exp_b, resid_b = _pass_fast(P["bwd"], comm_pad, stacked)
    exposed = exp_f + exp_b
    if resid_b is not None:
        # Non-blocking residue past the end of backward compute.
        resid = torch.clamp(resid_b, min=0.0)
        exposed = torch.stack([exposed[0], exposed[1], exposed[2] + resid])
    return compute, exposed


def _scan_pass(pP: dict, deltas, durs, exposed: list):
    """One timeline pass for the whole batch: the event walk, one step an
    event over ``(nenv,)`` rows. ``exposed`` is the list of the three
    phases' rows; returns the final compute clock and scope streams."""
    nenv = deltas.shape[1]
    tc = torch.zeros(nenv, dtype=F64, device=deltas.device)
    tn = [tc] * _SCOPE_COUNT
    for i, (blk, sc, ph) in enumerate(zip(pP["block"].tolist(),
                                          pP["scope"].tolist(),
                                          pP["phase"].tolist())):
        tc = tc + deltas[i]
        end = torch.maximum(tc, tn[sc]) + durs[i]
        if blk:
            exposed[ph] = exposed[ph] + (end - tc)
            tc = end
        tn[sc] = end
    return tc, tn


def _stage_fn_scan(P: dict, sram, peak, mem_bw, comm):
    """The general stage kernel: the event walk over the environment batch.
    Needed only when a pass interleaves non-blocking and blocking events on
    one scope; it prices any stage."""
    delays = _delays(P, sram, peak, mem_bw)              # (ncls, nenv)
    compute = P["counts"] @ delays                        # (3, nenv)
    comm_pad = _padded(comm)
    exposed = [torch.zeros(delays.shape[1], dtype=F64, device=delays.device)
               for _ in range(3)]
    for name in ("fwd", "bwd"):
        pP = P[name]
        deltas = pP["dcounts"] @ delays                   # (nev+1, nenv)
        durs = comm_pad[torch.as_tensor(pP["comm"], device=comm.device)]
        tc, tn = _scan_pass(pP, deltas, durs, exposed)
    # Non-blocking residue past the end of backward compute.
    resid = torch.clamp(torch.amax(torch.stack(tn), dim=0) - tc, min=0.0)
    exposed[2] = exposed[2] + resid
    return compute, torch.stack(exposed)


def stage_compute_exposed(stage, envs, nodes, mem_bw, mp: int, dp: int,
                          pp: int, ep: int, placement, device=None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """One stage's ``(compute, exposed)``, each a numpy ``(3, nenv)``
    array: the collectives priced on the host (:func:`comm_matrix`), then
    the roofline and the timeline in one float64 device call over every
    environment. ``device`` is the caller's, else the GPU
    (:func:`repro_torch.resolve_device`)."""
    dev = resolve_device(device)
    comm = comm_matrix(stage, envs, mp, dp, pp, ep, placement)
    sram = np.array([max(int(n.sram_bytes), 1) for n in nodes], dtype=float)
    peak = np.array([n.peak_flops for n in nodes], dtype=float)
    T, fast = _device_prep(stage, dev)
    fn = _stage_fn_fast if fast else _stage_fn_scan
    compute, exposed = fn(
        T, torch.as_tensor(sram, dtype=F64, device=dev),
        torch.as_tensor(peak, dtype=F64, device=dev),
        torch.as_tensor(np.asarray(mem_bw, dtype=float), dtype=F64,
                        device=dev),
        torch.as_tensor(comm, dtype=F64, device=dev))
    return compute.cpu().numpy(), exposed.cpu().numpy()
