#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA package on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Needs one CUDA device, nvcc and no arguments. Imports nothing of JAX and
nothing of the JAX package. Phases, one JSON line each; any failure ends the
run with a non-zero exit code (nothing drops to the CPU or to a plain version):

  env      versions, the card's name and power limit
  build    nvcc over src/repro_torch/kernels/csrc/*.cu, loaded with ctypes
  kernels  each hand-written kernel against its plain PyTorch version on the
           card, fp32 and bf16, with times (on the card, from a CUDA graph's
           replay; and issued eagerly, host included), the card's bound and a
           library call's time as a yardstick; the embedding-bag backward
           also per stage, and at its two main shapes (uniform and Zipf
           indices) three calls that must agree bitwise
  serve    smollm-135m at full width and depth, bf16, random weights from a
           seed: the continuous-batching engine answers 16 requests; launch
           counters show that the run went through the kernels; then the
           kernel path against the plain path in fp32 on the same weights
  profile  a few decode ticks under torch.profiler: the device's busy share
  serve_mamba, profile_mamba
           the same for mamba2-780m at full width and depth (prefill through
           the SSD scan's stage kernels, every norm through the RMSNorm
           kernel); profile_mamba also traces one 1024-token prefill and
           reports the scan's share of its device time
  train_dlrm
           dlrm-1.2t at every published width, tables cut to 200,000 rows,
           fp32, weights from a seed: 20 training steps (loss -> backward ->
           AdamW) on batches of 4096 from the port's data pipeline, through
           the embedding-bag forward and backward kernels once each a step;
           then two steps under torch.profiler
  train_dlrm_check
           one step of the kernel path against the plain path, fp32, on the
           same weights and batch: loss, logits, gradients, updated weights

The last three lines are the card as nvidia-smi names it, one JSON object
describing every kernel, and the verdict.

fp32 comparisons run with TF32 switched off
(``torch.backends.cuda.matmul.allow_tf32 = False``, and for cuDNN too), so the
plain version's products are full fp32 like the kernels'.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, get_dlrm_config  # noqa: E402
from repro_torch.data import DataConfig, DataIterator, dlrm_batch  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    BACKWARD_STAGES,
    EmbeddingBagPlain,
    backward_kernels_per_call,
    embedding_bag_backward_buffers,
    embedding_bag_backward_cuda,
    embedding_bag_backward_plain,
    embedding_bag_backward_stages_cuda,
    embedding_bag_cuda,
    embedding_bag_plain,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    DECODE_CLUSTERS,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.rmsnorm import rmsnorm_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    KERNELS_PER_CALL,
    STAGES,
    ssd_buffers,
    ssd_scan_plain,
    ssd_stages_cuda,
)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.dlrm import DLRM  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    AdamWConfig,
    apply_updates,
    init_state,
)

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,   # tensor cores
              torch.float32: 67e12}     # fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LOGIT_TOL = 2e-3    # fp32 logits, kernel path against plain path
# SSD scan: max |kernel - plain| over y and over the final state, each against
# its own scale max(1, max |plain|). fp32: both sum the same terms in another
# order; the decays exp(cs_i - cs_j) carry the rounding of cumsums that reach
# |cs| ~ Q * |dt * A|, i.e. ~1e-5 of the output's scale. bf16: y is rounded
# to bf16 once on each side, one ulp is up to 2^-7 of |y|.
SSD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_NO_LIBRARY = "no single PyTorch call computes the SSD scan"

# DLRM training: dlrm-1.2t at every published width, the tables cut from
# 146,484,375 rows to 200,000 (6.55 GB of fp32 tables; the whole model's 1.2e12
# parameters fit no card); global batch 4096; launch/train.py's learning rate.
DLRM_ROWS = 200_000
DLRM_BATCH = 4096
DLRM_STEPS = 20
DLRM_OPT = dict(lr=3e-3, warmup_steps=2, total_steps=20, use_master=False)
DLRM_SAMPLE_BAGS = 64   # bags whose table rows the kernel-vs-plain step reads
ZIPF_ALPHA = 1.05       # the skewed bag case: row k of a table drawn ~ k^-1.05
BAG_REPEATS = 3         # backward calls at a main shape that must agree bitwise

DEVICE = "cuda"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


# ------------------------------------------------------------------------- #
# Timing
# ------------------------------------------------------------------------- #

def time_ms(fn, arg_sets, iters: int = 50, graph: bool = True) -> dict:
    """Milliseconds of one ``fn(*args)``, mean of ``iters`` launches that
    rotate through ``arg_sets``, taken twice by CUDA events:

    ``device``: the launches captured into one CUDA graph and replayed, so
    the host's launch rate does not cap the reading: the time on the card;
    ``eager``: the same launches issued one by one from Python, as the main
    path issues them: at small shapes this is the host's time per call.

    ``graph=False`` for calls of several milliseconds whose temporaries are
    gigabytes (a capture would keep every launch's): there the host's time
    per call is a small part of the eager reading, which stands for both."""
    def run():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])

    def timed(launch) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        launch()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    for args in arg_sets[:2]:
        fn(*args)
    eager = timed(run)
    if not graph:
        return {"device": eager, "eager": eager}
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        run()
    cuda_graph.replay()
    return {"device": timed(cuda_graph.replay), "eager": eager}


def copies_for_cold_l2(tensors) -> int:
    """How many copies of a case's inputs a timing loop rotates through.

    An input set of 4 MB or more (the decode cache of one layer, a long
    prompt's activations) is found cold by its real caller, because 30 layers
    of it pass through the 50 MB L2 in between: such a case rotates over
    copies that together exceed twice the L2. A smaller one was written by
    the previous operation and is timed warm, as the main path finds it."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    if nbytes < 4 * 2 ** 20:
        return 1
    return min(32, math.ceil(2 * L2_BYTES / nbytes))


def clone_like(t: torch.Tensor) -> torch.Tensor:
    """A copy with the same strides (``clone`` would make views contiguous)."""
    out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                              device=t.device)
    out.copy_(t)
    return out


# ------------------------------------------------------------------------- #
# Phases
# ------------------------------------------------------------------------- #

def phase_env() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs one CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = {"python": sys.version.split()[0], "torch": torch.__version__,
           "cuda": torch.version.cuda, "card": smi.splitlines()[0],
           "device_count": torch.cuda.device_count(),
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit("env", **env)
    return env


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         library=str(path.relative_to(ROOT)),
         sources=sorted(p.name for p in _build.CSRC.glob("*.cu")))


def _rmsnorm_case(shape, dtype, gen, ulp_tol=False) -> dict:
    """``ulp_tol``: in bf16, allow one bf16 ulp of the largest output. Kernel
    and plain version round once from fp32 values a few fp32 ulps apart, so
    they may land one bf16 ulp apart, 2^-7 of |y|: above the absolute 1e-2
    wherever |y| >= 2, which a large random input reaches."""
    d = shape[-1]
    x = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    gamma = (1.0 + 0.1 * torch.randn(d, generator=gen, device=DEVICE)).to(dtype)
    got = ops.rmsnorm(x, gamma, 1e-5)
    torch.cuda.synchronize()
    want = rmsnorm_plain(x, gamma, 1e-5)
    err = (got.float() - want.float()).abs().max().item()
    tol = NORM_TOL[dtype]
    if ulp_tol and dtype == torch.bfloat16:
        tol = max(tol, 2 ** -7 * want.float().abs().max().item())
    sets = [(x.clone(), gamma) for _ in range(copies_for_cold_l2([x, x]))]
    rows = x.numel() // d
    nbytes = (2 * rows * d + d) * x.element_size()
    flops = 4 * rows * d
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    kernel = time_ms(lambda a, g: ops.rmsnorm(a, g, 1e-5), sets)
    return {
        "kernel": "rmsnorm", "shape": list(shape), "dtype": dtype_name(dtype),
        "max_abs_err": err, "tol": tol,
        "kernel_ms": kernel["device"], "kernel_eager_ms": kernel["eager"],
        "plain_ms": time_ms(lambda a, g: rmsnorm_plain(a, g, 1e-5),
                            sets)["device"],
        "library_ms": time_ms(lambda a, g: F.rms_norm(a, (d,), g, 1e-5),
                              sets)["device"],
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "cold_copies": len(sets),
    }


def _sdpa(q, k, v, causal, mask):
    """The library yardstick: one call of PyTorch's fused attention on the
    same inputs (a boolean mask stands for kv_len / q_offset)."""
    if mask is not None:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def _attention_case(name, b, h, hkv, sq, skv, d, causal, dtype, gen,
                    kv_len=None, q_offset=None, clusters=False) -> dict:
    """Inputs in the model's layout, (b, s, heads, d), handed over as
    transposed views like the model's activations and cache. ``clusters``:
    also time the decode kernel at each cluster size it takes."""
    def draw(s, heads):
        t = torch.randn((b, s, heads, d), generator=gen, device=DEVICE)
        return t.to(dtype).transpose(1, 2)
    q, k, v = draw(sq, h), draw(skv, hkv), draw(skv, hkv)
    to_dev = lambda a: (None if a is None else
                        torch.tensor(a, dtype=torch.int32, device=DEVICE))
    kv_len_t, q_off_t = to_dev(kv_len), to_dev(q_offset)

    got = ops.flash_attention(q, k, v, causal, kv_len_t, q_off_t)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal, kv_len_t, q_off_t)
    err = (got.float() - want.float()).abs().max().item()

    # What this call's data needs: the (query, key) pairs the masks allow,
    # and the K/V rows at least one query may see.
    kpos = np.arange(skv)[None, None, :]
    lens = np.full(b, skv) if kv_len is None else np.minimum(kv_len, skv)
    allowed = kpos < lens[:, None, None]
    if causal:
        offs = np.zeros(b, int) if q_offset is None else np.asarray(q_offset)
        qpos = np.arange(sq)[None, :, None] + offs[:, None, None]
        allowed = allowed & (kpos <= qpos)
    allowed = np.broadcast_to(allowed, (b, sq, skv))
    pairs = int(allowed.sum())
    kv_rows = int(allowed.any(axis=1).sum())
    item = q.element_size()
    nbytes = (2 * b * h * sq * d + 2 * kv_rows * hkv * d) * item
    flops = 4 * pairs * h * d
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[dtype] * 1e3

    mask = None
    if kv_len is not None or q_offset is not None:
        mask = torch.from_numpy(allowed.copy()).to(DEVICE)[:, None]
    n = copies_for_cold_l2([q, k, v])
    sets = [(clone_like(q), clone_like(k), clone_like(v)) for _ in range(n)]
    kernel = time_ms(lambda a, b_, c: ops.flash_attention(
        a, b_, c, causal, kv_len_t, q_off_t), sets)
    case = {
        "kernel": "flash_attention", "case": name,
        "shape": {"b": b, "h": h, "hkv": hkv, "sq": sq, "skv": skv, "d": d,
                  "causal": causal, "kv_len": kv_len is not None,
                  "q_offset": q_offset is not None},
        "dtype": dtype_name(dtype), "max_abs_err": err, "tol": ATTN_TOL[dtype],
        "kernel_ms": kernel["device"], "kernel_eager_ms": kernel["eager"],
        "plain_ms": time_ms(lambda a, b_, c: flash_attention_plain(
            a, b_, c, causal, kv_len_t, q_off_t), sets)["device"],
        "library_ms": time_ms(lambda a, b_, c: _sdpa(a, b_, c, causal, mask),
                              sets)["device"],
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "cold_copies": n,
    }
    if clusters:
        # The cluster size is the decode kernel's one occupancy knob: time
        # each choice.
        case["cluster_ms"] = {
            str(c): time_ms(lambda a, b_, v_, c=c: flash_attention_cuda(
                a, b_, v_, causal, kv_len_t, q_off_t, decode_cluster=c),
                sets)["device"]
            for c in DECODE_CLUSTERS}
    return case


def _ssd_case(name, b, s, h, p, n, g, chunk, dtype, gen,
              stages=False) -> dict:
    """Inputs in the model's layout: x, B and C are views of one conv output
    (b, s, h*p + 2*g*n), as ``mamba_layer`` hands them over; dt is
    softplus-ed, A negative, as the reference tests draw them."""
    di, gn = h * p, g * n
    xbc = torch.randn((b, s, di + 2 * gn), generator=gen,
                      device=DEVICE).to(dtype)
    x = xbc[..., :di].unflatten(-1, (h, p))
    B = xbc[..., di:di + gn].unflatten(-1, (g, n))
    C = xbc[..., di + gn:].unflatten(-1, (g, n))
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=DEVICE))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=DEVICE))
    y, state = ops.ssd_scan(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    want_y, want_state = ssd_scan_plain(x, dt, A, B, C, chunk)
    err_y = (y.float() - want_y.float()).abs().max().item()
    err_state = (state - want_state).abs().max().item()
    scale_y = max(1.0, want_y.float().abs().max().item())
    scale_state = max(1.0, want_state.abs().max().item())
    rel = SSD_REL_TOL[dtype]

    # What this call's data needs: every chunk as long as it is.
    q = min(chunk, s)
    lens = [min(q, s - t0) for t0 in range(0, s, q)]
    flops = sum(b * g * L * (L + 1) * n                       # C B^T, j <= i
                + b * h * (L * (L + 1) * p + 4 * L * p * n)   # G x, C S^T, S
                for L in lens)
    item = x.element_size()
    nbytes = ((2 * b * s * h * p + 2 * b * s * g * n) * item
              + 4 * (b * s * h + h + b * h * p * n))
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[dtype] * 1e3

    def views():
        t = clone_like(xbc)
        return (t[..., :di].unflatten(-1, (h, p)),
                t[..., di:di + gn].unflatten(-1, (g, n)),
                t[..., di + gn:].unflatten(-1, (g, n)))
    sets = [views() for _ in range(copies_for_cold_l2([xbc, dt]))]
    iters = 20
    kernel = time_ms(lambda x_, B_, C_: ops.ssd_scan(x_, dt, A, B_, C_, chunk),
                     sets, iters)
    case = {
        "kernel": "ssd_scan", "case": name,
        "shape": {"b": b, "s": s, "h": h, "p": p, "n": n, "g": g,
                  "chunk": chunk},
        "dtype": dtype_name(dtype),
        "max_abs_err": max(err_y, err_state), "tol": rel * scale_y,
        "max_abs_err_y": err_y, "max_abs_err_state": err_state,
        "rel_tol": rel, "scale_y": scale_y, "scale_state": scale_state,
        "ok": err_y <= rel * scale_y and err_state <= rel * scale_state,
        "kernel_ms": kernel["device"], "kernel_eager_ms": kernel["eager"],
        "plain_ms": time_ms(lambda x_, B_, C_: ssd_scan_plain(
            x_, dt, A, B_, C_, chunk), sets, iters)["device"],
        "library_ms": None, "library_note": SSD_NO_LIBRARY,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "flops": flops, "bytes": nbytes, "cold_copies": len(sets),
        "kernels_per_call": KERNELS_PER_CALL,
    }
    if stages:
        # Each stage kernel's device time alone, on the scratch of one whole
        # call (a stage reads what the stages before it wrote).
        bufs = ssd_buffers(x, B, chunk)
        ssd_stages_cuda(x, dt, A, B, C, chunk, bufs)
        case["stage_ms"] = {
            stage: time_ms(lambda x_, B_, C_, stage=stage: ssd_stages_cuda(
                x_, dt, A, B_, C_, chunk, bufs, (stage,)), sets,
                iters)["device"]
            for stage in STAGES}
    return case


def _bag_tol(want: torch.Tensor, dtype) -> float:
    """Embedding bag, kernel against plain, both directions. fp32: the two
    sum the same terms in another order, up to a few hundred terms a value
    at uniform indices: 1e-5 of the output's scale. The backward's plain
    version is summed in fp64 here (in the kernels phase), because at Zipf
    indices a hot row sums ~13 k terms of either sign, and an fp32 sum of
    that many in index_add_'s order is itself off by up to ~1e-5 of the
    scale; the kernel sums pieces of 128 first and stays well inside. bf16:
    both round once from fp32 values a few fp32 ulps apart, so they may
    land one bf16 ulp apart, 2^-7 of |out|."""
    scale = max(1.0, want.float().abs().max().item())
    return (1e-5 if dtype == torch.float32 else 2 ** -7) * scale


def _bag_err(got: torch.Tensor, want: torch.Tensor, dtype):
    """(max |got - want|, the tolerance), both as floats."""
    err = (got.float() - want.float()).abs().max().item()
    return err, _bag_tol(want, dtype)


def _library_bag(tables, idx):
    """The yardstick's inputs: ``F.embedding_bag`` over the flattened
    (T * R, E) table with each table's indices shifted by t * R, one bag a
    row; None where an index lies outside [0, R) (the library call has no
    wrap, clamp or drop)."""
    t, r, e = tables.shape
    if int(idx.min()) < 0 or int(idx.max()) >= r:
        return None
    shift = r * torch.arange(t, device=idx.device, dtype=torch.int64)
    flat = (idx.long() + shift[None, :, None]).reshape(-1, idx.shape[2])
    return tables.view(t * r, e), flat


def _bag_case(name, tables, idx, direction, big, gen) -> dict:
    """One embedding-bag case, forward or backward, on the inputs given.
    ``big``: the main shape, timed eagerly over 10 calls (each is
    milliseconds, the plain versions' temporaries gigabytes)."""
    t, r, e = tables.shape
    b, _, n = idx.shape
    dtype, item = tables.dtype, tables.element_size()
    wrapped = torch.where(idx < 0, idx.long() + r, idx.long())
    shift = r * torch.arange(t, device=idx.device)[None, :, None]
    timing = dict(iters=10, graph=False) if big else {}
    timed = "eager, 10 calls" if big else "graph replay of 50 calls"
    library = _library_bag(tables, idx)
    extra = {}
    lookups = b * t * n
    idx_bytes = lookups * 4
    if direction == "forward":
        rows = (wrapped.clamp(0, r - 1) + shift).flatten()
        distinct = int(torch.unique(rows).numel())
        got = ops.embedding_bag(tables, idx)
        torch.cuda.synchronize()
        err, tol = _bag_err(got, embedding_bag_plain(tables, idx), dtype)
        del got
        # what this call's data needs: each distinct row read once, the
        # indices, the output written once
        nbytes = distinct * e * item + idx_bytes + b * t * e * item
        all_bytes = lookups * e * item + idx_bytes + b * t * e * item
        flops = lookups * e
        sets = [(tables, idx)]
        kernel = time_ms(embedding_bag_cuda, sets, **timing)
        plain_ms = time_ms(embedding_bag_plain, sets, **timing)["device"]
        library_ms = None
        if library is not None:
            # eager: the library call is not known to be capturable
            weight, flat = library
            timed = f"{timed}; library: eager"
            library_ms = time_ms(lambda w, f: F.embedding_bag(
                f, w, mode="sum"), [(weight, flat)],
                iters=timing.get("iters", 50), graph=False)["device"]
    else:
        dout = torch.randn((b, t + 1, e), generator=gen,
                           device=DEVICE).to(dtype)[:, 1:]   # the model's view
        valid = (wrapped >= 0) & (wrapped < r)
        distinct = int(torch.unique((wrapped + shift)[valid]).numel())
        got = embedding_bag_backward_cuda(dout, idx, r)
        torch.cuda.synchronize()
        # fp32: the plain version summed in fp64, so that what is compared
        # is the kernel's own rounding (see _bag_tol)
        exact = dout.double() if dtype == torch.float32 else dout
        err, tol = _bag_err(got, embedding_bag_backward_plain(exact, idx, r),
                            dtype)
        if big:   # the same inputs give the same bits, call after call
            extra["bitwise_equal_calls"] = 1 + sum(
                torch.equal(embedding_bag_backward_cuda(dout, idx, r), got)
                for _ in range(BAG_REPEATS - 1))
            extra["ok"] = (err <= tol and
                           extra["bitwise_equal_calls"] == BAG_REPEATS)
        del got
        # dout and the indices read once, the dense dtables written once
        nbytes = b * t * e * item + idx_bytes + t * r * e * item
        all_bytes = nbytes
        flops = int(valid.sum()) * e
        sets = [(dout, idx)]
        kernel = time_ms(lambda d, i: embedding_bag_backward_cuda(d, i, r),
                         sets, **timing)
        extra["kernels_per_call"] = backward_kernels_per_call(b, t, n, r)
        if big:
            # each stage's device time alone, on the scratch of one whole
            # call (a stage reads what the stages before it wrote)
            bufs = embedding_bag_backward_buffers(dout, idx, r)
            embedding_bag_backward_stages_cuda(dout, idx, r, bufs)
            extra["stage_ms"] = {
                stage: time_ms(
                    lambda d, i, stage=stage: embedding_bag_backward_stages_cuda(
                        d, i, r, bufs, (stage,)), sets, **timing)["device"]
                for stage in BACKWARD_STAGES}
            del bufs
        # The plain version's masked select and autograd's backward cannot
        # be captured into a graph: both are timed eagerly.
        eager = dict(iters=timing.get("iters", 50), graph=False)
        timed = f"kernel: {timed}; plain and library: eager"
        plain_ms = time_ms(lambda d, i: embedding_bag_backward_plain(d, i, r),
                           sets, **eager)["device"]
        library_ms = None
        if library is not None:
            weight = library[0].detach().clone().requires_grad_()
            with torch.enable_grad():
                out = F.embedding_bag(library[1], weight, mode="sum")
            dflat = dout.reshape(b * t, e)
            library_ms = time_ms(lambda o, g: torch.autograd.grad(
                o, weight, g, retain_graph=True), [(out, dflat)],
                **eager)["device"]
            del weight, out
        del dout
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return {
        "kernel": ("embedding_bag" if direction == "forward"
                   else "embedding_bag_backward"),
        "case": name, "shape": {"t": t, "r": r, "e": e, "b": b, "l": n},
        "dtype": dtype_name(dtype), "max_abs_err": err, "tol": tol,
        "kernel_ms": kernel["device"], "kernel_eager_ms": kernel["eager"],
        "timed": timed,
        "plain_ms": plain_ms, "library_ms": library_ms,
        **({} if library_ms is not None else {
            "library_note": "an index outside [0, R): F.embedding_bag has no "
                            "wrap, clamp or drop"}),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "bytes": nbytes, "bytes_all_lookups": all_bytes,
        "distinct_rows": distinct, "lookups": lookups, **extra,
    }


def _zipf_indices(gen, b, t, n, r) -> torch.Tensor:
    """(b, t, n) int32: each table's rows drawn with replacement, row k with
    weight (k + 1)^-ZIPF_ALPHA, on the card from ``gen``."""
    weight = torch.arange(1, r + 1, device=DEVICE,
                          dtype=torch.float32) ** -ZIPF_ALPHA
    rows = torch.multinomial(weight.expand(t, r), b * n, replacement=True,
                             generator=gen)
    return rows.view(t, b, n).permute(1, 0, 2).contiguous().int()


def _bag_cases() -> list:
    """Embedding-bag cases, forward and backward, fp32 and bf16: the DLRM
    training step's shape (batch 4096 over 64 tables of 200,000 x 128, 32
    lookups) at uniform indices and at Zipf-skewed ones (the hottest row of
    a table takes ~13 k of its 131 k lookups), the reference tests' table,
    the reduced config's shape, and a case with negative and >= R indices
    (scalar path: rows of 40 bytes). Every uniform backward case has a
    duplicate row in every bag. At the two main shapes the backward also
    runs BAG_REPEATS times on the same inputs, and a result that differs in
    any bit fails the case."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    # the Zipf cases draw from a stream of their own, so the other cases
    # keep the inputs they always had
    gen_zipf = torch.Generator(device=DEVICE).manual_seed(4)
    cfg = _dlrm_setup()[0]
    small = [("table t4 r50 e16 b3 l7", 4, 50, 16, 3, 7),
             ("table t2 r128 e32 b8 l1", 2, 128, 32, 8, 1),
             ("table t8 r16 e8 b2 l16", 8, 16, 8, 2, 16),
             ("reduced config", 4, 1000, 16, 64, 32),
             ("out of range", 3, 10, 10, 5, 9)]
    cases = []
    with torch.no_grad():
        main = torch.randn((cfg.num_tables, cfg.rows_per_table, cfg.emb_dim),
                           generator=gen, device=DEVICE)
        shape = (DLRM_BATCH, cfg.num_tables, cfg.lookups_per_table)
        for dtype in (torch.float32, torch.bfloat16):
            tables = main if dtype == torch.float32 else main.to(dtype)
            idx = torch.randint(0, cfg.rows_per_table, shape, generator=gen,
                                device=DEVICE, dtype=torch.int32)
            cases.append(_bag_case("main", tables, idx, "forward", True, gen))
            idx[..., 1] = idx[..., 0]
            cases.append(_bag_case("main", tables, idx, "backward", True, gen))
            idx = _zipf_indices(gen_zipf, *shape, cfg.rows_per_table)
            cases.append(_bag_case("zipf", tables, idx, "forward", True, gen))
            cases.append(_bag_case("zipf", tables, idx, "backward", True,
                                   gen))
            del tables, idx
            for name, t, r, e, b, n in small:
                tables = torch.randn((t, r, e), generator=gen,
                                     device=DEVICE).to(dtype)
                lo = -2 * r if name == "out of range" else 0
                idx = torch.randint(lo, 2 * r if lo else r, (b, t, n),
                                    generator=gen, device=DEVICE,
                                    dtype=torch.int32)
                cases.append(_bag_case(name, tables, idx, "forward", False,
                                       gen))
                if n > 1:
                    idx[..., 1] = idx[..., 0]
                cases.append(_bag_case(name, tables, idx, "backward", False,
                                       gen))
            torch.cuda.empty_cache()
        del main
    torch.cuda.empty_cache()
    return cases


def phase_kernels() -> list:
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    # mamba2's cases draw from a stream of their own, so the dense cases
    # keep the inputs they always had
    gen_mamba = torch.Generator(device=DEVICE).manual_seed(1)
    # and the cases added with the redesigned attention kernels from a third
    # (their positions too, so the decode tick keeps its positions)
    gen_attn = torch.Generator(device=DEVICE).manual_seed(3)
    rs = np.random.RandomState(0)
    rs_attn = np.random.RandomState(3)
    cases = []
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            # the main path's shapes first, then ragged rows, a wide row and
            # a row that is not a whole number of 16-byte packs
            for shape in ((8, 1, 576), (1, 1024, 576), (3, 37, 576),
                          (2, 64, 4096), (3, 7, 100)):
                cases.append(_rmsnorm_case(shape, dtype, gen))
            decode_pos = rs.randint(0, 2048, size=8).tolist()
            cases.append(_attention_case(
                "decode tick", 8, 9, 3, 1, 2048, 64, True, dtype, gen,
                q_offset=decode_pos, clusters=True))
            for s in (17, 130, 1024, 2048):
                cases.append(_attention_case(
                    f"prefill s={s}", 1, 9, 3, s, s, 64, True, dtype, gen))
            # the reference tests' table, for the head dims the kernel takes
            cases.append(_attention_case(
                "GQA group 2", 2, 4, 2, 256, 256, 64, True, dtype, gen))
            cases.append(_attention_case(
                "MQA non-causal d=128", 2, 2, 1, 64, 64, 128, False, dtype, gen))
            cases.append(_attention_case(
                "uneven length 100", 1, 4, 4, 100, 100, 64, True, dtype, gen))
            cases.append(_attention_case(
                "GQA group 3", 1, 6, 2, 96, 96, 64, True, dtype, gen))
            # sq != skv with both per-sequence arguments, both kernels
            cases.append(_attention_case(
                "chunk of 40 rows into a cache, d=128", 2, 4, 2, 40, 200, 128,
                True, dtype, gen, kv_len=[200, 77], q_offset=[160, 37]))
            cases.append(_attention_case(
                "3 rows non-causal with kv_len, d=128", 2, 8, 2, 3, 300, 128,
                False, dtype, gen, kv_len=[300, 1]))
            # every slot at the cache's end (the idle slots' clamp), a
            # chatglm3-6b tick (group 16, d 128), a mid-length prompt
            cases.append(_attention_case(
                "decode at the cache's end", 8, 9, 3, 1, 2048, 64, True,
                dtype, gen_attn, q_offset=[2047] * 8))
            # one key a sequence: the decode kernel's fixed cost (launch,
            # q, the merges)
            cases.append(_attention_case(
                "decode, one key a sequence", 8, 9, 3, 1, 2048, 64, True,
                dtype, gen_attn, q_offset=[0] * 8))
            cases.append(_attention_case(
                "decode chatglm3 group 16, d=128", 8, 32, 2, 1, 2048, 128,
                True, dtype, gen_attn,
                q_offset=rs_attn.randint(0, 2048, size=8).tolist()))
            cases.append(_attention_case(
                "prefill s=512", 1, 9, 3, 512, 512, 64, True, dtype,
                gen_attn))
            # mamba2-780m's norms: decode tick and prefill, d_model 1536
            # and the gated norm's d_inner 3072
            for shape in ((8, 1, 1536), (8, 1, 3072), (1, 1024, 3072)):
                cases.append(_rmsnorm_case(shape, dtype, gen_mamba,
                                           ulp_tol=True))
            # SSD scan: the main path's prefill, a ragged last chunk, a
            # prompt shorter than a chunk, the reference tests' table (B/C
            # one group each) and a grouped case
            cases.append(_ssd_case("main prefill", 1, 1024, 48, 64, 128, 1,
                                   256, dtype, gen_mamba, stages=True))
            for s in (700, 17):
                cases.append(_ssd_case(f"prefill s={s}", 1, s, 48, 64, 128,
                                       1, 256, dtype, gen_mamba))
            for b, h, s, p, n, chunk in ((2, 3, 128, 16, 32, 32),
                                         (1, 2, 100, 8, 16, 32),
                                         (2, 4, 64, 32, 64, 64),
                                         (1, 1, 256, 64, 128, 128)):
                cases.append(_ssd_case(f"table b{b} h{h} s{s} p{p} n{n} "
                                       f"chunk{chunk}", b, s, h, p, n, 1,
                                       chunk, dtype, gen_mamba))
            cases.append(_ssd_case("grouped h4 g2", 2, 45, 4, 16, 16, 2, 32,
                                   dtype, gen_mamba))
    cases.extend(_bag_cases())
    failed = [c for c in cases
              if not c.get("ok", c["max_abs_err"] <= c["tol"])]
    emit("kernels", cases=cases, failed=len(failed))
    if failed:
        raise SystemExit(f"chip_smoke: {len(failed)} kernel case(s) disagree "
                         f"with the plain version: {failed}")
    # A head dim the kernel does not take must raise, not run something else.
    q = torch.zeros((1, 2, 8, 32), device=DEVICE)
    try:
        ops.flash_attention(q, q, q)
    except ValueError:
        pass
    else:
        raise SystemExit("chip_smoke: head_dim 32 was accepted")
    return cases


class _Timed:
    """Wraps a model method: synchronises around each call and keeps the
    milliseconds, so prefills and decode ticks are counted and timed."""

    def __init__(self, fn):
        self.fn = fn
        self.ms = []

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


PLAIN = {"flash_attention": flash_attention_plain, "rmsnorm": rmsnorm_plain,
         "ssd_scan": ssd_scan_plain}


def _expected_launches(cfg, prefills: int, ticks: int) -> dict:
    """Each kernel's launches on the serve path, by the model's structure:
    two norms a layer and the final norm in every forward; attention in
    every layer of every forward (dense), the scan in every layer of a
    prefill (mamba2: a decode tick is the plain recurrence)."""
    forwards = prefills + ticks
    mamba = cfg.family == "ssm"
    return {"flash_attention": 0 if mamba else cfg.num_layers * forwards,
            "rmsnorm": (2 * cfg.num_layers + 1) * forwards,
            "ssd_scan": cfg.num_layers * prefills if mamba else 0}


def phase_serve(arch: str, phase: str, weight_device: str) -> dict:
    """Full-size ``arch`` in bf16 with random weights drawn on
    ``weight_device`` from seed 0, 16 requests through the engine, launch
    counts checked; then the kernel path against the plain path in fp32 on
    the same weights (one prefill of (2, 300) and one decode tick)."""
    cfg = get_config(arch)
    make = lambda dtype: get_model(cfg)(
        cfg, dtype=dtype, device=DEVICE,
        generator=torch.Generator(device=weight_device).manual_seed(0))
    t0 = time.perf_counter()
    model = make(torch.bfloat16)
    init_seconds = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ecfg = EngineConfig(max_batch=8, max_seq=2048, seed=0)
    engine = Engine(cfg, model, ecfg, dtype=torch.bfloat16)
    prefill_timer = model.prefill = _Timed(model.prefill)
    tick_timer = model.decode_step = _Timed(model.decode_step)

    rs = np.random.RandomState(0)
    n_requests, new_tokens = 16, 32
    requests = []
    for uid in range(n_requests):
        plen = int(rs.randint(64, 1025))
        prompt = rs.randint(0, cfg.vocab_size, size=plen).astype(np.int32)
        requests.append(Request(uid=uid, prompt=prompt,
                                max_new_tokens=new_tokens,
                                temperature=0.8 if uid in (3, 11) else 0.0))

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    # The main path: counters to 0 just before, read just after.
    for name in PLAIN:
        getattr(ops, name).launches = 0
    t0 = time.perf_counter()
    for req in requests:
        engine.submit(req)
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: getattr(ops, name).launches for name in PLAIN}

    prefills, ticks = len(prefill_timer.ms), len(tick_timer.ms)
    tokens = [t for r in done for t in r.out_tokens]
    problems = []
    if len(done) != n_requests or prefills != n_requests:
        problems.append(f"{len(done)} of {n_requests} requests completed, "
                        f"{prefills} prefills")
    if any(len(r.out_tokens) != new_tokens for r in done):
        problems.append("a request did not get its 32 tokens")
    if not all(0 <= t < cfg.padded_vocab for t in tokens):
        problems.append("a token lies outside the padded vocabulary")
    expected = _expected_launches(cfg, prefills, ticks)
    if launches != expected:
        problems.append(f"launches {launches} != {expected}")
    peak_bytes = torch.cuda.max_memory_allocated()
    del model.prefill, model.decode_step      # back to the class's methods

    # The same weights in fp32: kernel path against plain path on the card.
    model32 = make(torch.float32)
    prompts = torch.from_numpy(
        rs.randint(0, cfg.vocab_size, size=(2, 300))).to(DEVICE)
    nxt = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(2, 1))).to(DEVICE)

    def run_both():
        cache = model32.init_cache(2, 512)
        first, cache = model32.prefill(prompts, cache)
        second, cache = model32.decode_step(cache, nxt)
        torch.cuda.synchronize()
        return first.float(), second.float()

    kernel_first, kernel_second = run_both()
    kernel_wrappers = {name: getattr(ops, name) for name in PLAIN}
    for name, plain in PLAIN.items():
        setattr(ops, name, plain)
    try:
        plain_first, plain_second = run_both()
    finally:
        for name, wrapper in kernel_wrappers.items():
            setattr(ops, name, wrapper)
    del model32
    logit_err = {
        "prefill": (kernel_first - plain_first).abs().max().item(),
        "decode": (kernel_second - plain_second).abs().max().item()}
    for name, got in (("prefill", kernel_first), ("decode", kernel_second)):
        if got.shape != (2, 1, cfg.padded_vocab) or not torch.isfinite(got).all():
            problems.append(f"fp32 {name} logits: shape {tuple(got.shape)} or "
                            "values not finite")
        if not logit_err[name] <= LOGIT_TOL:
            problems.append(f"fp32 {name} logits differ from the plain path "
                            f"by {logit_err[name]} > {LOGIT_TOL}")

    result = {
        "arch": cfg.arch_id, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params": n_params, "dtype": "bfloat16", "max_batch": ecfg.max_batch,
        "max_seq": ecfg.max_seq, "requests": len(done), "tokens": len(tokens),
        "prompt_tokens": int(sum(len(r.prompt) for r in requests)),
        "seconds": seconds, "tokens_per_s": len(tokens) / seconds,
        "prefills": prefills, "ticks": ticks,
        "prefill_ms_mean": float(np.mean(prefill_timer.ms)),
        "tick_ms_mean": float(np.mean(tick_timer.ms)),
        "tick_ms_median": float(np.median(tick_timer.ms)),
        "launches": launches, "peak_memory_bytes": peak_bytes,
        "weights_init_seconds": init_seconds,
        "fp32_logit_max_abs_err": logit_err, "fp32_logit_tol": LOGIT_TOL,
        "fp32_logit_max_abs": {"prefill": plain_first.abs().max().item(),
                               "decode": plain_second.abs().max().item()},
        "problems": problems,
    }
    emit(phase, **result)
    if problems:
        raise SystemExit(f"chip_smoke: {phase} phase failed: {problems}")
    result["engine"] = engine
    return result


def _device_time(prof, units: int, unit: str):
    """torch.profiler's device time: the total in µs, the launches, and each
    kernel's launches per ``unit`` and µs per launch, largest share first."""
    device_us, launches, by_name = 0.0, 0, []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us:
            device_us += us
            launches += evt.count
            by_name.append({"name": evt.key[:60],
                            f"launches_per_{unit}": evt.count / units,
                            "device_us_per_launch": us / evt.count})
    by_name.sort(key=lambda e: -e[f"launches_per_{unit}"]
                 * e["device_us_per_launch"])
    return device_us, launches, by_name


def phase_profile(engine: Engine, phase: str) -> None:
    """More decode ticks of the drained engine's model (its slots are idle
    ones: dense positions are clamped to the cache's last row, mamba2 slots
    go on decoding their stale state; the work per tick is the same): first
    timed on the host's clock, then traced by torch.profiler for the kernels'
    time on the device. The busy share is device time over the untraced wall
    time, since tracing itself slows the host."""
    from torch.profiler import ProfilerActivity, profile
    ticks = 8

    def run_ticks():
        for _ in range(ticks):
            logits, _ = engine.model.decode_step(engine.cache,
                                                 engine.last_tokens)
            logits[:, 0].argmax(-1).tolist()
        torch.cuda.synchronize()

    run_ticks()
    t0 = time.perf_counter()
    run_ticks()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_ticks()
    device_us, launches, by_name = _device_time(prof, ticks, "tick")
    arch = engine.cfg.arch_id
    if device_us == 0:
        emit(phase, arch=arch, ticks=ticks, wall_ms_per_tick=wall_ms,
             device_busy_share="not measured",
             reason="torch.profiler reported no device time")
        return
    device_ms = device_us / 1e3 / ticks
    prefill = _traced_prefill(engine) if engine.cfg.family == "ssm" else {}
    emit(phase, arch=arch, ticks=ticks, wall_ms_per_tick=wall_ms,
         device_ms_per_tick=device_ms, device_busy_share=device_ms / wall_ms,
         device_idle_share=1.0 - device_ms / wall_ms,
         device_launches_per_tick=launches / ticks,
         top_device_time=by_name[:12], **prefill)


# The SSD scan's stage kernels as torch.profiler names them (either type).
SSD_KERNEL_NAMES = tuple(f"{stage}_{kind}_kernel" for stage in STAGES
                         if stage != "pass" for kind in ("mma", "f32")
                         ) + ("pass_kernel",)


def _traced_prefill(engine: Engine) -> dict:
    """One 1024-token prefill of one sequence (the longest prompt the serve
    phase draws), timed on the host's clock and then traced: its device ms
    and launches, and the SSD scan's share of them (its stage kernels)."""
    from torch.profiler import ProfilerActivity, profile
    model, tokens = engine.model, torch.from_numpy(
        np.random.RandomState(1).randint(
            0, engine.cfg.vocab_size, size=(1, 1024))).to(DEVICE)

    def run():
        logits, _ = model.prefill(tokens, model.init_cache(1, 1024))
        logits[:, 0].argmax(-1).tolist()
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    device_us, launches, by_name = _device_time(prof, 1, "prefill")
    scan_us, scan_launches = 0.0, 0
    for evt in prof.key_averages():
        if any(k in evt.key for k in SSD_KERNEL_NAMES):
            scan_us += getattr(evt, "self_device_time_total",
                               getattr(evt, "self_cuda_time_total", 0.0))
            scan_launches += evt.count
    if device_us == 0:
        return {"prefill_1024": "not measured: torch.profiler reported no "
                                "device time"}
    return {"prefill_1024": {
        "wall_ms": wall_ms, "device_ms": device_us / 1e3,
        "device_launches": launches, "scan_device_ms": scan_us / 1e3,
        "scan_launches": scan_launches, "scan_share": scan_us / device_us,
        "top_device_time": by_name[:8]}}


# ------------------------------------------------------------------------- #
# DLRM training
# ------------------------------------------------------------------------- #

def _dlrm_setup():
    cfg = dataclasses.replace(get_dlrm_config(), rows_per_table=DLRM_ROWS)
    dcfg = DataConfig(vocab_size=0, seq_len=0, global_batch=DLRM_BATCH,
                      seed=0, num_dense=cfg.num_dense_features,
                      num_tables=cfg.num_tables,
                      lookups=cfg.lookups_per_table, rows=cfg.rows_per_table)
    return cfg, dcfg, AdamWConfig(**DLRM_OPT)


def _dlrm_step(model, params, state, ocfg, batch):
    """The reference's composition: loss -> backward -> apply_updates (in
    place), then the gradients are let go."""
    loss, _ = model.loss(batch)
    loss.backward()
    _, _, metrics = apply_updates(
        params, {n: p.grad for n, p in params.items()}, state, ocfg)
    model.zero_grad(set_to_none=True)
    return loss, metrics


def phase_train_dlrm() -> dict:
    """dlrm-1.2t at full width (rows cut to DLRM_ROWS), fp32 parameters and
    Adam moments, weights from seed 0 drawn on the card, batches from the
    port's DataIterator: DLRM_STEPS steps, each synchronised and timed; then
    two more under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    cfg, dcfg, ocfg = _dlrm_setup()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = DLRM(cfg, seed=0, device=DEVICE)
    params = dict(model.named_parameters())
    state = init_state(params, ocfg)
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    data = DataIterator(dcfg, kind="dlrm", device=DEVICE)

    def step():
        loss, metrics = _dlrm_step(model, params, state, ocfg, next(data))
        return loss.item(), metrics

    losses, step_ms = [], []
    torch.cuda.synchronize()
    # The main path: counters to 0 just before, read just after.
    ops.embedding_bag.launches = 0
    ops.embedding_bag.backward_launches = 0
    t_run = time.perf_counter()
    for _ in range(DLRM_STEPS):
        t1 = time.perf_counter()
        loss, metrics = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss)
    run_seconds = time.perf_counter() - t_run
    launches = {"embedding_bag": ops.embedding_bag.launches,
                "embedding_bag_backward": ops.embedding_bag.backward_launches}
    peak_bytes = torch.cuda.max_memory_allocated()

    profiled = 2
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            step()
        torch.cuda.synchronize()
    device_us, device_launches, by_name = _device_time(prof, profiled, "step")

    problems = []
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"a loss is not finite: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        problems.append(f"the loss did not fall: first 5 {first}, last 5 "
                        f"{last}")
    expected = {name: DLRM_STEPS for name in launches}
    if launches != expected:
        problems.append(f"launches {launches} != {expected} (one forward and "
                        "one backward a step)")
    median_ms = float(np.median(step_ms))
    result = {
        "arch": cfg.arch_id, "rows_per_table": cfg.rows_per_table,
        "rows_cut_from": get_dlrm_config().rows_per_table,
        "widths": {"tables": cfg.num_tables, "emb_dim": cfg.emb_dim,
                   "lookups": cfg.lookups_per_table,
                   "dense": cfg.num_dense_features,
                   "bottom_mlp": cfg.bottom_mlp, "top_mlp": cfg.top_mlp,
                   "top_in": cfg.top_in()},
        "params": sum(p.numel() for p in params.values()),
        "dtype": "float32", "optimizer": DLRM_OPT, "batch": DLRM_BATCH,
        "steps": DLRM_STEPS, "losses": losses,
        "step_ms": step_ms, "step_ms_median": median_ms,
        "step_ms_mean": float(np.mean(step_ms)),
        "samples_per_s": DLRM_STEPS * DLRM_BATCH / run_seconds,
        "samples_per_s_at_median": DLRM_BATCH / median_ms * 1e3,
        "launches": launches,
        "launches_per_step": {k: v / DLRM_STEPS for k, v in launches.items()},
        "peak_memory_bytes": peak_bytes, "init_seconds": init_seconds,
        "grad_norm_last": metrics["grad_norm"].item(),
        "problems": problems,
    }
    if device_us:
        device_ms = device_us / 1e3 / profiled
        result.update(
            device_ms_per_step=device_ms,
            device_idle_share=1.0 - device_ms / median_ms,
            device_launches_per_step=device_launches / profiled,
            top_device_time=by_name[:12])
    else:
        result.update(device_idle_share="not measured",
                      reason="torch.profiler reported no device time")
    emit("train_dlrm", **result)
    if problems:
        raise SystemExit(f"chip_smoke: train_dlrm phase failed: {problems}")
    del model, params, state, data, prof
    torch.cuda.empty_cache()
    return launches


# Kernel path against plain path, one step from the same weights and batch,
# fp32 with TF32 off. Two comparisons:
#
# In the kernel path's step itself, each kernel against its plain version on
# the inputs the step gave it: the bag's output against embedding_bag_plain
# of the same tables and indices, and the whole dtables against
# embedding_bag_backward_plain of the dout the step produced. 1e-5 of the
# output's scale, as in the kernels phase (the same sums in another order).
#
# The two paths end to end. Their forwards differ only in the order of the
# bag's sums (~1e-7 relative), so loss and logits agree within 1e-5 of their
# scale. Their gradients do not agree that closely: a top-MLP pre-activation
# within rounding of 0 takes the other side of its ReLU in one path and moves
# that sample's share of every gradient before it (one sample's share of a
# sum over 4096 samples of either sign is about 1/64 of a typical element,
# and several such flips may meet in one leaf). So the
# gradients (the MLP leaves and the tables rows of 64 sampled bags) agree
# within 3e-2 of each leaf's largest. Adam's first step moves an element by
# lr * g / (|g| + eps), about lr * sign(g): an element whose gradient lies
# within that share of 0 may step the other way (at most 2 * lr). Updated
# parameters: no element moves by more than 2 * lr from the other path's,
# and at most 5 % of a leaf's elements (those whose gradient lies within a
# few such shares of 0) differ by more than 1e-3 * lr.
DLRM_CHECK_TOL = {"kernel_in_step": 1e-5, "loss": 1e-5, "logits": 1e-5,
                  "grads": 3e-2, "params_lr": 1e-3, "params_share": 5e-2}


def _dlrm_one_step(plain: bool) -> dict:
    cfg, dcfg, ocfg = _dlrm_setup()
    model = DLRM(cfg, seed=0, device=DEVICE)
    params = dict(model.named_parameters())
    state = init_state(params, ocfg)
    batch = dlrm_batch(dcfg, 0, device=DEVICE)
    bags = torch.arange(DLRM_SAMPLE_BAGS, device=DEVICE)
    b_s = bags * (DLRM_BATCH // DLRM_SAMPLE_BAGS)
    t_s = bags % cfg.num_tables
    rows = batch["sparse"][b_s, t_s].long()                    # (bags, L)
    kernel_wrapper = ops.embedding_bag
    seen = {}

    def spy(tables, indices):
        """The kernel path, keeping the bag's output and its gradient."""
        out = kernel_wrapper(tables, indices)
        if out.requires_grad:
            seen["out"] = out.detach()
            out.register_hook(lambda g: seen.__setitem__("dout", g))
        return out

    # the wrapper's counters are looked up on ops.embedding_bag
    spy.launches = spy.backward_launches = 0
    ops.embedding_bag = EmbeddingBagPlain.apply if plain else spy
    try:
        with torch.no_grad():
            logits = model(batch["dense"], batch["sparse"])
        loss, _ = model.loss(batch)
        loss.backward()
        out = {"loss": loss.item(), "logits": logits,
               "grads": {n: p.grad.clone() for n, p in params.items()
                         if n != "tables"}}
        out["grads"]["tables[sampled rows]"] = (
            params["tables"].grad[t_s[:, None], rows].clone())
        if not plain:
            with torch.no_grad():
                tables, r = params["tables"], cfg.rows_per_table
                out["kernel_in_step"] = {
                    "embedding_bag": _bag_err(
                        seen["out"], embedding_bag_plain(tables,
                                                         batch["sparse"]),
                        torch.float32),
                    "embedding_bag_backward": _bag_err(
                        tables.grad, embedding_bag_backward_plain(
                            seen["dout"], batch["sparse"], r),
                        torch.float32)}
            seen.clear()
        _, _, metrics = apply_updates(
            params, {n: p.grad for n, p in params.items()}, state, ocfg)
        out["lr"] = metrics["lr"]
        out["grad_norm"] = metrics["grad_norm"].item()
        with torch.no_grad():
            out["params"] = {n: p.detach().clone() for n, p in params.items()
                             if n != "tables"}
            out["params"]["tables[sampled rows]"] = (
                params["tables"][t_s[:, None], rows].clone())
    finally:
        ops.embedding_bag = kernel_wrapper
    del model, params, state
    torch.cuda.empty_cache()
    return out


def phase_train_dlrm_check() -> None:
    """One step of the kernel path, then one of the plain path, each from a
    fresh model drawn from seed 0 and the data's step 0, in sequence."""
    kernel = _dlrm_one_step(plain=False)
    plain = _dlrm_one_step(plain=True)
    tol = DLRM_CHECK_TOL
    problems = []

    def rel_err(got, want):
        scale = want.abs().max().item()
        return (got - want).abs().max().item(), scale

    in_step = {}
    for name, (err, bag_tol) in kernel["kernel_in_step"].items():
        in_step[name] = {"max_abs_err": err, "tol": bag_tol}
        if not err <= bag_tol:
            problems.append(f"{name} in the step: {err} > {bag_tol}")
    loss_err = abs(kernel["loss"] - plain["loss"])
    if not loss_err <= tol["loss"] * max(1.0, abs(plain["loss"])):
        problems.append(f"loss differs by {loss_err}")
    logit_err, logit_scale = rel_err(kernel["logits"], plain["logits"])
    if (kernel["logits"].shape != (DLRM_BATCH,)
            or not torch.isfinite(kernel["logits"]).all()):
        problems.append("logits: wrong shape or not finite")
    if not logit_err <= tol["logits"] * max(1.0, logit_scale):
        problems.append(f"logits differ by {logit_err}")
    grad_err = {}
    for name, want in plain["grads"].items():
        err, scale = rel_err(kernel["grads"][name], want)
        grad_err[name] = {"max_abs_err": err, "max_abs": scale}
        if not err <= tol["grads"] * scale:
            problems.append(f"gradient {name} differs by {err} (scale {scale})")
    lr = kernel["lr"]
    param_err = {}
    for name, want in plain["params"].items():
        diff = (kernel["params"][name] - want).abs()
        over = int((diff > tol["params_lr"] * lr).sum())
        param_err[name] = {"max_abs_err": diff.max().item(),
                           "elements_over": over, "elements": diff.numel()}
        if (over > tol["params_share"] * diff.numel()
                or diff.max().item() > 2 * lr * (1 + 1e-3)):
            problems.append(f"updated {name}: max difference "
                            f"{diff.max().item()}, {over} elements differ by "
                            f"more than {tol['params_lr']} * lr")
    gnorm_err = abs(kernel["grad_norm"] - plain["grad_norm"])
    if not gnorm_err <= 1e-4 * plain["grad_norm"]:
        problems.append(f"grad_norm differs by {gnorm_err}")
    emit("train_dlrm_check", tol=tol, kernel_in_step=in_step,
         loss=plain["loss"], loss_abs_err=loss_err,
         logit_max_abs=logit_scale, logit_max_abs_err=logit_err,
         grad_norm=plain["grad_norm"], grad_norm_abs_err=gnorm_err, lr=lr,
         grads=grad_err, updated_params=param_err,
         sampled_bags=DLRM_SAMPLE_BAGS, problems=problems)
    if problems:
        raise SystemExit(f"chip_smoke: train_dlrm_check failed: {problems}")


# ------------------------------------------------------------------------- #
# The kernels' line
# ------------------------------------------------------------------------- #

KERNELS = (
    # name, source, the TPU kernel it replaces, the main-path case it is timed at
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:79",
     lambda c: c.get("case") == "decode tick" and c["dtype"] == "bfloat16"),
    ("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "src/repro/kernels/rmsnorm.py:24",
     lambda c: c.get("shape") == [8, 1, 576] and c["dtype"] == "bfloat16"),
    ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:80",
     lambda c: c.get("case") == "main prefill" and c["dtype"] == "bfloat16"),
    ("embedding_bag", "src/repro_torch/kernels/csrc/embedding_bag.cu",
     "src/repro/kernels/embedding_bag.py:37",
     lambda c: c.get("case") == "main" and c["dtype"] == "float32"),
    ("embedding_bag_backward", "src/repro_torch/kernels/csrc/embedding_bag.cu",
     "src/repro/kernels/embedding_bag.py:37",
     lambda c: c.get("case") == "main" and c["dtype"] == "float32"),
)


def kernels_line(cases: list, launches_by_path: dict) -> dict:
    """One entry per kernel: its launches on the main paths (each path's
    count, read just after that path; 0 where a path never launches it; and
    their sum), its largest error over every case compared, and its times at
    the shape the main path gives it most often (attention and RMSNorm: one
    decode tick of the bf16 dense serve phase; the SSD scan: the bf16
    1024-token prefill; the embedding bag, both directions: the fp32 DLRM
    training step); attention also carries the bf16 1024-token prefill under
    ``prefill``, the embedding bag the same step at Zipf indices under
    ``zipf``. The other shapes' times are in the ``kernels`` phase's
    line."""
    entries = []
    for name, source, replaces, is_main in KERNELS:
        mine = [c for c in cases if c["kernel"] == name]
        main_case = next(c for c in mine if is_main(c))
        by_path = {path: counts.get(name, 0)
                   for path, counts in launches_by_path.items()}
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": main_case["kernel_ms"],
            "eager_ms": main_case["kernel_eager_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            **({"library_note": main_case["library_note"]}
               if "library_note" in main_case else {}),
            "timed_at": {k: main_case[k] for k in ("case", "shape", "dtype")
                         if k in main_case},
            "cases_compared": len(mine),
        })
        if name in ("ssd_scan", "embedding_bag_backward"):
            entries[-1]["kernels_per_call"] = main_case["kernels_per_call"]
            entries[-1]["stage_ms"] = main_case["stage_ms"]
        if name.startswith("embedding_bag"):
            zipf = next(c for c in mine if c["case"] == "zipf"
                        and c["dtype"] == "float32")
            entries[-1]["zipf"] = {
                k: zipf[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "stage_ms",
                                     "bitwise_equal_calls") if k in zipf}
        if name == "embedding_bag_backward":
            entries[-1]["bitwise_equal_calls"] = main_case[
                "bitwise_equal_calls"]
        if name == "flash_attention":
            prefill = next(c for c in mine if c["case"] == "prefill s=1024"
                           and c["dtype"] == "bfloat16")
            entries[-1]["prefill"] = {
                k: prefill[k] for k in ("case", "kernel_ms", "kernel_eager_ms",
                                        "plain_ms", "library_ms", "bound_ms",
                                        "bound_by")}
    return {"kernels": entries}


def main() -> int:
    env = phase_env()
    phase_build()
    cases = phase_kernels()
    launches = {}
    # The dense path keeps drawing its weights on the CPU, as it always did;
    # mamba2's 781 M are drawn on the card.
    for arch, phase, weight_device in (("smollm-135m", "serve", "cpu"),
                                       ("mamba2-780m", "serve_mamba", DEVICE)):
        serve = phase_serve(arch, phase, weight_device)
        phase_profile(serve["engine"], phase.replace("serve", "profile"))
        launches[phase] = serve["launches"]
        del serve
        torch.cuda.empty_cache()
    launches["train_dlrm"] = phase_train_dlrm()
    phase_train_dlrm_check()
    line = kernels_line(cases, launches)
    for entry in line["kernels"]:
        if entry["launches"] <= 0:
            raise SystemExit(f"chip_smoke: the main path never launched "
                             f"{entry['name']}")
    print(env["card"], flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
