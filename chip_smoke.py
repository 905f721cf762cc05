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
           library call's time as a yardstick
  serve    smollm-135m at full width and depth, bf16, random weights from a
           seed: the continuous-batching engine answers 16 requests; launch
           counters show that the run went through the kernels; then the
           kernel path against the plain path in fp32 on the same weights
  profile  a few decode ticks under torch.profiler: the device's busy share

The last three lines are the card as nvidia-smi names it, one JSON object
describing every kernel, and the verdict.

fp32 comparisons run with TF32 switched off
(``torch.backends.cuda.matmul.allow_tf32 = False``), so the plain version's
products are full fp32 like the kernels'.
"""

from __future__ import annotations

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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_plain  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, Request  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,   # tensor cores
              torch.float32: 67e12}     # fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LOGIT_TOL = 2e-3    # fp32 logits, kernel path against plain path

DEVICE = "cuda"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


# ------------------------------------------------------------------------- #
# Timing
# ------------------------------------------------------------------------- #

def time_ms(fn, arg_sets, iters: int = 50) -> dict:
    """Milliseconds of one ``fn(*args)``, mean of ``iters`` launches that
    rotate through ``arg_sets``, taken twice by CUDA events:

    ``device``: the launches captured into one CUDA graph and replayed, so
    the host's launch rate does not cap the reading: the time on the card;
    ``eager``: the same launches issued one by one from Python, as the main
    path issues them: at small shapes this is the host's time per call."""
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
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    return {"device": timed(graph.replay), "eager": eager}


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


def _rmsnorm_case(shape, dtype, gen) -> dict:
    d = shape[-1]
    x = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    gamma = (1.0 + 0.1 * torch.randn(d, generator=gen, device=DEVICE)).to(dtype)
    got = ops.rmsnorm(x, gamma, 1e-5)
    torch.cuda.synchronize()
    want = rmsnorm_plain(x, gamma, 1e-5)
    err = (got.float() - want.float()).abs().max().item()
    sets = [(x.clone(), gamma) for _ in range(copies_for_cold_l2([x, x]))]
    rows = x.numel() // d
    nbytes = (2 * rows * d + d) * x.element_size()
    flops = 4 * rows * d
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    kernel = time_ms(lambda a, g: ops.rmsnorm(a, g, 1e-5), sets)
    return {
        "kernel": "rmsnorm", "shape": list(shape), "dtype": dtype_name(dtype),
        "max_abs_err": err, "tol": NORM_TOL[dtype],
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
                    kv_len=None, q_offset=None) -> dict:
    """Inputs in the model's layout, (b, s, heads, d), handed over as
    transposed views like the model's activations and cache."""
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
    return {
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


def phase_kernels() -> list:
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rs = np.random.RandomState(0)
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
                q_offset=decode_pos))
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
    failed = [c for c in cases if not c["max_abs_err"] <= c["tol"]]
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


def phase_serve() -> dict:
    cfg = get_config("smollm-135m")
    make = lambda dtype: get_model(cfg)(
        cfg, dtype=dtype, device=DEVICE,
        generator=torch.Generator(device="cpu").manual_seed(0))
    model = make(torch.bfloat16)
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
    ops.flash_attention.launches = 0
    ops.rmsnorm.launches = 0
    t0 = time.perf_counter()
    for req in requests:
        engine.submit(req)
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"flash_attention": ops.flash_attention.launches,
                "rmsnorm": ops.rmsnorm.launches}

    prefills, ticks = len(prefill_timer.ms), len(tick_timer.ms)
    forwards = prefills + ticks
    tokens = [t for r in done for t in r.out_tokens]
    problems = []
    if len(done) != n_requests or prefills != n_requests:
        problems.append(f"{len(done)} of {n_requests} requests completed, "
                        f"{prefills} prefills")
    if any(len(r.out_tokens) != new_tokens for r in done):
        problems.append("a request did not get its 32 tokens")
    if not all(0 <= t < cfg.padded_vocab for t in tokens):
        problems.append("a token lies outside the padded vocabulary")
    if launches["flash_attention"] != cfg.num_layers * forwards:
        problems.append(f"flash_attention launches {launches['flash_attention']}"
                        f" != {cfg.num_layers} x {forwards}")
    if launches["rmsnorm"] != (2 * cfg.num_layers + 1) * forwards:
        problems.append(f"rmsnorm launches {launches['rmsnorm']} != "
                        f"{2 * cfg.num_layers + 1} x {forwards}")
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
    kernel_wrappers = ops.flash_attention, ops.rmsnorm
    ops.flash_attention, ops.rmsnorm = flash_attention_plain, rmsnorm_plain
    try:
        plain_first, plain_second = run_both()
    finally:
        ops.flash_attention, ops.rmsnorm = kernel_wrappers
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
        "fp32_logit_max_abs_err": logit_err, "fp32_logit_tol": LOGIT_TOL,
        "problems": problems,
    }
    emit("serve", **result)
    if problems:
        raise SystemExit(f"chip_smoke: serve phase failed: {problems}")
    result["engine"] = engine
    return result


def phase_profile(engine: Engine) -> None:
    """More decode ticks of the drained engine's model (its slots are idle
    ones with clamped positions; the work per tick is the same): first timed
    on the host's clock, then traced by torch.profiler for the kernels' time
    on the device. The busy share is device time over the untraced wall
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
    device_us, launches, by_name = 0.0, 0, []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us:
            device_us += us
            launches += evt.count
            by_name.append({"name": evt.key[:60],
                            "launches_per_tick": evt.count / ticks,
                            "device_us_per_launch": us / evt.count})
    by_name.sort(key=lambda e: -e["launches_per_tick"]
                 * e["device_us_per_launch"])
    if device_us == 0:
        emit("profile", ticks=ticks, wall_ms_per_tick=wall_ms,
             device_busy_share="not measured",
             reason="torch.profiler reported no device time")
        return
    device_ms = device_us / 1e3 / ticks
    emit("profile", ticks=ticks, wall_ms_per_tick=wall_ms,
         device_ms_per_tick=device_ms, device_busy_share=device_ms / wall_ms,
         device_idle_share=1.0 - device_ms / wall_ms,
         device_launches_per_tick=launches / ticks,
         top_device_time=by_name[:8])


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
)


def kernels_line(cases: list, launches: dict) -> dict:
    """One entry per kernel: its launches on the main path, its largest error
    over every case compared, and its times at the shape the main path gives
    it most often (one decode tick of the bf16 serve phase). The other shapes'
    times are in the ``kernels`` phase's line."""
    entries = []
    for name, source, replaces, is_main in KERNELS:
        mine = [c for c in cases if c["kernel"] == name]
        main_case = next(c for c in mine if is_main(c))
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": main_case["kernel_ms"],
            "eager_ms": main_case["kernel_eager_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "timed_at": {k: main_case[k] for k in ("case", "shape", "dtype")
                         if k in main_case},
            "cases_compared": len(mine),
        })
    return {"kernels": entries}


def main() -> int:
    env = phase_env()
    phase_build()
    cases = phase_kernels()
    serve = phase_serve()
    phase_profile(serve["engine"])
    for entry in kernels_line(cases, serve["launches"])["kernels"]:
        if entry["launches"] <= 0:
            raise SystemExit(f"chip_smoke: the main path never launched "
                             f"{entry['name']}")
    print(env["card"], flush=True)
    print(json.dumps(kernels_line(cases, serve["launches"])), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
