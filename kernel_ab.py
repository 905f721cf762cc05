"""Times this tree's flash attention (forward and backward), RMSNorm
(forward and backward), SSD scan (forward and backward) and embedding-bag
backward kernels against another tree's sources on the same inputs, in one
process on one card, in turns (other, this, this, other), so that two
versions are compared within one run. An attention backward without the
``splits`` argument (one block a KV head's whole group) is called without
scratch; an older RMSNorm backward without a launch plan (one ``blocks``
argument) on scratch of its own; an SSD backward without a plan (four
FMA kernels, each head's dB and dC in scratch) on that scratch, allocated
here; a tree without an SSD backward skips its cases. First,
each side's RMSNorm backward row-pass instances: registers, stack and
spill bytes a thread, as ``cuobjdump -res-usage`` reads them.

    git archive <rev> src/repro_torch/kernels/csrc | tar -x -C build/ab_other
    python3 kernel_ab.py build/ab_other/src/repro_torch/kernels/csrc [PATTERN]

PATTERN, a regular expression, keeps only the cases whose names it matches.

Prints one JSON line per case: each side's two device times (CUDA graph
replay over cold copies, as ``chip_smoke.py`` times), its largest error
against the plain version (the SSD scan's: over y and the final state; the
RMSNorm and SSD backwards': over their gradients, each against its largest
magnitude), and whether the two sides' results are equal bit for bit. Needs
one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_backward_cuda,
    embedding_bag_backward_plain,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_backward_cuda,
    flash_attention_backward_plain,
    flash_attention_forward_plain,
    flash_attention_lse_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    rmsnorm_backward_cuda,
    rmsnorm_backward_plain,
    rmsnorm_plain,
)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_scan_backward_cuda,
    ssd_scan_backward_plain,
    ssd_scan_plain,
    ssd_scan_train_cuda,
)

OUT = ROOT / "build" / "kernel_ab"
ORDER = ("other", "this", "this", "other")
PATTERN = None  # the cases to run (a regular expression), or None for all


class _NoSplitsArg:
    """An older attention backward entry point without the scratch pointer
    and the ``splits`` argument."""

    def __init__(self, lib):
        self.lib = lib

    def repro_flash_attention_backward(self, *args):
        args = list(args)
        del args[17]  # splits
        del args[7]   # scratch
        return self.lib.repro_flash_attention_backward(*args)

    def __getattr__(self, name):
        return getattr(self.lib, name)


class _NoPlanArg:
    """An older RMSNorm backward entry point that takes its grid as one
    ``blocks`` argument (ceil(rows / 4) blocks of 4 warps, at most 8 an SM)
    and fp32 scratch of (blocks, d): given here, once for each size."""

    def __init__(self, lib):
        self.lib = lib
        self.scratch = {}

    def repro_rmsnorm_backward(self, x, gamma, dy, dx, dgamma, part, rows, d,
                               eps, team_warps, lane_units, teams, blocks,
                               rows_per_block, stages, dtype, stream):
        old_blocks = max(1, min(-(-rows // 4), 8 * 132))
        if old_blocks * d not in self.scratch:
            self.scratch[old_blocks * d] = torch.empty(
                old_blocks * d, dtype=torch.float32, device="cuda")
        return self.lib.repro_rmsnorm_backward(
            x, gamma, dy, dx, dgamma, self.scratch[old_blocks * d].data_ptr(),
            rows, d, eps, old_blocks, dtype, stream)

    def __getattr__(self, name):
        return getattr(self.lib, name)


class _NoSsdPlan:
    """The SSD backward entry point without a plan: four kernels a call (stages mask
    15), each head's dB and dC in fp32 scratch (b, s, h, n), a (b, h, nc)
    dA_part, no ``dcs``, partials or ``splits``. The scratch is allocated
    here, once for each size."""

    def __init__(self, lib):
        self.lib = lib
        self.scratch = {}

    def repro_ssd_scan_backward(self, *args):
        a = list(args)
        b, s, h, n = a[20], a[21], a[22], a[25]
        size = b * s * h * n
        if size not in self.scratch:
            self.scratch[size] = torch.empty(2 * size, dtype=torch.float32, device="cuda")
        heads = self.scratch[size]
        mask = 15 if a[44] == 63 else a[44]
        return self.lib.repro_ssd_scan_backward(
            *a[:11], heads.data_ptr(), heads.data_ptr() + 4 * size, a[12], *a[15:27],
            *a[28:44], mask, a[45])

    def __getattr__(self, name):
        return getattr(self.lib, name)


def _load(name: str, bwd_splits: bool, norm_plan: bool, ssd_plan: bool):
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    lib.repro_ssd_scan.argtypes = [ptr] * 10 + [i32] * 7 + [i64] * 15 + [i32, i32, ptr]
    lib.repro_ssd_scan.restype = i32
    lib.repro_rmsnorm.argtypes = [ptr, ptr, ptr, i64, i32, f32, i32, ptr]
    lib.repro_rmsnorm.restype = i32
    lib.repro_rmsnorm_backward.argtypes = (
        [ptr] * 6 + [i64, i32, f32, i32, i32, i32, i32, i64, i32, i32, ptr] if norm_plan else
        [ptr] * 6 + [i64, i32, f32, i32, i32, ptr])
    lib.repro_rmsnorm_backward.restype = i32
    lib.repro_flash_attention.argtypes = ([ptr] * 6 + [i32] * 6 + [i64] * 12
                                          + [f32, i32, i32, i32, ptr])
    lib.repro_flash_attention.restype = i32
    lib.repro_flash_attention_lse.argtypes = ([ptr] * 5 + [i32] * 6 + [i64] * 12
                                              + [f32, i32, i32, ptr])
    lib.repro_flash_attention_lse.restype = i32
    lib.repro_embedding_bag_backward.argtypes = ([ptr] * 11 + [i32] * 5 + [i64] * 5
                                                 + [i32, i32, ptr])
    lib.repro_embedding_bag_backward.restype = i32
    lib.repro_flash_attention_backward.argtypes = (
        [ptr] * 11 + [i32] * 7 + [i64] * 24 + [f32, i32, i32, ptr] if bwd_splits else
        [ptr] * 10 + [i32] * 6 + [i64] * 24 + [f32, i32, i32, ptr])
    lib.repro_flash_attention_backward.restype = i32
    if hasattr(lib, "repro_ssd_scan_backward"):
        lib.repro_ssd_scan_backward.argtypes = (
            [ptr] * 20 + [i32] * 8 + [i64] * 15 + [i32, i32, ptr] if ssd_plan else
            [ptr] * 19 + [i32] * 7 + [i64] * 15 + [i32, i32, ptr])
        lib.repro_ssd_scan_backward.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib = lib if ssd_plan else _NoSsdPlan(lib)
    lib = lib if bwd_splits else _NoSplitsArg(lib)
    return lib if norm_plan else _NoPlanArg(lib)


SOURCES = ("flash_attention.cu", "flash_attention_backward.cu", "rmsnorm.cu", "ssd_scan.cu",
           "ssd_scan_backward.cu", "embedding_bag.cu")


def build(other: Path) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    sides = {"this": _build.CSRC, "other": other}
    nvcc = _build._nvcc()
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(OUT / f"{name}.so"),
                      *(str(src / f) for f in SOURCES if (src / f).exists())]
                     for name, src in sides.items()])
    ssd_bwd = {name: src / "ssd_scan_backward.cu" for name, src in sides.items()}
    return {name: _load(name, "int splits" in (src / "flash_attention_backward.cu").read_text(),
                        "int team_warps" in (src / "rmsnorm.cu").read_text(),
                        not ssd_bwd[name].exists() or "int splits" in ssd_bwd[name].read_text())
            for name, src in sides.items()}


def norm_backward_resources(sides) -> None:
    """One line per side: each RMSNorm backward row-pass instance's
    registers, stack and local (spill) bytes a thread, from ``cuobjdump
    -res-usage`` of the side's library, names demangled by ``cu++filt``."""
    tools = Path(_build._nvcc()).parent
    for side in sides:
        dump = subprocess.run([str(tools / "cuobjdump"), "-res-usage", str(OUT / f"{side}.so")],
                              capture_output=True, text=True, check=True).stdout
        found = re.findall(r"Function (\S*rmsnorm_bwd\S*?):?\s+REG:(\d+) STACK:(\d+) "
                           r"SHARED:\d+ LOCAL:(\d+)", dump)
        names = subprocess.run([str(tools / "cu++filt")], input="\n".join(f[0] for f in found),
                               capture_output=True, text=True, check=True).stdout.split("\n")
        print(json.dumps({"case": "rmsnorm_backward resources", "side": side, "kernels": [
            {"kernel": name.rsplit(">(", 1)[0] + ">", "registers": int(reg), "stack": int(stack),
             "local": int(local)} for name, (_, reg, stack, local) in zip(names, found)]}),
              flush=True)


def _max_err(got, want) -> float:
    if isinstance(want, tuple):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return (got.float() - want.float()).abs().max().item()


def _scaled_err(got, want) -> float:
    """The largest of each result's max |got - want| over its max |want|."""
    return max((g.float() - w.float()).abs().max().item()
               / w.float().abs().max().item() for g, w in zip(got, want))


def _same_bits(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_same_bits(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def ab(libs, name, dtype, fn, plain, sets, err=_max_err, **timing) -> None:
    """``fn`` on both sides; ``timing``: ``chip_smoke.time_ms``'s options.
    ``same_bits``: whether the two sides' first results are equal bit for
    bit."""
    if PATTERN and not re.search(PATTERN, name):
        return
    row = {"case": name, "dtype": cs.dtype_name(dtype), "err": {}}
    want = plain(*sets[0])
    for side in ORDER:
        _build._lib = libs[side]
        got = fn(*sets[0])
        torch.cuda.synchronize()
        row["err"][side] = err(got, want)
        if side == "other" and "same_bits" not in row:
            other_first = got
        elif "same_bits" not in row:
            row["same_bits"] = _same_bits(got, other_first)
            del other_first
        del got
        row.setdefault(side, []).append(cs.time_ms(fn, sets, **timing)["device"])
    print(json.dumps(row), flush=True)


def ssd_case(libs, name, b, s, h, p, n, g, chunk, dtype, gen) -> None:
    """Inputs drawn as ``chip_smoke._ssd_case`` draws them: x, B, C views of
    one conv output."""
    di, gn = h * p, g * n
    xbc = torch.randn((b, s, di + 2 * gn), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device="cuda"))

    def views(t):
        return (t[..., :di].unflatten(-1, (h, p)), t[..., di:di + gn].unflatten(-1, (g, n)),
                t[..., di + gn:].unflatten(-1, (g, n)))
    sets = [views(cs.clone_like(xbc)) for _ in range(cs.copies_for_cold_l2([xbc, dt]))]
    ab(libs, f"ssd_scan {name}", dtype,
       lambda x_, B_, C_: ops.ssd_scan(x_, dt, A, B_, C_, chunk),
       lambda x_, B_, C_: ssd_scan_plain(x_, dt, A, B_, C_, chunk), sets)


def ssd_backward_case(libs, name, b, s, h, p, n, g, chunk, dtype, gen) -> None:
    """The training route's backward, inputs as ``chip_smoke._ssd_backward_case``
    draws them (x, B, C views of one conv output; dy in x's type; no final
    state's cotangent, as the model passes none), on the training forward's
    scratch from this tree's kernels; timed as chip_smoke.py times it (eager,
    10 calls over cold copies)."""
    if not all(hasattr(lib, "repro_ssd_scan_backward") for lib in libs.values()):
        return
    di, gn = h * p, g * n
    xbc = torch.randn((b, s, di + 2 * gn), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device="cuda"))
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)

    def views(t):
        return (t[..., :di].unflatten(-1, (h, p)), t[..., di:di + gn].unflatten(-1, (g, n)),
                t[..., di + gn:].unflatten(-1, (g, n)))
    _build._lib = libs["this"]
    x, B, C = views(xbc)
    saved = ssd_scan_train_cuda(x, dt, A, B, C, chunk)[2:]
    sets = [(*views(cs.clone_like(xbc)), dy.clone())
            for _ in range(cs.copies_for_cold_l2([xbc, dy]))]
    ab(libs, f"ssd_scan_backward {name}", dtype,
       lambda x_, B_, C_, dy_: ssd_scan_backward_cuda(x_, dt, A, B_, C_, dy_, None, *saved,
                                                      chunk),
       lambda x_, B_, C_, dy_: ssd_scan_backward_plain(x_, dt, A, B_, C_, dy_, None, chunk),
       sets, err=_scaled_err, iters=10, graph=False)


def bag_backward_case(libs, name, idx, r, e, dtype, gen) -> None:
    """dout the model's strided view, as ``chip_smoke._bag_case`` draws it;
    timed as chip_smoke.py times the main shapes (eager, 10 calls)."""
    b, t, _ = idx.shape
    dout = torch.randn((b, t + 1, e), generator=gen, device="cuda").to(dtype)[:, 1:]
    ab(libs, f"embedding_bag_backward {name}", dtype,
       lambda d, i: embedding_bag_backward_cuda(d, i, r),
       lambda d, i: embedding_bag_backward_plain(d, i, r), [(dout, idx)],
       iters=10, graph=False)


def norm_case(libs, shape, dtype, gen) -> None:
    d = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    sets = [(x.clone(), g) for _ in range(cs.copies_for_cold_l2([x, x]))]
    ab(libs, f"rmsnorm {list(shape)}", dtype, lambda a, b: ops.rmsnorm(a, b, 1e-5),
       lambda a, b: rmsnorm_plain(a, b, 1e-5), sets)


def norm_backward_case(libs, shape, dtype, gen) -> None:
    """x, gamma, dy as ``chip_smoke._rmsnorm_backward_case`` draws them,
    on the cold copies it times over."""
    d = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    sets = [(x.clone(), g, dy.clone()) for _ in range(cs.copies_for_cold_l2([x, dy, x]))]
    ab(libs, f"rmsnorm_backward {list(shape)}", dtype, rmsnorm_backward_cuda,
       rmsnorm_backward_plain, sets, err=_scaled_err)


def attn_case(libs, name, b, h, hkv, sq, skv, d, causal, dtype, gen,
              kv_len=None, q_offset=None) -> None:
    def draw(s, heads):
        t = torch.randn((b, s, heads, d), generator=gen, device="cuda")
        return t.to(dtype).transpose(1, 2)
    q, k, v = draw(sq, h), draw(skv, hkv), draw(skv, hkv)
    vec = lambda a: (None if a is None else
                     torch.tensor(a, dtype=torch.int32, device="cuda"))
    kl, qo = vec(kv_len), vec(q_offset)
    sets = [(cs.clone_like(q), cs.clone_like(k), cs.clone_like(v))
            for _ in range(cs.copies_for_cold_l2([q, k, v]))]
    ab(libs, name, dtype, lambda a, b_, c: ops.flash_attention(a, b_, c, causal, kl, qo),
       lambda a, b_, c: flash_attention_plain(a, b_, c, causal, kl, qo), sets)


def attn_forward_lse_case(libs, name, b, h, hkv, s, d, dtype, gen) -> None:
    """The training route's forward (the output and the rows' log-sum-exp,
    causal) on cold copies, held to the plain forward."""
    def draw(heads):
        t = torch.randn((b, s, heads, d), generator=gen, device="cuda")
        return t.to(dtype).transpose(1, 2)
    q, k, v = draw(h), draw(hkv), draw(hkv)
    sets = [(cs.clone_like(q), cs.clone_like(k), cs.clone_like(v))
            for _ in range(cs.copies_for_cold_l2([q, k, v]))]
    ab(libs, f"attention_forward_lse {name}", dtype,
       lambda *a: flash_attention_lse_cuda(*a, True),
       lambda *a: flash_attention_forward_plain(*a, True), sets)


def attn_backward_case(libs, name, b, h, hkv, s, d, dtype, gen) -> None:
    """The backward on the training forward's o and lse, inputs as
    ``chip_smoke._attention_backward_case`` draws them (causal); both sides
    timed by CUDA graph replay and held to the plain backward."""
    def draw(heads):
        t = torch.randn((b, s, heads, d), generator=gen, device="cuda")
        return t.to(dtype).transpose(1, 2)
    q, k, v, do = draw(h), draw(hkv), draw(hkv), draw(h)
    out, lse = flash_attention_forward_plain(q, k, v, True)
    ab(libs, f"attention_backward {name}", dtype,
       lambda *a: flash_attention_backward_cuda(*a, True),
       lambda *a: flash_attention_backward_plain(*a, True), [(q, k, v, out, lse, do)],
       iters=20)


def main() -> int:
    global PATTERN
    if len(sys.argv) not in (2, 3):
        raise SystemExit(__doc__)
    PATTERN = sys.argv[2] if len(sys.argv) == 3 else None
    cs.phase_env()
    libs = build(Path(sys.argv[1]).resolve())
    norm_backward_resources(libs)
    # the RMSNorm backward at chip_smoke.py's train_lm rows, few wide rows, a
    # chatglm3/minitron-width training layer and rows of 100 (not whole
    # 16-byte units)
    gen_norm = torch.Generator(device="cuda").manual_seed(6)
    norm_shapes = ((cs.LM_BATCH * cs.LM_SEQ, 576), (2, 64, 4096),
                   (cs.LM_BATCH * cs.LM_SEQ, 4096), (3, 7, 100))
    for dtype in (torch.float32, torch.bfloat16):
        for shape in norm_shapes:
            norm_backward_case(libs, shape, dtype, gen_norm)
            torch.cuda.empty_cache()
    # the training forward with the log-sum-exp at the same two layers
    gen_fwd = torch.Generator(device="cuda").manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        attn_forward_lse_case(libs, "train main", cs.LM_BATCH, 9, 3, cs.LM_SEQ, 64, dtype,
                              gen_fwd)
        attn_forward_lse_case(libs, "chatglm3-like d=128", 1, 32, 2, 1024, 128, dtype, gen_fwd)
        torch.cuda.empty_cache()
    # chip_smoke.py's train_lm layer and its chatglm3-like layer
    gen_bwd = torch.Generator(device="cuda").manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        attn_backward_case(libs, "train main", cs.LM_BATCH, 9, 3, cs.LM_SEQ, 64, dtype, gen_bwd)
        attn_backward_case(libs, "chatglm3-like d=128", 1, 32, 2, 1024, 128, dtype, gen_bwd)
        torch.cuda.empty_cache()
    # chip_smoke.py's cases, positions drawn as there
    gen = torch.Generator(device="cuda").manual_seed(0)
    rs, rs_attn = np.random.RandomState(0), np.random.RandomState(3)
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for shape in ((8, 1, 576), (1, 1024, 576), (3, 37, 576), (2, 64, 4096),
                          (3, 7, 100), (8, 1, 1536), (8, 1, 3072), (1, 1024, 3072)):
                norm_case(libs, shape, dtype, gen)
            attn_case(libs, "decode tick", 8, 9, 3, 1, 2048, 64, True, dtype, gen,
                      q_offset=rs.randint(0, 2048, size=8).tolist())
            for s in (17, 130, 512, 1024, 2048):
                attn_case(libs, f"prefill s={s}", 1, 9, 3, s, s, 64, True, dtype, gen)
            attn_case(libs, "GQA group 2", 2, 4, 2, 256, 256, 64, True, dtype, gen)
            attn_case(libs, "MQA non-causal d=128", 2, 2, 1, 64, 64, 128, False, dtype, gen)
            attn_case(libs, "uneven length 100", 1, 4, 4, 100, 100, 64, True, dtype, gen)
            attn_case(libs, "GQA group 3", 1, 6, 2, 96, 96, 64, True, dtype, gen)
            attn_case(libs, "chunk of 40 rows into a cache, d=128", 2, 4, 2, 40, 200, 128,
                      True, dtype, gen, kv_len=[200, 77], q_offset=[160, 37])
            attn_case(libs, "3 rows non-causal with kv_len, d=128", 2, 8, 2, 3, 300, 128,
                      False, dtype, gen, kv_len=[300, 1])
            attn_case(libs, "decode at the cache's end", 8, 9, 3, 1, 2048, 64, True, dtype,
                      gen, q_offset=[2047] * 8)
            attn_case(libs, "decode, one key a sequence", 8, 9, 3, 1, 2048, 64, True, dtype,
                      gen, q_offset=[0] * 8)
            attn_case(libs, "decode chatglm3 group 16, d=128", 8, 32, 2, 1, 2048, 128, True,
                      dtype, gen, q_offset=rs_attn.randint(0, 2048, size=8).tolist())
            attn_case(libs, "decode 8 rows x group 16, d=128", 2, 32, 2, 8, 300, 128, True,
                      dtype, gen, q_offset=[100, 292])
        # zamba2's shared block at head_dim 160: serving's prefill and decode
        # tick, and the training forward with the log-sum-exp at train_zamba's
        # layer, from a stream of their own
        gen_160 = torch.Generator(device="cuda").manual_seed(8)
        rs_160 = np.random.RandomState(8)
        for dtype in (torch.float32, torch.bfloat16):
            attn_case(libs, "zamba2 prefill s=1024, d=160", 1, 32, 32, 1024, 1024, 160, True,
                      dtype, gen_160)
            attn_case(libs, "zamba2 decode tick, d=160", 8, 32, 32, 1, 2048, 160, True, dtype,
                      gen_160, q_offset=rs_160.randint(0, 2048, size=8).tolist())
            attn_forward_lse_case(libs, "zamba2 train d=160", cs.ZAMBA_BATCH, 32, 32,
                                  cs.ZAMBA_SEQ, 160, dtype, gen_160)
            torch.cuda.empty_cache()
        # chip_smoke.py's SSD cases, from their own stream
        gen_mamba = torch.Generator(device="cuda").manual_seed(1)
        for dtype in (torch.float32, torch.bfloat16):
            ssd_case(libs, "main prefill", 1, 1024, 48, 64, 128, 1, 256, dtype, gen_mamba)
            for s in (700, 17):
                ssd_case(libs, f"prefill s={s}", 1, s, 48, 64, 128, 1, 256, dtype, gen_mamba)
            for b, h, s, p, n, chunk in ((2, 3, 128, 16, 32, 32), (1, 2, 100, 8, 16, 32),
                                         (2, 4, 64, 32, 64, 64), (1, 1, 256, 64, 128, 128)):
                ssd_case(libs, f"table b{b} h{h} s{s} p{p} n{n} chunk{chunk}", b, s, h, p, n,
                         1, chunk, dtype, gen_mamba)
            ssd_case(libs, "grouped h4 g2", 2, 45, 4, 16, 16, 2, 32, dtype, gen_mamba)
        # the SSD scan backward at chip_smoke.py's train_mamba layer and at
        # zamba2-2.7b's, from a stream of its own
        gen_ssd_bwd = torch.Generator(device="cuda").manual_seed(7)
        mamba = cs.get_config(cs.MAMBA_ARCH)
        for dtype in (torch.float32, torch.bfloat16):
            ssd_backward_case(libs, "train main", cs.MAMBA_BATCH, cs.MAMBA_SEQ,
                              mamba.ssm_heads, mamba.ssm.head_dim, mamba.ssm.state_dim,
                              mamba.ssm.ngroups, mamba.ssm.chunk_size, dtype, gen_ssd_bwd)
            ssd_backward_case(libs, "zamba2 layer", 1, 1024, 80, 64, 64, 1, 256, dtype,
                              gen_ssd_bwd)
            torch.cuda.empty_cache()
        # the embedding-bag backward at the DLRM step's shape, uniform (a
        # duplicate row in every bag) and Zipf-skewed indices
        gen_bag = torch.Generator(device="cuda").manual_seed(2)
        cfg = cs._dlrm_setup()[0]
        shape = (cs.DLRM_BATCH, cfg.num_tables, cfg.lookups_per_table)
        r = cfg.rows_per_table
        uniform = torch.randint(0, r, shape, generator=gen_bag, device="cuda",
                                dtype=torch.int32)
        uniform[..., 1] = uniform[..., 0]
        zipf = cs._zipf_indices(gen_bag, *shape, r)
        for dtype in (torch.float32, torch.bfloat16):
            for name, idx in (("main", uniform), ("zipf", zipf)):
                bag_backward_case(libs, name, idx, r, cfg.emb_dim, dtype, gen_bag)
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
