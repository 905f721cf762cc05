"""The attention backward at head_dim 160 (csrc/flash_attention_backward.cu)
on one card: each kernel's registers and spill bytes, and the d 160 tile
against other choices of its rows and stages, at zamba2-2.7b's training
layer (b 2, h 32, hkv 32, s 2048, d 160, causal), fp32 and bf16.

    python3 attn_bwd_variants.py

Variants (copies of this checkout's sources under build/attn_bwd_variants/,
each built by nvcc into a library of its own; (rows, stages) of the streamed
tiles at d 160, the other head dims untouched):

    this        the checkout's constants: fp32 16 rows in one stage
                (105,088 bytes a dK/dV block: two blocks an SM), bf16 32 rows
                in two stages
    f32_32x2    fp32 32 rows, two stages (168,448 bytes: one block an SM)
    f32_16x2    fp32 16 rows, two stages (126,208 bytes: one block an SM)
    bf16_16x2   bf16 16 rows, two stages (three blocks an SM)
    bf16_32x3   bf16 32 rows, three stages
    bf16_64x2   bf16 64 rows, two stages (one block an SM)

Prints one JSON line a variant with every backward kernel's registers and
spill-store bytes as `nvcc -Xptxas -v` reports them (`this`: every head dim;
the others: d 160), then one a variant and type: the call's ms at the
zamba2 layer (CUDA events, mean of 10 calls after 2) and each gradient's
largest error against the plain backward over its largest magnitude, at
the zamba2 layer and at two small cases (ragged causal s 37; GQA h 8 over 2,
not causal, s 130), which chip_smoke.py's BWD_TOL must hold. Needs one CUDA
device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_backward_cuda,
    flash_attention_backward_plain,
    flash_attention_lse_cuda,
)

OUT = ROOT / "build" / "attn_bwd_variants"
SOURCES = ("flash_attention_backward.cu", "rmsnorm.cu")  # rmsnorm: the error string
# name -> {constant: value} of flash_attention_backward.cu
VARIANTS = {"this": {},
            "f32_32x2": {"kF32Rows160": 32, "kF32Stages160": 2},
            "f32_16x2": {"kF32Rows160": 16, "kF32Stages160": 2},
            "bf16_16x2": {"kBf16Rows160": 16, "kBf16Stages160": 2},
            "bf16_32x3": {"kBf16Rows160": 32, "kBf16Stages160": 3},
            "bf16_64x2": {"kBf16Rows160": 64, "kBf16Stages160": 2}}
MAIN = (2, 32, 32, 2048, 160, True)   # b, h, hkv, s, d, causal
SMALL = ((1, 4, 4, 37, 160, True), (2, 8, 2, 130, 160, False))


def make_variants() -> dict:
    """name -> csrc directory, the copies written under OUT."""
    dirs = {"this": _build.CSRC}
    for name, consts in VARIANTS.items():
        if not consts:
            continue
        d = OUT / name / "csrc"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(_build.CSRC, d)
        src = d / "flash_attention_backward.cu"
        text = src.read_text()
        for const, value in consts.items():
            text, k = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", text)
            if k != 1:
                raise SystemExit(f"attn_bwd_variants: no single {const} in {src.name}")
        src.write_text(text)
        dirs[name] = d
    return dirs


def _resources(stderr: str, every_dim: bool) -> list:
    """Registers and spill stores of each backward kernel in ptxas's report."""
    filt = Path(_build._nvcc()).parent / "cu++filt"
    rows, name, spill = [], None, None
    for line in stderr.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            demangled = subprocess.run([str(filt), found.group(1)], capture_output=True,
                                       text=True).stdout
            name = re.search(r"bwd_\w+?_kernel<[^>]*>",
                             demangled.replace("(int)", "")).group(0)
            if not every_dim and not name.endswith(" 160>"):
                name = None
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "registers" in line:
            rows.append({"kernel": name, "registers":
                         int(re.search(r"Used (\d+) registers", line).group(1)),
                         "spill_store_bytes": spill})
            name = None
    return rows


def build(dirs: dict) -> dict:
    """Each variant's library (its objects compiled with `-Xptxas -v`, all
    at once); prints each one's backward kernels' resources."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, d in dirs.items():
        for src in SOURCES:
            obj = OUT / f"{name}_{Path(src).stem}.o"
            flags = ["-Xptxas", "-v"] if src == SOURCES[0] else []
            procs[(name, src)] = (obj, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, *flags, "-c", str(d / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    reports = {}
    for key, (obj, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"attn_bwd_variants: nvcc failed on {key}:\n{out}{err}")
        if key[1] == SOURCES[0]:
            reports[key[0]] = err
    libs = {}
    for name in dirs:
        path = OUT / f"{name}.so"
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(path),
                        *(str(OUT / f"{name}_{Path(src).stem}.o") for src in SOURCES)],
                       check=True)
        lib = ctypes.CDLL(str(path))
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.repro_flash_attention_backward.argtypes = (
            [ptr] * 11 + [i32] * 7 + [i64] * 24 + [f32, i32, i32, ptr])
        lib.repro_flash_attention_backward.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        print(json.dumps({"case": "resources", "variant": name,
                          "kernels": _resources(reports[name], name == "this")}), flush=True)
    return libs


def inputs(shape, dtype, gen):
    """q, k, v, do in the model's layout, as transposed views; the forward's
    o and lse by the checkout's own library."""
    b, h, hkv, s, d, causal = shape
    draw = lambda heads: torch.randn((b, s, heads, d), generator=gen,
                                     device="cuda").to(dtype).transpose(1, 2)
    q, k, v, do = draw(h), draw(hkv), draw(hkv), draw(h)
    out, lse = flash_attention_lse_cuda(q, k, v, causal)
    return q, k, v, out, lse, do


def errors(args, causal) -> dict:
    got = flash_attention_backward_cuda(*args, causal)
    want = flash_attention_backward_plain(*args, causal)
    return {name: ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
            for name, g, w in zip(("dq", "dk", "dv"), got, want)}


def time_call(args, causal) -> float:
    run = lambda: flash_attention_backward_cuda(*args, causal)
    for _ in range(2):
        run()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(10):
        run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / 10


def main() -> int:
    cs.phase_env()
    libs = build(make_variants())
    _build.lib()  # the checkout's own, for the forward
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        main_args = inputs(MAIN, dtype, gen)
        small_args = [inputs(shape, dtype, gen) for shape in SMALL]
        tol = cs.BWD_TOL["flash_attention_backward"][dtype]
        own = _build._lib
        for name, lib in libs.items():
            if name != "this" and not any(
                    k.startswith("kF32" if dtype == torch.float32 else "kBf16")
                    for k in VARIANTS[name]):
                continue
            _build._lib = lib
            errs = [errors(main_args, MAIN[-1])] + [
                errors(a, shape[-1]) for a, shape in zip(small_args, SMALL)]
            row = {"case": "variant", "variant": name, "dtype": cs.dtype_name(dtype),
                   "ms": time_call(main_args, MAIN[-1]), "err": errs, "tol": tol,
                   "ok": all(e <= tol for es in errs for e in es.values())}
            ok &= row["ok"]
            print(json.dumps(row), flush=True)
        _build._lib = own
        del main_args, small_args
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
