"""What holds the SSD scan backward (csrc/ssd_scan_backward.cu) on one card:
builds copies of this checkout's kernel sources with one thing changed and
times them at mamba2-780m's training layer (b 8, s 2048, h 48, p 64, n 128,
chunk 256), fp32 and bf16, in one process, in turns.

    python3 ssd_bwd_variants.py [--check]

Variants (copies under build/ssd_bwd_variants/, each built by nvcc into a
library of its own):

    this       the checkout's sources
    no_mma     `mma_tf32` and `mma_bf16` made no-ops (the products' fragment
               loads go with them): what the rest costs
    no_copy    `cp_async16` made a no-op: what the copies cost
    neither    both
    one_chain  `scores` with one chain of hi x hi products (kHiChains = 1)
               instead of two: the accumulation the tensor cores round
               toward zero

Prints, first, each backward kernel's registers and spill bytes as
`nvcc -Xptxas -v` reports them for this checkout; then one JSON line per
variant, type and round: the `rows`, `cols` and `dstates` stages alone and
the whole call (CUDA events, 10 calls after 2), and the largest error of
each gradient against the float64 closed form (only `this` and `one_chain`
compute the gradient; the others' results are meaningless); then the
call's time against the plan's splits (`BACKWARD_MIN_BLOCKS` varied, on
`this`). With --check, chip_smoke.py's `train_mamba_check` on `this` and on
`one_chain`. Needs one CUDA device and nvcc.
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
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as m  # noqa: E402

OUT = ROOT / "build" / "ssd_bwd_variants"
SHAPE = dict(b=8, s=2048, h=48, p=64, n=128, g=1, chunk=256)
GRADS = ("dx", "ddt", "dA", "dB", "dC")
# file -> the functions whose bodies a variant empties
STUBS = {"no_mma": {"mma.cuh": ("mma_tf32", "mma_bf16")},
         "no_copy": {"mma.cuh": ("cp_async16",)},
         "neither": {"mma.cuh": ("mma_tf32", "mma_bf16", "cp_async16")}}
GRADIENTS = ("this", "one_chain")  # the variants whose results are gradients


def _stub(text: str, functions) -> str:
    for fn in functions:
        text, k = re.subn(r"(void " + fn + r"\([^{]*\{).*?\n\}", r"\1\n}", text, flags=re.S)
        if k != 1:
            raise SystemExit(f"ssd_bwd_variants: no single body of {fn} to stub")
    return text


def make_variants() -> dict:
    """name -> csrc directory, the copies written under OUT."""
    dirs = {"this": _build.CSRC}
    for name in (*STUBS, "one_chain"):
        d = OUT / name / "csrc"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(_build.CSRC, d)
        for f, fns in STUBS.get(name, {}).items():
            (d / f).write_text(_stub((d / f).read_text(), fns))
        if name == "one_chain":
            src = d / "ssd_scan_backward.cu"
            text, k = re.subn(r"kHiChains = 2;", "kHiChains = 1;", src.read_text())
            if k != 1:
                raise SystemExit("ssd_bwd_variants: no `kHiChains = 2;` in ssd_scan_backward.cu")
            src.write_text(text)
        dirs[name] = d
    return dirs


def resources() -> None:
    """Each backward kernel's registers and spill stores, this checkout."""
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                          str(_build.CSRC / "ssd_scan_backward.cu"), "-o",
                          str(OUT / "resources.o")], capture_output=True, text=True, check=True)
    filt = Path(_build._nvcc()).parent / "cu++filt"
    rows, name, spill = [], None, None
    for line in out.stderr.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            demangled = subprocess.run([str(filt), found.group(1)], capture_output=True,
                                       text=True).stdout.replace("(int)", "")
            name = re.search(r"ssd_bwd_\w+?_kernel(<[^>]*>)?", demangled).group(0)
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "registers" in line:
            rows.append({"kernel": name, "registers":
                         int(re.search(r"Used (\d+) registers", line).group(1)),
                         "spill_store_bytes": spill})
            name = None
    print(json.dumps({"case": "resources", "kernels": rows}), flush=True)


def load(name: str):
    lib_path = OUT / f"{name}.so"
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_ssd_scan.argtypes = [ptr] * 10 + [i32] * 7 + [i64] * 15 + [i32, i32, ptr]
    lib.repro_ssd_scan.restype = i32
    lib.repro_ssd_scan_backward.argtypes = [ptr] * 20 + [i32] * 8 + [i64] * 15 + [i32, i32, ptr]
    lib.repro_ssd_scan_backward.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def inputs(dtype, gen):
    b, s, h, p, n, g = (SHAPE[k] for k in "bshpng")
    di, gn = h * p, g * n
    xbc = torch.randn((b, s, di + 2 * gn), generator=gen, device="cuda").to(dtype)
    x = xbc[..., :di].unflatten(-1, (h, p))
    B = xbc[..., di:di + gn].unflatten(-1, (g, n))
    C = xbc[..., di + gn:].unflatten(-1, (g, n))
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device="cuda"))
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    return x, dt, A, B, C, dy


def time_stages(args, saved, bufs, stages) -> float:
    x, dt, A, B, C, dy = args
    chunk = SHAPE["chunk"]
    run = lambda: m.ssd_scan_backward_stages_cuda(x, dt, A, B, C, dy, None, *saved, chunk,
                                                   bufs, stages)
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
    check = "--check" in sys.argv[1:]
    cs.phase_env()
    OUT.mkdir(parents=True, exist_ok=True)
    resources()
    dirs = make_variants()
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      str(OUT / f"{name}.so"), *(str(d / f) for f in
                                                 ("ssd_scan.cu", "ssd_scan_backward.cu",
                                                  "rmsnorm.cu"))]
                     for name, d in dirs.items()])
    libs = {name: load(name) for name in dirs}
    chunk = SHAPE["chunk"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        args = inputs(dtype, gen)
        x, dt, A, B, C, dy = args
        _build._lib = libs["this"]
        saved = m.ssd_scan_train_cuda(x, dt, A, B, C, chunk)[2:]
        want = m.ssd_scan_backward_plain(*(t.double() for t in args), None, chunk)
        for rnd in range(2):
            for name in dirs:
                _build._lib = libs[name]
                bufs = m.ssd_backward_buffers(x, B, chunk)
                row = {"case": "variant", "variant": name, "dtype": cs.dtype_name(dtype),
                       "round": rnd}
                if rnd == 0 and name in GRADIENTS:
                    m.ssd_scan_backward_stages_cuda(x, dt, A, B, C, dy, None, *saved, chunk,
                                                    bufs)
                    row["err_vs_float64"] = {
                        k: ((bufs[k].double() - w).abs().max() / w.abs().max()).item()
                        for k, w in zip(GRADS, want)}
                for stage in ("rows", "cols", "dstates"):
                    row[stage] = time_stages(args, saved, bufs, (stage,))
                row["call"] = time_stages(args, saved, bufs, m.BACKWARD_STAGES)
                print(json.dumps(row), flush=True)
                del bufs
        _build._lib = libs["this"]
        default = m.BACKWARD_MIN_BLOCKS
        for min_blocks in (256, 512, 1056, 2112, 12288):
            m.BACKWARD_MIN_BLOCKS = min_blocks
            bufs = m.ssd_backward_buffers(x, B, chunk)
            print(json.dumps({"case": "splits", "dtype": cs.dtype_name(dtype),
                              "min_blocks": min_blocks,
                              "splits": m.ssd_scan_backward_plan(
                                  *(SHAPE[k] for k in ("b", "s", "h", "g", "n", "chunk")))[0],
                              "reduce": time_stages(args, saved, bufs, ("reduce",)),
                              "call": time_stages(args, saved, bufs, m.BACKWARD_STAGES)}),
                  flush=True)
            del bufs
        m.BACKWARD_MIN_BLOCKS = default
        del args, x, B, C, dy, saved, want
        torch.cuda.empty_cache()
    if check:
        for name in GRADIENTS:
            _build.CSRC, _build._lib = dirs[name], None  # the variant's own full build
            try:
                cs.phase_train_mamba_check()
                print(json.dumps({"case": "train_mamba_check", "variant": name, "ok": True}))
            except SystemExit as err:
                print(json.dumps({"case": "train_mamba_check", "variant": name, "ok": False,
                                  "problems": str(err)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
