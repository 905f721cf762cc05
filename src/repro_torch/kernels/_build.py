"""Builds the CUDA sources under ``csrc/`` into one shared library and loads
it with ``ctypes``.

The sources have plain C entry points and include nothing of PyTorch, so the
build takes seconds. It happens at the first kernel launch of a process, never
at import: each ``.cu`` is compiled by its own ``nvcc`` (all started together),
the objects are linked into ``build/repro_torch/`` at the root of the checkout,
and the library's name carries a hash of the sources, so a changed source is
rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(commands) -> None:
    """Start every command at once, wait for all, raise with the output of
    the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(commands, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel build failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile ``csrc/*.cu`` if the library for these sources is not there
    yet; return the library's path."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"librepro_torch_{tag}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objects = [BUILD_DIR / f"{src.stem}_{tag}.{os.getpid()}.o" for src in sources]
    tmp_lib = BUILD_DIR / f"{lib_path.name}.{os.getpid()}.tmp"
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources, objects)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
                   *map(str, objects)]])
        os.replace(tmp_lib, lib_path)  # atomic: a reader never sees half a file
    finally:
        for path in (*objects, tmp_lib):
            path.unlink(missing_ok=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded library, built on first call, with every entry point's
    ``argtypes`` set (an undeclared pointer would be cut to 32 bits)."""
    global _lib
    if _lib is not None:
        return _lib
    loaded = ctypes.CDLL(str(build()))
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    loaded.repro_rmsnorm.argtypes = [ptr, ptr, ptr, i64, i32, f32, i32, ptr]
    loaded.repro_rmsnorm.restype = i32
    loaded.repro_flash_attention.argtypes = (
        [ptr] * 6 + [i32] * 6 + [i64] * 12 + [f32, i32, i32, i32, ptr])
    loaded.repro_flash_attention.restype = i32
    loaded.repro_ssd_scan.argtypes = [ptr] * 10 + [i32] * 7 + [i64] * 15 + [i32, i32, ptr]
    loaded.repro_ssd_scan.restype = i32
    loaded.repro_embedding_bag.argtypes = [ptr] * 3 + [i32] * 5 + [i64] * 5 + [i32, ptr]
    loaded.repro_embedding_bag.restype = i32
    loaded.repro_embedding_bag_backward.argtypes = (
        [ptr] * 11 + [i32] * 5 + [i64] * 5 + [i32, i32, ptr])
    loaded.repro_embedding_bag_backward.restype = i32
    loaded.repro_cuda_error_string.argtypes = [i32]
    loaded.repro_cuda_error_string.restype = ctypes.c_char_p
    _lib = loaded
    return loaded


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        message = lib().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {message}")


def on_device(device: torch.device):
    """Context in which ``device`` is the current CUDA device, as a launch
    needs. Costs nothing when it already is, the usual case."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
