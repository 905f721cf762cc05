"""Times this tree's flash attention and RMSNorm kernels against another
tree's sources on the same inputs, in one process on one card, in turns
(other, this, this, other), so that two versions are compared within one run.

    git archive <rev> src/repro_torch/kernels/csrc | tar -x -C build/ab_other
    python3 kernel_ab.py build/ab_other/src/repro_torch/kernels/csrc

Prints one JSON line per case: each side's two device times (CUDA graph
replay over cold copies, as ``chip_smoke.py`` times) and its largest error
against the plain version. Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_plain  # noqa: E402

OUT = ROOT / "build" / "kernel_ab"
ORDER = ("other", "this", "this", "other")


class _NoClusterArg:
    """An older entry point without the decode-cluster argument."""

    def __init__(self, lib):
        self.lib = lib

    def repro_flash_attention(self, *args):
        args = list(args)
        del args[-3]
        return self.lib.repro_flash_attention(*args)

    def __getattr__(self, name):
        return getattr(self.lib, name)


def _load(name: str, takes_cluster: bool):
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    lib.repro_rmsnorm.argtypes = [ptr, ptr, ptr, i64, i32, f32, i32, ptr]
    lib.repro_rmsnorm.restype = i32
    tail = [f32, i32, i32, i32, ptr] if takes_cluster else [f32, i32, i32, ptr]
    lib.repro_flash_attention.argtypes = [ptr] * 6 + [i32] * 6 + [i64] * 12 + tail
    lib.repro_flash_attention.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib if takes_cluster else _NoClusterArg(lib)


def build(other: Path) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    sides = {"this": _build.CSRC, "other": other}
    nvcc = _build._nvcc()
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(OUT / f"{name}.so"),
                      str(src / "flash_attention.cu"), str(src / "rmsnorm.cu")]
                     for name, src in sides.items()])
    return {name: _load(name, "int cluster" in (src / "flash_attention.cu").read_text())
            for name, src in sides.items()}


def ab(libs, name, dtype, fn, plain, sets) -> None:
    row = {"case": name, "dtype": cs.dtype_name(dtype), "err": {}}
    want = plain(*sets[0]).float()
    for side in ORDER:
        _build._lib = libs[side]
        got = fn(*sets[0])
        torch.cuda.synchronize()
        row["err"][side] = (got.float() - want).abs().max().item()
        row.setdefault(side, []).append(cs.time_ms(fn, sets)["device"])
    print(json.dumps(row), flush=True)


def norm_case(libs, shape, dtype, gen) -> None:
    d = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    sets = [(x.clone(), g) for _ in range(cs.copies_for_cold_l2([x, x]))]
    ab(libs, f"rmsnorm {list(shape)}", dtype, lambda a, b: ops.rmsnorm(a, b, 1e-5),
       lambda a, b: rmsnorm_plain(a, b, 1e-5), sets)


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


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    cs.phase_env()
    libs = build(Path(sys.argv[1]).resolve())
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
