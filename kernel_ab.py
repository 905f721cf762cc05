"""Times this tree's flash attention, RMSNorm, SSD scan and embedding-bag
backward kernels against another tree's sources on the same inputs, in one
process on one card, in turns (other, this, this, other), so that two
versions are compared within one run. An SSD scan source with the older
single-kernel entry point (its ``p_tile`` argument) is called with p-tiles
of 32, its default; an embedding-bag source with the older atomic backward
(no ``stages`` argument) is called as its wrapper called it, on a
zero-filled fp32 (T, R, E).

    git archive <rev> src/repro_torch/kernels/csrc | tar -x -C build/ab_other
    python3 kernel_ab.py build/ab_other/src/repro_torch/kernels/csrc

Prints one JSON line per case: each side's two device times (CUDA graph
replay over cold copies, as ``chip_smoke.py`` times) and its largest error
against the plain version (the SSD scan's: over y and the final state). Needs
one CUDA device and ``nvcc``.
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
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_backward_cuda,
    embedding_bag_backward_plain,
)
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import _DTYPE_CODE, ssd_scan_plain  # noqa: E402

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


def _load(name: str, takes_cluster: bool, ssd_p_tile: bool, bag_stages: bool):
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    lib.repro_ssd_scan.argtypes = (
        [ptr] * 7 + [i32] * 8 + [i64] * 15 + [i32, ptr] if ssd_p_tile else
        [ptr] * 10 + [i32] * 7 + [i64] * 15 + [i32, i32, ptr])
    lib.repro_ssd_scan.restype = i32
    lib.repro_rmsnorm.argtypes = [ptr, ptr, ptr, i64, i32, f32, i32, ptr]
    lib.repro_rmsnorm.restype = i32
    tail = [f32, i32, i32, i32, ptr] if takes_cluster else [f32, i32, i32, ptr]
    lib.repro_flash_attention.argtypes = [ptr] * 6 + [i32] * 6 + [i64] * 12 + tail
    lib.repro_flash_attention.restype = i32
    lib.repro_embedding_bag_backward.argtypes = (
        [ptr] * 11 + [i32] * 5 + [i64] * 5 + [i32, i32, ptr] if bag_stages else
        [ptr] * 4 + [i32] * 5 + [i64] * 5 + [i32, ptr])
    lib.repro_embedding_bag_backward.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib if takes_cluster else _NoClusterArg(lib)


def build(other: Path) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    sides = {"this": _build.CSRC, "other": other}
    nvcc = _build._nvcc()
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(OUT / f"{name}.so"),
                      str(src / "flash_attention.cu"), str(src / "rmsnorm.cu"),
                      str(src / "ssd_scan.cu"), str(src / "embedding_bag.cu")]
                     for name, src in sides.items()])
    return {name: _load(name, "int cluster" in (src / "flash_attention.cu").read_text(),
                        "int p_tile" in (src / "ssd_scan.cu").read_text(),
                        "int stages" in (src / "embedding_bag.cu").read_text())
            for name, src in sides.items()}


def _max_err(got, want) -> float:
    if isinstance(want, tuple):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return (got.float() - want.float()).abs().max().item()


def ab(libs, name, dtype, fn, plain, sets, fns=None, **timing) -> None:
    """``fn`` on both sides, or ``fns[side]`` where the sides' entry points
    differ; ``timing``: ``chip_smoke.time_ms``'s options."""
    row = {"case": name, "dtype": cs.dtype_name(dtype), "err": {}}
    want = plain(*sets[0])
    for side in ORDER:
        _build._lib = libs[side]
        f = fns[side] if fns else fn
        got = f(*sets[0])
        torch.cuda.synchronize()
        row["err"][side] = _max_err(got, want)
        del got
        row.setdefault(side, []).append(cs.time_ms(f, sets, **timing)["device"])
    print(json.dumps(row), flush=True)


def _ssd_p_tile_call(lib, x, dt, A, B, C, chunk):
    """The single-kernel SSD entry point, p-tiles of 32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    code = lib.repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, s, h, p, g, n, min(chunk, s), 32,
        *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
        *y.stride()[:3], _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(code, "ssd_scan kernel launch")
    return y, state


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
    fns = {side: (lambda x_, B_, C_, lib=lib: _ssd_p_tile_call(lib, x_, dt, A, B_, C_, chunk))
           if len(lib.repro_ssd_scan.argtypes) == 32  # the p_tile entry point
           else (lambda x_, B_, C_: ops.ssd_scan(x_, dt, A, B_, C_, chunk))
           for side, lib in libs.items()}
    ab(libs, f"ssd_scan {name}", dtype, None,
       lambda x_, B_, C_: ssd_scan_plain(x_, dt, A, B_, C_, chunk), sets, fns)


def _atomic_bag_backward(lib, dout, idx, r):
    """The older backward entry point: fp32 atomics into a zero-filled
    (T, R, E), rounded once into a bf16 result."""
    b, t, e = dout.shape
    acc = torch.zeros((t, r, e), dtype=torch.float32, device=dout.device)
    out = acc if dout.dtype == torch.float32 else torch.empty(
        (t, r, e), dtype=dout.dtype, device=dout.device)
    code = lib.repro_embedding_bag_backward(
        dout.data_ptr(), idx.data_ptr(), acc.data_ptr(), out.data_ptr(), b, t, idx.shape[2],
        r, e, dout.stride(0), dout.stride(1), *idx.stride(), _DTYPE_CODE[dout.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(code, "embedding_bag backward kernel launch")
    return out


def bag_backward_case(libs, name, idx, r, e, dtype, gen) -> None:
    """dout the model's strided view, as ``chip_smoke._bag_case`` draws it;
    timed as chip_smoke.py times the main shapes (eager, 10 calls)."""
    b, t, _ = idx.shape
    dout = torch.randn((b, t + 1, e), generator=gen, device="cuda").to(dtype)[:, 1:]
    fns = {side: (lambda d, i, lib=lib: _atomic_bag_backward(lib, d, i, r))
           if len(lib.repro_embedding_bag_backward.argtypes) == 16  # the atomic entry point
           else (lambda d, i: embedding_bag_backward_cuda(d, i, r))
           for side, lib in libs.items()}
    ab(libs, f"embedding_bag_backward {name}", dtype, None,
       lambda d, i: embedding_bag_backward_plain(d, i, r), [(dout, idx)], fns,
       iters=10, graph=False)


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
