"""The kernels' inputs for a sequence split over the data ranks on the card:
attention's ``q_offset`` on the training route and the SSD scan's
``init_state``, each kernel against its plain version (held to the JAX
package on the CPU in ``tests/test_torch_seq_kernels.py``, whose shapes
these are, and the card's own: a long block with a ragged edge, d 128).

The forward with the log-sum-exp and the backward with ``q_offset`` to the
training route's tolerances (the output fp32 2e-5 and bf16 3e-2 absolute,
each gradient to the same share of its largest), three backward calls
bitwise equal, the keys past the block's last row given zero dK and dV;
the SSD scan's forward, training forward and backward from an
``init_state``, y, the final state and each cotangent (the initial
state's among them) to 1e-4 (fp32) and 1e-2 (bf16) of their largest.
Every test needs the card and skips without one (the kernels have no CPU
mode): ``python -m pytest -m cuda tests/test_torch_seq_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.flash_attention import (
    flash_attention_backward_cuda,
    flash_attention_backward_plain,
    flash_attention_forward_plain,
    flash_attention_lse_cuda,
)

# b, h, hkv, block rows, keys, head_dim, offset (tests/test_torch_seq_kernels)
ATTN_CASES = [
    (1, 9, 3, 24, 48, 64, 24),
    (2, 4, 4, 19, 38, 160, 19),
    (1, 4, 2, 13, 52, 16, 26),
    (2, 4, 2, 16, 32, 16, 0),
    (1, 4, 2, 70, 300, 64, 230),
    (1, 2, 1, 64, 256, 128, 0),
]
SSD_CASES = [(2, 37, 4, 8, 16, 2, 16), (1, 64, 4, 16, 16, 1, 32),
             (2, 9, 2, 8, 32, 2, 16)]


def _ssd_inputs(seed, b, s, h, p, n, g):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, s, h, p).astype(np.float32),
            np.log1p(np.exp(rs.randn(b, s, h))).astype(np.float32),
            (-np.exp(0.5 * rs.randn(h))).astype(np.float32),
            rs.randn(b, s, g, n).astype(np.float32),
            rs.randn(b, s, g, n).astype(np.float32),
            rs.randn(b, h, p, n).astype(np.float32),
            rs.randn(b, s, h, p).astype(np.float32),
            rs.randn(b, h, p, n).astype(np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,off", ATTN_CASES)
def test_attention_kernels_with_q_offset_match_plain(cuda_device, dtype, tol,
                                                     b, h, hkv, sq, skv, d,
                                                     off):
    """The forward with the log-sum-exp and the backward with ``q_offset``
    against the plain versions on the card (each gradient to ``tol`` of its
    largest), three backward calls bitwise equal, and the keys past the
    block's last row given zero dK and dV."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    draw = lambda heads, rows: torch.randn(
        (b, rows, heads, d), generator=gen, device=cuda_device).to(
            dtype).transpose(1, 2)
    q, k, v, do = draw(h, sq), draw(hkv, skv), draw(hkv, skv), draw(h, sq)
    offset = torch.full((b,), off, dtype=torch.int32, device=cuda_device)
    out, lse = flash_attention_lse_cuda(q, k, v, True, offset)
    want_out, want_lse = flash_attention_forward_plain(q, k, v, True, None,
                                                       offset)
    assert (out.float() - want_out.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-4 * max(
        1.0, want_lse.abs().max().item())
    got = flash_attention_backward_cuda(q, k, v, out, lse, do, True, offset)
    want = flash_attention_backward_plain(q, k, v, want_out, want_lse, do,
                                          True, offset)
    for g, w in zip(got, want):
        scale = max(w.float().abs().max().item(), 1e-30)
        assert (g.float() - w.float()).abs().max().item() <= tol * scale
    for _ in range(2):
        again = flash_attention_backward_cuda(q, k, v, out, lse, do, True,
                                              offset)
        assert all(torch.equal(a, g) for a, g in zip(again, got))
    seen = min(skv, sq + off)
    assert not got[1][:, :, seen:].any() and not got[2][:, :, seen:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,s,h,p,n,g,chunk", SSD_CASES)
def test_ssd_kernels_with_init_state_match_plain(cuda_device, dtype, rel, b,
                                                 s, h, p, n, g, chunk):
    """The forward, the training forward and the backward from an
    ``init_state`` on the card against the plain versions: y and the final
    state to ``rel`` of their largest, each cotangent (the initial
    state's included) to ``rel`` of its largest."""
    arrays = _ssd_inputs(6, b, s, h, p, n, g)
    x, dt, A, B, C, init, dy, dstate = (torch.from_numpy(a).to(cuda_device)
                                        for a in arrays)
    x, B, C, dy = (t.to(dtype) for t in (x, B, C, dy))
    want_y, want_st = ssd.ssd_scan_plain(x, dt, A, B, C, chunk, init)
    for y, st in (ssd.ssd_scan_cuda(x, dt, A, B, C, chunk, init),
                  ssd.ssd_scan_train_cuda(x, dt, A, B, C, chunk, init)[:2]):
        for got, want in ((y, want_y), (st, want_st)):
            scale = max(want.float().abs().max().item(), 1.0)
            assert (got.float() - want.float()).abs().max().item() <= (
                rel * scale)
    saved = ssd.ssd_scan_train_cuda(x, dt, A, B, C, chunk, init)[2:]
    got = ssd.ssd_scan_backward_cuda(x, dt, A, B, C, dy, dstate, *saved,
                                     chunk, init=True)
    want = ssd.ssd_scan_backward_plain(x, dt, A, B, C, dy, dstate, chunk,
                                       init)
    assert len(got) == len(want) == 6
    for g_, w in zip(got, want):
        scale = max(w.float().abs().max().item(), 1e-30)
        assert (g_.float() - w.float()).abs().max().item() <= rel * scale
