"""repro_torch kernels' modules against the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX function (the Pallas kernel
in interpret mode and its jnp oracle) and through the port's plain PyTorch
version, which is what the port's wrappers run for CPU tensors. Tolerances
are the reference tests': attention fp32 2e-5, bf16 3e-2; RMSNorm fp32 1e-5,
bf16 1e-2; SSD scan fp32 5e-4 / rtol 1e-3; embedding bag fp32 1e-5, bf16
1e-2, its backward against ``jax.grad``. Tests marked ``cuda`` hold the
CUDA kernels against the plain versions and need the card:
``python -m pytest -m cuda tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.rmsnorm import rmsnorm as rmsnorm_pallas
from repro.kernels.ssd_scan import ssd_scan as ssd_scan_pallas
from repro.models import dlrm as dlrm_jax
from repro.models.common import naive_attention as naive_attention_jax
from repro.models.mamba import ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import (
    BACKWARD_STAGES,
    PIECE,
    backward_kernels_per_call,
    embedding_bag_backward_buffers,
    embedding_bag_backward_cuda,
    embedding_bag_backward_keys_plain,
    embedding_bag_backward_links,
    embedding_bag_backward_pieces_plain,
    embedding_bag_backward_plain,
    embedding_bag_backward_sort_plain,
    embedding_bag_backward_sorted_plain,
    embedding_bag_backward_stages_cuda,
    embedding_bag_backward_write_plain,
    embedding_bag_cuda,
    embedding_bag_plain,
)
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plain
from repro_torch.kernels.ssd_scan import (
    MAX_CHUNK,
    STAGES,
    ssd_buffers,
    ssd_chunk_outputs_plain,
    ssd_chunk_scores_plain,
    ssd_chunk_states_plain,
    ssd_scan_cuda,
    ssd_scan_plain,
    ssd_scan_stages_plain,
    ssd_stages_cuda,
    ssd_state_pass_plain,
)
from repro_torch.models import common as tcommon

torch.set_num_threads(1)

# b, h, hkv, s, d, causal, block_q, block_k: the table of tests/test_kernels.py
ATTN_TABLE = [
    (2, 4, 2, 256, 64, True, 128, 128),
    (1, 8, 8, 130, 32, True, 64, 64),        # ragged seq
    (2, 2, 1, 64, 128, False, 32, 32),       # MQA, non-causal
    (1, 4, 4, 100, 64, True, 64, 32),        # uneven blocks
    (1, 6, 2, 96, 16, True, 32, 32),         # GQA group=3
]


def _qkv(seed, b, h, hkv, sq, skv, d):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, sq, d).astype(np.float32),
            rs.randn(b, hkv, skv, d).astype(np.float32),
            rs.randn(b, hkv, skv, d).astype(np.float32))


def _bf16(x):
    """numpy fp32 -> (jax bf16 array, torch bf16 tensor) of equal values."""
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


@pytest.mark.parametrize("b,h,hkv,s,d,causal,bq,bk", ATTN_TABLE)
def test_flash_plain_matches_pallas_kernel(b, h, hkv, s, d, causal, bq, bk):
    q, k, v = _qkv(0, b, h, hkv, s, s, d)
    want = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, block_q=bq, block_k=bk,
                               interpret=True)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,h,hkv,s,d,causal,bq,bk", ATTN_TABLE)
def test_flash_plain_matches_attention_ref(b, h, hkv, s, d, causal, bq, bk):
    q, k, v = _qkv(1, b, h, hkv, s, s, d)
    want = ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)          # CPU -> plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("oracle", ["pallas", "ref"])
def test_flash_plain_bf16(oracle):
    q, k, v = _qkv(2, 1, 2, 2, 128, 128, 64)
    (qj, qt), (kj, kt), (vj, vt) = _bf16(q), _bf16(k), _bf16(v)
    if oracle == "pallas":
        want = flash_attention_fwd(qj, kj, vj, interpret=True)
    else:
        want = ref.attention_ref(qj, kj, vj)
    got = flash_attention_plain(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=3e-2)


@pytest.mark.parametrize("sq,skv,offset", [(1, 12, 11), (5, 12, 7),
                                           (3, 40, 0), (8, 8, 0)])
def test_flash_plain_q_offset_matches_naive_attention(sq, skv, offset):
    """sq != skv: the only oracle with the port's alignment is
    ``naive_attention(q_offset=...)`` (``attention_ref`` is bottom-right
    aligned and agrees only at sq == skv)."""
    b, h, hkv, d = 2, 4, 2, 16
    q, k, v = _qkv(3, b, h, hkv, sq, skv, d)
    want = naive_attention_jax(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)),
        causal=True, q_offset=offset)                      # (b, sq, h, d)
    got = flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)), causal=True,
        q_offset=torch.full((b,), offset, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1, 3),
                               np.asarray(want), atol=2e-5, rtol=2e-5)


def test_flash_plain_per_sequence_offset_and_kv_len():
    """Each sequence has its own q_offset and kv_len: equal to running the
    reference on each sequence alone, with the keys cut at kv_len."""
    b, h, hkv, sq, skv, d = 3, 4, 2, 4, 20, 16
    q, k, v = _qkv(4, b, h, hkv, sq, skv, d)
    offsets, lens = [0, 9, 16], [20, 11, 18]
    got = flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)), causal=True,
        kv_len=torch.tensor(lens, dtype=torch.int32),
        q_offset=torch.tensor(offsets, dtype=torch.int32)).numpy()
    for i in range(b):
        want = naive_attention_jax(
            jnp.asarray(q[i:i + 1].transpose(0, 2, 1, 3)),
            jnp.asarray(k[i:i + 1, :, :lens[i]].transpose(0, 2, 1, 3)),
            jnp.asarray(v[i:i + 1, :, :lens[i]].transpose(0, 2, 1, 3)),
            causal=True, q_offset=offsets[i])
        np.testing.assert_allclose(got[i:i + 1].transpose(0, 2, 1, 3),
                                   np.asarray(want), atol=2e-5, rtol=2e-5)


def test_flash_plain_row_without_keys_is_zero():
    q, k, v = map(torch.from_numpy, _qkv(5, 2, 2, 1, 3, 6, 16))
    out = flash_attention_plain(q, k, v, causal=False,
                                kv_len=torch.tensor([6, 0], dtype=torch.int32))
    assert torch.isfinite(out).all()
    assert out[0].abs().max() > 0 and out[1].abs().max() == 0


@pytest.mark.parametrize("sq,skv,offset", [(6, 6, 0), (1, 9, 8), (4, 10, 3)])
def test_model_attention_matches_jax_naive(sq, skv, offset):
    """The port's model-layout entry (``attention``, through the wrapper) and
    its literal ``naive_attention`` both equal the JAX ``naive_attention``."""
    b, h, hkv, d = 2, 6, 2, 16
    rs = np.random.RandomState(6)
    q = rs.randn(b, sq, h, d).astype(np.float32)
    k = rs.randn(b, skv, hkv, d).astype(np.float32)
    v = rs.randn(b, skv, hkv, d).astype(np.float32)
    want = np.asarray(naive_attention_jax(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=offset))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    naive = tcommon.naive_attention(tq, tk, tv, causal=True, q_offset=offset)
    fused = tcommon.attention(
        tq, tk, tv, causal=True,
        q_offset=torch.full((b,), offset, dtype=torch.int32))
    np.testing.assert_allclose(naive.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(fused.numpy(), want, atol=2e-5, rtol=2e-5)


RMS_TABLE = [((4, 64), "float32"), ((3, 17, 128), "float32"),
             ((2, 100, 256), "bfloat16"), ((8, 1, 576), "float32"),
             ((5, 576), "bfloat16")]


@pytest.mark.parametrize("shape,dtype", RMS_TABLE)
@pytest.mark.parametrize("oracle", ["pallas", "ref"])
def test_rmsnorm_plain_matches_jax(shape, dtype, oracle):
    rs = np.random.RandomState(7)
    x = rs.randn(*shape).astype(np.float32)
    g = rs.randn(shape[-1]).astype(np.float32)
    if dtype == "bfloat16":
        (xj, xt), (gj, gt), atol = _bf16(x), _bf16(g), 1e-2
    else:
        xj, gj, atol = jnp.asarray(x), jnp.asarray(g), 1e-5
        xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    if oracle == "pallas":
        want = rmsnorm_pallas(xj, gj, interpret=True)
    else:
        want = ref.rmsnorm_ref(xj, gj)
    got = ops.rmsnorm(xt, gt)                          # CPU -> plain version
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol)
    np.testing.assert_array_equal(got.float().numpy(),
                                  rmsnorm_plain(xt, gt).float().numpy())


def test_cpu_calls_do_not_count_as_launches():
    before = ops.flash_attention.launches, ops.rmsnorm.launches
    q = torch.zeros(1, 1, 2, 64)
    ops.flash_attention(q, q, q)
    ops.rmsnorm(torch.ones(2, 8), torch.ones(8))
    assert (ops.flash_attention.launches, ops.rmsnorm.launches) == before


def test_launch_functions_refuse_cpu_tensors():
    """The functions that launch the kernels never compute another way."""
    q = torch.zeros(1, 1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(torch.ones(2, 8), torch.ones(8))


# b, h, s, p, n, chunk, g: the table of tests/test_kernels.py (one group of
# B/C each), then a grouped case whose length is not a multiple of the chunk
SSD_TABLE = [
    (2, 3, 128, 16, 32, 32, 1),
    (1, 2, 100, 8, 16, 32, 1),      # ragged chunks
    (2, 4, 64, 32, 64, 64, 1),
    (1, 1, 256, 64, 128, 128, 1),   # production-like dims
    (2, 4, 45, 16, 16, 32, 2),      # two groups of two heads, ragged
]


def _ssd_inputs(seed, b, h, s, p, n, g):
    """Model layout: x (b,s,h,p), dt (b,s,h) softplus-ed, A (h,) < 0,
    B/C (b,s,g,n), drawn as the reference tests draw them."""
    rs = np.random.RandomState(seed)
    return (rs.randn(b, s, h, p).astype(np.float32),
            np.log1p(np.exp(rs.randn(b, s, h))).astype(np.float32),
            (-np.exp(0.5 * rs.randn(h))).astype(np.float32),
            rs.randn(b, s, g, n).astype(np.float32),
            rs.randn(b, s, g, n).astype(np.float32))


def _ssd_oracle(oracle, x, dt, A, B, C, chunk):
    """The JAX function in the model's layout: ``ssd_chunked`` takes it as
    is; the Pallas kernel and ``ref.ssd_ref`` take (b,h,s,*) with B/C
    repeated per head."""
    if oracle == "chunked":
        y, st = ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk)
        return np.asarray(y.astype(jnp.float32)), np.asarray(st)
    reps = x.shape[2] // B.shape[2]
    heads_first = lambda a: jnp.asarray(a).swapaxes(1, 2)
    args = (heads_first(x), heads_first(dt), jnp.asarray(A),
            heads_first(jnp.repeat(jnp.asarray(B), reps, axis=2)),
            heads_first(jnp.repeat(jnp.asarray(C), reps, axis=2)))
    if oracle == "pallas":
        y, st = ssd_scan_pallas(*args, chunk=chunk, interpret=True)
    else:
        y, st = ref.ssd_ref(*args)
    return np.asarray(y.astype(jnp.float32)).swapaxes(1, 2), np.asarray(st)


@pytest.mark.parametrize("b,h,s,p,n,chunk,g", SSD_TABLE)
@pytest.mark.parametrize("oracle", ["pallas", "ref", "chunked"])
def test_ssd_plain_matches_jax(oracle, b, h, s, p, n, chunk, g):
    x, dt, A, B, C = _ssd_inputs(10, b, h, s, p, n, g)
    want_y, want_st = _ssd_oracle(oracle, x, dt, A, B, C, chunk)
    y, st = ops.ssd_scan(*map(torch.from_numpy, (x, dt, A, B, C)),
                         chunk)                     # CPU -> plain version
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want_y, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(st.numpy(), want_st, atol=5e-4, rtol=1e-3)


def test_ssd_plain_bf16_matches_pallas_kernel():
    """bf16 inputs: both sides widen to fp32, compute, and round y to bf16
    once, from fp32 values ~1e-6 of |y| apart, so they differ by at most one
    bf16 ulp: 2^-7 of |y| (rtol 1e-2; atol 1e-2 covers values near 0). The
    state is fp32 on both sides: the fp32 tolerance."""
    x, dt, A, B, C = _ssd_inputs(11, 1, 2, 100, 16, 16, 1)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    xt, Bt, Ct = bf(x), bf(B), bf(C)
    want_y, want_st = _ssd_oracle(
        "pallas", xt.float().numpy(), dt, A, Bt.float().numpy(),
        Ct.float().numpy(), 32)
    jx = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16).swapaxes(1, 2)
    y_pallas, _ = ssd_scan_pallas(
        jx, jnp.asarray(dt).swapaxes(1, 2), jnp.asarray(A),
        jnp.asarray(Bt.float().numpy()).swapaxes(1, 2).astype(jnp.bfloat16),
        jnp.asarray(Ct.float().numpy()).swapaxes(1, 2).astype(jnp.bfloat16),
        chunk=32, interpret=True)
    y, st = ssd_scan_plain(xt, torch.from_numpy(dt), torch.from_numpy(A),
                           Bt, Ct, 32)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    np.testing.assert_allclose(
        y.float().numpy(),
        np.asarray(y_pallas.astype(jnp.float32)).swapaxes(1, 2),
        atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(y.float().numpy(), want_y, atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(st.numpy(), want_st, atol=5e-4, rtol=1e-3)


def test_ssd_plain_takes_views_of_the_conv_output():
    """The model hands over strided views of one (b, s, h*p + 2*g*n)
    tensor; the result is the one of contiguous copies."""
    b, s, h, p, n, g = 2, 40, 4, 16, 16, 2
    rs = np.random.RandomState(12)
    xbc = torch.from_numpy(rs.randn(b, s, h * p + 2 * g * n).astype(np.float32))
    x = xbc[..., :h * p].unflatten(-1, (h, p))
    B = xbc[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    C = xbc[..., h * p + g * n:].unflatten(-1, (g, n))
    assert not x.is_contiguous()
    _, dt, A, _, _ = _ssd_inputs(12, b, h, s, p, n, g)
    dt, A = torch.from_numpy(dt), torch.from_numpy(A)
    got = ops.ssd_scan(x, dt, A, B, C, 32)
    want = ops.ssd_scan(x.contiguous(), dt, A, B.contiguous(),
                        C.contiguous(), 32)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), w.numpy())


@pytest.mark.parametrize("b,h,s,p,n,chunk,g", SSD_TABLE)
def test_ssd_stages_compose_to_the_plain_scan(b, h, s, p, n, chunk, g):
    """The four stages as the kernels run them (scores, chunk states, the
    state pass, outputs) give what the chunk loop gives; the sums are taken
    in another order, so fp32 rounding apart (1e-5 of the scale)."""
    args = tuple(map(torch.from_numpy, _ssd_inputs(16, b, h, s, p, n, g)))
    want_y, want_st = ssd_scan_plain(*args, chunk)
    y, st = ssd_scan_stages_plain(*args, chunk)
    for got, want in ((y, want_y), (st, want_st)):
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("b,h,s,p,n,chunk,g", SSD_TABLE)
@pytest.mark.parametrize("oracle", ["pallas", "chunked"])
def test_ssd_stages_match_jax(oracle, b, h, s, p, n, chunk, g):
    """The composed stages against ``ssd_chunked`` and the Pallas kernel in
    interpret mode, at the tolerance of the other SSD tests."""
    x, dt, A, B, C = _ssd_inputs(17, b, h, s, p, n, g)
    want_y, want_st = _ssd_oracle(oracle, x, dt, A, B, C, chunk)
    y, st = ssd_scan_stages_plain(*map(torch.from_numpy, (x, dt, A, B, C)),
                                  chunk)
    np.testing.assert_allclose(y.numpy(), want_y, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(st.numpy(), want_st, atol=5e-4, rtol=1e-3)


def test_ssd_stage_shapes_and_scratch():
    """What each plain stage returns, and the kernels' scratch: a ragged
    last chunk (s 100, chunk 32: 4 chunks), the cumsum flat past its last
    position, the first incoming state zero, G's rows padded to 64."""
    b, h, s, p, n, chunk, g = 1, 4, 100, 8, 16, 32, 2
    x, dt, A, B, C = map(torch.from_numpy, _ssd_inputs(18, b, h, s, p, n, g))
    G = ssd_chunk_scores_plain(B, C, chunk)
    cs, states = ssd_chunk_states_plain(x, dt, A, B, chunk)
    incoming, final = ssd_state_pass_plain(states, cs)
    assert G.shape == (b, g, 4, 32, 32)
    assert cs.shape == (b, h, 4, 32) and states.shape == (b, h, 4, p, n)
    assert torch.equal(cs[:, :, 3, 4:], cs[:, :, 3, 3:4].expand(-1, -1, 28))
    assert incoming.abs()[:, :, 0].max() == 0 and final.shape == (b, h, p, n)
    y = ssd_chunk_outputs_plain(x, dt, cs, B, C, incoming, chunk)
    assert y.shape == x.shape and y.dtype == x.dtype
    bufs = {k: tuple(v.shape) for k, v in ssd_buffers(x, B, chunk).items()}
    assert bufs == {"y": (b, s, h, p), "state": (b, h, p, n),
                    "scores": (b, g, 4, 64, 64), "cs": (b, h, 4, 64),
                    "states": (b, h, 4, p, n)}


def test_ssd_cpu_call_does_not_count_as_launch():
    before = ops.ssd_scan.launches
    ops.ssd_scan(*map(torch.from_numpy, _ssd_inputs(13, 1, 2, 8, 8, 16, 1)), 4)
    assert ops.ssd_scan.launches == before


def test_ssd_launch_function_refuses_cpu_tensors():
    """The functions that launch the kernels never compute another way."""
    args = tuple(map(torch.from_numpy, _ssd_inputs(14, 1, 2, 8, 8, 16, 1)))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(*args, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_stages_cuda(*args, 4, ssd_buffers(args[0], args[3], 4))


# ------------------------------------------------------------------------- #
# Embedding bag (DLRM). The Pallas kernel does not run on this jax (it calls
# pl.load, which jax 0.9.0 no longer has), so the oracles are
# ref.embedding_bag_ref and models.dlrm.embedding_bag, and jax.grad of the
# latter for the backward. Tolerances: fp32 1e-5, bf16 1e-2 (the reference
# test's; the tables are drawn at 0.05 so that a bf16 ulp of the sums stays
# below 1e-2).
# ------------------------------------------------------------------------- #

# t, r, e, b, n: the table of tests/test_kernels.py::TestEmbeddingBag
BAG_TABLE = [(4, 50, 16, 3, 7), (2, 128, 32, 8, 1), (8, 16, 8, 2, 16)]


def _bag_inputs(seed, t, r, e, b, n):
    rs = np.random.RandomState(seed)
    return ((0.05 * rs.randn(t, r, e)).astype(np.float32),
            rs.randint(0, r, size=(b, t, n)).astype(np.int32))


def _jax_bag_grad(tables, idx, cot):
    """jax.grad of <embedding_bag(tables, idx), cot> with respect to tables."""
    return np.asarray(jax.grad(lambda tb: jnp.sum(
        dlrm_jax.embedding_bag(tb, jnp.asarray(idx)) * jnp.asarray(cot)))(
            jnp.asarray(tables)))


@pytest.mark.parametrize("t,r,e,b,n", BAG_TABLE)
@pytest.mark.parametrize("oracle", ["ref", "dlrm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_plain_matches_jax(t, r, e, b, n, oracle, dtype):
    tables, idx = _bag_inputs(20, t, r, e, b, n)
    fn = ref.embedding_bag_ref if oracle == "ref" else dlrm_jax.embedding_bag
    if dtype == "bfloat16":
        (tj, tt), atol = _bf16(tables), 1e-2
    else:
        tj, tt, atol = jnp.asarray(tables), torch.from_numpy(tables), 1e-5
    want = fn(tj, jnp.asarray(idx))
    got = embedding_bag_plain(tt, torch.from_numpy(idx))
    assert got.dtype == tt.dtype and got.shape == (b, t, e)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("t,r,e,b,n", BAG_TABLE)
@pytest.mark.parametrize("route", ["plain", "ops"])
def test_embedding_bag_backward_plain_matches_jax_grad(t, r, e, b, n, route):
    """``route="ops"``: the gradient autograd takes through the wrapper on
    CPU tensors, which is the plain backward under an autograd.Function."""
    tables, idx = _bag_inputs(21, t, r, e, b, n)
    cot = np.random.RandomState(22).randn(b, t, e).astype(np.float32)
    want = _jax_bag_grad(tables, idx, cot)
    if route == "plain":
        got = embedding_bag_backward_plain(torch.from_numpy(cot),
                                           torch.from_numpy(idx), r)
    else:
        tt = torch.from_numpy(tables).requires_grad_()
        ops.embedding_bag(tt, torch.from_numpy(idx)).backward(
            torch.from_numpy(cot))
        got = tt.grad
    assert got.shape == (t, r, e) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_embedding_bag_out_of_range_indices_follow_jax():
    """A negative index wraps by +R; in the forward an index still outside
    [0, R) is clamped, in the gradient it is dropped. R = 5, indices [7, -1]:
    the forward sums row 4 twice, the gradient puts 1 (not 2) in row 4."""
    rs = np.random.RandomState(23)
    tables = rs.randn(2, 5, 6).astype(np.float32)
    idx = np.array([[[7, -1], [0, 3]],
                    [[-6, -5], [5, 4]],
                    [[2, -2], [9, -9]]], np.int32)             # (3, 2, 2)
    cot = rs.randn(3, 2, 6).astype(np.float32)
    tt = torch.from_numpy(tables).requires_grad_()
    out = ops.embedding_bag(tt, torch.from_numpy(idx))
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(dlrm_jax.embedding_bag(jnp.asarray(tables),
                                          jnp.asarray(idx))), atol=1e-6)
    np.testing.assert_allclose(out[0, 0].detach().numpy(), 2 * tables[0, 4],
                               atol=1e-6)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tt.grad.numpy(),
                               _jax_bag_grad(tables, idx, cot), atol=1e-6)
    ones = embedding_bag_backward_plain(torch.ones(1, 1, 6),
                                        torch.tensor([[[7, -1]]],
                                                     dtype=torch.int32), 5)
    assert ones[0, 4].tolist() == [1.0] * 6 and ones.sum().item() == 6.0


def test_embedding_bag_cpu_calls_do_not_count_as_launches():
    before = (ops.embedding_bag.launches, ops.embedding_bag.backward_launches)
    tables, idx = map(torch.from_numpy, _bag_inputs(24, 2, 10, 8, 3, 4))
    tables.requires_grad_()
    ops.embedding_bag(tables, idx).sum().backward()
    assert tables.grad is not None
    assert (ops.embedding_bag.launches,
            ops.embedding_bag.backward_launches) == before


def test_embedding_bag_launch_functions_refuse_cpu_tensors():
    """The functions that launch the kernels never compute another way."""
    tables, idx = map(torch.from_numpy, _bag_inputs(25, 2, 10, 8, 3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_cuda(tables, idx)
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_backward_cuda(torch.zeros(3, 2, 8), idx, 10)
    dout = torch.zeros(3, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_backward_stages_cuda(
            dout, idx, 10, embedding_bag_backward_buffers(dout, idx, 10))


# The backward kernels' design in PyTorch: keys with the sentinel, a stable
# sort, the pieces' head and tail sums, the segmented sum. Cases: the
# reference table, the wrap/clamp/drop case, every lookup of a bag on one
# row, and a Zipf-like draw (alpha 1.05) whose hot rows cross pieces.
def _bag_grad_case(case):
    rs = np.random.RandomState(28)
    if case in range(len(BAG_TABLE)):
        t, r, e, b, n = BAG_TABLE[case]
        tables, idx = _bag_inputs(21, t, r, e, b, n)
    elif case == "out of range":
        tables = rs.randn(2, 5, 6).astype(np.float32)
        idx = np.array([[[7, -1], [0, 3]], [[-6, -5], [5, 4]],
                        [[2, -2], [9, -9]]], np.int32)
    elif case == "one row a bag":
        t, r, e, b, n = 3, 40, 8, 64, 32      # rows 0-2 named, ~680 each
        tables = (0.05 * rs.randn(t, r, e)).astype(np.float32)
        idx = np.repeat(rs.randint(0, 3, size=(b, t, 1)), n, axis=2)
    else:                                                    # zipf
        t, r, e, b, n = 2, 50, 8, 96, 32
        tables = (0.05 * rs.randn(t, r, e)).astype(np.float32)
        weight = np.arange(1, r + 1) ** -1.05
        idx = rs.choice(r, size=(b, t, n), p=weight / weight.sum())
    cot = rs.randn(idx.shape[0], idx.shape[1], tables.shape[2])
    return tables, idx.astype(np.int32), cot.astype(np.float32)


BAG_GRAD_CASES = [*range(len(BAG_TABLE)), "out of range", "one row a bag",
                  "zipf"]


def _scaled_tol(want) -> float:
    """1e-5 of the gradient's scale: the same fp32 terms, up to ~700 of them
    a value here, summed in another order."""
    return 1e-5 * max(1.0, float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("case", BAG_GRAD_CASES)
def test_embedding_bag_backward_sorted_plain_matches_jax_grad(case):
    tables, idx, cot = _bag_grad_case(case)
    r = tables.shape[1]
    want = _jax_bag_grad(tables, idx, cot)
    got = embedding_bag_backward_sorted_plain(torch.from_numpy(cot),
                                              torch.from_numpy(idx), r)
    assert got.shape == tables.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=_scaled_tol(want),
                               rtol=0)
    if case in ("one row a bag", "zipf"):     # hot rows cross pieces
        keys, _ = embedding_bag_backward_sort_plain(torch.from_numpy(idx), r)
        assert embedding_bag_backward_links(keys, r, tables.shape[0]).sum() >= 2


def test_embedding_bag_backward_plain_sums_float64_in_float64():
    """fp64 dout is summed and returned in fp64 (the yardstick chip_smoke.py
    holds the fp32 kernel against): equal to numpy's fp64 scatter-add."""
    tables, idx, cot = _bag_grad_case("zipf")
    t, r, e = tables.shape
    got = embedding_bag_backward_plain(torch.from_numpy(cot).double(),
                                       torch.from_numpy(idx), r)
    assert got.dtype == torch.float64
    want = np.zeros((t, r, e))
    b_i, t_i, _ = np.indices(idx.shape)
    np.add.at(want, (t_i, idx), cot.astype(np.float64)[b_i, t_i])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_embedding_bag_backward_keys_sentinel_and_stable_order():
    """R 5, T 2: key t * 5 + wrap(idx), the sentinel 10 for a dropped index,
    payload b; the stable sort keeps lookup order within a key."""
    idx = torch.tensor([[[7, -1], [0, 3]],
                        [[3, -6], [5, 0]]], dtype=torch.int32)
    keys, payload = embedding_bag_backward_keys_plain(idx, 5)
    assert keys.dtype == payload.dtype == torch.int32
    assert keys.tolist() == [10, 4, 5, 8, 3, 10, 10, 5]
    assert payload.tolist() == [0, 0, 0, 0, 1, 1, 1, 1]
    keys, payload = embedding_bag_backward_sort_plain(idx, 5)
    assert keys.tolist() == [3, 4, 5, 5, 8, 10, 10, 10]
    assert payload.tolist() == [1, 0, 0, 1, 0, 0, 1, 1]


def test_embedding_bag_backward_pieces_and_scratch():
    """Table 1 takes 600 lookups, all on row 3 (key 10); table 0's are all
    dropped (the sentinel 14). Pieces of 128: 0-3 are all key 10 and linked
    to the next, piece 4 starts with 88 of key 10 and ends with the
    sentinel, pieces 5-9 are the sentinel's. And the kernels' scratch and
    launches."""
    b, t, n, r, e = 60, 2, 10, 7, 4
    idx = torch.full((b, t, n), 3, dtype=torch.int32)
    idx[:, 0] = -20                                          # all dropped
    dout = torch.from_numpy(
        np.random.RandomState(29).randn(b, t, e).astype(np.float32))
    keys, payload = embedding_bag_backward_sort_plain(idx, r)
    assert embedding_bag_backward_links(keys, r, t).tolist() == [True] * 4 + [
        False] * 5
    pieces = embedding_bag_backward_pieces_plain(dout, keys, payload, r)
    assert pieces["head_len"].tolist() == [128] * 4 + [88] + [0] * 5
    rows = dout[:, 1].repeat_interleave(n, dim=0)             # sorted order
    want = torch.cat([rows[:512].view(4, PIECE, e).sum(1),
                      rows[512:].sum(0, keepdim=True)])
    tol = _scaled_tol(want)
    torch.testing.assert_close(pieces["head"][:5], want, rtol=0, atol=tol)
    torch.testing.assert_close(pieces["tail"][:4], want[:4], rtol=0, atol=tol)
    assert pieces["tail"][4:].abs().max() == 0
    assert pieces["head"][5:].abs().max() == 0
    got = embedding_bag_backward_write_plain(dout, keys, payload, pieces, r)
    want = embedding_bag_backward_plain(dout, idx, r)
    torch.testing.assert_close(got, want, rtol=0, atol=_scaled_tol(want))
    bufs = {k: (tuple(v.shape), v.dtype) for k, v in
            embedding_bag_backward_buffers(dout, idx, r).items()}
    i32 = torch.int32
    assert bufs == {"dtables": ((t, r, e), torch.float32),
                    "keys": ((1200,), i32), "vals": ((1200,), i32),
                    "keys_tmp": ((1200,), i32), "vals_tmp": ((1200,), i32),
                    "hist": ((256 * 1 + 256,), i32),
                    "head": ((10, e), torch.float32),
                    "tail": ((10, e), torch.float32),
                    "head_len": ((10,), i32)}
    assert backward_kernels_per_call(b, t, n, r) == 3 + 1 + 1
    assert backward_kernels_per_call(4096, 64, 32, 200_000) == 3 * 3 + 2
    assert BACKWARD_STAGES == ("sort", "pieces", "write")


# ------------------------------------------------------------------------- #
# On the card: the CUDA kernels against the plain versions.
# ------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# b, h, hkv, sq, skv, d, causal, q_offset, kv_len (None: not passed). sq <= 8
# goes to the decode kernel (keys split over a cluster of up to 8 blocks of
# 32-key stages), longer q to the prefill kernels.
FLASH_CUDA_TABLE = [
    (2, 4, 2, 256, 256, 64, True, None, None),
    (2, 2, 1, 64, 64, 128, False, None, None),
    (1, 9, 3, 130, 130, 64, True, None, None),
    (8, 9, 3, 1, 512, 64, True, [37 * i for i in range(8)], None),
    # prefill: ragged and whole tiles, a long prompt, d 128
    (1, 9, 3, 17, 17, 64, True, None, None),
    (1, 9, 3, 64, 64, 64, True, None, None),
    (1, 9, 3, 65, 65, 64, True, None, None),
    (1, 9, 3, 1000, 1000, 64, True, None, None),
    (1, 8, 2, 200, 200, 128, True, None, None),
    # a chunk of 40 rows into a cache
    (2, 4, 2, 40, 200, 128, True, [160, 37], [200, 77]),
    # decode, groups 1, 3 and 16 (chatglm3: 32 heads over 2 KV heads)
    (8, 8, 8, 1, 512, 128, True, [511, 3, 100, 257, 0, 64, 33, 490], None),
    (8, 9, 3, 1, 2048, 64, True, [1999, 5, 700, 1024, 31, 32, 2047, 1500],
     None),
    (8, 32, 2, 1, 2048, 128, True, [2047, 1, 900, 1023, 1024, 64, 1800, 300],
     None),
    # 8 rows x group 16 in one block
    (2, 32, 2, 8, 300, 128, True, [100, 292], None),
    # kv_len 1
    (4, 9, 3, 1, 256, 64, True, [0, 0, 255, 100], [1, 1, 1, 256]),
    # every q_offset at the cache's end: every block of the cluster is full
    (8, 9, 3, 1, 2048, 64, True, [2047] * 8, None),
    # short sequences in a long cache: most blocks of the cluster have no key
    (8, 9, 3, 1, 2048, 64, True, [0, 1, 3, 5, 7, 9, 31, 40], None),
]


def _flash_cuda_case(device, dtype, b, h, hkv, sq, skv, d, q_off, lens):
    q, k, v = (torch.from_numpy(a).to(device, dtype)
               for a in _qkv(8, b, h, hkv, sq, skv, d))
    vec = lambda a: (None if a is None else
                     torch.tensor(a, dtype=torch.int32, device=device))
    return q, k, v, vec(q_off), vec(lens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,q_off,lens",
                         FLASH_CUDA_TABLE)
def test_flash_kernel_matches_plain(cuda_device, dtype, atol, b, h, hkv, sq,
                                    skv, d, causal, q_off, lens):
    q, k, v, offset, kv_len = _flash_cuda_case(cuda_device, dtype, b, h, hkv,
                                               sq, skv, d, q_off, lens)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal, kv_len, offset)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal, kv_len, offset)
    assert got.shape == want.shape and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_flash_decode_cluster_sizes_match_plain(cuda_device, dtype, atol,
                                                cluster):
    """Every cluster size the decode kernel takes gives the plain result."""
    offsets = [1999, 5, 700, 1024, 31, 32, 2047, 1500]
    q, k, v, offset, _ = _flash_cuda_case(cuda_device, dtype, 8, 9, 3, 1,
                                          2048, 64, offsets, None)
    got = flash_attention_cuda(q, k, v, True, None, offset,
                               decode_cluster=cluster)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, True, None, offset)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(8, 1, 576), (3, 37, 576), (2, 5, 4096),
                                   (3, 7, 100), (8, 1, 1536), (8, 1, 3072),
                                   (1, 1024, 3072)])
def test_rmsnorm_kernel_matches_plain(cuda_device, dtype, atol, shape):
    """mamba2-780m's shapes (d 1536 and 3072) draw gamma at 0.1: the output
    then stays below 1, where a bf16 ulp is below the tolerance. Kernel and
    plain version sum the squares in another order, and a bf16 output near a
    rounding boundary may land one ulp apart; with gamma ~ N(0, 1) a million
    outputs reach |y| > 2, where one ulp exceeds 1e-2."""
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        cuda_device, dtype)
    g_scale = 0.1 if shape[-1] in (1536, 3072) else 1.0
    g = torch.from_numpy(g_scale * rs.randn(shape[-1]).astype(np.float32)).to(
        cuda_device, dtype)
    before = ops.rmsnorm.launches
    got = ops.rmsnorm(x, g)
    torch.cuda.synchronize()
    assert ops.rmsnorm.launches == before + 1
    want = rmsnorm_plain(x, g)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,h,s,p,n,chunk,g", SSD_TABLE + [
    (1, 48, 1024, 64, 128, 256, 1), (1, 48, 700, 64, 128, 256, 1),
    (1, 48, 17, 64, 128, 256, 1), (1, 4, 2500, 72, 64, MAX_CHUNK, 2)])
def test_ssd_kernel_matches_plain(cuda_device, dtype, rel, b, h, s, p, n,
                                  chunk, g):
    """Tolerance as chip_smoke.py states it: max |kernel - plain| against
    rel * max(1, max |plain|), for y and for the state."""
    x, dt, A, B, C = (torch.from_numpy(a).to(cuda_device)
                      for a in _ssd_inputs(15, b, h, s, p, n, g))
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    before = ops.ssd_scan.launches
    y, st = ops.ssd_scan(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    want_y, want_st = ssd_scan_plain(x, dt, A, B, C, chunk)
    for got, want in ((y.float(), want_y.float()), (st, want_st)):
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= rel * scale


# b, h, s, p, n, chunk, g: the main prefill, a ragged chunk with p over two
# p-tiles, a long chunk with groups, narrow shapes
SSD_STAGE_TABLE = [(1, 48, 1024, 64, 128, 256, 1), (2, 4, 300, 72, 32, 128, 2),
                   (1, 2, 1100, 16, 16, MAX_CHUNK, 1), (2, 3, 45, 8, 64, 32, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,h,s,p,n,chunk,g", SSD_STAGE_TABLE)
@pytest.mark.parametrize("stage", STAGES)
def test_ssd_stage_kernel_matches_plain(cuda_device, stage, dtype, rel, b, h,
                                        s, p, n, chunk, g):
    """One stage kernel against its plain stage, fed the plain stages'
    results for what it reads. Tolerance as ``test_ssd_kernel_matches_plain``
    states it: max |kernel - plain| against rel * max(1, max |plain|)."""
    x, dt, A, B, C = (torch.from_numpy(a).to(cuda_device)
                      for a in _ssd_inputs(19, b, h, s, p, n, g))
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    q = min(chunk, s)
    cs, states = ssd_chunk_states_plain(x, dt, A, B, chunk)
    incoming, final = ssd_state_pass_plain(states, cs)
    bufs = ssd_buffers(x, B, chunk)
    for t in bufs.values():
        t.fill_(float("nan"))       # what a stage reads must be written
    if stage in ("pass", "outputs"):
        bufs["cs"][..., :q] = cs
        bufs["cs"][..., q:] = cs[..., -1:]
    if stage == "pass":
        bufs["states"].copy_(states)
    if stage == "outputs":
        bufs["states"].copy_(incoming)
        G = ssd_chunk_scores_plain(B, C, chunk)
        bufs["scores"].zero_()
        bufs["scores"][..., :q, :q] = G
    ssd_stages_cuda(x, dt, A, B, C, chunk, bufs, stages=(stage,))
    torch.cuda.synchronize()
    if stage == "scores":
        G = ssd_chunk_scores_plain(B, C, chunk)
        lower = torch.ones((q, q), dtype=torch.bool,
                           device=cuda_device).tril()
        pairs = [(bufs["scores"][..., :q, :q][..., lower], G[..., lower])]
    elif stage == "states":
        pairs = [(bufs["cs"][..., :q], cs), (bufs["states"], states)]
    elif stage == "pass":
        pairs = [(bufs["states"], incoming), (bufs["state"], final)]
    else:
        want = ssd_chunk_outputs_plain(x, dt, cs, B, C, incoming, chunk)
        pairs = [(bufs["y"].float(), want.float())]
    for got, want in pairs:
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= rel * scale


# t, r, e, b, n: the reference table, the reduced DLRM, an out-of-range case
# whose rows are not 16-byte packs (the scalar path) and a wide one
BAG_CUDA_TABLE = BAG_TABLE + [(4, 1000, 16, 64, 32), (3, 10, 10, 5, 9),
                              (64, 20000, 128, 256, 32)]


def _bag_tol(want: torch.Tensor, dtype) -> float:
    """fp32: the kernel sums in sorted order (full pieces first summed
    apart), the plain version in index_add_'s order: the same terms, up to
    a few hundred of them a value, in another order, 1e-5 of the output's
    scale. bf16: both round once from fp32 values a few fp32 ulps apart, so
    they may land one bf16 ulp apart, 2^-7 of |out|."""
    scale = max(1.0, want.float().abs().max().item())
    return (1e-5 if dtype == torch.float32 else 2 ** -7) * scale


def _bag_cuda_inputs(device, dtype, t, r, e, b, n, seed):
    tables, idx = _bag_inputs(seed, t, r, e, b, n)
    if r == 10:                                   # wrap, clamp and drop
        idx = np.random.RandomState(seed).randint(-2 * r, 2 * r,
                                                  size=idx.shape)
    if n > 1:                                     # a duplicate in every bag
        idx[..., 1] = idx[..., 0]
    return (torch.from_numpy(tables).to(device, dtype),
            torch.from_numpy(idx.astype(np.int32)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,r,e,b,n", BAG_CUDA_TABLE)
def test_embedding_bag_kernel_matches_plain(cuda_device, dtype, t, r, e, b, n):
    tables, idx = _bag_cuda_inputs(cuda_device, dtype, t, r, e, b, n, 26)
    before = ops.embedding_bag.launches
    got = ops.embedding_bag(tables, idx)
    torch.cuda.synchronize()
    assert ops.embedding_bag.launches == before + 1
    want = embedding_bag_plain(tables, idx)
    assert got.dtype == dtype and got.shape == (b, t, e)
    assert (got.float() - want.float()).abs().max().item() <= _bag_tol(want,
                                                                       dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,r,e,b,n", BAG_CUDA_TABLE)
def test_embedding_bag_backward_kernel_matches_plain(cuda_device, dtype, t, r,
                                                     e, b, n):
    """Through autograd, with dout a strided view (as the DLRM's cat hands
    it over)."""
    tables, idx = _bag_cuda_inputs(cuda_device, dtype, t, r, e, b, n, 27)
    wide = torch.randn((b, t + 1, e), device=cuda_device).to(dtype)
    dout = wide[:, 1:]
    tables.requires_grad_()
    before = ops.embedding_bag.backward_launches
    ops.embedding_bag(tables, idx).backward(dout)
    torch.cuda.synchronize()
    assert ops.embedding_bag.backward_launches == before + 1
    want = embedding_bag_backward_plain(dout, idx, r)
    got = tables.grad
    assert got.dtype == dtype and got.shape == (t, r, e)
    assert (got.float() - want.float()).abs().max().item() <= _bag_tol(want,
                                                                       dtype)


# t, r, e, b, n, draw: the cases of the backward's stages. "zipf": rows drawn
# with weight k^-1.05 (hot rows over many pieces); "one row": every lookup of
# a table on row 7; "wrap": indices in [-2R, 2R) (dropped ones, the scalar
# path); "uniform": the reduced DLRM.
BAG_STAGE_TABLE = [(4, 20000, 128, 1024, 32, "zipf"),
                   (2, 1000, 128, 512, 32, "one row"),
                   (3, 10, 10, 5, 9, "wrap"),
                   (4, 1000, 16, 64, 32, "uniform")]


def _bag_stage_inputs(device, dtype, t, r, e, b, n, draw, seed=30):
    rs = np.random.RandomState(seed)
    if draw == "zipf":
        weight = np.arange(1, r + 1) ** -1.05
        idx = rs.choice(r, size=(b, t, n), p=weight / weight.sum())
    elif draw == "one row":
        idx = np.full((b, t, n), 7)
    elif draw == "wrap":
        idx = rs.randint(-2 * r, 2 * r, size=(b, t, n))
    else:
        idx = rs.randint(0, r, size=(b, t, n))
    wide = torch.from_numpy(rs.randn(b, t + 1, e).astype(np.float32))
    dout = wide.to(device, dtype)[:, 1:]          # the DLRM's strided view
    return dout, torch.from_numpy(idx.astype(np.int32)).to(device)


def _assert_near_exact(got, dout, idx, r, dtype):
    """got against the exact gradient (index_add_ in float64). Any order of
    an fp32 sum of c terms lies within (c - 1) * 2^-24 * sum |terms| of the
    exact sum (Higham, Accuracy and Stability of Numerical Algorithms, 4.2),
    so a hot row of 16 k terms gets a wide margin and a row of one term
    none. bf16 rounds that sum once more: one bf16 ulp, 2^-7 of |exact|."""
    t, e = dout.shape[1], dout.shape[2]
    keys, payload = embedding_bag_backward_keys_plain(idx, r)
    valid = keys < t * r
    k = keys[valid].long()
    rows = dout.double()[payload[valid].long(), k // r]
    exact = torch.zeros((t * r, e), dtype=torch.float64, device=dout.device)
    abs_sum, count = torch.zeros_like(exact), torch.zeros_like(exact[:, 0])
    exact.index_add_(0, k, rows)
    abs_sum.index_add_(0, k, rows.abs())
    count.index_add_(0, k, torch.ones_like(rows[:, 0]))
    allowed = (count - 1).clamp(min=0)[:, None] * 2.0 ** -24 * abs_sum
    if dtype == torch.bfloat16:
        allowed = 2 * allowed + 2 ** -7 * exact.abs()
    err = (got.double().view(t * r, e) - exact).abs()
    assert (err <= allowed).all(), (err - allowed).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,r,e,b,n,draw", BAG_STAGE_TABLE)
@pytest.mark.parametrize("stage", BACKWARD_STAGES)
def test_embedding_bag_backward_stage_kernel_matches_plain(
        cuda_device, stage, dtype, t, r, e, b, n, draw):
    """One stage's kernels against the plain stage, fed the plain stages'
    results for what they read. The sort's output is unique: equal exactly.
    The writer starts from NaN: every row is written, those no lookup names
    with 0."""
    dout, idx = _bag_stage_inputs(cuda_device, dtype, t, r, e, b, n, draw)
    keys, payload = embedding_bag_backward_sort_plain(idx, r)
    pieces = embedding_bag_backward_pieces_plain(dout, keys, payload, r)
    bufs = embedding_bag_backward_buffers(dout, idx, r)
    for buf in bufs.values():
        buf.fill_(-1 if buf.dtype == torch.int32 else float("nan"))
    if stage != "sort":
        bufs["keys"].copy_(keys)
        bufs["vals"].copy_(payload)
    # pieces whose first / last key is not the sentinel: what the kernel
    # writes and the writer reads
    last = keys[torch.clamp(torch.arange(1, len(pieces["head"]) + 1,
                                         device=keys.device) * PIECE,
                            max=keys.numel()) - 1]
    heads, tails = keys[::PIECE] < t * r, last < t * r
    if stage == "write":
        for name, valid in (("head", heads), ("tail", tails),
                            ("head_len", heads)):
            bufs[name][valid] = pieces[name][valid]
    embedding_bag_backward_stages_cuda(dout, idx, r, bufs, stages=(stage,))
    torch.cuda.synchronize()
    if stage == "sort":
        assert torch.equal(bufs["keys"], keys)
        assert torch.equal(bufs["vals"], payload)
    elif stage == "pieces":
        assert torch.equal(bufs["head_len"][heads], pieces["head_len"][heads])
        rows = dout.float()[payload.long(), (keys.clamp(max=t * r - 1)
                                             // r).long()]
        pad = len(heads) * PIECE - keys.numel()
        abs_sum = torch.cat([rows.abs(), rows.new_zeros((pad, e))]).view(
            -1, PIECE, e).sum(1)
        for name, valid in (("head", heads), ("tail", tails)):
            got, want = bufs[name][valid], pieces[name][valid]
            # up to PIECE terms, summed in two orders
            assert ((got - want).abs()
                    <= 2 * PIECE * 2.0 ** -24 * abs_sum[valid]).all()
    else:
        got = bufs["dtables"]
        assert got.dtype == dtype and not got.isnan().any()
        untouched = torch.ones(t * r, dtype=torch.bool, device=cuda_device)
        untouched[keys[keys < t * r].long()] = False
        assert not got.view(t * r, e)[untouched].any()
        _assert_near_exact(got, dout, idx, r, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,r,e,b,n,draw", BAG_STAGE_TABLE[:2])
def test_embedding_bag_backward_kernel_is_deterministic(cuda_device, dtype, t,
                                                        r, e, b, n, draw):
    """Five calls on a Zipf-hot and on a single-row input: bitwise equal,
    and near the exact gradient."""
    dout, idx = _bag_stage_inputs(cuda_device, dtype, t, r, e, b, n, draw)
    first = embedding_bag_backward_cuda(dout, idx, r)
    for _ in range(4):
        assert torch.equal(embedding_bag_backward_cuda(dout, idx, r), first)
    _assert_near_exact(first, dout, idx, r, dtype)
