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

import math
import re
import shutil

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
from repro.models.common import rms_norm as rms_norm_jax
from repro.models.mamba import ssd_chunked
from repro_torch.kernels import _build, ops
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
    flash_attention_backward_cuda,
    flash_attention_backward_plain,
    flash_attention_backward_plan,
    flash_attention_backward_stages_plain,
    flash_attention_cuda,
    flash_attention_forward_plain,
    flash_attention_lse_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.rmsnorm import (
    BACKWARD_KERNELS_PER_CALL as RMS_BACKWARD_KERNELS_PER_CALL,
    BACKWARD_STAGES as RMS_BACKWARD_STAGES,
    _bwd_registers,
    rmsnorm_backward_buffers,
    rmsnorm_backward_cuda,
    rmsnorm_backward_plan,
    rmsnorm_backward_plain,
    rmsnorm_backward_stages_cuda,
    rmsnorm_cuda,
    rmsnorm_plain,
)
from repro_torch.kernels.ssd_scan import (
    MAX_CHUNK,
    STAGES,
    ssd_buffers,
    ssd_chunk_outputs_plain,
    ssd_chunk_scores_plain,
    ssd_chunk_states_plain,
    ssd_scan_backward_plain,
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


# ------------------------------------------------------------------------- #
# head_dim 160 (zamba2's shared attention block: 32 heads of 160)
# ------------------------------------------------------------------------- #

@pytest.mark.parametrize("b,h,hkv,s,causal,bq,bk", [
    (1, 2, 2, 130, True, 64, 64), (2, 4, 2, 64, False, 32, 32),
    (1, 3, 3, 100, True, 64, 32)])
def test_flash_plain_matches_pallas_kernel_at_head_dim_160(b, h, hkv, s,
                                                           causal, bq, bk):
    """The Pallas kernel takes any head dim; the plain version at d 160
    matches it in interpret mode at the fp32 tolerance, 2e-5."""
    q, k, v = _qkv(20, b, h, hkv, s, s, 160)
    want = flash_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, block_q=bq, block_k=bk,
                               interpret=True)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def _cu_constants(*names) -> dict:
    """``constexpr int NAME = value;`` of csrc/flash_attention.cu."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    return {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
            for n in names}


def test_forward_shared_memory_at_head_dim_160():
    """The shared memory of the four forward kernels at d 160, reckoned from
    the source's constants: the bf16 prefill (two stages) 193,536 bytes;
    the bf16 decode 177,408 and a 10,368-byte merge slot a cluster block, so
    a cluster of 4 fits a block's 232,448 bytes and one of 8 does not; the
    fp32 prefill (a 64-key tile, two stages, 164-float rows) 209,920; the
    fp32 decode (one 32-key stage: a 640-byte row is over the 256 that two
    take) fits at every cluster size. The wrapper's ``decode_smem_bytes``
    is the same reckoning."""
    from repro_torch.kernels import flash_attention as fa
    c = _cu_constants("MM_BM", "MM_BN", "MM_GROUPS", "TF_ROWS", "TF_STAGES",
                      "kDecodeTile", "DM_ROWS", "DM_WARPS", "DEC_WARPS",
                      "DEC_ROWS", "DEC_PITCH_PAD")
    assert (c["kDecodeTile"], c["DM_ROWS"], c["DM_WARPS"], c["DEC_WARPS"],
            c["DEC_ROWS"], c["DEC_PITCH_PAD"]) == (
        fa.DECODE_TILE, fa.DM_ROWS, fa.DM_WARPS, fa.DEC_WARPS, fa.DEC_ROWS,
        fa.DEC_PITCH_PAD)
    assert _cu_constants("kDecodeDefaultCluster")[
        "kDecodeDefaultCluster"] == fa.DECODE_DEFAULT_CLUSTER
    d, ld = 160, 168
    mma = (c["MM_BM"] * ld + c["MM_GROUPS"] * 2 * 2 * c["MM_BN"] * ld) * 2
    assert mma == 193_536 <= fa.SMEM_PER_BLOCK
    tf32 = (c["TF_ROWS"] + c["TF_STAGES"] * 2 * 64) * (d + 4) * 4
    assert tf32 == 209_920 <= fa.SMEM_PER_BLOCK
    own = fa.decode_smem_bytes(d, torch.bfloat16, 32, 0)
    assert own == 177_408
    assert fa.decode_smem_bytes(d, torch.bfloat16, 32, 1) - own == 10_368
    fits = [cl for cl in fa.DECODE_CLUSTERS
            if fa.decode_cluster_fits(d, torch.bfloat16, 32, cl)]
    assert fits == [1, 2, 4]
    for rows in (1, 32):
        assert all(fa.decode_cluster_fits(d, torch.float32, rows, cl)
                   for cl in fa.DECODE_CLUSTERS)
    # every cluster still fits at the head dims served before
    for d_old in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            assert all(fa.decode_cluster_fits(d_old, dtype, 3, cl)
                       for cl in fa.DECODE_CLUSTERS)


def test_flash_attention_head_dims():
    """One tuple of head dims serves every route (serving, the partial
    route, the training forward and the backward): 16 (the reduced
    configs), 64, 128 and 160 (zamba2's shared block), the head dims the
    sources' dispatch instantiates, in the forward and in the backward."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.HEAD_DIMS == (16, 64, 128, 160)
    assert not hasattr(fa, "TRAIN_HEAD_DIMS")
    for source in ("flash_attention.cu", "flash_attention_backward.cu"):
        text = (_build.CSRC / source).read_text()
        dims = re.findall(r"if \(d == (\d+)\) return launch\w*<T, (\d+)>",
                          text)
        assert dims and all(a == b for a, b in dims), source
        assert tuple(int(a) for a, _ in dims) == fa.HEAD_DIMS, source


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("group_rows", [1, 2, 8])
def test_decode_shared_memory_at_head_dim_16(dtype, cluster, group_rows):
    """The decode kernels' shared memory at d 16, reckoned from the
    source's constants and formulas (``dm_stages``, ``dec_stages``,
    ``merge_slot_floats``): bf16 25,344 bytes of its own (Q and two stages
    of each warp's ring, 48-byte rows) and a 1,152-byte merge slot a
    cluster block; fp32 43,264 (4 rows a block) or 41,536 (one row, a
    group of one row) and slots of 72 or 20 floats. Every cluster fits, and
    the wrapper's ``decode_smem_bytes`` is the same reckoning. The fp32
    kernel's P V at d 16 gives each column two lanes (``KS``), each half of
    a tile's keys in groups of four."""
    from repro_torch.kernels import flash_attention as fa
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert "return D == 64 ? 4 : 2;" in src                  # dm_stages
    assert "return D * (int)sizeof(float) <= 256 ? 2 : 1;" in src
    assert "return RM * D + (2 * RM + 3) / 4 * 4;" in src   # merge slots
    assert "constexpr int KS = D < 32 ? 32 / D : 1;" in src
    d, pitch = 16, 16 + 8
    slot = lambda rows: rows * d + (2 * rows + 3) // 4 * 4
    if dtype == torch.bfloat16:
        own = (fa.DM_ROWS * pitch
               + fa.DM_WARPS * 2 * 2 * fa.DECODE_TILE * pitch) * 2
        rows = fa.DM_ROWS
        assert (own, slot(rows) * 4) == (25_344, 1_152)
        assert pitch * 2 % 16 == 0          # every ldmatrix row 16-byte aligned
    else:
        rows = 1 if group_rows == 1 else fa.DEC_ROWS
        own = 4 * (fa.DEC_WARPS * 2 * 2 * fa.DECODE_TILE
                   * (d + fa.DEC_PITCH_PAD) + rows * d
                   + fa.DEC_WARPS * rows * fa.DECODE_TILE)
        assert own == {1: 41_536, 4: 43_264}[rows]
        assert slot(rows) == {1: 20, 4: 72}[rows]
    assert fa.decode_smem_bytes(d, dtype, group_rows, cluster) == (
        own + cluster * slot(rows) * 4)
    assert fa.decode_cluster_fits(d, dtype, group_rows, cluster)


def _bwd_constants() -> dict:
    """``constexpr int NAME = value;`` of csrc/flash_attention_backward.cu."""
    src = (_build.CSRC / "flash_attention_backward.cu").read_text()
    return {n: int(v) for n, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_backward_tiles_at_head_dim_160_match_the_source():
    """The d 160 tiles the wrapper reckons with are the source's constants,
    and the block's own rows are its ``kRows``."""
    from repro_torch.kernels import flash_attention as fa
    c = _bwd_constants()
    assert c["kRows"] == fa.BACKWARD_KEY_TILE == 64
    assert fa.BACKWARD_D160_TILE == {
        torch.float32: (c["kF32Rows160"], c["kF32Stages160"]),
        torch.bfloat16: (c["kBf16Rows160"], c["kBf16Stages160"])}
    # the forward's tile at the other head dims (attn_warp.cuh)
    warp = (_build.CSRC / "attn_warp.cuh").read_text()
    assert "return D == 128 ? 32 : 64;" in warp
    assert "return sizeof(T) == 4 && D == 128 ? 1 : 2;" in warp
    assert [fa.backward_tile(d, t) for d in (16, 64, 128)
            for t in (torch.float32, torch.bfloat16)] == [
        (64, 2), (64, 2), (64, 2), (64, 2), (32, 1), (32, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128, 160])
def test_backward_shared_memory_fits_a_block(d, dtype):
    """Each backward kernel's shared memory, reckoned as the source does
    (``dkdv_smem_bytes``, ``dq_smem_bytes``: 64 rows of two inputs, the
    streamed tiles' stages, 16 bytes of padding a row, the dK/dV kernel's
    fp32 lse and D a streamed row), fits a block's 232,448 bytes at every
    head dim of the training route. At d 160, fp32 (16 streamed rows, one
    stage): 105,088 and 104,960 bytes, two blocks an SM (two stages of 64
    rows would be 251,904, more than a block takes); bf16 (32 rows, two
    stages): 86,528 and 86,016."""
    from repro_torch.kernels import flash_attention as fa
    dkdv, dq = fa.backward_smem_bytes(d, dtype)
    rows, stages = fa.backward_tile(d, dtype)
    pitch = (d + 16 // dtype.itemsize) * dtype.itemsize
    assert dq == (2 * 64 + stages * 2 * rows) * pitch
    assert dkdv == dq + stages * 2 * rows * 4
    assert max(dkdv, dq) <= fa.SMEM_PER_BLOCK
    if d == 160:
        assert (dkdv, dq) == {torch.float32: (105_088, 104_960),
                              torch.bfloat16: (86_528, 86_016)}[dtype]
    if d == 160 and dtype == torch.float32:
        assert (2 * 64 + 2 * 2 * 64) * pitch == 251_904 > fa.SMEM_PER_BLOCK
        assert 2 * dkdv <= 228 * 1024    # two blocks share an SM


def test_ssd_scan_keeps_the_gradient_on_the_cpu():
    """On the CPU a scan that wants a gradient runs autograd through the
    plain version: every input gets one (a loss through the scan, held to
    ``jax.grad`` by the model tests)."""
    rs = np.random.RandomState(21)
    b, s, h, p, g, n = 1, 9, 2, 4, 1, 4
    x = torch.from_numpy(rs.randn(b, s, h, p).astype(np.float32))
    dt = torch.from_numpy(rs.rand(b, s, h).astype(np.float32))
    A = -torch.from_numpy(rs.rand(h).astype(np.float32) + 0.5)
    B, C = (torch.from_numpy(rs.randn(b, s, g, n).astype(np.float32))
            for _ in range(2))
    ins = [t.requires_grad_() for t in (x, dt, A, B, C)]
    y, state = ops.ssd_scan(*ins, 4)
    (y.sum() + state.sum()).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in ins)


def test_launch_functions_refuse_cpu_tensors():
    """The functions that launch the kernels never compute another way."""
    q = torch.zeros(1, 1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(torch.ones(2, 8), torch.ones(8))


# ------------------------------------------------------------------------- #
# The training route: attention and RMSNorm backwards against jax.grad
# ------------------------------------------------------------------------- #

def _scaled_err(got: torch.Tensor, want) -> float:
    """max |got - want| over max |want| (1 where want is all zero)."""
    want = np.asarray(want, dtype=np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got.detach().float().numpy() - want).max()) / scale


def _jax_attention_vjp(q, k, v, cot, causal, dtype):
    """jax.vjp of the JAX package's naive_attention, in the kernels' layout
    (b, heads, s, d) on both sides; the gradients as fp32 numpy."""
    cast = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) \
        if dtype == "bfloat16" else jnp.asarray
    tr = lambda a: jnp.swapaxes(a, 1, 2)
    fn = lambda q_, k_, v_: tr(naive_attention_jax(tr(q_), tr(k_), tr(v_),
                                                   causal=causal))
    out, vjp = jax.vjp(fn, cast(q), cast(k), cast(v))
    grads = vjp(cast(cot).astype(out.dtype))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch_leaf(a, dtype):
    t = torch.from_numpy(a)
    t = t.to(torch.bfloat16) if dtype == "bfloat16" else t
    return t.requires_grad_(True)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 160])
@pytest.mark.parametrize("group", [1, 3, 4])
def test_flash_backward_plain_matches_jax_grad(group, d, causal, dtype, tol):
    """The training route on the CPU (the plain forward and the plain
    backward, through ``ops.flash_attention``'s autograd Function) against
    ``jax.grad`` of ``naive_attention``: dq, dk, dv, each within ``tol`` of
    its largest magnitude."""
    b, hkv, s = 2, 2, 19
    h = hkv * group
    q, k, v = _qkv(20 + group, b, h, hkv, s, s, d)
    cot = np.random.RandomState(21).randn(b, h, s, d).astype(np.float32)
    want = _jax_attention_vjp(q, k, v, cot, causal, dtype)
    leaves = [_torch_leaf(a, dtype) for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal)
    out.backward(torch.from_numpy(cot).to(out.dtype))
    for name, leaf, w in zip("qkv", leaves, want):
        assert leaf.grad.dtype == leaf.dtype and leaf.grad.shape == leaf.shape
        assert _scaled_err(leaf.grad, w) <= tol, name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,sq,skv", [(2, 6, 2, 23, 23), (1, 4, 4, 5, 9),
                                            (2, 3, 1, 8, 8)])
def test_flash_backward_plain_is_autograd_in_float64(b, h, hkv, sq, skv,
                                                     causal):
    """In fp64 (no rounding of the probabilities) the plain backward equals
    autograd through ``flash_attention_plain``."""
    q, k, v = (torch.from_numpy(a).double().requires_grad_(True)
               for a in _qkv(22, b, h, hkv, sq, skv, 16))
    g = torch.from_numpy(np.random.RandomState(23).randn(b, h, sq, 16))
    flash_attention_plain(q, k, v, causal).backward(g)
    out, lse = flash_attention_forward_plain(q.detach(), k.detach(),
                                             v.detach(), causal)
    np.testing.assert_allclose(out.numpy(), flash_attention_plain(
        q, k, v, causal).detach().numpy(), rtol=0, atol=0)
    got = flash_attention_backward_plain(q.detach(), k.detach(), v.detach(),
                                         out, lse, g, causal)
    for name, leaf, gr in zip("qkv", (q, k, v), got):
        np.testing.assert_allclose(gr.numpy(), leaf.grad.numpy(), atol=1e-12,
                                   err_msg=name)


def test_flash_forward_plain_lse_is_the_rows_logsumexp():
    b, h, hkv, s, d = 2, 4, 2, 11, 16
    q, k, v = _qkv(24, b, h, hkv, s, s, d)
    _, lse = flash_attention_forward_plain(*map(torch.from_numpy, (q, k, v)),
                                           causal=True)
    kk = np.repeat(k, h // hkv, axis=1)
    scores = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                       kk.astype(np.float64)) / np.sqrt(d)
    scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    top = scores.max(-1, keepdims=True)
    want = (top + np.log(np.exp(scores - top).sum(-1, keepdims=True)))[..., 0]
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)


def test_flash_training_route_takes_no_cache_arguments():
    """The training route refuses a cache's ``kv_len``; it takes
    ``q_offset``, a rank's block of a sequence split over the data ranks
    (``tests/test_torch_seq_kernels.py``); the serve route takes both."""
    q = torch.zeros(1, 2, 3, 16, requires_grad=True)
    kv_len = torch.full((1,), 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="training route"):
        ops.flash_attention(q, q, q, True, kv_len=kv_len)
    out = ops.flash_attention(q, q, q, True,
                              q_offset=torch.zeros(1, dtype=torch.int32))
    assert out.requires_grad
    with torch.no_grad():        # the serve route takes them
        ops.flash_attention(q, q, q, True, kv_len=kv_len,
                            q_offset=torch.zeros(1, dtype=torch.int32))


def _visible_lse(q, k, causal, kv_len, q_offset):
    """float64 log-sum-exp of each row's visible scaled scores (b, h, sq),
    +inf for a row that sees no key."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kk = np.repeat(k, h // hkv, axis=1).astype(np.float64)
    scores = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk) / np.sqrt(d)
    kpos = np.arange(skv)
    ok = kpos[None, None, :] < np.asarray(kv_len)[:, None, None]
    if causal:
        qpos = np.arange(sq)[None, :, None] + np.asarray(q_offset)[:, None, None]
        ok = ok & (kpos[None, None, :] <= qpos)
    scores = np.where(ok[:, None], scores, -np.inf)
    top = scores.max(-1, keepdims=True)
    safe = np.where(np.isfinite(top), top, 0.0)
    total = np.exp(scores - safe).sum(-1)
    return np.where(total > 0, safe[..., 0] + np.log(np.maximum(total, 1e-300)),
                    np.inf)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_plain_with_offsets_matches_naive_attention(causal):
    """The forward with the log-sum-exp (the partial route's plain version,
    output unrounded) with a q_offset and a kv_len per sequence: the output
    against the JAX package's ``naive_attention`` on each sequence alone,
    keys cut at kv_len, fp32 2e-5; the log-sum-exp against float64, 1e-5;
    the third sequence's negative offset (a block past its rows) and the
    fourth's kv_len of 0 see no key: zeros and +inf."""
    b, h, hkv, sq, skv, d = 4, 4, 2, 3, 24, 16
    q, k, v = _qkv(31, b, h, hkv, sq, skv, d)
    offsets, lens = [0, 13, -5, 7], [24, 18, 24, 0]
    out, lse = ops.flash_attention_partial(
        *map(torch.from_numpy, (q, k, v)), causal,
        kv_len=torch.tensor(lens, dtype=torch.int32),
        q_offset=torch.tensor(offsets, dtype=torch.int32))
    assert out.dtype == lse.dtype == torch.float32
    assert out.shape == (b, h, sq, d) and lse.shape == (b, h, sq)
    for i in range(2):
        want = naive_attention_jax(
            jnp.asarray(q[i:i + 1].transpose(0, 2, 1, 3)),
            jnp.asarray(k[i:i + 1, :, :lens[i]].transpose(0, 2, 1, 3)),
            jnp.asarray(v[i:i + 1, :, :lens[i]].transpose(0, 2, 1, 3)),
            causal=causal, q_offset=offsets[i])
        np.testing.assert_allclose(out[i:i + 1].numpy().transpose(0, 2, 1, 3),
                                   np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(),
                               _visible_lse(q, k, causal, lens, offsets),
                               rtol=1e-5, atol=1e-5)
    assert out[3].abs().max() == 0 and torch.isinf(lse[3]).all()
    if causal:
        assert out[2].abs().max() == 0 and (lse[2] == math.inf).all()


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-6),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("blocks", [2, 4])
def test_combined_partials_match_the_whole_row(blocks, dtype, atol):
    """A decode row over a cache of 64 keys split into ``blocks`` blocks,
    each block's partial (its keys, q_offset the row's position in it) then
    ``combine_partials`` in block order, against the attention of the
    whole cache; the row at position 20 leaves the last block(s) with no
    visible key, which weigh 0. GQA 4 over 2; fp32 2e-6, bf16 1e-2."""
    from repro_torch.parallel.tensor import combine_partials
    b, h, hkv, skv, d = 2, 4, 2, 64, 16
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(32, b, h, hkv, 1, skv, d))
    pos = torch.tensor([20, 63], dtype=torch.int32)
    whole = flash_attention_plain(q, k, v, True, None, pos)
    rows = skv // blocks
    parts = [ops.flash_attention_partial(
        q, k[:, :, r * rows:(r + 1) * rows], v[:, :, r * rows:(r + 1) * rows],
        True, q_offset=(pos - r * rows).to(torch.int32))
        for r in range(blocks)]
    assert torch.isinf(parts[-1][1][0]).all()            # the empty block
    got = combine_partials(torch.stack([o for o, _ in parts]),
                           torch.stack([lse for _, lse in parts]), dtype)
    assert got.dtype == dtype
    assert (got.float() - whole.float()).abs().max().item() <= atol


def test_flash_partial_route_serves_only():
    q = torch.zeros(1, 2, 1, 16, requires_grad=True)
    with pytest.raises(ValueError, match="serves only"):
        ops.flash_attention_partial(q, q, q, True)


# b, h, hkv, skv, d -> (splits, kernels a call, scratch bytes): the train_lm
# layer keeps one split (768 blocks) and three kernels; a small grid splits
# its group over the smallest divisor that reaches 264 blocks, or the whole
# group, and adds the partials' sum; a group of one never splits.
BWD_PLAN_TABLE = [
    ((8, 9, 3, 2048, 64), (1, 3, 0)),
    ((1, 32, 2, 1024, 128), (16, 4, 2 * 1 * 2 * 16 * 1024 * 128 * 4)),
    ((8, 4, 2, 128, 16), (2, 4, 2 * 8 * 2 * 2 * 128 * 16 * 4)),
    ((2, 6, 2, 130, 64), (3, 4, 2 * 2 * 2 * 3 * 130 * 64 * 4)),
    ((4, 8, 1, 512, 64), (8, 4, 2 * 4 * 1 * 8 * 512 * 64 * 4)),
    ((1, 4, 4, 37, 64), (1, 3, 0)),
    ((4, 8, 2, 1024, 128), (4, 4, 2 * 4 * 2 * 4 * 1024 * 128 * 4)),
]


@pytest.mark.parametrize("shape,want", BWD_PLAN_TABLE)
def test_flash_backward_plan(shape, want):
    b, h, hkv, skv, d = shape
    splits, kernels, scratch = flash_attention_backward_plan(*shape)
    assert (splits, kernels, scratch) == want
    assert (h // hkv) % splits == 0
    blocks = -(-skv // 64) * hkv * b
    # the smallest split that reaches the grid's floor, or the whole group
    assert blocks * splits >= 264 or splits == h // hkv
    assert all(blocks * s < 264 for s in range(1, splits) if h // hkv % s == 0)


@pytest.mark.parametrize("splits", [1, 2, 3, 6])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_stages_plain_is_plain_in_float64(causal, splits):
    """The kernels' decomposition (D, per-split partial dK/dV summed in split
    order, dQ) gives the plain backward's result in fp64."""
    b, h, hkv, s, d = 2, 12, 2, 21, 16
    q, k, v = (torch.from_numpy(a).double() for a in _qkv(25, b, h, hkv, s,
                                                          s, d))
    do = torch.from_numpy(np.random.RandomState(26).randn(b, h, s, d))
    out, lse = flash_attention_forward_plain(q, k, v, causal)
    want = flash_attention_backward_plain(q, k, v, out, lse, do, causal)
    got = flash_attention_backward_stages_plain(q, k, v, out, lse, do, causal,
                                                splits)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group,splits,d", [(3, 3, 64), (4, 2, 64),
                                            (4, 4, 64), (4, 2, 160)])
def test_flash_backward_stages_plain_matches_jax_grad(group, splits, d,
                                                      causal):
    """The decomposition in fp32 against ``jax.grad`` of the reference
    attention, at ``test_flash_backward_plain_matches_jax_grad``'s
    tolerance; at d 64 and at zamba2's d 160."""
    b, hkv, s = 2, 2, 19
    h = hkv * group
    q, k, v = _qkv(20 + group, b, h, hkv, s, s, d)
    cot = np.random.RandomState(21).randn(b, h, s, d).astype(np.float32)
    want = _jax_attention_vjp(q, k, v, cot, causal, "float32")
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, cot))
    out, lse = flash_attention_forward_plain(qt, kt, vt, causal)
    got = flash_attention_backward_stages_plain(qt, kt, vt, out, lse, dot,
                                                causal, splits)
    for name, g, w in zip("qkv", got, want):
        assert _scaled_err(g, w) <= 2e-5, name


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 by bit masking: the low 13 mantissa bits cleared, as
    the kernel splits a value and as the mma reads an fp32 register."""
    bits = x.contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's fp32 route takes it: both split into TF32 hi
    and lo (lo = v - hi, read as TF32), hi lo + lo hi + hi hi summed in
    fp32, lo lo dropped."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def _emulated_backward(q, k, v, o, lse, do, causal):
    """The kernels' roundings on fp32 or bf16 inputs: fp32 products as
    3xTF32; bf16 products of exact bf16 operands in fp32, with P rounded to
    bf16 for dV and dS rounded once to bf16 for dK and dQ; P = 2^(S scale
    log2 e - lse log2 e); results rounded once to the input type. Its sums
    are PyTorch's fp32 products, which round to nearest in their own order:
    it does not model the tensor cores' accumulation, which truncates, nor
    the kernels' order over key and query tiles, so the card's error can
    exceed it (the ``cuda`` cases hold the kernels themselves)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    bf16 = q.dtype == torch.bfloat16
    f = lambda t: t.float()
    mm = (lambda x, y: x @ y) if bf16 else _mm_3xtf32
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    kk = f(k).repeat_interleave(group, dim=1)
    vv = f(v).repeat_interleave(group, dim=1)
    scale, log2e = 1.0 / math.sqrt(d), 1.4426950408889634
    allowed = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        allowed = torch.tril(allowed)
    s = mm(f(q), kk.transpose(-1, -2))
    p = torch.where(allowed, torch.exp2(s * (scale * log2e)
                                        - lse[..., None] * log2e), 0.0)
    delta = (f(do) * f(o)).sum(-1, keepdim=True)
    dp = mm(f(do), vv.transpose(-1, -2))
    ds = p * (dp - delta)
    dv = mm(rnd(p).transpose(-1, -2), f(do))
    dk = mm(rnd(ds).transpose(-1, -2), f(q))
    dq = mm(rnd(ds), kk) * scale
    dk = dk.view(b, hkv, group, skv, d).sum(2) * scale
    dv = dv.view(b, hkv, group, skv, d).sum(2)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("d", [16, 64, 128, 160])
def test_flash_backward_kernel_roundings_hold_the_tolerance(d, dtype, tol):
    """The error budget of the kernels' operand roundings (3xTF32 in fp32;
    P and dS rounded once to bf16 in bf16) at a small causal GQA shape:
    within the card's tolerance of the fp64 backward. The accumulation's
    rounding is not modelled (``_emulated_backward``)."""
    b, h, hkv, s = 2, 6, 2, 70
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(27, b, h, hkv, s,
                                                           s, d))
    do = torch.from_numpy(np.random.RandomState(28).randn(b, h, s, d)
                          .astype(np.float32)).to(dtype)
    out, lse = flash_attention_forward_plain(q, k, v, True)
    exact = flash_attention_backward_plain(*(t.double() for t in (q, k, v,
                                                                  out)),
                                           lse.double(), do.double(), True)
    got = _emulated_backward(q, k, v, out, lse, do, True)
    for name, g, w in zip("qkv", got, exact):
        assert _scaled_err(g, w.numpy()) <= tol, name


def _emulated_forward(q, k, v, causal, kv_len=None, q_offset=None):
    """The fp32 forward kernel's roundings (``flash_tf32_kernel``): Q K^T
    and P V as 3xTF32 (``_mm_3xtf32``) over key tiles of 64 (32 at d 128);
    the online softmax tile by tile in the kernel's order, in the log2
    domain (m = max(m, tile max of S times scale log2 e), P = 2^(S scale
    log2 e - m) with one rounding, l and acc rescaled by 2^(m_old - m) before
    the tile's terms are added); each tile's P V summed alone and then added
    to acc; the output acc / max(l, 1e-30) and lse = m ln 2 + ln l (+inf
    where l is 0). Returns (out, lse), fp32. Not modelled: the tensor cores'
    accumulation inside a tile's product, which truncates where PyTorch's
    fp32 products round to nearest; the order of the sums inside a tile
    (the kernel sums a lane's share of l, then a quad's); ``ex2.approx``'s
    error (~2 ulp). The ``cuda`` cases hold the kernel itself."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kk = k.repeat_interleave(h // hkv, dim=1)
    vv = v.repeat_interleave(h // hkv, dim=1)
    allowed = _visible(b, sq, skv, causal, kv_len, q_offset)[:, None]
    sl = (torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
          * torch.tensor(1.4426950408889634, dtype=torch.float32))
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    bn = 32 if d == 128 else 64
    for k0 in range(0, skv, bn):
        s = _mm_3xtf32(q, kk[:, :, k0:k0 + bn].transpose(-1, -2))
        s = torch.where(allowed[..., k0:k0 + bn], s, -1e30)
        top = s.amax(-1, keepdim=True)
        mn = torch.maximum(m, torch.where(top == -1e30, -1e30, top * sl))
        mu = torch.where(mn == -1e30, 0.0, mn)
        alpha = torch.exp2(m - mu)
        p = torch.exp2((s.double() * sl.double() - mu.double()).float())
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm_3xtf32(p, vv[:, :, k0:k0 + bn])
        m = mn
    out = acc * (1.0 / torch.clamp(l, min=1e-30))
    lse = torch.where(l > 0, m * math.log(2.0) + torch.log(l), math.inf)
    return out, lse[..., 0]


def _visible(b, sq, skv, causal, kv_len=None, q_offset=None):
    """(b, sq, skv) bool: the keys each query row may see."""
    kpos = np.arange(skv)[None, None, :]
    lens = np.full(b, skv) if kv_len is None else np.asarray(kv_len)
    offs = np.zeros(b, int) if q_offset is None else np.asarray(q_offset)
    seen = np.broadcast_to(kpos < lens[:, None, None], (b, sq, skv))
    if causal:
        seen = seen & (kpos <= np.arange(sq)[None, :, None]
                       + offs[:, None, None])
    return torch.from_numpy(np.ascontiguousarray(seen))


def _lse_f64(q, k, seen):
    """Each row's log-sum-exp of its visible scaled scores in fp64 (+inf
    for a row with none)."""
    kk = np.repeat(k, q.shape[1] // k.shape[1], axis=1).astype(np.float64)
    scores = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk)
    scores = np.where(seen[:, None], scores / np.sqrt(q.shape[-1]), -np.inf)
    top = scores.max(-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        lse = top[..., 0] + np.log(np.exp(scores - top).sum(-1))
    return np.where(seen.any(-1)[:, None], lse, np.inf)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_forward_kernel_roundings_hold_the_tolerance(d, causal):
    """The fp32 forward kernel's roundings (``_emulated_forward``) at a GQA
    group of 3 with a ragged last key tile (70 keys: 64 + 6, or 2 x 32 + 6
    at d 128) against the JAX package's ``naive_attention`` and its Pallas
    kernel in interpret mode, fp32 2e-5; the log-sum-exp within 1e-4 of
    the fp64 one."""
    b, h, hkv, s = 2, 6, 2, 70
    q, k, v = _qkv(29, b, h, hkv, s, s, d)
    out, lse = _emulated_forward(*map(torch.from_numpy, (q, k, v)), causal)
    tr = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))
    naive = np.asarray(naive_attention_jax(tr(q), tr(k), tr(v),
                                           causal=causal))
    pallas = np.asarray(flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=64, block_k=64, interpret=True))
    np.testing.assert_allclose(out.numpy(), naive.transpose(0, 2, 1, 3),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), pallas, atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _lse_f64(q, k, _visible(
        b, s, s, causal).numpy()), atol=1e-4, rtol=0)


def test_flash_forward_kernel_roundings_with_offset_and_kv_len():
    """The serving route's arguments through the fp32 forward's roundings
    at d 128: a chunk of 40 rows into a cache, each sequence with its own
    q_offset and kv_len, against ``naive_attention`` on each sequence alone
    (keys cut at kv_len), fp32 2e-5; the third sequence has no key and
    gives zeros and an lse of +inf."""
    b, h, hkv, sq, skv, d = 3, 4, 2, 40, 100, 128
    offsets, lens = [60, 10, 0], [100, 45, 0]
    q, k, v = _qkv(30, b, h, hkv, sq, skv, d)
    out, lse = _emulated_forward(*map(torch.from_numpy, (q, k, v)), True,
                                 kv_len=lens, q_offset=offsets)
    for i in range(2):
        want = naive_attention_jax(
            jnp.asarray(q[i:i + 1].transpose(0, 2, 1, 3)),
            jnp.asarray(k[i:i + 1, :, :lens[i]].transpose(0, 2, 1, 3)),
            jnp.asarray(v[i:i + 1, :, :lens[i]].transpose(0, 2, 1, 3)),
            causal=True, q_offset=offsets[i])
        np.testing.assert_allclose(out[i:i + 1].numpy().transpose(0, 2, 1, 3),
                                   np.asarray(want), atol=2e-5, rtol=0)
    seen = _visible(b, sq, skv, True, lens, offsets).numpy()
    np.testing.assert_allclose(lse[:2].numpy(), _lse_f64(q, k, seen)[:2],
                               atol=1e-4, rtol=0)
    assert out[2].abs().max() == 0 and torch.isinf(lse[2]).all()


@pytest.mark.parametrize("changed", ["mma.cuh", "attn_warp.cuh",
                                     "flash_attention_backward.cu"])
def test_build_digest_covers_sources_and_headers(tmp_path, changed):
    """The library's tag changes when a header changes, not only a source,
    so a stale library under build/ is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = _build._source_digest(csrc)
    assert before == _build._source_digest(_build.CSRC)
    path = csrc / changed
    path.write_text(path.read_text() + "\n// changed\n")
    assert _build._source_digest(csrc) != before


RMS_GRAD_TABLE = [((4, 64), "float32"), ((3, 17, 128), "float32"),
                  ((2, 100, 576), "float32"), ((2, 100, 256), "bfloat16"),
                  ((5, 576), "bfloat16"), ((3, 7, 100), "bfloat16")]


@pytest.mark.parametrize("shape,dtype", RMS_GRAD_TABLE)
def test_rmsnorm_backward_plain_matches_jax_grad(shape, dtype):
    """dx and dgamma through ``ops.rmsnorm``'s autograd Function on the CPU
    against ``jax.grad`` of the JAX package's ``rms_norm``: fp32 1e-5, bf16
    1e-2, of each gradient's largest magnitude."""
    rs = np.random.RandomState(25)
    x = rs.randn(*shape).astype(np.float32)
    g = (1.0 + 0.2 * rs.randn(shape[-1])).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    tol = 1e-5 if dtype == "float32" else 1e-2
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    out, vjp = jax.vjp(lambda a, b_: rms_norm_jax(a, b_),
                       jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt))
    want = vjp(jnp.asarray(dy).astype(jdt))
    xt, gt = _torch_leaf(x, dtype), _torch_leaf(g, dtype)
    got = ops.rmsnorm(xt, gt)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(out.astype(jnp.float32)),
                               atol=tol * 4)
    got.backward(torch.from_numpy(dy).to(got.dtype))
    for name, leaf, w in (("dx", xt, want[0]), ("dgamma", gt, want[1])):
        assert leaf.grad.dtype == leaf.dtype
        assert _scaled_err(leaf.grad, np.asarray(w.astype(jnp.float32))) <= tol, name


def test_rmsnorm_backward_plain_is_autograd_in_float64():
    rs = np.random.RandomState(26)
    x = torch.from_numpy(rs.randn(3, 5, 48)).requires_grad_(True)
    g = torch.from_numpy(rs.randn(48)).requires_grad_(True)
    dy = torch.from_numpy(rs.randn(3, 5, 48))
    rmsnorm_plain(x, g).backward(dy)
    dx, dg = rmsnorm_backward_plain(x.detach(), g.detach(), dy)
    np.testing.assert_allclose(dx.numpy(), x.grad.numpy(), atol=1e-13)
    np.testing.assert_allclose(dg.numpy(), g.grad.numpy(), atol=1e-13)


# (rows, d): one row; few wide rows (chip_smoke.py's (2, 64, 4096)); the
# train_lm rows; a chatglm3/minitron-width training layer; internlm2's
# width; rows that are not whole 16-byte units; ragged rows of 576; the
# widest row the kernels take today's callers to (14,528) and their limit
ROWS_PLAN_TABLE = [(1, 64), (1, 576), (128, 4096), (16_384, 576),
                   (16_384, 4096), (4, 6144), (21, 100), (111, 576),
                   (2, 14_528), (3, 16_384), (5000, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", ROWS_PLAN_TABLE)
def test_rmsnorm_backward_plan_covers_rows_and_columns_once(rows, d, dtype):
    """The plan is a function of the shape alone; its teams walk every row
    exactly once and a team's lanes hold every 16-byte unit of a row
    exactly once; a block is at most 8 warps, a lane at most 4 fp32 / 3
    bf16 units (16 / 8 at the widest rows), the grid at most one wave and,
    rows allowing, a block an SM; 128 rows of 4096 spread over 128 SMs."""
    plan = rmsnorm_backward_plan(rows, d, dtype)
    assert plan == rmsnorm_backward_plan(rows, d, dtype)
    per = 16 // dtype.itemsize
    assert plan.per == per and plan.units * per >= d > (plan.units - 1) * per
    seen = [r for b in range(plan.blocks) for t in range(plan.teams)
            for r in plan.team_rows(b, t)]
    assert sorted(seen) == list(range(rows))
    cols = [u for w in range(plan.team_warps) for lane in range(32)
            for u in plan.lane_units_of(w, lane)]
    assert sorted(cols) == list(range(plan.units))
    assert plan.team_warps in (1, 2, 4, 8)
    assert plan.teams * plan.team_warps <= 8
    assert plan.lane_units <= (16 if dtype == torch.float32 else 8)
    assert plan.blocks <= 132 * 2 * 8 // (plan.teams * plan.team_warps)
    assert plan.part_shape == (plan.blocks, plan.units * per)
    assert (plan.lane_units <= (4 if dtype == torch.float32 else 3)
            or plan.team_warps == 8)
    if rows >= 132:
        assert plan.blocks >= min(132, rows // plan.teams)
    if (rows, d) == (128, 4096):
        assert plan.blocks == 128 and plan.team_warps == 8


def _kernel_bwd_registers(np_: int, itemsize: int) -> dict:
    """``BwdRegs<T, NP>`` of ``csrc/rmsnorm.cu``, its lines evaluated in
    order as Python (``a ? b : c`` as ``b if a else c``)."""
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    body = re.search(r"struct BwdRegs \{(.*?)\};", src, re.S).group(1)
    env = {"NP": np_}
    for name, expr in re.findall(
            r"static constexpr (?:int|bool) (\w+) = (.+?);", body):
        expr = expr.replace("sizeof(T)", str(itemsize)).replace("/", "//")
        expr = re.sub(r"(.+?) \? (.+?) : (.+)", r"(\2 if \1 else \3)", expr)
        env[name] = eval(expr, {}, env)
    return env


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_plan_registers_match_the_kernels(dtype):
    """The plan's register reckoning (``_bwd_registers``: blocks an SM, the
    next row loaded early) is the kernel's ``BwdRegs`` (its launch bounds
    and early load) for every number of units a lane can hold."""
    for np_ in range(1, 17):
        regs = _kernel_bwd_registers(np_, dtype.itemsize)
        assert regs["PER"] == 16 // dtype.itemsize
        assert _bwd_registers(np_, regs["PER"]) == (
            regs["MIN_BLOCKS"], regs["PREFETCH"]), np_


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf in fp32: the product exact, one rounding of the sum."""
    return (a.double() * b.double() + c.double()).float()


def _emulated_rmsnorm_backward(x, gamma, dy, plan, eps=1e-5):
    """(dx, dgamma) as the two kernels sum them on ``plan``, fp32 inputs:
    each row's rstd from its sum of squares; dx = rstd (dy gamma - x^
    mean(g x^)); dgamma: each team's lanes fma dy x^ over the team's rows
    in order into fp32 sums, the block adds its teams' sums in team order
    into its partial row, and the dgamma kernel's warp w of 8 adds partial
    rows w, w + 8, ... in order, then the 8 warps' sums in order. Not
    modelled: the order of the row's two sums over lanes and warps."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    dyf = dy.reshape(-1, d).float()
    gf = gamma.float()
    rstd = 1.0 / torch.sqrt(xf.square().sum(-1, keepdim=True) / d + eps)
    xh = xf * rstd
    mean_gx = (dyf * gf * xf).sum(-1, keepdim=True) * rstd / d
    dx = rstd * _fma(dyf, gf.expand_as(dyf), -(xh * mean_gx))
    blocks = torch.arange(plan.blocks)[:, None]
    part = None
    for t in range(plan.teams):
        acc = torch.zeros(plan.blocks, d)
        for k in range(-(-plan.rows_per_block // plan.teams)):
            row = blocks * plan.rows_per_block + t + k * plan.teams
            end = torch.clamp((blocks + 1) * plan.rows_per_block, max=plan.rows)
            live = row < end
            r = torch.where(live, row, 0)[:, 0]
            acc = torch.where(live, _fma(dyf[r], xh[r], acc), acc)
        part = acc if part is None else part + acc
    total = None
    for w in range(8):
        s = torch.zeros(d)
        for p_ in range(w, plan.blocks, 8):
            s = s + part[p_]
        total = s if total is None else total + s
    return dx.reshape(x.shape), total


@pytest.mark.parametrize("shape", [(6000, 64), (2, 64, 4096), (3, 7, 100),
                                   (4, 2048, 576), (2, 6144)])
def test_rmsnorm_backward_kernel_order_matches_jax_grad(shape):
    """The kernels' summation order on the fp32 plan
    (``_emulated_rmsnorm_backward``) against ``jax.grad`` of the JAX
    package's ``rms_norm``: dx and dgamma within 1e-5 of each gradient's
    largest magnitude. (6000, 64): eight teams a block, three rows a team;
    (4, 2048, 576): the train_lm rows' plan at half the rows."""
    rs = np.random.RandomState(43)
    x = rs.randn(*shape).astype(np.float32)
    g = (1.0 + 0.2 * rs.randn(shape[-1])).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b_: rms_norm_jax(a, b_), jnp.asarray(x),
                     jnp.asarray(g))
    want = vjp(jnp.asarray(dy))
    plan = rmsnorm_backward_plan(x.size // shape[-1], shape[-1],
                                 torch.float32)
    got = _emulated_rmsnorm_backward(*map(torch.from_numpy, (x, g, dy)), plan)
    for name, a, w in zip(("dx", "dgamma"), got, want):
        assert _scaled_err(a, np.asarray(w)) <= 1e-5, name


def test_cpu_backward_calls_do_not_count_as_launches():
    before = (ops.flash_attention.launches,
              ops.flash_attention.backward_launches,
              ops.rmsnorm.launches, ops.rmsnorm.backward_launches)
    q = torch.zeros(1, 1, 2, 64, requires_grad=True)
    ops.flash_attention(q, q, q).sum().backward()
    x = torch.ones(2, 8, requires_grad=True)
    ops.rmsnorm(x, torch.ones(8, requires_grad=True)).sum().backward()
    assert (ops.flash_attention.launches,
            ops.flash_attention.backward_launches,
            ops.rmsnorm.launches, ops.rmsnorm.backward_launches) == before


def test_backward_launch_functions_refuse_cpu_tensors():
    q = torch.zeros(1, 1, 2, 64)
    lse = torch.zeros(1, 1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_lse_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_backward_cuda(q, q, q, q, lse, q)
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_backward_cuda(x, torch.ones(8), x)


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
    # d 128 with a ragged last tile of 32 keys, causal and not
    (2, 6, 2, 77, 77, 128, True, None, None),
    (1, 4, 1, 100, 100, 128, False, None, None),
    # a chunk of 40 rows into a cache
    (2, 4, 2, 40, 200, 128, True, [160, 37], [200, 77]),
    # a chunk of 70 rows at d 64; a sequence with no key gives zeros
    (2, 9, 3, 70, 300, 64, True, [230, 5], [300, 60]),
    (2, 4, 2, 20, 50, 64, False, None, [50, 0]),
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


# The partial route (serving over a cache split along its sequence): b, h,
# hkv, sq, skv, d, causal, q_offset, kv_len. zamba2's decode row (32 heads of
# 160), a GQA row at d 64 (smollm's 9 over 3), a row past the block and a row
# before it (no visible key: zeros, +inf), a cross-attention chunk of 40
# rows (the prefill kernels, not causal), a kv_len.
FLASH_PARTIAL_TABLE = [
    (1, 32, 32, 1, 4096, 160, True, [3000], None),
    (4, 9, 3, 1, 2048, 64, True, [2047, 700, 5000, -3], None),
    (2, 32, 32, 1, 1024, 160, True, [-1, 1023], None),
    (2, 8, 2, 40, 300, 128, False, None, None),
    (2, 9, 3, 1, 512, 64, True, [400, 100], [300, 512]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,q_off,lens",
                         FLASH_PARTIAL_TABLE)
def test_flash_partial_kernel_matches_plain(cuda_device, dtype, rtol, b, h,
                                            hkv, sq, skv, d, causal, q_off,
                                            lens):
    """The partial route on the card (the decode kernels writing the
    log-sum-exp at sq <= 8, fp32 output) against its plain version: the
    output within ``rtol`` of the plain output's largest magnitude (rows
    over thousands of unit-normal keys average to ~1e-2, under an absolute
    bf16 tolerance), exact zeros where a row sees no key, the log-sum-exp
    within 1e-4, +inf at the same rows."""
    q, k, v, offset, kv_len = _flash_cuda_case(cuda_device, dtype, b, h, hkv,
                                               sq, skv, d, q_off, lens)
    before = ops.flash_attention_partial.launches
    got, lse = ops.flash_attention_partial(q, k, v, causal, kv_len, offset)
    torch.cuda.synchronize()
    assert ops.flash_attention_partial.launches == before + 1
    want, want_lse = flash_attention_forward_plain(q, k, v, causal, kv_len,
                                                   offset, unrounded=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= rtol * want.abs().max().item()
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    finite = torch.isfinite(want_lse)
    assert (got[~finite] == 0).all()
    assert (lse[finite] - want_lse[finite]).abs().max().item() <= 1e-4


# b, h, hkv, sq, skv, causal, q_offset, kv_len at head_dim 160: each of the
# four forward kernels (bf16 and fp32 prefill, bf16 and fp32 decode), zamba2's
# MHA decode tick (group 1: one query row a block), its prefill, a GQA group
# and a chunk into a cache with both per-sequence arguments.
FLASH_D160_TABLE = [
    (8, 32, 32, 1, 2048, True, [1999, 5, 700, 1024, 31, 32, 2047, 1500], None),
    (1, 32, 32, 1024, 1024, True, None, None),
    (1, 4, 4, 130, 130, True, None, None),
    (2, 4, 2, 77, 77, False, None, None),
    (2, 8, 2, 3, 300, False, None, [300, 1]),
    (2, 4, 2, 40, 200, True, [160, 37], [200, 77]),
    (4, 6, 3, 1, 256, True, [0, 0, 255, 100], [1, 1, 1, 256]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,hkv,sq,skv,causal,q_off,lens",
                         FLASH_D160_TABLE)
def test_flash_kernel_at_head_dim_160_matches_plain(
        cuda_device, dtype, atol, b, h, hkv, sq, skv, causal, q_off, lens):
    q, k, v, offset, kv_len = _flash_cuda_case(cuda_device, dtype, b, h, hkv,
                                               sq, skv, 160, q_off, lens)
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
def test_flash_decode_clusters_at_head_dim_160(cuda_device, dtype, atol,
                                               cluster):
    """Each cluster that fits a block gives the plain result; one that does
    not (8 blocks, bf16) is refused before anything is launched."""
    from repro_torch.kernels.flash_attention import decode_cluster_fits
    offsets = [1999, 5, 700, 1024, 31, 32, 2047, 1500]
    q, k, v, offset, _ = _flash_cuda_case(cuda_device, dtype, 8, 32, 32, 1,
                                          2048, 160, offsets, None)
    if not decode_cluster_fits(160, dtype, 1, cluster):
        with pytest.raises(ValueError, match="shared memory"):
            flash_attention_cuda(q, k, v, True, None, offset,
                                 decode_cluster=cluster)
        return
    got = flash_attention_cuda(q, k, v, True, None, offset,
                               decode_cluster=cluster)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, True, None, offset)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,causal", [(2, 4, 4, 130, True),
                                              (1, 8, 2, 77, False)])
def test_flash_training_route_at_head_dim_160_matches_plain(
        cuda_device, dtype, b, h, hkv, s, causal):
    """The training route at zamba2's head dim (through ``ops``' autograd
    Function: the forward with the log-sum-exp and the backward, each
    counted once) against the plain route (autograd through the plain
    versions) on the same inputs: the output and dq, dk, dv."""
    q, k, v, do = _flash_train_inputs(cuda_device, dtype, b, h, hkv, s, 160,
                                      seed=42)
    grads = {}
    for route in ("kernel", "plain"):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        before = (ops.flash_attention.launches,
                  ops.flash_attention.backward_launches)
        out = (ops.flash_attention(*leaves, causal=causal) if route == "kernel"
               else flash_attention_plain(*leaves, causal))
        out.backward(do)
        torch.cuda.synchronize()
        launched = (ops.flash_attention.launches - before[0],
                    ops.flash_attention.backward_launches - before[1])
        assert launched == ((1, 1) if route == "kernel" else (0, 0))
        grads[route] = [out.detach()] + [t.grad for t in leaves]
    for name, g, w in zip(("out", "dq", "dk", "dv"), grads["kernel"],
                          grads["plain"]):
        assert g.dtype == dtype and g.shape == w.shape
        assert _grad_err(g, w) <= BWD_TOL[dtype], name


@pytest.mark.cuda
def test_flash_training_route_refuses_a_head_dim_it_does_not_take(
        cuda_device):
    """96 is in neither route's head dims: the training route raises
    rather than launch a kernel it has not, and the backward's entry
    too."""
    q = torch.zeros((1, 2, 16, 96), device=cuda_device, requires_grad=True)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q)
    x = q.detach()
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_backward_cuda(x, x, x, x, torch.zeros(
            (1, 2, 16), device=cuda_device), x)


@pytest.mark.cuda
def test_ssd_scan_refuses_a_gradient_on_the_card(cuda_device):
    """A call that wants a gradient is no longer refused: with any one
    input requiring grad it takes the training route (the forward's kernels
    and, on backward, the backward's, each counted once) and that input's
    gradient is the closed form's; under no_grad, and with no input that
    requires grad, it launches the forward only. What the card still
    refuses on this route is a head_dim the backward does not take."""
    rs = np.random.RandomState(22)
    b, s, h, p, g, n = 1, 40, 2, 16, 1, 16
    x = torch.from_numpy(rs.randn(b, s, h, p).astype(np.float32)).to(
        cuda_device)
    dt = torch.from_numpy(rs.rand(b, s, h).astype(np.float32)).to(cuda_device)
    A = -torch.from_numpy(rs.rand(h).astype(np.float32) + 0.5).to(cuda_device)
    B, C = (torch.from_numpy(rs.randn(b, s, g, n).astype(np.float32)).to(
        cuda_device) for _ in range(2))
    dy = torch.from_numpy(rs.randn(b, s, h, p).astype(np.float32)).to(
        cuda_device)
    want = ssd_scan_backward_plain(x, dt, A, B, C, dy, None, 16)
    before = (ops.ssd_scan.launches, ops.ssd_scan.backward_launches)
    for wants in range(5):
        ins = [x, dt, A, B, C]
        ins[wants] = ins[wants].clone().requires_grad_()
        y, _ = ops.ssd_scan(*ins, 16)
        (y * dy).sum().backward()
        got, ref = ins[wants].grad, want[wants]
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
        with torch.no_grad():
            y, _ = ops.ssd_scan(*ins, 16)
        assert not y.requires_grad
    assert (ops.ssd_scan.launches, ops.ssd_scan.backward_launches) == (
        before[0] + 10, before[1] + 5)
    ops.ssd_scan(x, dt, A, B, C, 16)
    assert ops.ssd_scan.launches == before[0] + 11
    wide = torch.zeros((b, s, h, 128), device=cuda_device,
                       requires_grad=True)
    with pytest.raises(ValueError, match="head_dim"):
        ops.ssd_scan(wide, dt, A, B, C, 16)


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


# ------------------------------------------------------------------------- #
# On the card: the training route's kernels against the plain versions.
# ------------------------------------------------------------------------- #

# b, h, hkv, s, d, causal (training: sq == skv, no kv_len, no q_offset):
# smollm-135m's layer at the train phase's length, a chatglm3-like d 128,
# ragged tiles, non-causal, and short rows, which the serve route sends to the
# decode kernels and the training route to the prefill kernels; then the
# reduced configs' head_dim 16 (the training route's alone). Then a group
# of 8 split over 8 blocks with a ragged key tile, head_dim 16 with its group
# split, and ragged key tiles of the fp32 forward at d 128 (32 keys) and
# d 16 (64 keys), causal and not.
FLASH_BWD_CUDA_TABLE = [
    (8, 9, 3, 2048, 64, True),
    (2, 32, 2, 512, 128, True),
    (1, 4, 4, 37, 64, True),
    (2, 6, 2, 130, 64, False),
    (2, 4, 1, 100, 128, False),
    (3, 6, 3, 2, 64, True),
    (2, 9, 3, 8, 64, True),
    (2, 8, 2, 5, 128, True),
    (4, 4, 2, 32, 16, True),
    (2, 4, 2, 130, 16, False),
    (3, 4, 4, 70, 16, True),
    (2, 4, 2, 5, 16, True),
    (1, 16, 2, 300, 64, True),
    (2, 8, 2, 200, 16, True),
    (2, 6, 2, 77, 128, True),
    (1, 3, 3, 33, 16, False),
    # zamba2's head dim 160: its training layer (32 heads, MHA, s 2048), a
    # ragged tile, a GQA group not causal, short rows, a group split over
    # blocks with ragged 32-row tiles
    (2, 32, 32, 2048, 160, True),
    (1, 4, 4, 37, 160, True),
    (2, 8, 2, 130, 160, False),
    (2, 4, 4, 5, 160, True),
    (1, 16, 2, 77, 160, True),
]
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _grad_err(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = max(want.float().abs().max().item(), 1e-30)
    return (got.float() - want.float()).abs().max().item() / scale


def _flash_train_inputs(device, dtype, b, h, hkv, s, d, seed=40):
    """q, k, v as transposed views of (b, s, heads, d), as the model hands
    them over, and an output gradient in the same layout."""
    rs = np.random.RandomState(seed)
    draw = lambda heads: torch.from_numpy(
        rs.randn(b, s, heads, d).astype(np.float32)).to(
            device, dtype).transpose(1, 2)
    return draw(h), draw(hkv), draw(hkv), draw(h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d,causal", FLASH_BWD_CUDA_TABLE)
def test_flash_backward_kernel_matches_plain(cuda_device, dtype, b, h, hkv, s,
                                             d, causal):
    """The forward with lse against the plain forward, and the backward's
    dq, dk, dv against the plain backward on the same o and lse; three
    backward calls bitwise equal."""
    q, k, v, do = _flash_train_inputs(cuda_device, dtype, b, h, hkv, s, d)
    out, lse = flash_attention_lse_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    want_out, want_lse = flash_attention_forward_plain(q, k, v, causal)
    assert (out.float() - want_out.float()).abs().max().item() <= BWD_TOL[dtype]
    assert (lse - want_lse).abs().max().item() <= 1e-4 * max(
        1.0, want_lse.abs().max().item())
    got = flash_attention_backward_cuda(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    want = flash_attention_backward_plain(q, k, v, out, lse, do, causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert _grad_err(g, w) <= BWD_TOL[dtype], name
    for _ in range(2):
        again = flash_attention_backward_cuda(q, k, v, out, lse, do, causal)
        assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_training_forward_is_deterministic(cuda_device, dtype):
    """At the train_lm layer (b 8, h 9, hkv 3, s 2048, d 64, causal) three
    calls of the forward with the log-sum-exp give the same bits."""
    q, k, v, _ = _flash_train_inputs(cuda_device, dtype, 8, 9, 3, 2048, 64)
    first = flash_attention_lse_cuda(q, k, v, True)
    for _ in range(2):
        again = flash_attention_lse_cuda(q, k, v, True)
        assert all(torch.equal(a, b_) for a, b_ in zip(again, first))


# The reduced configs' serving at head_dim 16 (b, h, hkv, sq, skv, causal,
# q_offset, kv_len): their decode tick (4 slots, 4 heads over 2 KV heads,
# the cache up to 128 rows; one slot at row 0, one at the end), a ragged
# prefill into the cache's first rows, short prompts (the decode kernels up to
# 8 rows), a chunk into a cache with both per-sequence arguments, a
# non-causal row and a sequence with no key.
FLASH_D16_TABLE = [
    (4, 4, 2, 1, 128, True, [0, 17, 64, 127], None),
    (1, 4, 2, 23, 128, True, [0], [23]),
    (2, 4, 2, 5, 24, True, None, None),
    (2, 4, 2, 8, 8, True, None, None),
    (2, 4, 2, 40, 200, True, [160, 37], [200, 77]),
    (3, 4, 4, 1, 96, False, None, [96, 1, 0]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,hkv,sq,skv,causal,q_off,lens", FLASH_D16_TABLE)
def test_flash_serve_route_at_head_dim_16_matches_plain(
        cuda_device, dtype, atol, b, h, hkv, sq, skv, causal, q_off, lens):
    """The serving entry point at the reduced configs' head dim: the decode
    kernels (sq <= 8) and the prefill kernels without the log-sum-exp,
    counted once, against the plain version."""
    q, k, v, offset, kv_len = _flash_cuda_case(cuda_device, dtype, b, h, hkv,
                                               sq, skv, 16, q_off, lens)
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
@pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4)])
def test_flash_decode_clusters_at_head_dim_16(cuda_device, dtype, atol,
                                              cluster, h, hkv):
    """Every decode cluster fits at d 16 and gives the plain result: the
    reduced tick's GQA group (two rows a KV head) and MHA (one row: the
    fp32 kernel's one-row blocks), over 128 keys (4 tiles: a cluster of 8
    is clamped to 4) and over 512."""
    from repro_torch.kernels.flash_attention import decode_cluster_fits
    assert decode_cluster_fits(16, dtype, h // hkv, cluster)
    for skv, offsets in ((128, [0, 17, 64, 127]), (512, [511, 3, 300, 40])):
        q, k, v, offset, _ = _flash_cuda_case(cuda_device, dtype, 4, h, hkv,
                                              1, skv, 16, offsets, None)
        got = flash_attention_cuda(q, k, v, True, None, offset,
                                   decode_cluster=cluster)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, True, None, offset)
        assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,h,hkv,sq,skv,causal,q_off,lens", [
    (4, 4, 2, 1, 128, True, [127, 40, 300, -1], None),
    (2, 4, 2, 1, 64, True, [20, 63], [64, 10]),
    (2, 4, 2, 24, 96, True, [50, 0], None),
])
def test_flash_partial_route_at_head_dim_16_matches_plain(
        cuda_device, dtype, rtol, b, h, hkv, sq, skv, causal, q_off, lens):
    """The partial route at d 16 (the decode kernels writing the
    log-sum-exp and an fp32 output at sq <= 8, the prefill kernels above),
    held as ``test_flash_partial_kernel_matches_plain`` holds d 64: a row
    past its block, one before it (zeros, +inf), a kv_len."""
    q, k, v, offset, kv_len = _flash_cuda_case(cuda_device, dtype, b, h, hkv,
                                               sq, skv, 16, q_off, lens)
    before = ops.flash_attention_partial.launches
    got, lse = ops.flash_attention_partial(q, k, v, causal, kv_len, offset)
    torch.cuda.synchronize()
    assert ops.flash_attention_partial.launches == before + 1
    want, want_lse = flash_attention_forward_plain(q, k, v, causal, kv_len,
                                                   offset, unrounded=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= rtol * want.abs().max().item()
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    finite = torch.isfinite(want_lse)
    assert (got[~finite] == 0).all()
    assert (lse[finite] - want_lse[finite]).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [2, 3, 5, 8, 9, 65])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_short_causal_prefill_both_routes(cuda_device, dtype, s, d):
    """A causal prefill of 2-65 tokens with no q_offset and skv == sq: the
    serve route (the decode kernels up to 8 tokens, the prefill kernels
    above) and, with grad, the training route (the prefill kernels)
    forward, and its backward, against the plain versions; the autograd
    Function counts one launch each way."""
    q, k, v, do = _flash_train_inputs(cuda_device, dtype, 2, 9, 3, s, d,
                                      seed=41)
    want = flash_attention_plain(q, k, v, True)
    with torch.no_grad():
        served = ops.flash_attention(q, k, v, True)
    assert (served.float() - want.float()).abs().max().item() <= BWD_TOL[dtype]
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    before = (ops.flash_attention.launches,
              ops.flash_attention.backward_launches)
    out = ops.flash_attention(*leaves, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches,
            ops.flash_attention.backward_launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert (out.float() - want.float()).abs().max().item() <= BWD_TOL[dtype]
    _, lse = flash_attention_forward_plain(q, k, v, True)
    grads = flash_attention_backward_plain(q, k, v, out.detach(), lse, do,
                                           True)
    for name, leaf, w in zip("qkv", leaves, grads):
        assert _grad_err(leaf.grad, w) <= BWD_TOL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,offset", [
    ((8, 2048, 576), 0), ((3, 37, 576), 0), ((2, 5, 4096), 0),
    ((3, 7, 100), 0), ((1, 1, 64), 0), ((2, 64, 4096), 0), ((4, 6144), 0),
    ((2, 14_528), 0),
    # x's storage one element in: not 16-byte aligned, the scalar route
    ((3, 37, 576), 1), ((2, 64, 4096), 1)])
def test_rmsnorm_backward_kernel_matches_plain(cuda_device, dtype, tol, shape,
                                               offset):
    """dx and dgamma against the plain backward, each within ``tol`` of its
    largest magnitude; three calls bitwise equal; the autograd Function
    counts one launch each way and gives the same bits on an aligned copy
    of x (where x is one element in, the 16-byte route's bits against the
    scalar route's, on the same plan)."""
    rs = np.random.RandomState(42)
    n = int(np.prod(shape))
    x = torch.empty(n + offset, device=cuda_device, dtype=dtype)[offset:]
    x = x.view(shape)
    x.copy_(torch.from_numpy(rs.randn(*shape).astype(np.float32)))
    g = torch.from_numpy((1 + 0.2 * rs.randn(shape[-1])).astype(
        np.float32)).to(cuda_device, dtype)
    dy = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        cuda_device, dtype)
    got = rmsnorm_backward_cuda(x, g, dy)
    torch.cuda.synchronize()
    want = rmsnorm_backward_plain(x, g, dy)
    for name, a, w in zip(("dx", "dgamma"), got, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert _grad_err(a, w) <= tol, name
    for _ in range(2):
        again = rmsnorm_backward_cuda(x, g, dy)
        assert all(torch.equal(a, b_) for a, b_ in zip(again, got))
    xl, gl = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    before = ops.rmsnorm.launches, ops.rmsnorm.backward_launches
    ops.rmsnorm(xl, gl).backward(dy)
    assert (ops.rmsnorm.launches, ops.rmsnorm.backward_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(xl.grad, got[0]) and torch.equal(gl.grad, got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
# each a layout of its own on rmsnorm_backward_plan: several teams a block
# walking several rows each; a block a row of 8-warp teams; few narrow rows;
# eight one-warp teams a block with a short last block; a block a row of
# 2- / 1-warp teams; the widest units a lane (16 fp32, 8 bf16)
@pytest.mark.parametrize("shape", [(16_384, 576), (128, 4096), (21, 100),
                                   (5000, 64), (111, 576), (3, 16_384)])
def test_rmsnorm_backward_stages_give_the_whole_call(cuda_device, dtype, tol,
                                                      shape):
    """The two stages launched one at a time give the whole call's bits,
    and the whole call is within ``tol`` of the plain backward."""
    rs = np.random.RandomState(44)
    x, dy = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        cuda_device, dtype) for _ in range(2))
    g = torch.from_numpy((1 + 0.2 * rs.randn(shape[-1])).astype(
        np.float32)).to(cuda_device, dtype)
    assert RMS_BACKWARD_KERNELS_PER_CALL == len(RMS_BACKWARD_STAGES) == 2
    whole = rmsnorm_backward_cuda(x, g, dy)
    bufs = rmsnorm_backward_buffers(x, g)
    for stage in RMS_BACKWARD_STAGES:
        rmsnorm_backward_stages_cuda(x, g, dy, 1e-5, bufs, (stage,))
    assert torch.equal(bufs["dx"], whole[0])
    assert torch.equal(bufs["dgamma"], whole[1])
    want = rmsnorm_backward_plain(x, g, dy)
    for name, a, w in zip(("dx", "dgamma"), whole, want):
        assert _grad_err(a, w) <= tol, name
