"""The kernels' inputs for a sequence split over the data ranks, on the CPU:
attention's ``q_offset`` on the training route and the SSD scan's
``init_state``, against the JAX package.

A rank's block of a split sequence holds query rows ``[o, o + sq)`` of a
sequence of ``skv`` over every row's keys, and scans its block from the
state the earlier blocks leave. So:

  * the training route's forward (with the log-sum-exp) and backward, plain
    and through ``ops.flash_attention``'s autograd, with ``q_offset`` = o,
    against the reference's attention over the whole sequence and its
    ``jax.vjp`` with the cotangent of the block's rows alone, sliced to the
    block (dK and dV whole: zero for the keys no row of the block sees),
    fp32 at 2e-5;
  * ``ssd_scan_plain`` / ``ssd_scan_backward_plain`` (and their stage
    compositions, and ``ops.ssd_scan``'s autograd) from an ``init_state``
    against the reference's ``ssd_chunked(..., init_state)`` and its
    ``jax.vjp``, the initial state's cotangent included, at
    ``tests/test_kernels.py``'s SSD tolerance (5e-4 absolute, 1e-3
    relative).

The kernels against these plain versions on the card, with the same
inputs: ``tests/test_torch_seq_kernels_cuda.py`` (no JAX there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import naive_attention as naive_attention_jax
from repro.models.mamba import ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.flash_attention import (
    flash_attention_backward_plain,
    flash_attention_backward_stages_plain,
    flash_attention_forward_plain,
    offset_pairs,
)

ATTN_TOL = 2e-5
SSD_ATOL, SSD_RTOL = 5e-4, 1e-3

# b, h, hkv, block rows, keys, head_dim, offset: the train_lm layer's heads
# (9 over 3 KV heads of 64) and the train_zamba block's head_dim 160, a
# rank-1 block of a two-rank split (sq = skv / 2 at offset skv / 2), a
# ragged sequence, a middle block of four, and a first block (offset 0)
ATTN_CASES = [
    (1, 9, 3, 24, 48, 64, 24),
    (2, 4, 4, 19, 38, 160, 19),
    (1, 4, 2, 13, 52, 16, 26),
    (2, 4, 2, 16, 32, 16, 0),
]


def _attention_inputs(b, h, hkv, sq, skv, d, seed=0):
    """The whole sequence's q (b, skv, h, d), k, v and a cotangent of the
    block's rows, in the reference's (b, s, heads, d) layout."""
    rs = np.random.RandomState(seed)
    return (rs.randn(b, skv, h, d).astype(np.float32),
            rs.randn(b, skv, hkv, d).astype(np.float32),
            rs.randn(b, skv, hkv, d).astype(np.float32),
            rs.randn(b, sq, h, d).astype(np.float32))


def _reference_block(q, k, v, do, off):
    """The reference's attention over the whole sequence and its vjp with
    ``do`` on rows [off, off + sq) and zeros elsewhere: (the block's rows,
    dq of the block, dk, dv)."""
    sq = do.shape[1]
    out, vjp = jax.vjp(lambda q_, k_, v_: naive_attention_jax(q_, k_, v_),
                       *map(jnp.asarray, (q, k, v)))
    cot = np.zeros_like(np.asarray(out))
    cot[:, off:off + sq] = do
    dq, dk, dv = vjp(jnp.asarray(cot))
    return (np.asarray(out)[:, off:off + sq], np.asarray(dq)[:, off:off + sq],
            np.asarray(dk), np.asarray(dv))


def _heads(a: np.ndarray) -> torch.Tensor:
    """(b, s, heads, d) numpy -> the kernels' (b, heads, s, d) view."""
    return torch.from_numpy(a).transpose(1, 2)


def _offsets(b, off):
    return torch.full((b,), off, dtype=torch.int32)


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,off", ATTN_CASES)
def test_attention_with_q_offset_matches_the_reference_block(b, h, hkv, sq,
                                                             skv, d, off):
    """The plain forward with the log-sum-exp and the plain backward, given
    the block's rows and ``q_offset`` = o, against the reference's
    attention over the whole sequence and its vjp, sliced to the block."""
    q, k, v, do = _attention_inputs(b, h, hkv, sq, skv, d)
    want_out, want_dq, want_dk, want_dv = _reference_block(q, k, v, do, off)
    qb = _heads(q[:, off:off + sq])
    kt, vt, dot = _heads(k), _heads(v), _heads(do)
    offset = _offsets(b, off)
    out, lse = flash_attention_forward_plain(qb, kt, vt, True, None, offset)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), want_out,
                               atol=ATTN_TOL)
    grads = flash_attention_backward_plain(qb, kt, vt, out, lse, dot, True,
                                           offset)
    staged = flash_attention_backward_stages_plain(qb, kt, vt, out, lse, dot,
                                                   True, h // hkv, offset)
    for got in (grads, staged):
        for g, want in zip(got, (want_dq, want_dk, want_dv)):
            np.testing.assert_allclose(g.transpose(1, 2).numpy(), want,
                                       atol=ATTN_TOL)


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,off", ATTN_CASES)
def test_training_route_takes_q_offset(b, h, hkv, sq, skv, d, off):
    """``ops.flash_attention`` with an input that requires grad (the
    training route's operators, their plain versions on the CPU) and
    ``q_offset``: the block's rows and autograd's gradients against the
    reference's."""
    q, k, v, do = _attention_inputs(b, h, hkv, sq, skv, d, seed=1)
    want_out, *want = _reference_block(q, k, v, do, off)
    leaves = [_heads(a).clone().requires_grad_(True)
              for a in (q[:, off:off + sq], k, v)]
    out = ops.flash_attention(*leaves, True, q_offset=_offsets(b, off))
    out.backward(_heads(do))
    np.testing.assert_allclose(out.detach().transpose(1, 2).numpy(), want_out,
                               atol=ATTN_TOL)
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.transpose(1, 2).numpy(), w,
                                   atol=ATTN_TOL)


def test_training_route_still_refuses_kv_len():
    q = torch.zeros(1, 2, 4, 16, requires_grad=True)
    with pytest.raises(ValueError, match="no kv_len"):
        ops.flash_attention(q, q, q, True, torch.ones(1, dtype=torch.int32))


def test_offset_pairs_count_the_mask():
    """The pairs and key rows a shifted causal mask allows, against the
    mask itself (the bound of the kernels' work)."""
    for sq, skv, offs in ((24, 48, [24]), (13, 52, [26, 0]), (5, 8, [-3]),
                          (8, 8, [0, 20])):
        pairs = rows = 0
        for off in offs:
            mask = (np.arange(skv)[None, :]
                    <= np.arange(sq)[:, None] + off)
            pairs += int(mask.sum())
            rows += int(mask.any(0).sum())
        assert offset_pairs(sq, skv, offs) == (pairs, rows)


# b, s, h, p, n, g, chunk: a ragged last chunk, grouped heads, a block
# shorter than a chunk
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


def _reference_ssd(x, dt, A, B, C, init, dy, dstate, chunk):
    """``ssd_chunked`` from ``init`` and its vjp: (y, final state, dx, ddt,
    dA, dB, dC, dinit)."""
    (y, st), vjp = jax.vjp(
        lambda *a: ssd_chunked(*a[:5], chunk, init_state=a[5]),
        *map(jnp.asarray, (x, dt, A, B, C, init)))
    grads = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    return tuple(np.asarray(t) for t in (y, st, *grads))


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), want, atol=SSD_ATOL,
                               rtol=SSD_RTOL, err_msg=name)


NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")


@pytest.mark.parametrize("b,s,h,p,n,g,chunk", SSD_CASES)
def test_ssd_with_init_state_matches_the_reference(b, s, h, p, n, g, chunk):
    """The plain forward (chunk loop and stages) and backward (closed form
    and stages) from ``init_state``: y, the final state, and every
    cotangent, the initial state's included."""
    arrays = _ssd_inputs(3, b, s, h, p, n, g)
    want = _reference_ssd(*arrays, chunk)
    x, dt, A, B, C, init, dy, dstate = map(torch.from_numpy, arrays)
    for fn in (ssd.ssd_scan_plain, ssd.ssd_scan_stages_plain):
        y, st = fn(x, dt, A, B, C, chunk, init)
        _close(y, want[0], "y")
        _close(st, want[1], "state")
    for fn in (ssd.ssd_scan_backward_plain,
               ssd.ssd_scan_backward_stages_plain):
        got = fn(x, dt, A, B, C, dy, dstate, chunk, init)
        assert len(got) == 6
        for name, g, w in zip(NAMES, got, want[2:]):
            _close(g, w, name)


@pytest.mark.parametrize("b,s,h,p,n,g,chunk", SSD_CASES)
def test_ssd_scan_autograd_returns_the_initial_states_cotangent(
        b, s, h, p, n, g, chunk):
    """``ops.ssd_scan`` with an ``init_state`` that requires grad (the
    training route's operators, their plain versions on the CPU): y and the
    final state, and autograd's gradient of every input, against the
    reference's."""
    arrays = _ssd_inputs(4, b, s, h, p, n, g)
    want = _reference_ssd(*arrays, chunk)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:6]]
    y, st = ops.ssd_scan(*leaves[:5], chunk, init_state=leaves[5])
    _close(y.detach(), want[0], "y")
    _close(st.detach(), want[1], "state")
    torch.autograd.backward((y, st), tuple(map(torch.from_numpy,
                                               arrays[6:])))
    for name, leaf, w in zip(NAMES, leaves, want[2:]):
        _close(leaf.grad, w, name)


def test_ssd_scan_split_in_two_is_the_whole_scan():
    """Two blocks, the second from the first's final state: the whole
    sequence's y and final state (the split's premise), and the backward's
    initial-state cotangent of the second block as the first block's final
    state's cotangent."""
    x, dt, A, B, C, init, dy, _ = map(torch.from_numpy,
                                      _ssd_inputs(5, 2, 40, 4, 8, 16, 2))
    whole = ssd.ssd_scan_plain(x, dt, A, B, C, 16)
    y1, s1 = ssd.ssd_scan_plain(x[:, :24], dt[:, :24], A, B[:, :24],
                                C[:, :24], 16)
    y2, s2 = ssd.ssd_scan_plain(x[:, 24:], dt[:, 24:], A, B[:, 24:],
                                C[:, 24:], 16, s1)
    _close(torch.cat([y1, y2], 1), whole[0].numpy(), "y")
    _close(s2, whole[1].numpy(), "state")
