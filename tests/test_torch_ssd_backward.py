"""The SSD scan's backward in the port, on the CPU, against the JAX package.

``ssd_scan_backward_plain`` (the closed form the CPU runs, and the card's
yardstick) against ``jax.vjp`` of the reference's ``ssd_chunked`` on the
same numpy-seeded inputs and cotangents, each gradient within 1e-4 of its
largest magnitude (fp32 on both sides, sums in another order); against
torch autograd of ``ssd_scan_plain``, and the backward's stages composed
against it, within 1e-5. Then the training route of ``ops.ssd_scan`` (the
``ssd_scan_train`` and ``ssd_scan_backward`` operators: CPU, CUDA and fake
implementations), the op counter on ``cpu`` and ``meta``, and a reduced
mamba2 training step against the reference's. Tests marked ``cuda`` hold
the kernels against the plain backward on the card:
``python -m pytest -m cuda tests/test_torch_ssd_backward.py``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as get_config_jax
from repro.models import get_model as get_model_jax
from repro.models.mamba import ssd_chunked
from repro.parallel.policy import MemoryPlan as MemoryPlanJax
from repro.train import optimizer as opt_jax
from repro.train.train_step import make_train_step as make_train_step_jax
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.core.op_counter import OpCounter
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.parallel.policy import MemoryPlan
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train import optimizer as opt
from repro_torch.train.optimizer import AdamWConfig

torch.set_num_threads(1)

GRADS = ("dx", "ddt", "dA", "dB", "dC")

# b, h, s, p, n, g, chunk, dstate: one group and two, a sequence that is a
# whole number of chunks, ragged ones, one shorter than a chunk; with and
# without a cotangent on the final state
CASES = [
    (2, 4, 45, 8, 6, 2, 16, True),
    (2, 4, 45, 8, 6, 2, 16, False),
    (1, 3, 48, 16, 16, 1, 16, False),
    (1, 3, 37, 16, 16, 1, 16, True),
    (2, 2, 9, 8, 8, 1, 32, False),
    (1, 4, 100, 16, 32, 2, 32, True),
]
CASE_IDS = [f"b{b}h{h}s{s}p{p}n{n}g{g}q{q}{'-dstate' if d else ''}"
            for b, h, s, p, n, g, q, d in CASES]


def _inputs(seed, b, h, s, p, n, g, dstate):
    """x, dt (softplus-ed), A (< 0), B, C as the reference tests draw them,
    the cotangent dy and, if asked, the final state's; numpy fp32."""
    rs = np.random.RandomState(seed)
    return (rs.randn(b, s, h, p).astype(np.float32),
            np.log1p(np.exp(rs.randn(b, s, h))).astype(np.float32),
            (-np.exp(0.5 * rs.randn(h))).astype(np.float32),
            rs.randn(b, s, g, n).astype(np.float32),
            rs.randn(b, s, g, n).astype(np.float32),
            rs.randn(b, s, h, p).astype(np.float32),
            rs.randn(b, h, p, n).astype(np.float32) if dstate else None)


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _scaled(got: torch.Tensor, want) -> float:
    """max |got - want| over the largest |want|."""
    want = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got.detach().double().numpy() - want).max()) / scale


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_backward_plain_matches_jax_grad(case):
    """Every gradient against ``jax.vjp`` of ``ssd_chunked`` (the reference
    model's scan) with the same cotangents (zeros on the final state where
    the case has none), within 1e-4 of its largest magnitude."""
    b, h, s, p, n, g, chunk, dstate = case
    x, dt, A, B, C, dy, ds = _inputs(40, b, h, s, p, n, g, dstate)
    _, vjp = jax.vjp(lambda *a: ssd_chunked(*a, chunk),
                     *map(jnp.asarray, (x, dt, A, B, C)))
    want = vjp((jnp.asarray(dy),
                jnp.asarray(ds if dstate else np.zeros((b, h, p, n),
                                                       np.float32))))
    got = ssd.ssd_scan_backward_plain(*_torch((x, dt, A, B, C, dy, ds)),
                                      chunk=chunk)
    for name, a, w in zip(GRADS, got, want):
        assert a.shape == w.shape and a.dtype == torch.float32, name
        assert _scaled(a, np.asarray(w)) <= 1e-4, name


def _autograd(x, dt, A, B, C, dy, ds, chunk):
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, state = ssd.ssd_scan_plain(*leaves, chunk)
    total = (y * dy).sum() + (0 if ds is None else (state * ds).sum())
    return torch.autograd.grad(total, leaves)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_backward_plain_is_autograd_of_the_plain_scan(case):
    """The closed form against torch autograd through ``ssd_scan_plain``.
    Both in float64 (the plain versions keep float64 inputs float64): the
    same numbers, within 1e-12 of each gradient's largest magnitude. The
    closed form in fp32 against that float64 autograd: within 1e-5 (dA,
    a sum over every position with cancellation, is the widest)."""
    b, h, s, p, n, g, chunk, dstate = case
    args = _torch(_inputs(41, b, h, s, p, n, g, dstate))
    wide = [None if t is None else t.double() for t in args]
    want = _autograd(*wide, chunk)
    got = ssd.ssd_scan_backward_plain(*wide, chunk=chunk)
    got32 = ssd.ssd_scan_backward_plain(*args, chunk=chunk)
    for name, a, a32, w in zip(GRADS, got, got32, want):
        assert a.dtype == w.dtype == torch.float64, name
        assert _scaled(a, w.numpy()) <= 1e-12, name
        assert a32.dtype == torch.float32, name
        assert _scaled(a32, w.numpy()) <= 1e-5, name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_backward_stages_compose_to_the_plain_backward(case, dtype, tol):
    """The training forward's scratch and the six backward stages, as the
    kernels compose them on the plan's splits, give the closed form's
    gradients: fp32, sums in another order (1e-5); float64 (the plain
    stages keep float64 inputs float64), the same numbers (1e-12)."""
    b, h, s, p, n, g, chunk, dstate = case
    args = [None if t is None else t.to(dtype)
            for t in _torch(_inputs(42, b, h, s, p, n, g, dstate))]
    want = ssd.ssd_scan_backward_plain(*args, chunk=chunk)
    got = ssd.ssd_scan_backward_stages_plain(*args, chunk=chunk)
    for name, a, w in zip(GRADS, got, want):
        assert a.shape == w.shape and a.dtype == w.dtype == dtype, name
        assert _scaled(a, w.numpy()) <= tol, name


def test_backward_plain_bf16_takes_and_gives_each_inputs_type():
    """bf16 x, B, C and dy: fp32 inside, dx, dB and dC rounded to bf16 once
    (one ulp, 2^-8 of the largest, within 1e-2), dt's and A's gradients
    fp32, against the fp32 closed form on the same (bf16-exact) values."""
    x, dt, A, B, C, dy, ds = _torch(_inputs(43, 1, 4, 70, 16, 16, 2, True))
    bf = [t.to(torch.bfloat16) for t in (x, B, C, dy)]
    got = ssd.ssd_scan_backward_plain(bf[0], dt, A, bf[1], bf[2], bf[3], ds,
                                      32)
    want = ssd.ssd_scan_backward_plain(bf[0].float(), dt, A, bf[1].float(),
                                       bf[2].float(), bf[3].float(), ds, 32)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    for name, a, w in zip(GRADS, got, want):
        assert _scaled(a.float(), w.numpy()) <= 1e-2, name


def test_train_forward_plain_is_the_scan_and_its_scratch():
    """``ssd_scan_train_plain``: y and the final state of ``ssd_scan_plain``,
    and the scratch in the kernels' layouts (``_buffer_specs``): the
    scores padded with zeros to 64, the cumsums flat past the chunk's last
    position, the first chunk's incoming state zero."""
    b, h, s, p, n, g, chunk = 1, 4, 100, 8, 16, 2, 32
    x, dt, A, B, C, _, _ = _torch(_inputs(44, b, h, s, p, n, g, False))
    y, state, scores, cs, incoming = ssd.ssd_scan_train_plain(x, dt, A, B, C,
                                                              chunk)
    want_y, want_state = ssd.ssd_scan_plain(x, dt, A, B, C, chunk)
    assert _scaled(y, want_y.numpy()) <= 1e-5
    assert _scaled(state, want_state.numpy()) <= 1e-5
    specs = ssd._buffer_specs(x, B, chunk)
    for name, t in zip(ssd.TRAIN_OUTPUTS, (y, state, scores, cs, incoming)):
        assert (tuple(t.shape), t.dtype) == specs[name], name
        assert t.is_contiguous(), name
    assert scores[..., 32:, :].abs().max() == 0
    assert torch.equal(cs[:, :, 3, 4:], cs[:, :, 3, 3:4].expand(-1, -1, 60))
    assert torch.equal(cs[:, :, 0, 32:], cs[:, :, 0, 31:32].expand(-1, -1, 32))
    assert incoming[:, :, 0].abs().max() == 0


# ------------------------------------------------------------------------- #
# The training route through the operators
# ------------------------------------------------------------------------- #

def _counting(monkeypatch, name):
    """Count the calls of ``ops.<name>`` (a plain version the CPU
    implementations look up when called) while delegating to it."""
    real = getattr(ops, name)
    calls = []

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, name, counted)
    return calls


def test_a_gradient_on_the_cpu_goes_through_the_backward_operator(
        monkeypatch):
    """``ops.ssd_scan`` with an input that requires grad takes the training
    route on the CPU too: the ``ssd_scan_train`` operator forward, the
    ``ssd_scan_backward`` operator backward (their CPU implementations, the
    plain versions), no kernel launch counted, the closed form's
    gradients."""
    x, dt, A, B, C, dy, ds = _torch(_inputs(45, 2, 4, 45, 8, 16, 2, True))
    forwards = _counting(monkeypatch, "ssd_scan_train_plain")
    backwards = _counting(monkeypatch, "ssd_scan_backward_plain")
    plain_forwards = _counting(monkeypatch, "ssd_scan_plain")
    before = (ops.ssd_scan.launches, ops.ssd_scan.backward_launches)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, state = ops.ssd_scan(*leaves, 16)
    ((y * dy).sum() + (state * ds).sum()).backward()
    assert (len(forwards), len(backwards), len(plain_forwards)) == (1, 1, 0)
    assert (ops.ssd_scan.launches, ops.ssd_scan.backward_launches) == before
    want = ssd.ssd_scan_backward_plain(x, dt, A, B, C, dy, ds, 16)
    for name, leaf, w in zip(GRADS, leaves, want):
        assert torch.equal(leaf.grad, w), name
    with torch.no_grad():
        ops.ssd_scan(*leaves, 16)
    assert len(plain_forwards) == 1 and len(forwards) == 1


def test_an_unused_final_state_sends_no_cotangent(monkeypatch):
    """A loss that reads y only hands the backward no final-state cotangent
    (None: no zeros are made); one that reads the final state only hands it
    a zero dy. Both give the closed form's gradients."""
    x, dt, A, B, C, dy, ds = _torch(_inputs(46, 1, 2, 40, 8, 16, 1, True))
    backwards = _counting(monkeypatch, "ssd_scan_backward_plain")
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, _ = ops.ssd_scan(*leaves, 16)
    (y * dy).sum().backward()
    assert backwards[-1][6] is None
    want = ssd.ssd_scan_backward_plain(x, dt, A, B, C, dy, None, 16)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    _, state = ops.ssd_scan(*leaves, 16)
    (state * ds).sum().backward()
    assert torch.equal(backwards[-1][5], torch.zeros_like(x))
    want = ssd.ssd_scan_backward_plain(x, dt, A, B, C, torch.zeros_like(x),
                                       ds, 16)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))


def _op_args(dtype=torch.float32, dstate=True):
    x, dt, A, B, C, dy, ds = _torch(_inputs(47, 2, 4, 45, 8, 16, 2, dstate))
    x, B, C, dy = (t.to(dtype) for t in (x, B, C, dy))
    saved = ssd.ssd_scan_train_plain(x, dt, A, B, C, 16)[2:]
    o = torch.ops.repro_torch
    return {"ssd_scan_train": (o.ssd_scan_train, (x, dt, A, B, C, 16)),
            "ssd_scan_backward": (o.ssd_scan_backward,
                                  (x, dt, A, B, C, dy, ds, *saved, 16))}


def _meta(args):
    return tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)


def test_the_training_route_is_two_operators_with_three_implementations():
    for name in ("ssd_scan_train", "ssd_scan_backward"):
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                f"repro_torch::{name}", key), (name, key)
        assert getattr(torch.ops.repro_torch, name) in ops.WORK


@pytest.mark.parametrize("dstate", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["ssd_scan_train", "ssd_scan_backward"])
def test_fake_gives_the_kernels_shapes_dtypes_and_strides(name, dtype,
                                                          dstate):
    """``meta`` in, ``meta`` out, with the CPU implementation's shapes,
    dtypes and strides, which are the kernels' buffers'
    (``_buffer_specs``, ``_backward_buffer_specs``: contiguous, each
    gradient in its input's type)."""
    op, args = _op_args(dtype, dstate)[name]
    want = op(*args)
    got = op(*_meta(args))
    x, B = args[0], args[3]
    specs = (ssd._buffer_specs(x, B, 16) if name == "ssd_scan_train"
             else ssd._backward_buffer_specs(x, B, 16))
    names = (ssd.TRAIN_OUTPUTS if name == "ssd_scan_train"
             else ssd.BACKWARD_OUTPUTS)
    for key, g, w in zip(names, got, want):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype, g.stride()) == (w.shape, w.dtype,
                                                  w.stride()), key
        assert (tuple(w.shape), w.dtype) == specs[key] and w.is_contiguous()


@pytest.mark.parametrize("name", ["ssd_scan_train", "ssd_scan_backward"])
def test_opcheck(name):
    op, args = _op_args()[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("name", ["ssd_scan_train", "ssd_scan_backward"])
def test_flop_counter_counts_the_work_formula(name):
    """``FlopCounterMode`` and the op counter count the kernel module's
    formula (the forward's for the training forward), the same on ``meta``
    and on the CPU."""
    op, args = _op_args()[name]
    want = ops.WORK[op](*args)
    for a in (args, _meta(args)):
        with FlopCounterMode(display=False) as fc:
            op(*a)
        assert fc.get_total_flops() == want[0]
        with OpCounter() as c:
            op(*a)
        assert (c.cost.flops, c.cost.bytes) == want
    assert want[0] > 0 and want[1] > 0


def test_backward_work_formula():
    """Per chunk of L positions: C B^T on and below the diagonal a group,
    and per head 2 L (L + 1) (p + n) + 8 L p n; x, B, C, dy read and dx,
    dB, dC written once, dt/ddt, A/dA and the final state's cotangent in
    fp32; the training forward counts the forward's formula."""
    b, s, h, p, n, g, chunk = 2, 40, 4, 8, 16, 2, 16
    flops = sum(b * g * L * (L + 1) * n
                + b * h * (2 * L * (L + 1) * (p + n) + 8 * L * p * n)
                for L in (16, 16, 8))
    for dtype, item in ((torch.float32, 4), (torch.bfloat16, 2)):
        for dstate in (False, True):
            nbytes = ((3 * b * s * h * p + 4 * b * s * g * n) * item
                      + 4 * (2 * b * s * h + 2 * h)
                      + (4 * b * h * p * n if dstate else 0))
            assert ssd.backward_work(b, s, h, p, n, g, chunk, dtype,
                                     dstate) == (flops, nbytes)
    assert ssd.BACKWARD_STAGES == ("dstates", "dpass", "rows", "cols",
                                   "finish", "reduce")
    assert ssd.BACKWARD_KERNELS_PER_CALL == 6
    x = torch.empty((8, 2048, 48, 64), device="meta")
    B = torch.empty((8, 2048, 1, 128), device="meta")
    bufs = ssd.ssd_backward_buffers(x, B, 256)
    nbytes = {k: t.numel() * t.element_size() for k, t in bufs.items()}
    # six splits of the group's 48 heads: partials of (b, s, g, n), not a
    # dB and dC of each head (402,653,184 bytes each)
    assert nbytes["dB_part"] == nbytes["dC_part"] == 6 * 8 * 2048 * 128 * 4
    assert nbytes["dB_part"] + nbytes["dC_part"] == ssd.ssd_scan_backward_plan(
        8, 2048, 48, 1, 128, 256)[2] == 100_663_296
    assert nbytes["dS"] == 8 * 48 * 8 * 64 * 128 * 4
    assert nbytes["dcs"] == 8 * 48 * 8 * 3 * 256 * 4
    assert nbytes["dA_part"] == 8 * 48 * 8 * 2 * 4
    assert set(bufs) == {*ssd.BACKWARD_OUTPUTS, "dS", "dcs", "dA_part",
                         "dB_part", "dC_part"}


# (b, s, h, g, n, chunk) -> (splits, kernels, partials' bytes): mamba2-780m's
# training layer, zamba2-2.7b's, the ragged grouped case of chip_smoke.py,
# and a batch large enough for one split (no partials)
PLANS = [((8, 2048, 48, 1, 128, 256), (6, 6, 100_663_296)),
         ((1, 1024, 80, 1, 64, 256), (80, 6, 41_943_040)),
         ((2, 130, 4, 2, 32, 64), (2, 6, 266_240)),
         ((32, 8192, 2, 1, 128, 256), (1, 6, 0))]


@pytest.mark.parametrize("shape,plan", PLANS,
                         ids=["train-main", "zamba2", "ragged", "one-split"])
def test_backward_plan(shape, plan):
    """``ssd_scan_backward_plan``: the fewest splits of a group's heads (a
    divisor of h // g) that give ``rows`` and ``cols`` BACKWARD_MIN_BLOCKS
    blocks each (one a 64-row tile, batch, group, split, chunk), else the
    whole group; the buffers' partials take its splits (none for one)."""
    b, s, h, g, n, chunk = shape
    assert ssd.ssd_scan_backward_plan(*shape) == plan
    splits = plan[0]
    q = min(chunk, s)
    blocks = b * g * -(-s // q) * -(-q // 64) * splits
    assert (h // g) % splits == 0
    assert blocks >= ssd.BACKWARD_MIN_BLOCKS or splits == h // g
    specs = ssd._backward_buffer_specs(torch.empty((b, s, h, 8),
                                                   device="meta"),
                                       torch.empty((b, s, g, n),
                                                   device="meta"), chunk)
    parts = splits if splits > 1 else 0
    assert specs["dB_part"] == specs["dC_part"] == ((parts, b, s, g, n),
                                                     torch.float32)


def test_launch_functions_refuse_cpu_tensors_and_wide_heads():
    """The functions that launch the kernels never compute another way; the
    training route refuses a head_dim the backward does not take before it
    launches anything."""
    x, dt, A, B, C, dy, ds = _torch(_inputs(48, 1, 2, 40, 8, 16, 1, True))
    saved = ssd.ssd_scan_train_plain(x, dt, A, B, C, 16)[2:]
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_train_cuda(x, dt, A, B, C, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_backward_cuda(x, dt, A, B, C, dy, ds, *saved, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_backward_stages_cuda(x, dt, A, B, C, dy, ds, *saved, 16,
                                          ssd.ssd_backward_buffers(x, B, 16))
    with pytest.raises(ValueError, match="head_dim p <= 64"):
        ssd._check_backward_head_dim(128)


# ------------------------------------------------------------------------- #
# The model: remat, the op counter, one training step, the launcher
# ------------------------------------------------------------------------- #

@pytest.mark.parametrize("remat,again", [("none", 1), ("dots", 2),
                                         ("full", 2)])
def test_remat_recomputes_the_scan_and_keeps_none_of_its_outputs(
        remat, again, monkeypatch):
    """Under ``dots`` (and ``full``) every layer's training forward runs
    again just before its backward, so nothing of it is kept across
    layers; each layer runs one backward."""
    cfg = get_config("mamba2-780m", reduced=True)
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 41),
                         generator=torch.Generator().manual_seed(2))
    forwards = _counting(monkeypatch, "ssd_scan_train_plain")
    backwards = _counting(monkeypatch, "ssd_scan_backward_plain")
    loss, _ = model.loss({"tokens": toks[:, :-1], "targets": toks[:, 1:]},
                         remat=remat)
    assert len(forwards) == cfg.num_layers
    loss.backward()
    assert (len(forwards), len(backwards)) == (again * cfg.num_layers,
                                               cfg.num_layers)


def _mamba_step(device: str):
    cfg = get_config("mamba2-780m", reduced=True)
    plan = MemoryPlan(1, "float32", True, "dots", 0.0, 1)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    state = init_train_state(cfg, plan, gen, ocfg, dtype=torch.float32,
                             device=device)
    toks = torch.randint(0, cfg.vocab_size, (2, 41),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1].clone().to(device),
             "targets": toks[:, 1:].clone().to(device)}
    step = make_train_step(cfg, plan, ocfg)
    hold = ({"params": state["params"], "opt": state["opt"]}, batch)
    return lambda: step(state, batch), hold


def test_op_counter_counts_a_mamba_step_equally_on_cpu_and_meta():
    """The reduced mamba2 training step (remat "dots"): equal FLOPs, bytes,
    collective bytes and peak live bytes on ``meta`` and on CPU tensors,
    with the scan's training forward (twice a layer) and backward (once) in
    the count."""
    cfg = get_config("mamba2-780m", reduced=True)
    shape = (2, 40, cfg.ssm_heads, cfg.ssm.head_dim, cfg.ssm.state_dim,
             cfg.ssm.ngroups, cfg.ssm.chunk_size, torch.float32)
    layers = cfg.num_layers
    counts = []
    for device in ("cpu", "meta"):
        run, hold = _mamba_step(device)
        with OpCounter(hold=hold) as c:
            run()
        counts.append((c.cost.flops, c.cost.bytes, c.cost.coll,
                       c.peak_bytes, c.argument_bytes))
        assert c.by_op["repro_torch.ssd_scan_train"] == [
            2 * layers, *(2 * layers * v for v in ssd.work(*shape))]
        assert c.by_op["repro_torch.ssd_scan_backward"] == [
            layers, *(layers * v for v in ssd.backward_work(*shape))]
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][3] > counts[0][4] > 0


def _scaled_t(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = max(want.abs().max().item(), 1e-30)
    return (got.detach() - want).abs().max().item() / scale


def test_reduced_mamba_train_step_matches_jax():
    """One step of reduced mamba2 from the same weights, optimizer state and
    batch (45 tokens across the 32-token chunk) against the JAX package's
    ``make_train_step``: the metrics (1e-5); m, which carries the clipped
    gradients, within 1e-5 of its largest, and v, their squares (twice
    their relative error), within 2e-5; every updated
    parameter and its master copy within 1e-6. Adam's eps is 1e-3 on both
    sides: its first step moves an element by lr g / (|g| + eps), and at
    the default 1e-8 an element whose gradient is a few eps from zero moves
    by a fraction of lr that its gradient's last digits decide, on each
    side its own; at 1e-3 the step is smooth in g (gradients d apart move
    the parameter at most lr d / eps apart)."""
    cfg_j = get_config_jax("mamba2-780m", reduced=True)
    params = get_model_jax(cfg_j).init_params(jax.random.PRNGKey(5), cfg_j,
                                              dtype=jnp.float32)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)
    cj, ct = opt_jax.AdamWConfig(**kw), AdamWConfig(**kw)
    rs = np.random.RandomState(36)
    toks = rs.randint(0, cfg_j.vocab_size, size=(2, 46)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    step_j = make_train_step_jax(
        cfg_j, MemoryPlanJax(1, "float32", True, "dots", 0.0, 1), cj)
    new_j, metrics_j = step_j(
        {"params": params, "opt": opt_jax.init_state(params, cj)},
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    cfg = get_config("mamba2-780m", reduced=True)
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          cfg))
    tparams = dict(model.named_parameters())
    state = {"model": model, "params": tparams,
             "opt": opt.init_state(tparams, ct)}
    step = make_train_step(cfg, MemoryPlan(1, "float32", True, "dots", 0.0,
                                           1), ct)
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                          torch.Generator().manual_seed(0))
    for name in ("loss", "ce", "aux", "grad_norm", "lr"):
        got = metrics[name]
        got = got.item() if torch.is_tensor(got) else got
        assert got == pytest.approx(float(metrics_j[name]), rel=1e-5,
                                    abs=1e-12), name
    want_params = from_jax_params(jax.tree.map(np.asarray, new_j["params"]),
                                  cfg)
    for name, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want_params[name].numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)
    for part in ("m", "v", "master"):
        want = from_jax_params(jax.tree.map(np.asarray, new_j["opt"][part]),
                               cfg)
        for name, t in state["opt"][part].items():
            if part == "master":
                np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                           atol=1e-6, rtol=0,
                                           err_msg=name)
            else:
                tol = 2e-5 if part == "v" else 1e-5
                assert _scaled_t(t, want[name]) <= tol, (part, name)
    assert int(state["opt"]["step"]) == int(new_j["opt"]["step"]) == 1


def test_launch_train_mamba_reduced_on_cpu(capsys):
    """``python -m repro_torch.launch.train --arch mamba2-780m --reduced
    --device cpu --steps 20``: runs to its summary, the loss falls."""
    summary = launch_train.main(["--arch", "mamba2-780m", "--reduced",
                                 "--device", "cpu", "--steps", "20"])
    out = capsys.readouterr().out
    logged = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step=(\d+) time_s=\S+ loss=(\S+)", out)}
    assert sorted(logged) == [10, 20]
    assert logged[20] < logged[10]
    assert summary["final_step"] == 20
    assert "summary:" in out


# ------------------------------------------------------------------------- #
# On the card: the kernels against the plain backward.
# ------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(device, dtype, case, seed=50):
    b, h, s, p, n, g, chunk, dstate = case
    x, dt, A, B, C, dy, ds = _torch(_inputs(seed, b, h, s, p, n, g, dstate))
    x, B, C, dy = (t.to(device, dtype) for t in (x, B, C, dy))
    dt, A = dt.to(device), A.to(device)
    return x, dt, A, B, C, dy, None if ds is None else ds.to(device)


# the CPU cases at state dims the kernels take (16, 32, 64, 128), then a
# mamba2-780m layer and a zamba2-2.7b one at short lengths; then the tiles'
# edges: chunks that are not a multiple of 64 (96, 100) with a ragged last
# chunk, a long chunk (512, eight row tiles) with a short last one, p 8 with
# n 16 and p 64 with n 128, groups of 2, 4 and 12 heads, and plans that sum
# two heads a block (splits 4 of 8 heads, 6 of 12 heads a group). At chunk
# 1024 the cumsums reach the hundreds and fp32 itself (the plain version
# against float64) does not hold dA to 1e-4 of its largest
CARD_CASES = [(b, h, s, p, max(n, 16), g, q, d)
              for b, h, s, p, n, g, q, d in CASES] + [
    (2, 48, 512, 64, 128, 1, 256, False),
    (1, 80, 300, 64, 64, 1, 256, True),
    (2, 8, 200, 64, 128, 2, 96, True),
    (1, 6, 150, 8, 16, 3, 100, False),
    (3, 4, 1100, 32, 32, 1, 512, True),
    (16, 8, 2048, 64, 128, 1, 256, False),
    (8, 24, 1024, 32, 64, 2, 256, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", CARD_CASES)
def test_backward_kernels_match_plain_and_repeat_bitwise(cuda_device, dtype,
                                                         tol, case):
    """The training forward's kernels, then the backward's, against the
    closed form on the same inputs in float64 (each gradient to ``tol`` of
    its largest magnitude: fp32, the kernels' own rounding; bf16, dx, dB,
    dC rounded once); a second call gives the same bits. float64, since the
    closed form in fp32 itself misses dA by about the tolerance at long
    chunks."""
    x, dt, A, B, C, dy, ds = _card_inputs(cuda_device, dtype, case)
    chunk = case[6]
    saved = ssd.ssd_scan_train_cuda(x, dt, A, B, C, chunk)[2:]
    got = ssd.ssd_scan_backward_cuda(x, dt, A, B, C, dy, ds, *saved, chunk)
    torch.cuda.synchronize()
    want = ssd.ssd_scan_backward_plain(
        *(None if t is None else t.double() for t in (x, dt, A, B, C, dy, ds)),
        chunk=chunk)
    types = (dtype, torch.float32, torch.float32, dtype, dtype)
    for name, a, w, kind in zip(GRADS, got, want, types):
        assert a.dtype == kind and a.shape == w.shape, name
        assert _scaled(a.float().cpu(), w.cpu().numpy()) <= tol, name
    again = ssd.ssd_scan_backward_cuda(x, dt, A, B, C, dy, ds, *saved, chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_backward_stages_on_the_card_compose_to_the_call(cuda_device):
    x, dt, A, B, C, dy, ds = _card_inputs(cuda_device, torch.float32,
                                          CARD_CASES[0])
    saved = ssd.ssd_scan_train_cuda(x, dt, A, B, C, 16)[2:]
    want = ssd.ssd_scan_backward_cuda(x, dt, A, B, C, dy, ds, *saved, 16)
    bufs = ssd.ssd_backward_buffers(x, B, 16)
    for stage in ssd.BACKWARD_STAGES:
        ssd.ssd_scan_backward_stages_cuda(x, dt, A, B, C, dy, ds, *saved, 16,
                                          bufs, (stage,))
    assert all(torch.equal(bufs[k], w)
               for k, w in zip(ssd.BACKWARD_OUTPUTS, want))


@pytest.mark.cuda
def test_ssd_scan_gradient_on_the_card_launches_the_backward(cuda_device):
    """``ops.ssd_scan`` with a gradient on the card: the training forward
    counts one launch, the backward one, and the gradients are the closed
    form's."""
    x, dt, A, B, C, dy, ds = _card_inputs(cuda_device, torch.float32,
                                          CARD_CASES[0])
    before = (ops.ssd_scan.launches, ops.ssd_scan.backward_launches)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, state = ops.ssd_scan(*leaves, 16)
    ((y * dy).sum() + (state * ds).sum()).backward()
    assert (ops.ssd_scan.launches - before[0],
            ops.ssd_scan.backward_launches - before[1]) == (1, 1)
    want = ssd.ssd_scan_backward_plain(x, dt, A, B, C, dy, ds, 16)
    for name, leaf, w in zip(GRADS, leaves, want):
        assert _scaled(leaf.grad.cpu(), w.cpu().numpy()) <= 1e-4, name


@pytest.mark.cuda
def test_launch_train_mamba_reduced_on_the_card(cuda_device, capsys):
    """``python -m repro_torch.launch.train --arch mamba2-780m --reduced
    --steps 20`` on the card: the scan both ways and RMSNorm through the
    kernels, as many launches as the layers and the remat policy reckon,
    and the loss falls."""
    before = launch_train.kernel_launches()
    summary = launch_train.main(["--arch", "mamba2-780m", "--reduced",
                                 "--steps", "20"])
    out = capsys.readouterr().out
    logged = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step=(\d+) time_s=\S+ loss=(\S+)", out)}
    assert sorted(logged) == [10, 20] and logged[20] < logged[10]
    assert summary["final_step"] == 20
    layers = get_config("mamba2-780m", reduced=True).num_layers
    after = launch_train.kernel_launches()
    want = {"ssd_scan": 2 * layers * 20, "ssd_scan_backward": layers * 20,
            "rmsnorm": (4 * layers + 1) * 20,
            "rmsnorm_backward": (2 * layers + 1) * 20,
            "flash_attention": 0, "flash_attention_backward": 0}
    assert {k: after[k] - before[k] for k in want} == want
