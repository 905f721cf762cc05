"""The ssm and hybrid families split over the model axis, and their ZeRO-3,
on gloo ranks on the CPU.

``tests/test_torch_distributed.py``'s harness (``python -c`` ranks, a
``file://`` store under the test's temporary directory, a 180 s job
timeout, every rank killed once one fails), in a file of its own so that
xdist runs it beside the dense job. Reduced mamba2-780m (8 SSD heads of 16,
state 16) and zamba2-2.7b (the same trunk; its shared block's 4 heads over
2 KV heads of 16 after both layers) on four ranks: two steps of two
microbatches of the sharded step against the port's one-process
``make_train_step`` from the same state, itself held to
``jax.value_and_grad`` for both families in ``tests/test_torch_models.py``:

  * (2 data, 2 model) ZeRO-1;
  * (2, 2) ZeRO-3, where the rules give ``A_log``, ``D`` and ``norm_g``
    of each layer whole to one data rank (``Placement.owner``);
  * (1, 4), where zamba2's 2 KV heads do not divide over the 4 ranks and
    each rank takes the one its query head shares;
  * (4, 1) ZeRO-3.

Also an owned layer's ZeRO-3 gradient on its holder alone, serving split at
(1, 2) and (2, 2) against the whole model (a prefill and three greedy
ticks: logits, tokens and the gathered caches), and the split-row gated norm
against ``rms_norm`` of the whole row.

Tolerances: ``test_sharded_step_matches_one_process``'s (loss 2e-4, every
parameter 5e-3 absolute and relative after two steps, m, v and master 5e-3
of each leaf's largest, the global norm 1e-5 relative); serving as the dense
family's (fp32 logits 1e-4, tokens equal) and the caches 1e-5 of their
largest; an owned layer's gradient 1e-4 of its largest; the split-row norm
1e-6 relative (fp32).
"""

import numpy as np
import pytest

from test_torch_distributed import _check_serving as _check_logits
from test_torch_distributed import _run_job

ARCHS = ("mamba2-780m", "zamba2-2.7b")

_BODY = """
from repro_torch.models.common import rms_norm, split_rms_norm
from repro_torch.parallel.sharding import Placement, batch_spec, local_shard

ARCHS = ("mamba2-780m", "zamba2-2.7b")


def use(arch):
    global CFG
    CFG = get_config(arch, reduced=True)


def owned_grads():
    \"\"\"(2, 2) ZeRO-3: one loss's gradient of each layer the rules give
    whole to one data rank, on this rank, against the one-process
    gradient's model piece.\"\"\"
    plan = MemoryPlan(3, "float32", True, "dots", 0.0, 1)
    mesh = build_mesh((2, 2), ("data", "model"), "cpu")
    ref = fresh(plan)
    state = shard_train_state(CFG, plan, fresh(plan), mesh)
    b = lm_batch(4, 16, 30)
    ref["model"].loss(b, remat=plan.remat)[0].backward()
    local = {k: local_shard(v, batch_spec(mesh, tuple(v.shape)), mesh)
             for k, v in b.items()}
    # each data rank's mean over its rows: the global mean is their average
    (state["model"].loss(local, remat=plan.remat)[0] / 2).backward()
    out = {}
    for name, pl in state["shardings"]["params"].items():
        if pl.owner is None:
            continue
        g = state["params"][name].grad
        want = local_shard(ref["params"][name].grad,
                           Placement(pl.spec, pl.shape), mesh)
        holder = mesh.get_local_rank(pl.owner[0]) == pl.owner[1]
        out[name] = {"holder": holder, "grad_shape": list(g.shape),
                     "err": ((g - want).abs().max()
                             / want.abs().max()).item() if holder else None}
    return out


def split_norm_case():
    \"\"\"split_rms_norm over the world's columns against rms_norm of the
    whole row: the output and the gradients of x and gamma of
    sum(out * w).\"\"\"
    group = dist.group.WORLD
    n, d = dist.get_world_size(), 128
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(3, 7, d).astype(np.float32))
    g = torch.from_numpy((1 + 0.1 * rs.randn(d)).astype(np.float32))
    w = torch.from_numpy(rs.randn(3, 7, d).astype(np.float32))
    xr, gr = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    want = rms_norm(xr, gr, 1e-5)
    (want * w).sum().backward()
    cols = slice(rank * d // n, (rank + 1) * d // n)
    xm = x[..., cols].clone().requires_grad_(True)
    gm = g[cols].clone().requires_grad_(True)
    got = split_rms_norm(xm, gm, 1e-5, d, group)
    (got * w[..., cols]).sum().backward()
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    return {"out": rel(got.detach(), want.detach()[..., cols]),
            "dx": rel(xm.grad, xr.grad[..., cols]),
            "dgamma": rel(gm.grad, gr.grad[cols])}
"""

_FOUR_RANKS = _BODY + """
for arch in ARCHS:
    use(arch)
    results[arch + ":dp2_tp2"] = step_pair((2, 2))
    results[arch + ":dp2_tp2_zero3"] = step_pair((2, 2), zero_stage=3)
    results[arch + ":tp4"] = step_pair((1, 4))
    results[arch + ":dp4_zero3"] = step_pair((4, 1), zero_stage=3, batch=8)
    results[arch + ":owned"] = owned_grads()
    results[arch + ":serve_dp2_tp2"] = serve_pair((2, 2))
results["split_norm"] = split_norm_case()
"""

_TWO_RANKS = _BODY + """
for arch in ARCHS:
    use(arch)
    results[arch + ":serve_tp2"] = serve_pair((1, 2))
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run_job(_FOUR_RANKS, 4, tmp_path_factory.mktemp("ssm_four"))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run_job(_TWO_RANKS, 2, tmp_path_factory.mktemp("ssm_two"))


STEP_CASES = ["dp2_tp2", "dp2_tp2_zero3", "tp4", "dp4_zero3"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_matches_one_process(four, arch, case):
    """Two steps of two microbatches: every rank's loss, the gathered
    parameters and the optimizer's m, v and master against
    ``make_train_step`` from the same state."""
    for res in four:
        r = res[f"{arch}:{case}"]
        np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=2e-4,
                                   atol=2e-4)
        assert r["param_abs_err"] <= 5e-3 * max(1.0, r["param_scale"])
        for part in ("m", "v", "master"):
            assert r[part + "_scaled_err"] <= 5e-3, part


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", STEP_CASES)
def test_global_norm_matches_one_process(four, arch, case):
    """Each element counted once, B's and C's replicated projections and
    an owned layer's empty pieces included."""
    for res in four:
        r = res[f"{arch}:{case}"]
        np.testing.assert_allclose(r["grad_norm"], r["ref_grad_norm"],
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero3_divides_the_parameters(four, arch):
    """(4, 1) ZeRO-3 keeps pieces between steps; the owned layers of (2, 2)
    leave their non-holders nothing."""
    for res in four:
        r = res[f"{arch}:dp4_zero3"]
        assert r["local_param_numel"] < 0.3 * r["full_param_numel"]


@pytest.mark.parametrize("arch", ARCHS)
def test_owned_layer_gradient_lands_on_its_holder(four, arch):
    """(2, 2) ZeRO-3: ``A_log``, ``D`` and ``norm_g`` of layer i are held
    by data rank i. One loss's gradient of each is the one-process
    gradient's model piece (the sum over the data ranks) on its holder,
    and an empty piece on the other data rank. 1e-4 of the leaf's
    largest: ``A_log``'s gradient sums fp32 cumsums, whose split over two
    batches moves its digits at 1e-5."""
    for rank, res in enumerate(four):
        data, _ = divmod(rank, 2)
        owned = res[f"{arch}:owned"]
        assert {n.split(".", 2)[2] for n in owned} == {"A_log", "D",
                                                       "norm_g"}
        for name, r in owned.items():
            layer = int(name.split(".")[1])
            assert r["holder"] == (data == layer), name
            if r["holder"]:
                assert r["grad_shape"][0] > 0 and r["err"] <= 1e-4, (name, r)
            else:
                assert r["grad_shape"][0] == 0, (name, r)


def _check_serving(r, ssm_heads):
    """The dense family's checks of the logits and tokens; each cache
    gathered whole within 1e-5 of the whole model's, the ``ssm`` cache
    split by heads and the ``conv`` cache whole."""
    _check_logits(r)
    assert r["pos_equal"]
    for name, err in r["cache_err"].items():
        assert err <= 1e-5, (name, err)
    assert r["local_shapes"]["ssm"][2] == ssm_heads
    assert r["local_shapes"]["conv"][3] == 128 + 2 * 16      # whole


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_split_over_2x2_matches_one_process(four, arch):
    """(2 data, 2 model): a prefill and three greedy ticks; each rank's
    ``ssm`` cache holds its 4 of the 8 heads, its ``conv`` cache every
    channel; zamba2's 2 KV heads split one a rank. The caches gathered
    whole equal the one-process caches."""
    for res in four:
        r = res[f"{arch}:serve_dp2_tp2"]
        _check_serving(r, 4)
        if arch == "zamba2-2.7b":
            assert r["local_shapes"]["attn_k"][3] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_split_over_two_ranks_matches_one_process(two, arch):
    for res in two:
        _check_serving(res[f"{arch}:serve_tp2"], 4)


def test_split_row_norm_matches_the_whole_row(four):
    """The gated norm's row split over four ranks: the output and the
    gradients of x and gamma against ``rms_norm`` of the whole row, 1e-6
    relative in fp32."""
    for res in four:
        for key, err in res["split_norm"].items():
            assert err <= 1e-6, (key, err)
