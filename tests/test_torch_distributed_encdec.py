"""The encoder-decoder and the VLM split over the model axis, and their
ZeRO-3, on gloo ranks on the CPU.

``tests/test_torch_distributed.py``'s harness (``python -c`` ranks, a
``file://`` store under the test's temporary directory, a 180 s job
timeout, every rank killed once one fails), in a file of its own so that
xdist runs it beside the other jobs; its ``lm_batch`` and ``serve_pair``
add the family's input (``family_inputs``): the encdec's ``frames``, 24 of
them against 16 target tokens, and the VLM's 8 ``patches``. Reduced
seamless-m4t-large-v2 (2 + 2 layers, 4 heads over 2 KV heads of 16) and
internvl2-76b (the dense trunk behind 8 patch embeddings) on four ranks:
two steps of two microbatches of the sharded step against the port's
one-process ``make_train_step`` from the same state, itself held to
``jax.value_and_grad`` in ``tests/test_torch_encdec.py`` and
``tests/test_torch_models.py``:

  * (2 data, 2 model) ZeRO-1;
  * (2, 2) ZeRO-3;
  * (1, 4), where the 2 KV heads do not divide over the 4 ranks and each
    rank takes the one its query head shares (the cross K/V too);
  * (4, 1) ZeRO-3.

Also one loss's gradient of every leaf at (2, 2) and (1, 4) against one
process's, serving split at (1, 2), (2, 2) and (1, 4) against the whole
model (a prefill and three greedy ticks: logits, tokens and the gathered
caches, ``cross_k`` and ``cross_v`` among them), and the refusal of query
heads that straddle KV groups, naming the layer.

Tolerances: ``tests/test_torch_distributed_ssm.py``'s. Loss 2e-4; every
parameter 5e-3 absolute and relative after two steps; m, v and master 5e-3
of each leaf's largest; the global norm 1e-5 relative; fp32 logits 1e-4
with the greedy tokens equal; the caches 1e-5 of their largest; one loss's
gradients 1e-5 of each leaf's largest.

The steps run AdamW with eps 1e-6 (the harness's is 1e-8). At (2, 2) the
reduced internvl2's first step has an embedding gradient element that,
clipped by the global norm (~8.6), is 1.20e-8 on one side and 1.66e-8 on
the other: the fp32 noise of its terms (the leaf's largest, unclipped, is
0.66). Near an eps of 1e-8, AdamW's step m / (sqrt(v) + eps) turns that
into 7.7 % of lr; after two steps the master then lies 1.4e-2 of its
leaf's largest off one process's, and the second step's norm 1.1e-5
relative. At an eps of 1e-6 such an element's step is near 0 on both
sides. The gradients themselves are held directly, without AdamW (1.2e-6
of each leaf's largest).
"""

import numpy as np
import pytest

from test_torch_distributed import _check_serving as _check_logits
from test_torch_distributed import _run_job

ARCHS = ("seamless-m4t-large-v2", "internvl2-76b")

_BODY = """
import dataclasses

ARCHS = ("seamless-m4t-large-v2", "internvl2-76b")


# AdamW's eps at 1e-6, not the harness's 1e-8 (see the module's docstring)
OPT = AdamWConfig(lr=1e-3, eps=1e-6, warmup_steps=0, total_steps=10)


def use(arch):
    global CFG
    CFG = get_config(arch, reduced=True)


def grads_case(shape):
    \"\"\"One loss's gradient of every leaf on ``shape``, summed over the
    data ranks (each rank's mean over its rows, halved at 2 data ranks),
    against the one-process gradient's piece: the largest error over each
    leaf's largest.\"\"\"
    from repro_torch.parallel.sharding import (Placement, batch_spec,
                                               local_shard)
    plan = MemoryPlan(1, "float32", True, "dots", 0.0, 1)
    mesh = build_mesh(shape, ("data", "model"), "cpu")
    ref = fresh(plan)
    state = shard_train_state(CFG, plan, fresh(plan), mesh)
    b = lm_batch(4, 16, 30)
    ref["model"].loss(b, remat=plan.remat)[0].backward()
    local = {k: local_shard(v, batch_spec(mesh, tuple(v.shape)), mesh)
             for k, v in b.items()}
    (state["model"].loss(local, remat=plan.remat)[0] / shape[0]).backward()
    worst = 0.0
    for name, pl in state["shardings"]["params"].items():
        g = state["params"][name].grad
        dist.all_reduce(g, group=mesh.get_group("data"))
        want = local_shard(ref["params"][name].grad,
                           Placement(pl.spec, pl.shape), mesh)
        worst = max(worst, ((g - want).abs().max()
                            / max(want.abs().max().item(), 1e-30)).item())
    return worst


def straddle_case():
    \"\"\"The reduced seamless at 6 heads over 3 KV heads on the world's 2
    ranks: 3 query heads a rank straddle KV groups of 2. The refusal's
    text, or None where nothing raised.\"\"\"
    from repro_torch.models import get_model
    from repro_torch.train import shard_model
    cfg = dataclasses.replace(get_config(ARCHS[0], reduced=True),
                              num_heads=6, num_kv_heads=3)
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    mesh = build_mesh((1, 2), ("data", "model"), "cpu")
    try:
        shard_model(cfg, MemoryPlan(1, "float32", True, "dots", 0.0), model,
                    mesh)
    except NotImplementedError as e:
        return str(e)
    return None
"""

_FOUR_RANKS = _BODY + """
for arch in ARCHS:
    use(arch)
    results[arch + ":dp2_tp2"] = step_pair((2, 2))
    results[arch + ":dp2_tp2_zero3"] = step_pair((2, 2), zero_stage=3)
    results[arch + ":tp4"] = step_pair((1, 4))
    results[arch + ":dp4_zero3"] = step_pair((4, 1), zero_stage=3, batch=8)
    results[arch + ":grads_dp2_tp2"] = grads_case((2, 2))
    results[arch + ":grads_tp4"] = grads_case((1, 4))
    results[arch + ":serve_dp2_tp2"] = serve_pair((2, 2))
    results[arch + ":serve_tp4"] = serve_pair((1, 4))
"""

_TWO_RANKS = _BODY + """
for arch in ARCHS:
    use(arch)
    results[arch + ":serve_tp2"] = serve_pair((1, 2))
results["straddle"] = straddle_case()
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run_job(_FOUR_RANKS, 4, tmp_path_factory.mktemp("encdec_four"))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run_job(_TWO_RANKS, 2, tmp_path_factory.mktemp("encdec_two"))


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
    """Each element counted once: the replicated KV projections at (1, 4)
    and the norms' gains among them."""
    for res in four:
        r = res[f"{arch}:{case}"]
        np.testing.assert_allclose(r["grad_norm"], r["ref_grad_norm"],
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["grads_dp2_tp2", "grads_tp4"])
def test_one_gradient_matches_one_process(four, arch, case):
    """The split backward alone, without AdamW: cross-attention's K/V
    projections on the rank's heads (replicated at (1, 4): every rank's
    part summed), the encoder output's gradient summed over the model axis,
    the vocabulary's split."""
    for res in four:
        assert res[f"{arch}:{case}"] <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_zero3_divides_the_parameters(four, arch):
    """(4, 1) ZeRO-3 keeps pieces of every leaf between steps."""
    for res in four:
        r = res[f"{arch}:dp4_zero3"]
        assert r["local_param_numel"] < 0.3 * r["full_param_numel"]


def _check_serving(r, arch, kv_heads):
    """The dense family's checks of the logits and tokens; each cache
    gathered whole within 1e-5 of the whole model's, with ``kv_heads`` KV
    heads a rank in every K/V cache (the encdec's cross K/V included)."""
    _check_logits(r)
    assert r["pos_equal"]
    names = (("self_k", "self_v", "cross_k", "cross_v")
             if arch.startswith("seamless") else ("k", "v"))
    assert set(r["cache_err"]) == set(names)
    for name, err in r["cache_err"].items():
        assert err <= 1e-5, (name, err)
    for name in names:
        assert r["local_shapes"][name][3] == kv_heads, name


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_split_over_2x2_matches_one_process(four, arch):
    """(2 data, 2 model): a prefill and three greedy ticks; the 2 KV heads
    split one a rank, in the self and the cross K/V alike."""
    for res in four:
        _check_serving(res[f"{arch}:serve_dp2_tp2"], arch, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_over_four_model_ranks_shares_the_kv_heads(four, arch):
    """(1, 4): the 2 KV heads are replicated. The prefill writes the whole
    cross K/V on every rank; each rank reads the KV head its query head
    shares, and writes only that one of its self K/V cache, within 1e-5 of
    the whole model's."""
    for rank, res in enumerate(four):
        r = res[f"{arch}:serve_tp4"]
        _check_logits(r)
        assert r["pos_equal"]
        own = rank // 2              # one query head a rank, two a KV head
        for name, errs in r["kv_head_err"].items():
            assert r["local_shapes"][name][3] == 2, name
            for head in (range(2) if name.startswith("cross") else [own]):
                assert errs[head] <= 1e-5, (name, head, errs)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_split_over_two_ranks_matches_one_process(two, arch):
    for res in two:
        _check_serving(res[f"{arch}:serve_tp2"], arch, 1)


def test_heads_that_straddle_kv_groups_raise_naming_the_layer(two):
    for res in two:
        assert res["straddle"] == ("encoder.0.attn: 3 query heads a rank "
                                   "straddle KV groups of 2")
