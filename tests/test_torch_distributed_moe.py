"""The MoE family split over the model axis (expert parallelism and
expert-TP), its routing under data parallelism, and the reference's
microbatches, on gloo ranks on the CPU.

``tests/test_torch_distributed.py``'s harness (``python -c`` ranks, a
``file://`` store under the test's temporary directory, a 180 s job
timeout, every rank killed once one fails), one job a world size, each read
by many tests. The oracle is the port's one-process ``make_train_step`` (or
forward) on the global batch, itself held to ``jax.value_and_grad`` of the
reference in ``tests/test_torch_moe.py``; the reference's own sharded
programs run as one ``jit`` of the whole step, which routes the global
microbatch (``src/repro/train/train_step.py:63``).

* The microbatches: the reference cuts the global batch into ``m`` blocks
  of consecutive rows and splits each over the data ranks. Reduced
  smollm-135m on (2, 1), two microbatches, rows with uneven counts of
  ignored targets (16, 2, 16 and 8 of 16), so that another cut weighs the
  rows otherwise: the loss to 1e-6 relative.
* Global routing: reduced granite-moe with ``capacity_factor`` 0.5 (each
  expert keeps 8 of a microbatch's 32 routed (token, expert) pairs at 4
  ranks' 2 x 16 tokens, so experts overflow) on (2, 1) and (4, 1): the
  ``aux`` metric to 1e-6 relative, each layer's dropped pairs equal to one
  process's, each MoE layer's output at the rank's rows, the router's
  gradient.
* Expert parallelism (EP, ``num_experts`` divisible by the model axis:
  reduced granite's 4 experts, 2 a rank at (1, 2), 1 at (1, 4)) and
  expert-TP (3 experts at (1, 2), 6 at (1, 4): each expert's 64 hidden
  columns split), each with ``dispatch`` "gather" and "dense"; EP with
  ZeRO-3 on (2, 2), where the experts lie over both axes; reduced
  llama4-maverick (a MoE layer with a shared expert behind a dense layer)
  at (1, 2), (2, 2) and (1, 4).
* ``test_moe_ep_equivalence`` of ``tests/test_distributed.py`` restated:
  reduced llama4-maverick with ``capacity_factor`` 4.0 on a (2 data, 4
  model) mesh of eight ranks, one expert a rank, the logits of a forward
  within 2e-4 of one process's.
* Split serving of granite (``capacity_factor`` 0.5, so the split prefill's
  capacity binds) at (1, 2) and (2, 2) and of llama4 at (1, 4): a prefill
  and three greedy ticks against the whole model.

Tolerances: the split steps' as ``tests/test_torch_distributed.py``'s and
``test_moe_under_zero3_matches_zero1``'s: loss 2e-4, every parameter 5e-3
absolute, m, v and master 5e-3 of each leaf's largest, the global norm 1e-5
relative; one loss's gradients 1e-5 of each leaf's largest; a MoE layer's
output 1e-5 of its largest; serving's logits 1e-4 with the greedy tokens
equal.
"""

import numpy as np
import pytest

from test_torch_distributed import _check_serving, _run_job

_BODY = """
import dataclasses

from repro_torch.parallel.sharding import Placement, batch_spec, local_shard

GRANITE = get_config("granite-moe-3b-a800m", reduced=True)
LLAMA4 = get_config("llama4-maverick-400b-a17b", reduced=True)


def moe_cfg(base=GRANITE, **moe):
    return dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                             **moe))


def use(cfg):
    global CFG
    CFG = cfg


def moes(model):
    return [layer.moe for layer in model.layers if hasattr(layer, "moe")]


def split_by_experts(moe):
    \"\"\"EP: the rank holds fewer than all the experts.\"\"\"
    return moe.we_up.shape[0] < moe.cfg.moe.num_experts


def moe_pair(shape, zero_stage=1, micro=2, batch=4, steps=2, make=None):
    \"\"\"``steps`` sharded steps of CFG against make_train_step from one
    state: every metric of each step, and the gathered state's errors.\"\"\"
    plan = MemoryPlan(zero_stage, "float32", True, "dots", 0.0, micro)
    ref, step_ref = fresh(plan), make_train_step(CFG, plan, OPT)
    mesh = build_mesh(shape, ("data", "model"), "cpu")
    state = shard_train_state(CFG, plan, fresh(plan), mesh)
    step = sharded_train_step(CFG, plan, mesh, OPT)
    keys = ("loss", "ce", "aux", "grad_norm")
    out = {k: [] for k in keys}
    out.update({"ref_" + k: [] for k in keys})
    for i in range(steps):
        b = (make or lm_batch)(batch, 16, 10 + i)
        ref, mr = step_ref(ref, b)
        state, ms = step(state, b)
        for k in keys:
            out[k].append(ms[k].item())
            out["ref_" + k].append(mr[k].item())
    full = gather_train_state(state, mesh)
    out["param_abs_err"] = max(
        (full["params"][n] - p.detach()).abs().max().item()
        for n, p in ref["params"].items())
    out["param_scale"] = max(p.abs().max().item()
                             for p in ref["params"].values())
    for part in ("m", "v", "master"):
        out[part + "_scaled_err"] = scaled_err(full["opt"][part],
                                               ref["opt"][part])
    out["local_param_numel"] = sum(p.numel() for p in state["params"].values())
    out["full_param_numel"] = sum(p.numel() for p in ref["params"].values())
    if CFG.moe is not None:
        out["local_expert_shape"] = list(state["params"][
            f"layers.{CFG.moe.moe_every - 1}.moe.we_up"].shape)
    return out


def uneven_batch(b, s, seed):
    \"\"\"lm_batch with 16, 2, 16 and 8 of each row's 16 targets kept.\"\"\"
    out = lm_batch(b, s, seed)
    out["targets"][1, 2:] = -1
    out["targets"][3, :8] = -1
    return out


def forward_case(shape):
    \"\"\"One loss of CFG's model sharded over ``shape`` (each rank's
    share of the targets, as the step weighs it) against one process's on
    the global batch: the gradient of every leaf (the largest error over
    each leaf's largest, and the router's alone), each MoE layer's output
    at the rank's rows (over its largest) and its (token, expert) pairs
    routed and dropped, summed over the ranks that split them.\"\"\"
    plan = MemoryPlan(1, "float32", True, "dots", 0.0, 1)
    mesh = build_mesh(shape, ("data", "model"), "cpu")
    ref = fresh(plan)
    state = shard_train_state(CFG, plan, fresh(plan), mesh)
    model = state["model"]
    b = lm_batch(4 * shape[0], 16, 30)
    outs = {}

    def keep(tag, i):
        def hook(module, args, result):
            outs[(tag, i)] = result[0].detach()
        return hook

    for tag, m in (("ref", ref["model"]), ("split", model)):
        for i, moe in enumerate(moes(m)):
            moe.stats = {}
            moe.register_forward_hook(keep(tag, i))
    ref["model"].loss(b, remat="none")[0].backward()
    rows = batch_spec(mesh, (b["tokens"].shape[0],))
    local = {k: local_shard(v, rows + (None,) * (v.dim() - 1), mesh)
             for k, v in b.items()}
    (model.loss(local, remat="none")[0] / shape[0]).backward()
    worst, router = 0.0, 0.0
    for name, pl in state["shardings"]["params"].items():
        g = state["params"][name].grad
        dist.all_reduce(g, group=mesh.get_group("data"))
        want = local_shard(ref["params"][name].grad,
                           Placement(pl.spec, pl.shape), mesh)
        err = ((g - want).abs().max()
               / max(want.abs().max().item(), 1e-30)).item()
        worst = max(worst, err)
        if name.endswith("router"):
            router = max(router, err)
    split_ep = split_by_experts(moes(model)[0])
    layers = []
    for i, (mine, theirs) in enumerate(zip(moes(model), moes(ref["model"]))):
        want = local_shard(outs[("ref", i)], rows + (None, None), mesh)
        counts = torch.stack([mine.stats["routed"], mine.stats["kept"]])
        counts = counts.float()
        dist.all_reduce(counts, group=mesh.get_group("data"))
        if split_ep:
            dist.all_reduce(counts, group=mesh.get_group("model"))
        layers.append({
            "out_err": ((outs[("split", i)] - want).abs().max()
                        / want.abs().max()).item(),
            "routed": int(counts[0]), "dropped": int(counts[0] - counts[1]),
            "ref_routed": int(theirs.stats["routed"]),
            "ref_dropped": int(theirs.stats["routed"] - theirs.stats["kept"])})
    return {"grad_err": worst, "router_grad_err": router, "layers": layers,
            "experts_split": split_ep,
            "tp_group": moes(model)[0].tp_group is not None}


def ep_equivalence_case():
    \"\"\"``test_moe_ep_equivalence``: reduced llama4 with 4 experts and
    capacity_factor 4.0, its forward's logits on a (2, 4) mesh against one
    process's: the largest difference.\"\"\"
    from repro_torch.models import get_model
    from repro_torch.train import shard_model
    cfg = moe_cfg(LLAMA4, num_experts=4, capacity_factor=4.0)
    make = lambda: get_model(cfg)(cfg, dtype=torch.float32, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    ref, model = make(), make()
    mesh = build_mesh((2, 4), ("data", "model"), "cpu")
    shard_model(cfg, MemoryPlan(1, "float32", True, "dots", 0.0), model,
                mesh, batch_rows=4)
    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(4, 16)))
    rows = batch_spec(mesh, (4,))
    with torch.no_grad():
        want = ref(tokens)[0]
        got = model(local_shard(tokens, rows + (None,), mesh))[0]
    want = local_shard(want, rows + (None, None), mesh)
    return {"err": (got - want).abs().max().item(),
            "experts_split": split_by_experts(moes(model)[0]),
            "local_experts": moes(model)[0].we_up.shape[0]}
"""

_TWO_RANKS = _BODY + """
use(get_config("smollm-135m", reduced=True))
results["microbatches_dp2"] = moe_pair((2, 1), make=uneven_batch)
use(moe_cfg(capacity_factor=0.5))
results["route_dp2"] = moe_pair((2, 1))
results["route_dp2_forward"] = forward_case((2, 1))
for dispatch in ("gather", "dense"):
    use(moe_cfg(dispatch=dispatch))
    results["ep_tp2_" + dispatch] = moe_pair((1, 2))
    results["ep_tp2_" + dispatch + "_forward"] = forward_case((1, 2))
    use(moe_cfg(num_experts=3, dispatch=dispatch))
    results["etp_tp2_" + dispatch] = moe_pair((1, 2))
    results["etp_tp2_" + dispatch + "_forward"] = forward_case((1, 2))
use(moe_cfg(capacity_factor=0.5))
results["serve_tp2"] = serve_pair((1, 2))
use(LLAMA4)
results["llama4_tp2"] = moe_pair((1, 2))
"""

_FOUR_RANKS = _BODY + """
use(moe_cfg(capacity_factor=0.5))
results["route_dp4"] = moe_pair((4, 1), batch=8)
results["route_dp4_forward"] = forward_case((4, 1))
results["ep_dp2_tp2_zero3"] = moe_pair((2, 2), zero_stage=3)
results["ep_dp2_tp2_forward"] = forward_case((2, 2))
results["serve_dp2_tp2"] = serve_pair((2, 2))
use(GRANITE)
results["ep_tp4"] = moe_pair((1, 4))
for dispatch in ("gather", "dense"):
    use(moe_cfg(num_experts=6, dispatch=dispatch))
    results["etp_tp4_" + dispatch] = moe_pair((1, 4))
use(LLAMA4)
results["llama4_dp2_tp2"] = moe_pair((2, 2))
results["llama4_tp4"] = moe_pair((1, 4))
results["llama4_tp4_forward"] = forward_case((1, 4))
results["serve_llama4_tp4"] = serve_pair((1, 4))
"""

_EIGHT_RANKS = _BODY + """
results["ep_equivalence"] = ep_equivalence_case()
"""


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run_job(_TWO_RANKS, 2, tmp_path_factory.mktemp("moe_two"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run_job(_FOUR_RANKS, 4, tmp_path_factory.mktemp("moe_four"))


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    return _run_job(_EIGHT_RANKS, 8, tmp_path_factory.mktemp("moe_eight"))


def _jobs(two, four):
    return {"two": two, "four": four}


def _check_step(r):
    """Every step's loss, global norm and ``aux``, then the gathered
    parameters and moments."""
    np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(r["grad_norm"], r["ref_grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(r["aux"], r["ref_aux"], rtol=1e-6)
    assert r["param_abs_err"] <= 5e-3 * max(1.0, r["param_scale"])
    for part in ("m", "v", "master"):
        assert r[part + "_scaled_err"] <= 5e-3, part


# ------------------------------------------------------------------------- #
# The repairs: the reference's microbatches and its routing under DP
# ------------------------------------------------------------------------- #

def test_microbatches_are_the_references(two):
    """(2, 1), two microbatches of two rows, the rows keeping 16, 2, 16 and
    8 targets: microbatch i is rows [2i, 2i + 2) split over the two ranks,
    so each microbatch's mean weighs its rows as the reference's does (rows
    {0, 2} and {1, 3} would give another loss)."""
    for res in two:
        r = res["microbatches_dp2"]
        np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-6)
        _check_step(r)


@pytest.mark.parametrize("case", ["route_dp2", "route_dp4"])
def test_moe_routes_the_global_microbatch_under_data_parallelism(two, four,
                                                                case):
    """granite-moe reduced at capacity_factor 0.5 on (2, 1) and (4, 1), two
    steps of two microbatches: the auxiliary loss is the global
    microbatch's (to 1e-6 relative; each rank's own misses it by ~2e-4 at 2
    ranks, ~6e-3 at 4), and so is the step."""
    job = two if case.endswith("2") else four
    for res in job:
        r = res[case]
        np.testing.assert_allclose(r["aux"], r["ref_aux"], rtol=1e-6)
        np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-6)
        _check_step(r)


@pytest.mark.parametrize("case", ["route_dp2_forward", "route_dp4_forward"])
def test_capacity_drops_are_the_global_microbatchs(two, four, case):
    """One loss at capacity_factor 0.5: experts overflow, and each MoE
    layer drops as many (token, expert) pairs over the ranks as one process
    does over the global batch, the same ones (its output at the rank's
    rows within 1e-5 of one process's); every gradient, the router's among
    them, within 1e-5 of each leaf's largest."""
    job = two if case.startswith("route_dp2") else four
    for res in job:
        r = res[case]
        for layer in r["layers"]:
            assert layer["ref_dropped"] > 0, layer
            assert layer["routed"] == layer["ref_routed"], layer
            assert layer["dropped"] == layer["ref_dropped"], layer
            assert layer["out_err"] <= 1e-5, layer
        assert r["router_grad_err"] <= 1e-5
        assert r["grad_err"] <= 1e-5


# ------------------------------------------------------------------------- #
# Item 11: the experts over the model axis
# ------------------------------------------------------------------------- #

SPLIT_STEPS = [("two", "ep_tp2_gather", [2, 64, 64]),
               ("two", "ep_tp2_dense", [2, 64, 64]),
               ("two", "etp_tp2_gather", [3, 64, 32]),
               ("two", "etp_tp2_dense", [3, 64, 32]),
               ("four", "ep_tp4", [1, 64, 64]),
               ("four", "etp_tp4_gather", [6, 64, 16]),
               ("four", "etp_tp4_dense", [6, 64, 16]),
               ("two", "llama4_tp2", [2, 64, 64]),
               ("four", "llama4_dp2_tp2", [2, 64, 64]),
               ("four", "llama4_tp4", [1, 64, 64])]


@pytest.mark.parametrize("job,case,local", SPLIT_STEPS)
def test_split_moe_step_matches_one_process(two, four, job, case, local):
    """Two steps of two microbatches split over the model axis against
    ``make_train_step``: EP (whole experts a rank) where the experts divide
    over the axis, else expert-TP (each expert's hidden columns), with both
    dispatches; each rank's expert leaf is the piece the rules give it."""
    for res in _jobs(two, four)[job]:
        r = res[case]
        _check_step(r)
        assert r["local_expert_shape"] == local


@pytest.mark.parametrize("job,case,split", [
    ("two", "ep_tp2_gather_forward", True),
    ("two", "ep_tp2_dense_forward", True),
    ("two", "etp_tp2_gather_forward", False),
    ("two", "etp_tp2_dense_forward", False),
    ("four", "llama4_tp4_forward", True),
    ("four", "ep_dp2_tp2_forward", True)])
def test_split_moe_gradients_match_one_process(two, four, job, case, split):
    """One loss's gradients without AdamW: the router, replicated, gets the
    one-process gradient on every rank (the dispatch's part summed over the
    ranks' experts, the auxiliary loss's counted once); the experts' pieces
    and each MoE layer's output as one process's."""
    for res in _jobs(two, four)[job]:
        r = res[case]
        assert r["tp_group"] and r["experts_split"] == split
        assert r["router_grad_err"] <= 1e-5
        assert r["grad_err"] <= 1e-5
        for layer in r["layers"]:
            assert layer["out_err"] <= 1e-5, layer
            assert layer["routed"] == layer["ref_routed"], layer
            assert layer["dropped"] == layer["ref_dropped"], layer


def test_ep_with_zero3_over_both_axes(four):
    """(2, 2) ZeRO-3 at capacity_factor 0.5: the experts split over the
    model axis (2 a rank) and each piece over the data axis, gathered where
    read; the routing global over the data axis."""
    for res in four:
        r = res["ep_dp2_tp2_zero3"]
        _check_step(r)
        assert r["local_expert_shape"] == [2, 64, 32]
        assert r["local_param_numel"] < 0.4 * r["full_param_numel"]


def test_moe_ep_equivalence(eight):
    """The reference's test on its (2 data, 4 model) mesh: reduced llama4
    with 4 experts at capacity_factor 4.0, one expert a rank, the forward's
    logits within 2e-4 of one process's."""
    for res in eight:
        r = res["ep_equivalence"]
        assert r["experts_split"] and r["local_experts"] == 1
        assert r["err"] <= 2e-4


# ------------------------------------------------------------------------- #
# Split serving
# ------------------------------------------------------------------------- #

@pytest.mark.parametrize("job,case", [("two", "serve_tp2"),
                                      ("four", "serve_dp2_tp2"),
                                      ("four", "serve_llama4_tp4")])
def test_split_moe_serving_matches_one_process(two, four, job, case):
    """A prefill and three greedy ticks split over the mesh against the
    whole model: granite at capacity_factor 0.5 (the split prefill's
    capacity binds; at (2, 2) it is the global batch's), llama4 with its
    shared expert split; the logits all-gathered."""
    for res in _jobs(two, four)[job]:
        _check_serving(res[case])
