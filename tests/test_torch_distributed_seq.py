"""A train step and a prefill with each row's sequence split over the data
ranks, on gloo ranks on the CPU, against the JAX package.

``tests/test_torch_distributed.py``'s harness (``python -c`` ranks, a
``file://`` store under the test's temporary directory, a 180 s job
timeout, every rank killed once one fails). The reduced ``smollm-135m``
(dense), ``mamba2-780m`` (ssm) and ``zamba2-2.7b`` (hybrid) start from the
JAX package's ``init_params`` (fp32, converted once and read by every rank),
so that each rank's result is held to the reference itself:

  * the sharded step of a batch whose rows do not divide over the data
    ranks, its sequence split over them (``batch_spec``'s ``seq_shard``),
    against the reference's single-device ``make_train_step`` on the same
    batch (the reference's sharded jit step fails on this JAX, R2): at 2
    data ranks, at 4 (two microbatches of one row each), at (2 data, 2
    model), and on a (2 pod, 2 data, 1 model) mesh whose pod ranks hold the
    same positions; and where neither the rows nor the sequence divide
    (every data rank runs the whole microbatch). The MoE,
    encoder-decoder and VLM families: ``tests/test_torch_distributed_seq_
    families.py``;
  * ``attn_batch_shard`` on a (1 data, 2 model) mesh whose 3 heads do not
    divide over the model axis: the batch split over the model ranks gives
    the unsplit run's loss and gradients, and both runs, a forward and
    backward and a sharded step, are held to the reference's
    ``jax.value_and_grad`` and single-device step on the same batch;
  * the prefill of a batch served whole on every data rank (``shard_model``
    with ``batch_rows``), the prompt's rows split over the data ranks,
    against the reference's ``prefill``: the last row's logits (bitwise the
    same on every rank), the cache rows, the SSM and conv states; and a
    prompt whose length does not divide, run whole.

Tolerances: ``test_zamba2_twelve_steps_follow_the_reference``'s (the loss
within 1e-5 relative, the global norm within 1e-4, every parameter within
1e-3 of its leaf's largest magnitude); the prefill's logits 1e-4 and its
caches 1e-5 absolute, as ``tests/test_torch_models.py`` holds the port's
prefill to the reference's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.models import get_model as get_model_jax
from repro.parallel.policy import MemoryPlan as MemoryPlanJax
from repro.train import optimizer as opt_jax
from repro.train.train_step import make_train_step as make_train_step_jax
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from test_torch_distributed import _run_job

ARCHS = ("smollm-135m", "mamba2-780m", "zamba2-2.7b")
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
MAX_SEQ = 128
# case -> (ranks, mesh shape, mesh axes, batch rows, sequence, microbatches)
STEPS = {
    "dp2": (2, (2, 1), ("data", "model"), 1, 64, 1),
    "dp2_whole": (2, (2, 1), ("data", "model"), 1, 63, 1),
    "dp4": (4, (4, 1), ("data", "model"), 2, 64, 2),
    "dp2_tp2": (4, (2, 2), ("data", "model"), 1, 64, 1),
    "pod2_dp2": (4, (2, 2, 1), ("pod", "data", "model"), 1, 64, 1),
}
# case -> (ranks, mesh shape, prompt rows)
PREFILLS = {"dp2": (2, (2, 1), 48), "dp2_whole": (2, (2, 1), 47),
            "dp4": (4, (4, 1), 48), "dp2_tp2": (4, (2, 2), 48)}


def _tokens(b, s, seed):
    """(b, s + 1) int32 tokens of the reduced vocabulary from ``seed``."""
    vocab = get_config(ARCHS[0], reduced=True).vocab_size
    return np.random.RandomState(seed).randint(
        0, vocab, size=(b, s + 1)).astype(np.int32)


_BODY = """
import dataclasses
from repro_torch.models import get_model
from repro_torch.parallel.sharding import (all_gather_stacked,
                                           cache_shardings, gather_full,
                                           shard_cache)
from repro_torch.train import shard_model
from repro_torch.train.optimizer import init_state

WEIGHTS = WEIGHTS_DIR
STEPS, PREFILLS, MAX_SEQ = STEP_CASES, PREFILL_CASES, MAX_ROWS


def tokens(b, s, seed):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randint(0, CFG.vocab_size,
                                       size=(b, s + 1)).astype(np.int64))


def model_of(cfg, arch):
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(torch.load(
        os.path.join(WEIGHTS, "weights_" + arch + ".pt")))
    return model


def split_step(arch, case, cfg=None, tag=None):
    \"\"\"One sharded step of the case's batch from the reference's
    weights; rank 0 saves the gathered parameters under ``tag``.\"\"\"
    _, shape, axes, b, s, micro = STEPS[case]
    cfg = cfg or CFG
    plan = MemoryPlan(1, "float32", True, "dots", 0.0, micro)
    model = model_of(cfg, arch)
    params = dict(model.named_parameters())
    state = {"model": model, "params": params,
             "opt": init_state(params, OPT)}
    mesh = build_mesh(shape, axes, "cpu")
    state = shard_train_state(cfg, plan, state, mesh)
    toks = tokens(b, s, seed=20)
    state, m = sharded_train_step(cfg, plan, mesh, OPT)(
        state, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    full = gather_train_state(state, mesh)
    if rank == 0:
        torch.save(full["params"], os.path.join(
            out, "step_" + (tag or arch) + "_" + case + ".pt"))
    return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
            "seq_block_cleared": model.seq_block is None}


def split_prefill(arch, case):
    \"\"\"The prefill of one row served whole on every data rank; rank 0
    saves the logits and the gathered caches.\"\"\"
    _, shape, prompt = PREFILLS[case]
    plan = MemoryPlan(1, "float32", True, "dots", 0.0, 1)
    model = model_of(CFG, arch)
    mesh = build_mesh(shape, ("data", "model"), "cpu")
    shard_model(CFG, plan, model, mesh, batch_rows=1)
    whole = model.init_cache(1, MAX_SEQ)
    specs = cache_shardings(CFG, mesh, whole)
    cache = shard_cache(CFG, mesh, whole)
    with torch.no_grad():
        lg, cache = model.prefill(tokens(1, prompt, seed=30)[:, :-1], cache)
    gathered = {n: gather_full(cache[n], specs[n], mesh) for n in specs
                if n != "pos"}
    gathered["pos"] = cache["pos"]
    every = all_gather_stacked(lg.contiguous(), dist.group.WORLD)
    if rank == 0:
        torch.save({"logits": lg, "cache": gathered}, os.path.join(
            out, "prefill_" + arch + "_" + case + ".pt"))
    return {"logits_bitwise_on_every_rank": all(
        torch.equal(every[0], x) for x in every),
        "prompt_group": model.prompt_group is not None}


for arch in ARCHS:
    CFG = get_config(arch, reduced=True)
    for case, spec in STEPS.items():
        if spec[0] == world:
            results["step:" + arch + ":" + case] = split_step(arch, case)
    for case, spec in PREFILLS.items():
        if spec[0] == world:
            results["prefill:" + arch + ":" + case] = split_prefill(arch,
                                                                   case)


def batch_shard_run(flag):
    \"\"\"The reduced smollm with 3 query heads (one KV head), from the
    reference's weights, on a (1 data, 2 model) mesh: its attention is
    replicated over the model axis, and with ``flag`` (``attn_batch_shard``)
    each model rank runs it on its 2 of the 4 rows. One forward and
    backward, then one sharded step of a fresh copy; rank 0 saves the
    gradients and the updated parameters, gathered whole.\"\"\"
    from repro_torch.train.train_step import _forward_backward
    cfg = dataclasses.replace(CFG, num_heads=3, num_kv_heads=1,
                              attn_batch_shard=flag)
    plan = MemoryPlan(1, "float32", True, "dots", 0.0, 1)
    mesh = build_mesh((1, 2), ("data", "model"), "cpu")
    toks = tokens(4, 32, seed=21)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    model = model_of(cfg, "batch_shard")
    sh = shard_model(cfg, plan, model, mesh)
    params = dict(model.named_parameters())
    loss, _, grads = _forward_backward(model, params, batch, 1,
                                       torch.float32, plan.remat)
    whole = {n: gather_full(g, sh[n], mesh) for n, g in grads.items()}
    split = [layer.attn.batch_group is not None for layer in model.layers]
    model = model_of(cfg, "batch_shard")
    params = dict(model.named_parameters())
    state = {"model": model, "params": params,
             "opt": init_state(params, OPT)}
    state = shard_train_state(cfg, plan, state, mesh)
    state, m = sharded_train_step(cfg, plan, mesh, OPT)(state, batch)
    full = gather_train_state(state, mesh)
    if rank == 0:
        torch.save({"grads": whole, "params": full["params"]},
                   os.path.join(out, "batch_shard_" + str(flag) + ".pt"))
    return {"loss": loss.item(), "step_loss": m["loss"].item(),
            "grad_norm": m["grad_norm"].item(), "split": split,
            "step_split": [layer.attn.batch_group is not None
                           for layer in model.layers]}


if world == 2:
    CFG = get_config("smollm-135m", reduced=True)
    for flag in (False, True):
        results["batch_shard:" + str(flag)] = batch_shard_run(flag)
"""


def _batch_shard_configs():
    """The reduced smollm at 3 query heads and one KV head, so that its
    heads do not divide over 2 model ranks: (reference's, port's)."""
    heads = dict(num_heads=3, num_kv_heads=1)
    return (dataclasses.replace(get_config_jax("smollm-135m", reduced=True),
                                **heads),
            dataclasses.replace(get_config("smollm-135m", reduced=True),
                                **heads))


@functools.lru_cache(maxsize=None)
def _batch_shard_params():
    cfg_j, _ = _batch_shard_configs()
    return get_model_jax(cfg_j).init_params(jax.random.PRNGKey(0), cfg_j,
                                            dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _reference_batch_shard():
    """The reference on the job's batch (4 rows of 32, seed 21), single
    device: the loss and gradients of ``jax.value_and_grad`` and one step of
    ``make_train_step`` (loss, global norm, updated parameters), by the
    port's names."""
    cfg_j, cfg = _batch_shard_configs()
    params = _batch_shard_params()
    toks = _tokens(4, 32, seed=21)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:])}
    (loss, _), grads = jax.value_and_grad(
        lambda p: get_model_jax(cfg_j).loss(p, cfg_j, batch),
        has_aux=True)(params)
    cj = opt_jax.AdamWConfig(**OPT)
    step = jax.jit(make_train_step_jax(
        cfg_j, MemoryPlanJax(1, "float32", True, "dots", 0.0, 1), cj))
    state, m = step({"params": params, "opt": opt_jax.init_state(params, cj)},
                    batch, jax.random.PRNGKey(0))
    port = lambda tree: from_jax_params(jax.tree.map(np.asarray, tree), cfg)
    return {"loss": float(loss), "grads": port(grads),
            "step_loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": port(state["params"])}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference's fp32 parameters of each arch, and their conversion
    saved where the ranks read it."""
    directory = tmp_path_factory.mktemp("seq_weights")
    out = {}
    for arch in ARCHS:
        cfg_j = get_config_jax(arch, reduced=True)
        params = get_model_jax(cfg_j).init_params(jax.random.PRNGKey(0),
                                                  cfg_j, dtype=jnp.float32)
        out[arch] = params
        torch.save(from_jax_params(jax.tree.map(np.asarray, params),
                                   get_config(arch, reduced=True)),
                   directory / f"weights_{arch}.pt")
    _, cfg = _batch_shard_configs()
    torch.save(from_jax_params(jax.tree.map(np.asarray,
                                            _batch_shard_params()), cfg),
               directory / "weights_batch_shard.pt")
    return directory, out


def _job(weights, world, tmp_path_factory):
    body = (_BODY.replace("WEIGHTS_DIR", repr(str(weights[0])))
            .replace("STEP_CASES", repr(STEPS))
            .replace("PREFILL_CASES", repr(PREFILLS))
            .replace("MAX_ROWS", repr(MAX_SEQ)))
    body = "ARCHS = " + repr(ARCHS) + "\n" + body
    out = tmp_path_factory.mktemp(f"seq_{world}")
    return out, _run_job(body, world, out)


@pytest.fixture(scope="module")
def two(weights, tmp_path_factory):
    return _job(weights, 2, tmp_path_factory)


@pytest.fixture(scope="module")
def four(weights, tmp_path_factory):
    return _job(weights, 4, tmp_path_factory)


@functools.lru_cache(maxsize=None)
def _reference_step(arch, b, s, micro):
    """The reference's single-device step on the case's batch: (loss,
    global norm, the updated parameters by the port's names)."""
    cfg_j = get_config_jax(arch, reduced=True)
    params = get_model_jax(cfg_j).init_params(jax.random.PRNGKey(0), cfg_j,
                                              dtype=jnp.float32)
    cj = opt_jax.AdamWConfig(**OPT)
    step = jax.jit(make_train_step_jax(
        cfg_j, MemoryPlanJax(1, "float32", True, "dots", 0.0, micro), cj))
    toks = _tokens(b, s, seed=20)
    state, m = step({"params": params, "opt": opt_jax.init_state(params, cj)},
                    {"tokens": jnp.asarray(toks[:, :-1]),
                     "targets": jnp.asarray(toks[:, 1:])},
                    jax.random.PRNGKey(0))
    return (float(m["loss"]), float(m["grad_norm"]),
            from_jax_params(jax.tree.map(np.asarray, state["params"]),
                            get_config(arch, reduced=True)))


def _leaves_within(got, want, tol):
    """Every leaf of ``got`` within ``tol`` of its leaf's largest
    magnitude of ``want``."""
    assert set(got) == set(want)
    for name, w in want.items():
        scale = max(w.abs().max().item(), 1e-30)
        assert (got[name] - w).abs().max().item() <= tol * scale, name


def _step_results(two, four, case):
    out, res = two if STEPS[case][0] == 2 else four
    return out, res


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", list(STEPS))
def test_split_step_follows_the_reference(two, four, arch, case):
    """Every rank's loss within 1e-5 relative of the reference's and its
    global norm within 1e-4; the model's split record cleared after the
    step."""
    _, res = _step_results(two, four, case)
    _, _, _, b, s, micro = STEPS[case]
    loss, norm, _ = _reference_step(arch, b, s, micro)
    for r in res:
        got = r[f"step:{arch}:{case}"]
        assert got["loss"] == pytest.approx(loss, rel=1e-5)
        assert got["grad_norm"] == pytest.approx(norm, rel=1e-4)
        assert got["seq_block_cleared"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", list(STEPS))
def test_split_step_parameters_follow_the_reference(two, four, arch, case):
    """Every updated parameter, gathered whole, within 1e-3 of its leaf's
    largest magnitude of the reference's."""
    out, _ = _step_results(two, four, case)
    got = torch.load(out / f"step_{arch}_{case}.pt")
    _, _, _, b, s, micro = STEPS[case]
    _leaves_within(got, _reference_step(arch, b, s, micro)[2], 1e-3)


def test_attn_batch_shard_changes_nothing(two):
    """``attn_batch_shard`` where the rules replicate the attention over the
    model axis (3 heads over 2 model ranks): each rank attends over its
    block of the rows, and the loss and every gradient equal the unsplit
    run's (the loss within 1e-5 relative, each gradient within 1e-5 of its
    leaf's largest magnitude)."""
    out, res = two
    for r in res:
        plain, split = r["batch_shard:False"], r["batch_shard:True"]
        assert plain["split"] == plain["step_split"] == [False, False]
        assert split["split"] == split["step_split"] == [True, True]
        assert split["loss"] == pytest.approx(plain["loss"], rel=1e-5)
    got = torch.load(out / "batch_shard_True.pt")["grads"]
    want = torch.load(out / "batch_shard_False.pt")["grads"]
    _leaves_within(got, want, 1e-5)


@pytest.mark.parametrize("flag", [False, True])
def test_attn_batch_shard_follows_the_reference(two, flag):
    """The (1 data, 2 model) runs with and without ``attn_batch_shard``
    against the reference on the same weights and batch: the loss within
    1e-5 relative of ``jax.value_and_grad``'s and every gradient within
    1e-5 of its leaf's largest magnitude; the sharded step's loss within
    1e-5 relative, its global norm within 1e-4 and every updated parameter
    within 1e-3 of its leaf's largest, as the split steps above."""
    out, res = two
    ref = _reference_batch_shard()
    for r in res:
        got = r["batch_shard:" + str(flag)]
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        assert got["step_loss"] == pytest.approx(ref["step_loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-4)
    saved = torch.load(out / f"batch_shard_{flag}.pt")
    _leaves_within(saved["grads"], ref["grads"], 1e-5)
    _leaves_within(saved["params"], ref["params"], 1e-3)


@functools.lru_cache(maxsize=None)
def _reference_prefill(arch, prompt):
    cfg_j = get_config_jax(arch, reduced=True)
    mod = get_model_jax(cfg_j)
    params = mod.init_params(jax.random.PRNGKey(0), cfg_j, dtype=jnp.float32)
    toks = _tokens(1, prompt, seed=30)[:, :-1]
    lg, cache = mod.prefill(params, cfg_j, jnp.asarray(toks),
                            mod.init_cache(cfg_j, 1, MAX_SEQ,
                                           dtype=jnp.float32))
    return np.asarray(lg), jax.tree.map(np.asarray, cache)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", list(PREFILLS))
def test_split_prefill_follows_the_reference(two, four, arch, case):
    """The last row's logits within 1e-4 and bitwise the same on every
    rank; every cache gathered whole (the K/V rows, the SSM states, the
    conv tails, the clock) within 1e-5 of the reference's."""
    world, _, prompt = PREFILLS[case]
    out, res = two if world == 2 else four
    for r in res:
        got = r[f"prefill:{arch}:{case}"]
        assert got["logits_bitwise_on_every_rank"] and got["prompt_group"]
    saved = torch.load(out / f"prefill_{arch}_{case}.pt")
    lg, cache = _reference_prefill(arch, prompt)
    np.testing.assert_allclose(saved["logits"].numpy(), lg, atol=1e-4)
    assert set(saved["cache"]) == set(cache)
    for name, want in cache.items():
        got = saved["cache"][name].numpy()
        assert got.shape == want.shape, name
        if name == "pos":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
