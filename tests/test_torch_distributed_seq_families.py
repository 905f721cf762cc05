"""A train step and a prefill with each row's sequence split over the data
ranks for the MoE, encoder-decoder and VLM families, on gloo ranks on the
CPU, against the JAX package.

``tests/test_torch_distributed.py``'s harness (``python -c`` ranks, a
``file://`` store under the test's temporary directory, a 180 s job
timeout, every rank killed once one fails), as
``tests/test_torch_distributed_seq.py`` runs it for the other families.
The reduced ``granite-moe-3b-a800m`` (``capacity_factor`` 0.55, so that
each expert keeps at most 17 of a 64-token microbatch's tokens and capacity
drops pairs, and so that the capacity of twice the tokens is not twice the
capacity: int(35.2) = 2 x 17 + 1), ``seamless-m4t-large-v2`` (24 source
frames, whole on every rank)
and ``internvl2-76b`` (8 patches ahead of the tokens, in rank 0's block)
start from the JAX package's ``init_params`` (fp32, converted once and
read by every rank), and every input is drawn once here and read by the
ranks, so that each rank's result is held to the reference itself:

  * the sharded step of a batch whose rows do not divide over the data
    ranks, its sequence split over them, against the reference's
    single-device ``make_train_step`` on the same batch: at 2 data ranks;
    at 4 with two one-row microbatches; at 4 with one microbatch of 2 rows
    (the MoE's gathered tokens lie (rank, row, position), the reference's
    order (row, rank, position)); at (2 data, 2 model), the MoE's 4
    experts 2 a rank (EP); and on a (2 pod, 2 data, 1 model) mesh whose
    pod ranks hold the same positions, so that the MoE routes over the data
    axis alone. The MoE's ``aux`` metric and each layer's capacity drops
    too: the reference's kept (token, expert) pairs are counted in its own
    trunk, through a wrapped ``moe_block`` and ``jax.debug.callback``;
  * the prefill of one row served whole on every data rank (``shard_model``
    with ``batch_rows``), the prompt split over the data ranks, against the
    reference's ``prefill`` (the MoE capping over the whole prompt, the
    encdec's cross K/V cache split along the source, the VLM's patches on
    rank 0); and a prompt whose length does not divide, run whole;
  * ``moe_block`` alone on 4 ranks, each holding its block of the
    positions of a 2-row input, with a zero router, so that every gate ties
    and the reference breaks every tie by (b, s) index: the outputs, the
    auxiliary loss and each expert's kept tokens against the reference's
    ``moe_block`` on the whole input.

Tolerances: ``tests/test_torch_distributed_seq.py``'s (the loss within
1e-5 relative, the global norm within 1e-4, every parameter within 1e-3 of
its leaf's largest magnitude; the prefill's logits 1e-4 and its caches 1e-5
absolute); ``aux`` within 1e-5 relative and the drops equal; the lone
``moe_block``'s outputs within 1e-5 of their largest.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as transformer_jax
from repro.configs import get_config as get_config_jax
from repro.models import get_model as get_model_jax
from repro.models.common import moe_block as moe_block_jax
from repro.parallel.policy import MemoryPlan as MemoryPlanJax
from repro.train import optimizer as opt_jax
from repro.train.train_step import make_train_step as make_train_step_jax
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from test_torch_distributed import _run_job

MOE, ENCDEC, VLM = ("granite-moe-3b-a800m", "seamless-m4t-large-v2",
                    "internvl2-76b")
ARCHS = (MOE, ENCDEC, VLM)
CAPACITY = 0.55
SRC = 24               # the encdec's source frames
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
MAX_SEQ = 128
# case -> (ranks, mesh shape, mesh axes, batch rows, sequence, microbatches)
STEPS = {
    "dp2": (2, (2, 1), ("data", "model"), 1, 64, 1),
    "dp4": (4, (4, 1), ("data", "model"), 2, 64, 2),
    "dp4_rows2": (4, (4, 1), ("data", "model"), 2, 64, 1),
    "dp2_tp2": (4, (2, 2), ("data", "model"), 1, 64, 1),
    "pod2_dp2": (4, (2, 2, 1), ("pod", "data", "model"), 1, 64, 1),
}
# case -> (ranks, mesh shape, prompt rows)
PREFILLS = {"dp2": (2, (2, 1), 48), "dp2_whole": (2, (2, 1), 47),
            "dp4": (4, (4, 1), 48), "dp2_tp2": (4, (2, 2), 48)}
# the lone moe_block: experts, width, hidden, top-k, rows, positions
TIED = dict(e=4, d=16, f=8, k=2, b=2, s=16)


def _cfg(get, arch):
    """``arch``'s reduced config from ``get``, the MoE's at CAPACITY."""
    cfg = get(arch, reduced=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CAPACITY))
    return cfg


def _batch(arch, b, s, seed):
    """(b, s) tokens and targets of the reduced vocabulary, and the
    family's input (the encdec's frames, the VLM's patches), from
    ``seed``."""
    cfg = get_config(arch, reduced=True)
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "encdec":
        out["frames"] = rs.randn(b, SRC, cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rs.randn(b, cfg.vision.num_patches,
                                  cfg.d_model).astype(np.float32)
    return out


def _tied_inputs():
    """The lone ``moe_block``'s inputs: a zero router, the experts and x."""
    e, d, f, b, s = (TIED[k] for k in ("e", "d", "f", "b", "s"))
    rs = np.random.RandomState(40)
    params = {"router": np.zeros((d, e), np.float32)}
    for name, shape in (("we_gate", (e, d, f)), ("we_up", (e, d, f)),
                        ("we_down", (e, f, d))):
        params[name] = (0.3 * rs.randn(*shape)).astype(np.float32)
    return params, rs.randn(b, s, d).astype(np.float32)


_BODY = """
import dataclasses
from repro_torch.models import common, get_model
from repro_torch.parallel.sharding import (SeqBlock, all_gather_stacked,
                                           cache_shardings, gather_full,
                                           shard_cache)
from repro_torch.train import shard_model
from repro_torch.train.optimizer import init_state

WEIGHTS = WEIGHTS_DIR
STEPS, PREFILLS, MAX_SEQ, SRC = STEP_CASES, PREFILL_CASES, MAX_ROWS, SRC_ROWS
CAPACITY, TIED = CAPACITY_FACTOR, TIED_SHAPE


def config(arch):
    cfg = get_config(arch, reduced=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CAPACITY))
    return cfg


def saved(name):
    return torch.load(os.path.join(WEIGHTS, name + ".pt"))


def model_of(cfg, arch):
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(saved("weights_" + arch))
    return model


def moes_of(model):
    return [layer.moe for layer in getattr(model, "layers", ())
            if hasattr(layer, "moe")]


def drops(moes, mesh):
    \"\"\"Each MoE layer's (token, expert) pairs dropped for capacity in
    its last call, summed over the ranks that hold other tokens (the data
    axis; a pod axis's ranks hold the same ones) and, under EP, other
    experts (the model axis).\"\"\"
    out = []
    for moe in moes:
        n = (moe.stats["routed"] - moe.stats["kept"]).reshape(1).float()
        ep = moe.we_up.shape[0] < moe.cfg.moe.num_experts
        for a in ("data",) + (("model",) if ep else ()):
            dist.all_reduce(n, group=mesh.get_group(a))
        out.append(int(n.item()))
    return out


def split_step(arch, case):
    \"\"\"One sharded step of the case's batch from the reference's
    weights; rank 0 saves the gathered parameters.\"\"\"
    _, shape, axes, b, s, micro = STEPS[case]
    cfg = config(arch)
    plan = MemoryPlan(1, "float32", True, "dots", 0.0, micro)
    model = model_of(cfg, arch)
    params = dict(model.named_parameters())
    state = {"model": model, "params": params,
             "opt": init_state(params, OPT)}
    mesh = build_mesh(shape, axes, "cpu")
    state = shard_train_state(cfg, plan, state, mesh)
    for moe in moes_of(model):
        moe.stats = {}
    batch = saved("batch_" + arch + "_" + case)
    state, m = sharded_train_step(cfg, plan, mesh, OPT)(state, batch)
    full = gather_train_state(state, mesh)
    if rank == 0:
        torch.save(full["params"], os.path.join(
            out, "step_" + arch + "_" + case + ".pt"))
    return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
            "aux": m["aux"].item(), "dropped": drops(moes_of(model), mesh),
            "seq_block_cleared": model.seq_block is None}


def split_prefill(arch, case):
    \"\"\"The prefill of one row served whole on every data rank; rank 0
    saves the logits and the gathered caches.\"\"\"
    _, shape, prompt = PREFILLS[case]
    cfg = config(arch)
    plan = MemoryPlan(1, "float32", True, "dots", 0.0, 1)
    model = model_of(cfg, arch)
    mesh = build_mesh(shape, ("data", "model"), "cpu")
    shard_model(cfg, plan, model, mesh, batch_rows=1)
    inputs = saved("prefill_" + arch + "_" + str(prompt))
    tokens = inputs.pop("tokens")
    whole = model.init_cache(1, MAX_SEQ, *((SRC,) if "frames" in inputs
                                          else ()))
    specs = cache_shardings(cfg, mesh, whole)
    cache = shard_cache(cfg, mesh, whole)
    with torch.no_grad():
        lg, cache = model.prefill(tokens, cache, **inputs)
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


def tied_moe():
    \"\"\"moe_block on this rank's block of the positions of the lone
    input, every rank one data rank: its output rows, the auxiliary loss
    and, for each expert, the global (b, s) index of each token it kept
    (the picks recorded through a wrapped ``_pick``).\"\"\"
    params, x = saved("tied_moe")
    b, s = x.shape[:2]
    rows = s // world
    first = rank * rows
    picks, pick = [], common._pick

    def recording(*args, **kwargs):
        picks.append(pick(*args, **kwargs))
        return picks[-1]

    common._pick = recording
    try:
        y, aux = common.moe_block(
            params, x[:, first:first + rows].contiguous(), top_k=TIED["k"],
            capacity_factor=CAPACITY, activation="swiglu",
            aux_loss_weight=0.01, seq=SeqBlock(dist.group.WORLD, first))
    finally:
        common._pick = pick
    vals, idx, keep = picks[0]
    kept = keep & (vals > 0)
    index = (idx // rows) * s + first + idx % rows
    return {"y": y.tolist(), "aux": aux.item(),
            "kept": [index[j][kept[j]].tolist() for j in range(len(idx))]}


for arch in ARCHS:
    for case, spec in STEPS.items():
        if spec[0] == world:
            results["step:" + arch + ":" + case] = split_step(arch, case)
    for case, spec in PREFILLS.items():
        if spec[0] == world:
            results["prefill:" + arch + ":" + case] = split_prefill(arch,
                                                                   case)
if world == 4:
    results["tied_moe"] = tied_moe()
"""


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference's fp32 parameters of each arch and their conversion,
    every case's inputs and the lone moe_block's, saved where the ranks
    read them."""
    directory = tmp_path_factory.mktemp("seq_family_weights")
    for arch in ARCHS:
        torch.save(from_jax_params(
            jax.tree.map(np.asarray, _reference_params(arch)),
            _cfg(get_config, arch)), directory / f"weights_{arch}.pt")
        for case, (_, _, _, b, s, _) in STEPS.items():
            batch = {k: torch.from_numpy(v) for k, v in
                     _batch(arch, b, s, seed=20).items()}
            for k in ("tokens", "targets"):
                batch[k] = batch[k].long()
            torch.save(batch, directory / f"batch_{arch}_{case}.pt")
        for prompt in {p for _, _, p in PREFILLS.values()}:
            inputs = {k: torch.from_numpy(v) for k, v in
                      _batch(arch, 1, prompt, seed=30).items()
                      if k != "targets"}
            inputs["tokens"] = inputs["tokens"].long()
            torch.save(inputs, directory / f"prefill_{arch}_{prompt}.pt")
    params, x = _tied_inputs()
    torch.save(({k: torch.from_numpy(v) for k, v in params.items()},
                torch.from_numpy(x)), directory / "tied_moe.pt")
    return directory


def _job(weights, world, tmp_path_factory):
    body = (_BODY.replace("WEIGHTS_DIR", repr(str(weights)))
            .replace("STEP_CASES", repr(STEPS))
            .replace("PREFILL_CASES", repr(PREFILLS))
            .replace("MAX_ROWS", repr(MAX_SEQ))
            .replace("SRC_ROWS", repr(SRC))
            .replace("CAPACITY_FACTOR", repr(CAPACITY))
            .replace("TIED_SHAPE", repr(TIED)))
    body = "ARCHS = " + repr(ARCHS) + "\n" + body
    out = tmp_path_factory.mktemp(f"seq_families_{world}")
    return out, _run_job(body, world, out)


@pytest.fixture(scope="module")
def two(weights, tmp_path_factory):
    return _job(weights, 2, tmp_path_factory)


@pytest.fixture(scope="module")
def four(weights, tmp_path_factory):
    return _job(weights, 4, tmp_path_factory)


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    cfg_j = _cfg(get_config_jax, arch)
    return get_model_jax(cfg_j).init_params(jax.random.PRNGKey(0), cfg_j,
                                            dtype=jnp.float32)


def _reference_kept(params, x, top_k, capacity_factor):
    """The (token, expert) pairs the reference's ``moe_block`` keeps on x
    (b, s, d) at ``s > 1``, by its own steps: each expert's top ``cap`` of
    the combine matrix by ``jax.lax.top_k``. Returns the picked tokens (e,
    cap) and whether each holds a gate (a pair routed there)."""
    b, s, d = x.shape
    t = b * s
    probs = jax.nn.softmax(x.reshape(t, d).astype(jnp.float32)
                           @ params["router"], axis=-1)
    e = probs.shape[1]
    gate_vals, gate_idx = jax.lax.top_k(probs, top_k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    combine = jnp.zeros((t, e), jnp.float32).at[
        jnp.arange(t)[:, None], gate_idx].set(gate_vals)
    cap = min(t, max(1, int(t * top_k * capacity_factor / e)))
    sel_val, sel_idx = jax.lax.top_k(combine.T, cap)
    return sel_idx, sel_val > 0


def _reference_drops(arch, batch):
    """Each MoE layer's (token, expert) pairs the reference drops for
    capacity in one loss of ``batch``: its trunk's ``moe_block`` wrapped,
    the kept pairs read out through ``jax.debug.callback``."""
    cfg_j = _cfg(get_config_jax, arch)
    kept, block = [], transformer_jax.moe_block

    def recording(params, x, **kw):
        _, held = _reference_kept(params, x, kw["top_k"],
                                  kw["capacity_factor"])
        jax.debug.callback(lambda n: kept.append(int(n)), held.sum(),
                           ordered=True)
        return block(params, x, **kw)

    transformer_jax.moe_block = recording
    try:
        get_model_jax(cfg_j).loss(_reference_params(arch), cfg_j,
                                  jax.tree.map(jnp.asarray, batch))
        jax.effects_barrier()
    finally:
        transformer_jax.moe_block = block
    routed = batch["tokens"].size * cfg_j.moe.top_k
    return [routed - n for n in kept]


@functools.lru_cache(maxsize=None)
def _reference_step(arch, b, s, micro):
    """The reference's single-device step on the case's batch: (loss,
    global norm, aux, the updated parameters by the port's names, each
    MoE layer's drops in the last microbatch)."""
    cfg_j = _cfg(get_config_jax, arch)
    params = _reference_params(arch)
    cj = opt_jax.AdamWConfig(**OPT)
    step = jax.jit(make_train_step_jax(
        cfg_j, MemoryPlanJax(1, "float32", True, "dots", 0.0, micro), cj))
    batch = _batch(arch, b, s, seed=20)
    state, m = step({"params": params, "opt": opt_jax.init_state(params, cj)},
                    jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    dropped = []
    if cfg_j.moe is not None:
        rows = b // micro
        dropped = _reference_drops(
            arch, {k: v[b - rows:] for k, v in batch.items()})
    return (float(m["loss"]), float(m["grad_norm"]), float(m["aux"]),
            from_jax_params(jax.tree.map(np.asarray, state["params"]),
                            _cfg(get_config, arch)), dropped)


def _results(two, four, world):
    return two if world == 2 else four


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", list(STEPS))
def test_split_step_follows_the_reference(two, four, arch, case):
    """Every rank's loss within 1e-5 relative of the reference's and its
    global norm within 1e-4; the model's split record cleared after the
    step."""
    _, res = _results(two, four, STEPS[case][0])
    _, _, _, b, s, micro = STEPS[case]
    loss, norm = _reference_step(arch, b, s, micro)[:2]
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
    out, _ = _results(two, four, STEPS[case][0])
    got = torch.load(out / f"step_{arch}_{case}.pt")
    _, _, _, b, s, micro = STEPS[case]
    want = _reference_step(arch, b, s, micro)[3]
    assert set(got) == set(want)
    for name, w in want.items():
        scale = max(w.abs().max().item(), 1e-30)
        assert (got[name] - w).abs().max().item() <= 1e-3 * scale, name


@pytest.mark.parametrize("case", list(STEPS))
def test_split_moe_routes_as_the_reference(two, four, case):
    """The MoE's auxiliary loss within 1e-5 relative of the reference's on
    every rank, and each layer's capacity drops (the last microbatch's)
    equal to the reference's: the pick is the global microbatch's in the
    reference's (b, s) order."""
    _, res = _results(two, four, STEPS[case][0])
    _, _, _, b, s, micro = STEPS[case]
    _, _, aux, _, dropped = _reference_step(MOE, b, s, micro)
    assert dropped and all(n > 0 for n in dropped)
    for r in res:
        got = r[f"step:{MOE}:{case}"]
        assert got["aux"] == pytest.approx(aux, rel=1e-5)
        assert got["dropped"] == dropped


def test_moe_routes_over_the_data_axis_alone_on_a_pod_mesh(four):
    """On (2 pod, 2 data, 1 model) the pod ranks hold the same positions:
    routed over the data axis alone, the capacity is the microbatch's and
    every token counts once, so the drops, the auxiliary loss and the loss
    are the reference's on every rank (routed over the pods too, each token
    would count twice and the capacity, int(35.2) = 35, would keep one
    token more than twice 17 on one pod)."""
    _, res = four
    _, _, _, b, s, micro = STEPS["pod2_dp2"]
    loss, _, aux, _, dropped = _reference_step(MOE, b, s, micro)
    for r in res:
        got = r[f"step:{MOE}:pod2_dp2"]
        assert got["dropped"] == dropped
        assert got["aux"] == pytest.approx(aux, rel=1e-5)
        assert got["loss"] == pytest.approx(loss, rel=1e-5)


@functools.lru_cache(maxsize=None)
def _reference_prefill(arch, prompt):
    cfg_j = _cfg(get_config_jax, arch)
    mod = get_model_jax(cfg_j)
    inputs = _batch(arch, 1, prompt, seed=30)
    toks = jnp.asarray(inputs["tokens"])
    if cfg_j.family == "encdec":
        cache = mod.init_cache(cfg_j, 1, MAX_SEQ, dtype=jnp.float32,
                               src_len=SRC)
        lg, cache = mod.prefill(_reference_params(arch), cfg_j, toks, cache,
                                jnp.asarray(inputs["frames"]))
    else:
        cache = mod.init_cache(cfg_j, 1, MAX_SEQ, dtype=jnp.float32)
        patches = inputs.get("patches")
        lg, cache = mod.prefill(
            _reference_params(arch), cfg_j, toks, cache,
            None if patches is None else jnp.asarray(patches))
    return np.asarray(lg), jax.tree.map(np.asarray, cache)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", list(PREFILLS))
def test_split_prefill_follows_the_reference(two, four, arch, case):
    """The last row's logits within 1e-4 and bitwise the same on every
    rank; every cache gathered whole (the self K/V rows, the encdec's cross
    K/V, the clock) within 1e-5 of the reference's."""
    world, _, prompt = PREFILLS[case]
    out, res = _results(two, four, world)
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


def test_tied_gates_are_picked_in_the_references_order(four):
    """A zero router: every gate ties, so each expert's capacity pick is
    decided by token order alone. Four ranks hold the positions of a
    2-row input in blocks; their outputs, auxiliary loss and each expert's
    kept tokens are the reference's ``moe_block`` on the whole input (a
    pick in the ranks' order would keep row 0's and row 1's first
    positions, the reference keeps row 0's first ones)."""
    _, res = four
    params, x = _tied_inputs()
    y, aux = moe_block_jax(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), top_k=TIED["k"],
        capacity_factor=CAPACITY, activation="swiglu", aux_loss_weight=0.01)
    sel_idx, held = _reference_kept(jax.tree.map(jnp.asarray, params),
                                    jnp.asarray(x), TIED["k"], CAPACITY)
    want_kept = [sorted(np.asarray(i)[np.asarray(h)].tolist())
                 for i, h in zip(sel_idx, held)]
    assert any(want_kept) and not all(want_kept)
    got_y = np.concatenate([np.asarray(r["tied_moe"]["y"]) for r in res],
                           axis=1)
    y = np.asarray(y)
    np.testing.assert_allclose(got_y, y, atol=1e-5 * np.abs(y).max())
    got_kept = [sorted(sum((r["tied_moe"]["kept"][j] for r in res), []))
                for j in range(TIED["e"])]
    assert got_kept == want_kept
    for r in res:
        assert r["tied_moe"]["aux"] == pytest.approx(float(aux), rel=1e-5)
