"""Long-context serving with the cache split along its sequence, on gloo ranks
on the CPU.

``tests/test_torch_distributed.py``'s harness (``python -c`` ranks, a
``file://`` store under the test's temporary directory, a 180 s job
timeout, every rank killed once one fails), one job a world size, each read
by many tests. A batch of one row does not divide over the data ranks, so
``shard_model(..., batch_rows=1)`` runs it whole on every data rank and
``shard_cache`` gives each rank one block of every attention cache's
sequence (``kv_cache_spec``: the sequence over ``data``): rank r of n holds
rows ``[r S / n, (r + 1) S / n)``. A decode step writes its row on the rank
that owns it and each rank attends over its block (the kernels' partial
route), the partial rows combined by their log-sum-exp.

Each case: the reduced config at B 1, fp32, a cache of 64 rows (the
encdec's cross cache 24 source frames, the VLM's 8 patches ahead of the
prompt), a prefill and four greedy ticks that cross a rank's block
(prompt 30 at 2 data ranks, blocks of 32: rank 1 starts with no visible
key; prompt 46 at 4, blocks of 16: ranks 0 and 1 full, rank 2 partial,
rank 3 empty until the third tick), then an idle slot's tick (the clock
past the cache's end: the global last row, on the last data rank), each
call against the one-process model:

* zamba2-2.7b on (2, 1), (4, 1), (2, 2) (its shared block's 2 KV heads
  one a model rank) and (2 pod, 2 data, 1 model) (the cache split over
  ``data`` and replicated over ``pod``, the two-pod mesh's layout);
  mamba2-780m on (2, 1) (no KV cache: the SSM and conv states stay whole);
  smollm-135m, internvl2-76b and seamless-m4t-large-v2 (its self and cross
  caches split) on (2, 1);
* granite-moe-3b-a800m on (2, 1) with ``capacity_factor`` 0.5, so that the
  prefill drops (token, expert) pairs: under a replicated batch the MoE
  routes the rank's own tokens, not every data rank's copies of them;
* the zamba2 (2, 1) run against the reference's own ``prefill`` and
  ``decode_step`` (``src/repro/models/mamba.py``) on the same weights and
  tokens.

Tolerances: logits 1e-4 (the serving tests' against the JAX package) with
the greedy tokens equal; each cache gathered whole within 1e-5 of its
largest; the data ranks' logits bitwise equal (the combine sums in rank
order, so every replica computes the same bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.models import get_model as get_model_jax
from repro_torch.configs import get_config
from repro_torch.convert import to_jax_params
from repro_torch.models import get_model
from test_torch_distributed import _run_job

MAX_SEQ, TICKS = 64, 4
PROMPT = {2: 30, 4: 46}          # data ranks -> prompt tokens

_BODY = """
import dataclasses
import hashlib

from repro_torch.models import get_model
from repro_torch.parallel.sharding import (SEQ_SPLIT, cache_shardings,
                                           gather_full, shard_cache)
from repro_torch.train import shard_model

MAX_SEQ, TICKS = 64, 4
PROMPT = {2: 30, 4: 46}


def long_case(arch, shape, axes=("data", "model"), **changes):
    \"\"\"A prefill, TICKS greedy ticks and an idle slot's tick of the
    reduced ``arch`` (with ``changes`` to its MoE config) at B 1, split over
    ``shape`` (of ``axes``) with the cache split along its sequence over
    ``data``, against the one process: each call's largest logit
    difference, the greedy tokens, the logits' digest, the caches gathered
    whole.\"\"\"
    global CFG
    CFG = get_config(arch, reduced=True)
    if changes:
        CFG = dataclasses.replace(CFG, moe=dataclasses.replace(CFG.moe,
                                                               **changes))
    plan = MemoryPlan(1, "float32", True, "dots", 0.0)
    make = lambda: get_model(CFG)(CFG, dtype=torch.float32, device="cpu",
                                  generator=torch.Generator().manual_seed(7))
    ref, model = make(), make()
    mesh = build_mesh(shape, axes, "cpu")
    shard_model(CFG, plan, model, mesh, batch_rows=1)
    rs = np.random.RandomState(11)
    patches = CFG.vision.num_patches if CFG.family == "vlm" else 0
    prompt = PROMPT[shape[axes.index("data")]] - patches
    toks = torch.from_numpy(rs.randint(0, CFG.vocab_size, size=(1, prompt)))
    extra = family_inputs(1, rs)
    whole = ref.init_cache(1, MAX_SEQ, *(
        [SRC_LEN] if CFG.family == "encdec" else []))
    cache = shard_cache(CFG, mesh, whole)
    for moe in [l.moe for l in getattr(ref, "layers", ()) if hasattr(l, "moe")]:
        moe.stats = {}
    out = {"logit_err": [], "tokens_equal": [], "digest": [], "logits": [],
           "feed": toks[0].tolist(),
           "split": list(cache[SEQ_SPLIT].names) if SEQ_SPLIT in cache else [],
           "split_ranks": (dist.get_world_size(cache[SEQ_SPLIT].group)
                           if SEQ_SPLIT in cache else 0),
           "local_shapes": {n: list(t.shape) for n, t in cache.items()
                            if n != SEQ_SPLIT},
           "data_rank": mesh.get_local_rank("data"),
           "model_rank": mesh.get_local_rank("model")}
    with torch.no_grad():
        lg, cache = model.prefill(toks, cache, **extra)
        lr, whole = ref.prefill(toks, whole, **extra)
        if CFG.moe is not None:
            out["dropped"] = sum(int(m.stats["routed"] - m.stats["kept"])
                                 for m in [l.moe for l in ref.layers])
        for t in range(TICKS + 2):
            out["logit_err"].append((lg - lr).abs().max().item())
            out["digest"].append(hashlib.sha256(
                lg.contiguous().numpy().tobytes()).hexdigest())
            out["logits"].append(lg[0, -1].tolist())
            mine_next = lg[:, -1].argmax(-1, keepdim=True)
            ref_next = lr[:, -1].argmax(-1, keepdim=True)
            out["tokens_equal"].append(bool(torch.equal(mine_next, ref_next)))
            if t == TICKS:
                # an idle slot: the clock past the cache's end
                cache["pos"].fill_(MAX_SEQ + 2)
                whole["pos"].fill_(MAX_SEQ + 2)
            if t <= TICKS:
                out["feed"].append(int(ref_next))
                lg, cache = model.decode_step(cache, ref_next)
                lr, whole = ref.decode_step(whole, ref_next)
    specs = cache_shardings(CFG, mesh, whole)
    out["cache_err"] = {}
    for n in whole:
        if n == "pos":
            continue
        got = gather_full(cache[n], specs[n], mesh)
        scale = max(whole[n].abs().max().item(), 1e-30)
        out["cache_err"][n] = ((got - whole[n]).abs().max() / scale).item()
    out["last_row_written"] = {
        n: bool(whole[n][:, :, -1].abs().max() > 0)
        for n in out["split"] if not n.startswith("cross")}
    out["pos_equal"] = bool(torch.equal(cache["pos"], whole["pos"]))
    return out
"""

_FOUR_RANKS = _BODY + """
results["zamba2-2.7b:4x1"] = long_case("zamba2-2.7b", (4, 1))
results["zamba2-2.7b:2x2"] = long_case("zamba2-2.7b", (2, 2))
results["zamba2-2.7b:pod2x2x1"] = long_case(
    "zamba2-2.7b", (2, 2, 1), ("pod", "data", "model"))
"""

_TWO_RANKS = _BODY + """
for arch in ("zamba2-2.7b", "mamba2-780m", "smollm-135m", "internvl2-76b",
             "seamless-m4t-large-v2"):
    results[arch + ":2x1"] = long_case(arch, (2, 1))
results["granite-moe-3b-a800m:2x1"] = long_case(
    "granite-moe-3b-a800m", (2, 1), capacity_factor=0.5)
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run_job(_FOUR_RANKS, 4, tmp_path_factory.mktemp("long_four"))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run_job(_TWO_RANKS, 2, tmp_path_factory.mktemp("long_two"))


TWO = ["zamba2-2.7b", "mamba2-780m", "smollm-135m", "internvl2-76b",
       "seamless-m4t-large-v2", "granite-moe-3b-a800m"]
FOUR = ["zamba2-2.7b:4x1", "zamba2-2.7b:2x2", "zamba2-2.7b:pod2x2x1"]
# each family's caches split along the sequence (mamba2 has no KV cache)
SPLIT = {"zamba2-2.7b": {"attn_k", "attn_v"}, "mamba2-780m": set(),
         "smollm-135m": {"k", "v"}, "internvl2-76b": {"k", "v"},
         "granite-moe-3b-a800m": {"k", "v"},
         "seamless-m4t-large-v2": {"self_k", "self_v", "cross_k", "cross_v"}}


def _check(r):
    assert max(r["logit_err"]) <= 1e-4, r["logit_err"]
    assert r["tokens_equal"] == [True] * (TICKS + 2)
    for name, err in r["cache_err"].items():
        assert err <= 1e-5, (name, err)
    assert r["pos_equal"]


@pytest.mark.parametrize("arch", TWO)
def test_split_serving_over_two_data_ranks_matches_one_process(two, arch):
    """(2, 1): the prefill, four ticks that cross from rank 0's block into
    rank 1's (which holds no visible key until then) and an idle slot's
    tick, against the one process; the caches gathered whole."""
    for res in two:
        _check(res[f"{arch}:2x1"])


@pytest.mark.parametrize("case", FOUR)
def test_split_serving_over_four_ranks_matches_one_process(four, case):
    """(4, 1): blocks of 16 rows, one full, one partial and one empty
    after the prefill; (2, 2): the sequence over the data axis and the
    shared block's KV heads over the model axis; (2 pod, 2 data, 1 model):
    the sequence over ``data`` alone, replicated over ``pod``, the combine
    over ``data``."""
    for res in four:
        _check(res[case])


@pytest.mark.parametrize("arch", TWO)
def test_each_attention_cache_holds_a_block_of_the_sequence(two, arch):
    """``shard_cache`` names the caches the rules split and the data
    axis's group of 2 ranks (``SEQ_SPLIT``), each holding 32 of the 64 rows (the cross cache 12 of the 24 frames);
    the SSM and conv states stay whole."""
    for res in two:
        r = res[f"{arch}:2x1"]
        assert set(r["split"]) == SPLIT[arch]
        assert r["split_ranks"] == (2 if SPLIT[arch] else 0)
        for name in r["split"]:
            want = 12 if name.startswith("cross") else MAX_SEQ // 2
            assert r["local_shapes"][name][2] == want, name
        if "ssm" in r["local_shapes"]:
            assert r["local_shapes"]["ssm"][1] == 1          # whole row
            assert r["local_shapes"]["conv"][1] == 1


@pytest.mark.parametrize("case", [f"{a}:2x1" for a in TWO] + FOUR)
def test_the_data_ranks_logits_are_bitwise_equal(two, four, case):
    """Every data rank serves the same row: their logits of every call,
    digested, are equal, rank for rank of the model axis (a combine whose
    order differed by rank would let the replicas' greedy picks drift at a
    near tie)."""
    results = two if case.endswith(":2x1") else four
    by_model = {}
    for res in results:
        r = res[case]
        by_model.setdefault(r["model_rank"], []).append(r["digest"])
    for digests in by_model.values():
        assert len(digests) > 1
        assert all(d == digests[0] for d in digests)


@pytest.mark.parametrize("case", ["zamba2-2.7b:2x1", "zamba2-2.7b:4x1",
                                  "smollm-135m:2x1",
                                  "seamless-m4t-large-v2:2x1"])
def test_the_idle_slot_writes_the_global_last_row(two, four, case):
    """A clock past the cache's end writes the whole sequence's last row,
    held by the last data rank (the gathered caches equal the one
    process's, whose clamp is the last row), and nowhere else."""
    results = two if case.endswith(":2x1") else four
    for res in results:
        r = res[case]
        assert r["last_row_written"] and all(r["last_row_written"].values())
        assert max(r["cache_err"].values()) <= 1e-5


def test_a_moe_under_a_replicated_batch_routes_its_own_tokens(two):
    """granite-moe at ``capacity_factor`` 0.5: the one process's prefill
    drops (token, expert) pairs, and the split run, whose data ranks each
    hold the whole row, keeps the same ones (its logits and tokens equal
    the one process's); routing over the data ranks would see each token
    twice and double each expert's capacity."""
    for res in two:
        r = res["granite-moe-3b-a800m:2x1"]
        assert r["dropped"] > 0
        _check(r)


def test_split_zamba2_matches_the_reference_decode_step(two):
    """The zamba2 (2, 1) run against the JAX package's ``prefill`` and
    ``decode_step`` on the same weights (seed 7, through ``convert``) and
    the tokens it was fed: the prefill's and the four ticks' logits within
    1e-4. (Not the idle slot's tick: past the cache's end JAX drops the
    write and the port clamps it to the last row, ROADMAP Queue 3.)"""
    arch = "zamba2-2.7b"
    cfg, cfg_j = get_config(arch, reduced=True), get_config_jax(arch,
                                                               reduced=True)
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu",
                           generator=torch.Generator().manual_seed(7))
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          to_jax_params(model.state_dict(), cfg))
    mod = get_model_jax(cfg_j)
    r = two[0][f"{arch}:2x1"]
    prompt = PROMPT[2]
    feed = np.asarray(r["feed"], dtype=np.int32)
    cache = mod.init_cache(cfg_j, 1, MAX_SEQ, dtype=jnp.float32)
    lg, cache = mod.prefill(params, cfg_j, jnp.asarray(feed[None, :prompt]),
                            cache)
    want = [np.asarray(lg)[0, -1]]
    for t in range(TICKS):
        tok = jnp.asarray(feed[None, prompt + t:prompt + t + 1])
        lg, cache = mod.decode_step(params, cfg_j, cache, tok)
        want.append(np.asarray(lg)[0, -1])
    for res in two:
        got = res[f"{arch}:2x1"]["logits"]
        assert len(got) == len(want) + 1
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), w, atol=1e-4)
