"""The MoE and VLM transformers of repro_torch against the JAX package's, on
the CPU, on shared weights (JAX params -> numpy -> ``from_jax_params``).

granite-moe reduced (MoE in both layers, 4 experts, top-2) and
llama4-maverick reduced (``moe_every`` 2: a dense layer, then a MoE layer
with a shared expert, top-1, so every gate is exactly 1.0 and the capacity
cut at ``s > 1`` is decided by ties), in both dispatch modes; internvl2
reduced with 8 patch embeddings. Tolerances: the max |port - JAX| over
max(1, max |JAX|), fp32 2e-5, bf16 3e-2 (``tests/test_kernels.py``'s
attention tolerances); gradients 1e-4 of each leaf's largest magnitude, as
the dense loss test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.models import common as jcommon
from repro.models import get_model as get_model_jax
from repro.parallel import plan_memory as plan_memory_jax
from repro.serve import Engine as EngineJax
from repro.serve import EngineConfig as EngineConfigJax
from repro.serve import Request as RequestJax
from repro.train import init_train_state as init_train_state_jax
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_params, to_jax_train_state
from repro_torch.launch import serve as launch_serve
from repro_torch.models import common as tcommon
from repro_torch.models import get_model
from repro_torch.parallel import plan_memory
from repro_torch.serve import Engine, EngineConfig, Request
from repro_torch.train import init_train_state

torch.set_num_threads(1)

MOE_ARCHS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b"]
VLM = "internvl2-76b"
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 3e-2}
GRAD_TOL = 1e-4


def _cfgs(arch, dispatch=None):
    cfg_j, cfg = get_config_jax(arch, reduced=True), get_config(arch,
                                                                reduced=True)
    if dispatch is not None:
        cfg_j = dataclasses.replace(
            cfg_j, moe=dataclasses.replace(cfg_j.moe, dispatch=dispatch))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    return cfg_j, cfg


def _pair(arch, dispatch=None, dtype=jnp.float32, seed=0):
    cfg_j, cfg = _cfgs(arch, dispatch)
    mod = get_model_jax(cfg_j)
    params = mod.init_params(jax.random.PRNGKey(seed), cfg_j, dtype=dtype)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    model = get_model(cfg)(cfg, dtype=tdtype, device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return mod, cfg_j, params, model


def _err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _batch(cfg, b, s, seed):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}


# --------------------------------------------------------------------- #
# Routing and the MoE block
# --------------------------------------------------------------------- #

def test_top_k_breaks_ties_as_lax_top_k():
    rs = np.random.RandomState(0)
    x = rs.randint(0, 4, size=(6, 40)).astype(np.float32) / 4  # many ties
    for k in (1, 3, 8, 40):
        vj, ij = jax.lax.top_k(jnp.asarray(x), k)
        vt, it = tcommon.stable_top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def _moe_params(d, f, e, shared, seed, dtype=jnp.float32):
    p = jcommon.init_moe_params(jax.random.PRNGKey(seed), d, f, e, "swiglu",
                                shared_d_ff=f if shared else 0, dtype=dtype)
    pn = jax.tree.map(np.asarray, p)
    pt = jax.tree.map(lambda a: torch.tensor(np.asarray(a, np.float32))
                      .to(torch.float32 if a.dtype == np.float32
                          else torch.bfloat16), pn)
    return p, pt


@pytest.mark.parametrize("dispatch", ["gather", "dense"])
@pytest.mark.parametrize("top_k,e,shared,s", [
    (1, 4, True, 16),      # llama4-like: every gate 1.0, overflow by ties
    (2, 4, False, 16),     # granite-like
    (8, 40, False, 24),    # granite's width of routing
    (2, 4, False, 1),      # a decode step: cap = t, nothing dropped
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_moe_block_matches_jax(dispatch, top_k, e, shared, s, dtype):
    d, f, b = 32, 16, 3
    p, pt = _moe_params(d, f, e, shared, seed=top_k + e, dtype=dtype)
    x = np.random.RandomState(top_k).randn(b, s, d).astype(np.float32)
    kw = dict(capacity_factor=1.25, activation="swiglu",
              aux_loss_weight=0.01, dispatch=dispatch)
    yj, auxj = jcommon.moe_block(p, jnp.asarray(x, dtype), top_k=top_k, **kw)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    yt, auxt = tcommon.moe_block(pt, torch.from_numpy(x).to(tdtype),
                                 top_k=top_k, **kw)
    assert yt.dtype == tdtype and yt.shape == (b, s, d)
    assert _err(yt, yj) <= TOL[dtype], _err(yt, yj)
    assert auxt.dtype == torch.float32
    np.testing.assert_allclose(auxt.item(), float(auxj), rtol=1e-5)


def test_llama4_reduced_routing_overflows():
    """The llama4 cases below drop tokens: at top-1 some expert is routed
    more tokens than its capacity, so the cut among equal gates counts."""
    _, cfg_j, _, model = _pair(MOE_ARCHS[1])
    batch = _batch(cfg_j, 2, 16, seed=40)
    seen = []

    def spy(mod, args, out):
        x = args[0].reshape(-1, cfg_j.d_model)
        probs = torch.softmax(x.float() @ mod.router, -1)
        counts = torch.bincount(probs.argmax(-1), minlength=4)
        t, m = x.shape[0], cfg_j.moe
        seen.append(int(counts.max()) - int(t * m.top_k * m.capacity_factor
                                            / m.num_experts))

    model.layers[1].moe.register_forward_hook(spy)
    with torch.no_grad():
        model.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                   remat=None)
    assert seen and max(seen) > 0, seen


# --------------------------------------------------------------------- #
# The transformers
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", MOE_ARCHS + [VLM])
def test_tree_round_trips_through_the_jax_layout(arch):
    """from_jax_params -> the model's state dict -> to_jax_params gives the
    JAX tree back, leaf for leaf and bit for bit."""
    _, cfg_j, params, model = _pair(arch)
    back = to_jax_params(model.state_dict(), model.cfg)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(
        back, is_leaf=lambda x: torch.is_tensor(x))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=path)


# A token whose router logits at some MoE layer put the k-th and the
# (k+1)-th expert closer than this is a near-tie: in bf16 the two packages
# round the router's input differently (a bf16 ulp is 2^-8 of an activation),
# so either expert may win, and that token's logits legitimately differ.
NEAR_TIE_LOGITS = 0.05


def _near_ties(model, tokens: torch.Tensor) -> np.ndarray:
    """(b, s) mask of the tokens whose top-k routing is a near-tie in some
    MoE layer of the port's own forward."""
    b, s = tokens.shape
    mask = torch.zeros(b * s, dtype=torch.bool)

    def hook(mod, args, out):
        logits = args[0].reshape(b * s, -1).float() @ mod.router
        top = torch.sort(logits, dim=-1, descending=True).values
        k = mod.cfg.moe.top_k
        mask.logical_or_(top[:, k - 1] - top[:, k] < NEAR_TIE_LOGITS)

    hooks = [layer.moe.register_forward_hook(hook)
             for layer in model.layers if hasattr(layer, "moe")]
    with torch.no_grad():
        model(tokens)
    for h in hooks:
        h.remove()
    return mask.reshape(b, s).numpy()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("dispatch", ["gather", "dense"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_loss_and_aux_match_jax(arch, dispatch, dtype):
    """Logits, loss, ce and aux against the JAX package's. fp32: every
    token. bf16: every token but the near-ties (at most 4 of the 32), whose
    routing either rounding may decide."""
    mod, cfg_j, params, model = _pair(arch, dispatch, dtype)
    batch = _batch(cfg_j, 2, 16, seed=41)
    want_logits, want_aux, _ = mod.forward(params, cfg_j,
                                           jnp.asarray(batch["tokens"]))
    (want_loss, want_parts) = mod.loss(
        params, cfg_j, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(batch["tokens"]))
        loss, parts = model.loss({k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert logits.shape == (2, 16, cfg_j.padded_vocab)
    keep = np.ones((2, 16), bool)
    if dtype == jnp.bfloat16:
        keep = ~_near_ties(model, torch.from_numpy(batch["tokens"]))
        assert keep.sum() >= 28, keep
    want_logits = np.asarray(want_logits, np.float32)[keep]
    assert _err(logits[torch.from_numpy(keep)], want_logits) <= TOL[dtype]
    assert parts["aux"].item() > 0
    np.testing.assert_allclose(parts["aux"].item(), float(want_aux),
                               rtol=TOL[dtype])
    np.testing.assert_allclose(parts["aux"].item(), float(want_parts["aux"]),
                               rtol=TOL[dtype])
    np.testing.assert_allclose(parts["ce"].item(), float(want_parts["ce"]),
                               rtol=TOL[dtype])
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL[dtype])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serving_matches_jax(arch):
    """prefill (capacity cut at s > 1) and a decode step (cap = t) against
    the JAX package's on the same weights."""
    mod, cfg_j, params, model = _pair(arch)
    b, s = 2, 12
    toks = _batch(cfg_j, b, s, seed=42)["tokens"]
    nxt = np.array([[3], [5]], np.int32)
    cache = model.init_cache(b, 32)
    lg, cache = model.prefill(torch.from_numpy(toks), cache)
    lg2, cache = model.decode_step(cache, torch.from_numpy(nxt))
    cache_j = mod.init_cache(cfg_j, b, 32, dtype=jnp.float32)
    lg_j, cache_j = mod.prefill(params, cfg_j, jnp.asarray(toks), cache_j)
    lg2_j, _ = mod.decode_step(params, cfg_j, cache_j, jnp.asarray(nxt))
    assert _err(lg, lg_j) <= TOL[jnp.float32]
    assert _err(lg2, lg2_j) <= TOL[jnp.float32]
    assert cache["pos"].tolist() == [s + 1] * b


def test_moe_grads_match_jax():
    """The gradient of every leaf of granite-moe reduced's loss (remat
    "dots", aux included) against ``jax.grad`` of the JAX package's."""
    mod, cfg_j, params, model = _pair(MOE_ARCHS[0])
    batch = _batch(cfg_j, 2, 12, seed=43)
    (want_loss, _), grads = jax.value_and_grad(
        lambda p: mod.loss(p, cfg_j, {k: jnp.asarray(v)
                                      for k, v in batch.items()}),
        has_aux=True)(params)
    loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-5)
    loss.backward()
    want = from_jax_params(jax.tree.map(np.asarray, grads), model.cfg)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        w = want[name].numpy()
        err = float(np.abs(p.grad.numpy() - w).max()) / max(
            float(np.abs(w).max()), 1e-30)
        assert err <= GRAD_TOL, (name, err)


def test_vlm_patches_logits_and_loss_match_jax():
    mod, cfg_j, params, model = _pair(VLM)
    batch = _batch(cfg_j, 2, 10, seed=44)
    patches = np.random.RandomState(45).randn(
        2, cfg_j.vision.num_patches, cfg_j.d_model).astype(np.float32)
    want_logits, _, _ = mod.forward(params, cfg_j,
                                    jnp.asarray(batch["tokens"]),
                                    patches=jnp.asarray(patches))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_parts = mod.loss(params, cfg_j,
                                     {**jbatch, "patches": jnp.asarray(patches)})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, _ = model(tbatch["tokens"], patches=torch.from_numpy(patches))
        loss, parts = model.loss({**tbatch,
                                  "patches": torch.from_numpy(patches)})
        plain, _ = model.loss(tbatch)
    assert logits.shape == (2, 8 + 10, cfg_j.padded_vocab)
    assert _err(logits, want_logits) <= TOL[jnp.float32]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-5)
    assert parts["aux"].item() == float(want_parts["aux"]) == 0.0
    assert abs(plain.item() - loss.item()) > 1e-6     # the patches count
    # prefill behind the patches: the last position's logits, the cache
    # filled for patches and tokens
    cache = model.init_cache(2, 32)
    lg, cache = model.prefill(tbatch["tokens"], cache,
                              patches=torch.from_numpy(patches))
    assert _err(lg[:, 0], want_logits[:, -1]) <= TOL[jnp.float32]
    assert cache["pos"].tolist() == [18, 18]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_state_has_the_jax_tree(arch):
    """The port's train state in the JAX layout has the keys, shapes and
    dtypes of the JAX package's train state, so MoE checkpoints interchange
    too."""
    cfg_j, cfg = _cfgs(arch)
    state_j = init_train_state_jax(cfg_j, plan_memory_jax(cfg_j, 1, 1),
                                   jax.random.PRNGKey(0), dtype=jnp.float32)
    state = init_train_state(cfg, plan_memory(cfg, 1, 1),
                             torch.Generator().manual_seed(0),
                             dtype=torch.float32, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(state_j)[0]
    got = jax.tree_util.tree_flatten_with_path(
        to_jax_train_state(state), is_leaf=lambda x: torch.is_tensor(x))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == np.shape(w), path
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path


# --------------------------------------------------------------------- #
# Serving: greedy engine tokens against the JAX engine
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("max_batch", [1, 3])
def test_granite_engine_greedy_tokens_equal_jax_engine(max_batch):
    _, cfg_j, params, model = _pair(MOE_ARCHS[0])
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, cfg_j.vocab_size, size=int(rs.randint(2, 12)))
               for _ in range(4)]
    eng_j = EngineJax(cfg_j, params,
                      EngineConfigJax(max_batch=max_batch, max_seq=48),
                      dtype=jnp.float32)
    eng_t = Engine(model.cfg, model, EngineConfig(max_batch=max_batch,
                                                  max_seq=48),
                   dtype=torch.float32, device="cpu")
    for i, p in enumerate(prompts):
        eng_j.submit(RequestJax(uid=i, prompt=p, max_new_tokens=6))
        eng_t.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=6))
    done_j = eng_j.run_until_drained()
    done_t = eng_t.run_until_drained()
    assert [r.uid for r in done_t] == [r.uid for r in done_j]
    want = {r.uid: r.out_tokens for r in done_j}
    for r in done_t:
        assert r.out_tokens == want[r.uid], (r.uid, r.out_tokens, want[r.uid])


@pytest.mark.parametrize("arch", MOE_ARCHS + [VLM])
def test_launch_serve_runs_on_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--num-requests", "3", "--max-new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the combine's order is checked "
                    "where float atomics would reorder it")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_block_repeats_bitwise_on_the_card(cuda_device, dtype):
    """Three calls of ``moe_block`` at granite's routing (40 experts, top-8,
    a 512-token prefill with overflow) give the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    d, f, e = 256, 64, 40
    params = tcommon.init_moe_params(gen, d, f, e, "swiglu", dtype=dtype)
    params = {k: v.to(cuda_device) for k, v in params.items()}
    x = torch.randn((1, 512, d), generator=gen, device=cuda_device).to(dtype)
    runs = [tcommon.moe_block(params, x, top_k=8,
                              capacity_factor=1.5, activation="swiglu",
                              aux_loss_weight=0.01) for _ in range(3)]
    for y, aux in runs[1:]:
        assert torch.equal(y, runs[0][0]) and torch.equal(aux, runs[0][1])


@pytest.mark.cuda
def test_moe_block_on_the_card_matches_the_cpu(cuda_device):
    """fp32 ``moe_block`` at granite's routing (40 experts, top-8, a
    512-token prefill with overflow) on the card against the CPU's (which
    the parity tests hold against the JAX package), on the same inputs and
    the same routing (both devices' token and capacity choices are checked
    equal first): 2e-5 of the largest magnitude, the fp32 tolerance."""
    gen = torch.Generator().manual_seed(1)
    d, f, e, top_k, cf = 256, 64, 40, 8, 1.5
    params = tcommon.init_moe_params(gen, d, f, e, "swiglu",
                                     dtype=torch.float32)
    x = torch.randn((1, 512, d), generator=gen)

    def routing(params, x):
        xt = x.reshape(-1, d)
        probs = torch.softmax(xt @ params["router"], dim=-1)
        gate_vals, gate_idx = tcommon.stable_top_k(probs, top_k)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
        combine = torch.zeros_like(probs).scatter(1, gate_idx, gate_vals)
        cap = int(xt.shape[0] * top_k * cf / e)
        return gate_idx.cpu(), tcommon.stable_top_k(combine.T, cap)[1].cpu()

    on_card = {k: v.to(cuda_device) for k, v in params.items()}
    x_card = x.to(cuda_device)
    for want, got in zip(routing(params, x), routing(on_card, x_card)):
        assert torch.equal(want, got)
    kw = dict(top_k=top_k, capacity_factor=cf, activation="swiglu",
              aux_loss_weight=0.01)
    y_cpu, aux_cpu = tcommon.moe_block(params, x, **kw)
    y_card, aux_card = tcommon.moe_block(on_card, x_card, **kw)
    assert _err(y_card.cpu(), y_cpu.numpy()) <= TOL[jnp.float32]
    assert _err(aux_card.cpu(), aux_cpu.numpy()) <= TOL[jnp.float32]
