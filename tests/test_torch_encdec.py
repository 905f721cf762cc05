"""The port's encoder-decoder (seamless-m4t) against the JAX package's on
shared weights, on the CPU, fp32; and a layer stack on the card against the
same stack on the CPU (``cuda``).

JAX params -> numpy -> ``from_jax_params`` -> ``EncDec``; tokens and frames
are made with numpy from a seed and handed to both sides. Tolerances are
those of the dense and mamba2 parity tests (``tests/test_torch_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.models import common as jcommon
from repro.models import encdec as encdec_jax
from repro_torch.configs import get_config
from repro_torch.convert import cache_to_numpy, from_jax_params, to_jax_params
from repro_torch.models import common as tcommon
from repro_torch.models import get_model
from repro_torch.models.encdec import EncDec

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"


def _pair(seed=0, **replace):
    """The JAX (cfg, params) and the port's model on equal weights, the
    reduced config (2 + 2 layers, 4 heads over 2 KV heads of 16, gelu)
    with ``replace``'d fields on both sides."""
    cfg_j = dataclasses.replace(get_config_jax(ARCH, reduced=True), **replace)
    params = encdec_jax.init_params(jax.random.PRNGKey(seed), cfg_j,
                                    dtype=jnp.float32)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), **replace)
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return cfg_j, params, model


def _inputs(cfg, b, s, src, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, cfg.vocab_size, size=(b, s)),
            rs.randn(b, src, cfg.d_model).astype(np.float32))


def test_encdec_param_count_and_tree():
    """The full config counts 1,635,902,464 parameters; the module tree has
    the JAX tree's leaves and sizes (encoder and decoder stacked there, one
    module a layer here) and carries back to it bit for bit."""
    assert get_model(get_config(ARCH)) is EncDec
    assert get_config(ARCH).param_count() == 1_635_902_464
    cfg_j, params, model = _pair()
    converted = from_jax_params(jax.tree.map(np.asarray, params), cfg_j)
    assert set(converted) == set(model.state_dict())
    assert "decoder.1.cross_attn.wk" in converted
    assert "encoder.0.ffn.wu" in converted and "ln_enc" in converted
    assert (sum(p.numel() for p in model.parameters())
            == sum(a.size for a in jax.tree.leaves(params)))
    back = to_jax_params(model.state_dict(), model.cfg)
    assert (jax.tree.structure(jax.tree.map(lambda a: 0, back))
            == jax.tree.structure(jax.tree.map(lambda a: 0, params)))
    for (path, got), want in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree.leaves(params)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=str(path))


def test_cross_attention_block_matches_jax():
    """``attention_block`` with ``xkv`` (keys and values from a source of
    another length, no RoPE, not causal) and with ``precomputed_kv`` (the
    frozen cross K/V of a cache, which is left as it was) against the
    reference's."""
    rs = np.random.RandomState(5)
    h, hkv, hd, d, b, s, src = 6, 2, 16, 32, 2, 5, 11
    w = {n: (rs.randn(*shape) * 0.2).astype(np.float32) for n, shape in (
        ("wq", (d, h * hd)), ("wk", (d, hkv * hd)), ("wv", (d, hkv * hd)),
        ("wo", (h * hd, d)))}
    x = rs.randn(b, s, d).astype(np.float32)
    enc = rs.randn(b, src, d).astype(np.float32)
    wj = {n: jnp.asarray(a) for n, a in w.items()}
    wt = {n: torch.from_numpy(a) for n, a in w.items()}
    kw = dict(num_heads=h, num_kv_heads=hkv, head_dim=hd, rope_fraction=0.0,
              causal=False)
    want, _ = jcommon.attention_block(wj, jnp.asarray(x),
                                      xkv=jnp.asarray(enc), **kw)
    got = tcommon.attention_block(wt, torch.from_numpy(x),
                                  xkv=torch.from_numpy(enc), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    k = (enc @ w["wk"]).reshape(b, src, hkv, hd)
    v = (enc @ w["wv"]).reshape(b, src, hkv, hd)
    cache_j = {"k": jnp.asarray(k), "v": jnp.asarray(v),
               "pos": jnp.zeros((), jnp.int32)}
    cache_t = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    want, _ = jcommon.attention_block(wj, jnp.asarray(x), kv_cache=cache_j,
                                      precomputed_kv=True, **kw)
    got = tcommon.attention_block(wt, torch.from_numpy(x), kv_cache=cache_t,
                                  precomputed_kv=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert np.array_equal(cache_t["k"].numpy(), k)


@pytest.mark.parametrize("s,src", [(13, 8), (7, 40)])
def test_encdec_forward_logits_match_jax(s, src):
    cfg_j, params, model = _pair()
    toks, frames = _inputs(cfg_j, 2, s, src)
    want, _, _ = encdec_jax.forward(params, cfg_j, jnp.asarray(toks),
                                    frames=jnp.asarray(frames))
    with torch.no_grad():
        got, cache = model(torch.from_numpy(toks), torch.from_numpy(frames))
    assert cache is None
    assert got.shape == (2, s, cfg_j.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_encdec_encode_and_cross_kv_match_jax():
    cfg_j, params, model = _pair()
    _, frames = _inputs(cfg_j, 2, 1, 9, seed=1)
    enc_j = encdec_jax.encode(params, cfg_j, jnp.asarray(frames), remat=None)
    ck_j, cv_j = encdec_jax.precompute_cross_kv(params, cfg_j, enc_j)
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(frames))
        ck, cv = model.precompute_cross_kv(enc)
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_j), atol=1e-5)
    assert ck.shape == ck_j.shape == (2, 2, 9, 2, 16)
    np.testing.assert_allclose(ck.numpy(), np.asarray(ck_j), atol=1e-5)
    np.testing.assert_allclose(cv.numpy(), np.asarray(cv_j), atol=1e-5)


@pytest.mark.parametrize("s,src", [(12, 8), (3, 20)])
def test_encdec_serving_matches_forward_and_jax(s, src):
    """A prefill then three decode steps equal the full forward and the
    JAX package's prefill/decode_step, the cache included: the self K/V
    written at each position, the cross K/V filled by the prefill."""
    cfg_j, params, model = _pair()
    b = 2
    toks, frames = _inputs(cfg_j, b, s + 3, src, seed=2)
    tf = torch.from_numpy(frames)
    with torch.no_grad():
        full, _ = model(torch.from_numpy(toks), tf)
    cache = model.init_cache(b, 32, src_len=src)
    cache_j = encdec_jax.init_cache(cfg_j, b, 32, dtype=jnp.float32,
                                    src_len=src)
    lg, cache = model.prefill(torch.from_numpy(toks[:, :s]), cache, tf)
    lg_j, cache_j = encdec_jax.prefill(params, cfg_j,
                                       jnp.asarray(toks[:, :s]), cache_j,
                                       jnp.asarray(frames))
    steps = [(lg, lg_j, cache_to_numpy(cache),
              jax.tree.map(np.asarray, cache_j))]
    for t in range(s, s + 3):
        lg, cache = model.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]))
        lg_j, cache_j = encdec_jax.decode_step(params, cfg_j, cache_j,
                                               jnp.asarray(toks[:, t:t + 1]))
        steps.append((lg, lg_j, cache_to_numpy(cache),
                      jax.tree.map(np.asarray, cache_j)))
    names = {"self_k", "self_v", "cross_k", "cross_v", "pos"}
    for k, (got, want, mine, theirs) in enumerate(steps):
        assert got.shape == (b, 1, cfg_j.padded_vocab)
        np.testing.assert_allclose(got[:, 0].numpy(),
                                   full[:, s - 1 + k].numpy(),
                                   atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        assert set(mine) == set(theirs) == names
        for name in names - {"pos"}:
            assert mine[name].shape == theirs[name].shape, name
            np.testing.assert_allclose(mine[name], theirs[name], atol=1e-5,
                                       err_msg=name)
        np.testing.assert_array_equal(mine["pos"], theirs["pos"])


def test_encdec_decode_updates_the_cache_in_place():
    cfg_j, _, model = _pair()
    toks, frames = _inputs(cfg_j, 2, 4, 6, seed=3)
    cache = model.init_cache(2, 16, src_len=6)
    ptrs = {n: t.data_ptr() for n, t in cache.items() if n != "pos"}
    _, cache = model.prefill(torch.from_numpy(toks), cache,
                             torch.from_numpy(frames))
    cross = cache["cross_k"].clone()
    assert cross.abs().sum() > 0
    _, cache = model.decode_step(cache, torch.tensor([[3], [4]]))
    assert {n: t.data_ptr() for n, t in cache.items() if n != "pos"} == ptrs
    assert torch.equal(cache["cross_k"], cross)
    assert cache["pos"].tolist() == [5, 5]


def test_encdec_prefill_refuses_another_source_length():
    cfg_j, _, model = _pair()
    toks, frames = _inputs(cfg_j, 1, 4, 6, seed=4)
    cache = model.init_cache(1, 16, src_len=5)
    with pytest.raises(ValueError, match="source"):
        model.prefill(torch.from_numpy(toks), cache, torch.from_numpy(frames))


@pytest.mark.parametrize("remat", ["dots", "none", "full"])
def test_encdec_loss_and_grads_match_jax(remat):
    """``EncDec.loss`` and the gradient of every leaf against
    ``jax.value_and_grad`` of the reference's ``loss`` (remat "dots"):
    loss 1e-5 relative, each leaf within 1e-4 of its largest magnitude."""
    cfg_j, params, model = _pair()
    rs = np.random.RandomState(6)
    toks = rs.randint(0, cfg_j.vocab_size, size=(2, 11)).astype(np.int32)
    targets = toks[:, 1:].copy()
    targets[rs.rand(2, 10) < 0.2] = -1
    batch = {"tokens": toks[:, :-1], "targets": targets,
             "frames": rs.randn(2, 9, cfg_j.d_model).astype(np.float32)}
    (want_loss, want_parts), grads = jax.value_and_grad(
        lambda p: encdec_jax.loss(p, cfg_j, {k: jnp.asarray(v)
                                             for k, v in batch.items()}),
        has_aux=True)(params)
    loss, parts = model.loss({k: torch.from_numpy(v)
                              for k, v in batch.items()}, remat=remat)
    assert loss.dtype == torch.float32 and parts["aux"].item() == 0.0
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(parts["ce"].item(), float(want_parts["ce"]),
                               rtol=1e-5)
    loss.backward()
    want = from_jax_params(jax.tree.map(np.asarray, grads), model.cfg)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        scale = max(float(np.abs(want[name].numpy()).max()), 1e-30)
        err = float(np.abs(p.grad.numpy() - want[name].numpy()).max())
        assert err / scale <= 1e-4, name


def test_encdec_serving_builds_no_graph():
    cfg_j, _, model = _pair()
    assert all(p.requires_grad for p in model.parameters())
    toks, frames = _inputs(cfg_j, 1, 3, 4, seed=7)
    cache = model.init_cache(1, 8, src_len=4)
    lg, cache = model.prefill(torch.from_numpy(toks), cache,
                              torch.from_numpy(frames))
    lg2, _ = model.decode_step(cache, torch.tensor([[1]]))
    assert not lg.requires_grad and not lg2.requires_grad


# ------------------------------------------------------------------------- #
# On the card: seamless's layer stack (full width: d 1024, 16 heads of 64,
# gelu FFN 8192; 2 + 2 layers, a small vocabulary) through the kernels
# against the same weights on the CPU, fp32
# ------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_encdec_stack_on_the_card_matches_the_cpu(cuda_device):
    """Prefill (encoder: non-causal attention over 256 frames; decoder:
    causal self-attention and non-causal cross-attention) and two decode
    ticks through the kernels, against the plain versions on the CPU on the
    same weights: logits within 2e-3."""
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(
        get_config(ARCH), vocab_size=2048,
        encdec=dataclasses.replace(get_config(ARCH).encdec, encoder_layers=2,
                                   decoder_layers=2))
    cpu = EncDec(cfg, dtype=torch.float32, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    gpu = EncDec(cfg, dtype=torch.float32, device=cuda_device,
                 generator=torch.Generator().manual_seed(0))
    toks, frames = _inputs(cfg, 2, 40, 256, seed=8)
    outs = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = model.device
        cache = model.init_cache(2, 64, src_len=256)
        before = ops.flash_attention.launches
        lg, cache = model.prefill(torch.from_numpy(toks[:, :38]).to(dev),
                                  cache, torch.from_numpy(frames).to(dev))
        got = [lg]
        for t in (38, 39):
            lg, cache = model.decode_step(
                cache, torch.from_numpy(toks[:, t:t + 1]).to(dev))
            got.append(lg)
        outs[name] = [g.float().cpu() for g in got]
        if name == "gpu":
            assert ops.flash_attention.launches - before == 3 * 2 + 2 * 4
    for got, want in zip(outs["gpu"], outs["cpu"]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 2e-3


def test_engine_refuses_the_encoder_decoder():
    """The engine takes token prompts only (as the reference's): it refuses
    a model that needs source frames, with what to call instead."""
    from repro_torch.serve import Engine, EngineConfig
    _, _, model = _pair()
    with pytest.raises(ValueError, match="frames"):
        Engine(model.cfg, model, EngineConfig(max_batch=2, max_seq=16),
               dtype=torch.float32, device="cpu")
