"""repro_torch models against the JAX package on shared weights, on the CPU.

JAX params -> numpy -> ``from_jax_params`` -> the port's modules, fp32,
``device="cpu"`` (so attention and RMSNorm run their plain versions). Inputs
are made with numpy from a seed and handed to both sides.
"""

import dataclasses
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.models import common as jcommon
from repro.models import get_model as get_model_jax
from repro_torch import resolve_device
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import cache_to_numpy, from_jax_params
from repro_torch.models import common as tcommon
from repro_torch.models import get_model

torch.set_num_threads(1)

ARCHS = ["smollm-135m", "chatglm3-6b", "minitron-8b", "internlm2-20b"]
MOE_ARCHS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b"]
CONFIG_ARCHS = ARCHS + ["mamba2-780m"] + MOE_ARCHS + ["internvl2-76b",
                                                      "zamba2-2.7b",
                                                      "seamless-m4t-large-v2",
                                                      "transformer-1t"]


def _pair(arch, seed=0, dtype=jnp.float32):
    """The JAX (module, cfg, params) and the port's model on equal weights."""
    cfg_j = get_config_jax(arch, reduced=True)
    mod = get_model_jax(cfg_j)
    params = mod.init_params(jax.random.PRNGKey(seed), cfg_j, dtype=dtype)
    cfg = get_config(arch, reduced=True)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    model = get_model(cfg)(cfg, dtype=tdtype, device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return mod, cfg_j, params, model


def _tokens(cfg, b, s, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(b, s))


@pytest.mark.parametrize("arch", CONFIG_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_equals_reference(arch, reduced):
    import dataclasses
    mine = dataclasses.asdict(get_config(arch, reduced=reduced))
    theirs = dataclasses.asdict(get_config_jax(arch, reduced=reduced))
    mine.pop("notes"), theirs.pop("notes")     # prose, reworded in the copy
    assert mine == theirs
    assert (get_config(arch, reduced=reduced).padded_vocab
            == get_config_jax(arch, reduced=reduced).padded_vocab)
    assert (get_config(arch, reduced=reduced).param_count()
            == get_config_jax(arch, reduced=reduced).param_count())


def test_get_config_unknown_arch_raises_keyerror():
    from repro.configs import ASSIGNED_ARCHS
    assert set(ASSIGNED_ARCHS) | {"transformer-1t"} == set(list_configs())
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_get_model_names_pending_families():
    """No family is pending any more: each maps to the class that builds
    it, as the reference maps each to its module, and an unknown family
    raises ValueError."""
    from repro_torch.models import EncDec, Mamba, Transformer
    want = {"dense": Transformer, "moe": Transformer, "vlm": Transformer,
            "ssm": Mamba, "hybrid": Mamba, "encdec": EncDec}
    base = get_config("smollm-135m", reduced=True)
    for family, cls in want.items():
        assert get_model(dataclasses.replace(base, family=family)) is cls
    with pytest.raises(ValueError, match="unknown family"):
        get_model(dataclasses.replace(base, family="rnn"))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(fraction, dtype):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 7, 3, 16).astype(np.float32)
    pos = rs.randint(0, 500, size=(2, 7))
    cj, sj = jcommon.rope_frequencies(16, fraction, 10_000.0, jnp.asarray(pos))
    ct, st = tcommon.rope_frequencies(16, fraction, 10_000.0,
                                      torch.from_numpy(pos))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    if dtype == "float32":
        want = jcommon.apply_rope(jnp.asarray(x), cj, sj)
        got = tcommon.apply_rope(torch.from_numpy(x), ct, st)
        atol = 1e-5
    else:
        # bf16 rounds cos/sin before the multiply on both sides; one bf16
        # ulp at the largest |x| here (< 4) is 2^-6
        want = jcommon.apply_rope(jnp.asarray(x).astype(jnp.bfloat16), cj, sj)
        got = tcommon.apply_rope(torch.from_numpy(x).bfloat16(), ct, st)
        want, got, atol = want.astype(jnp.float32), got.float(), 2 ** -6
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_rms_norm_and_ffn_match_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 5, 24).astype(np.float32)
    g = rs.randn(24).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g))),
        atol=1e-5)
    for act, names in (("swiglu", ("wg", "wu", "wd")), ("gelu", ("wu", "wd"))):
        w = {n: (rs.randn(48, 24) if n == "wd" else rs.randn(24, 48)
                 ).astype(np.float32) * 0.2 for n in names}
        want = jcommon.ffn_block({n: jnp.asarray(a) for n, a in w.items()},
                                 jnp.asarray(x), act)
        got = tcommon.ffn_block({n: torch.from_numpy(a) for n, a in w.items()},
                                torch.from_numpy(x), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _attn_weights(rs, d_in, h, hkv, hd):
    shapes = {"wq": (d_in, h * hd), "wk": (d_in, hkv * hd),
              "wv": (d_in, hkv * hd), "wo": (h * hd, d_in)}
    return {n: rs.randn(*s).astype(np.float32) * 0.2 for n, s in shapes.items()}


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_attention_block_without_cache_matches_jax(fraction):
    rs = np.random.RandomState(3)
    h, hkv, hd, d_in = 6, 2, 16, 32
    w = _attn_weights(rs, d_in, h, hkv, hd)
    x = rs.randn(2, 9, d_in).astype(np.float32)
    kw = dict(num_heads=h, num_kv_heads=hkv, head_dim=hd,
              rope_fraction=fraction)
    want, _ = jcommon.attention_block(
        {n: jnp.asarray(a) for n, a in w.items()}, jnp.asarray(x), **kw)
    got = tcommon.attention_block(
        {n: torch.from_numpy(a) for n, a in w.items()}, torch.from_numpy(x),
        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_attention_block_with_cache_matches_jax():
    """Prefill (the reference attends over the whole zero-filled cache, the
    port over the prompt only: equal, the masked keys weigh 0) and then
    decode steps with the sequences at different depths."""
    rs = np.random.RandomState(4)
    h, hkv, hd, d_in, b, s, S = 6, 2, 16, 32, 2, 7, 20
    w = _attn_weights(rs, d_in, h, hkv, hd)
    wj = {n: jnp.asarray(a) for n, a in w.items()}
    wt = {n: torch.from_numpy(a) for n, a in w.items()}
    kw = dict(num_heads=h, num_kv_heads=hkv, head_dim=hd)
    x = rs.randn(b, s, d_in).astype(np.float32)
    cache_j = {"k": jnp.zeros((b, S, hkv, hd)), "v": jnp.zeros((b, S, hkv, hd)),
               "pos": jnp.zeros((b,), jnp.int32)}
    cache_t = {"k": torch.zeros(b, S, hkv, hd), "v": torch.zeros(b, S, hkv, hd),
               "pos": torch.zeros(b, dtype=torch.int32)}
    want, cache_j = jcommon.attention_block(wj, jnp.asarray(x),
                                            kv_cache=cache_j, **kw)
    got = tcommon.attention_block(wt, torch.from_numpy(x), kv_cache=cache_t,
                                  **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the port's block leaves the clock to its caller; put the sequences at
    # different depths on both sides
    pos = np.array([s, s - 3], np.int32)
    cache_j["pos"] = jnp.asarray(pos)
    cache_t["pos"] = torch.from_numpy(pos.copy())
    for step in range(3):
        x1 = rs.randn(b, 1, d_in).astype(np.float32)
        want, cache_j = jcommon.attention_block(wj, jnp.asarray(x1),
                                                kv_cache=cache_j, **kw)
        got = tcommon.attention_block(wt, torch.from_numpy(x1),
                                      kv_cache=cache_t, **kw)
        cache_t["pos"] = cache_t["pos"] + 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(cache_t["k"].numpy(), np.asarray(cache_j["k"]),
                               atol=1e-6)
    np.testing.assert_allclose(cache_t["v"].numpy(), np.asarray(cache_j["v"]),
                               atol=1e-6)
    np.testing.assert_array_equal(cache_t["pos"].numpy(),
                                  np.asarray(cache_j["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    mod, cfg_j, params, model = _pair(arch)
    toks = _tokens(cfg_j, 2, 13)
    want, _, _ = mod.forward(params, cfg_j, jnp.asarray(toks))
    with torch.no_grad():
        got, cache = model(torch.from_numpy(toks))
    assert cache is None
    assert got.shape == (2, 13, cfg_j.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_forward_and_jax(arch):
    """prefill + decode_step equal the full forward (the contract of
    tests/test_models_smoke.py::test_serving_matches_forward) and the JAX
    package's prefill/decode on the same weights; so does the cache."""
    mod, cfg_j, params, model = _pair(arch)
    b, s = 2, 12
    toks = _tokens(cfg_j, b, s + 1, seed=1)
    with torch.no_grad():
        full, _ = model(torch.from_numpy(toks))
    cache = model.init_cache(b, 32)
    lg, cache = model.prefill(torch.from_numpy(toks[:, :s]), cache)
    lg2, cache = model.decode_step(cache, torch.from_numpy(toks[:, s:]))
    assert lg.shape == (b, 1, cfg_j.padded_vocab)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, s - 1].numpy(),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(lg2[:, 0].numpy(), full[:, s].numpy(),
                               atol=2e-3, rtol=1e-3)

    cache_j = mod.init_cache(cfg_j, b, 32, dtype=jnp.float32)
    lg_j, cache_j = mod.prefill(params, cfg_j, jnp.asarray(toks[:, :s]),
                                cache_j)
    after_prefill = jax.tree.map(np.asarray, cache_j)
    lg2_j, cache_j = mod.decode_step(params, cfg_j, cache_j,
                                     jnp.asarray(toks[:, s:]))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), atol=1e-4)
    np.testing.assert_allclose(lg2.numpy(), np.asarray(lg2_j), atol=1e-4)
    mine = cache_to_numpy(cache)
    for name in ("k", "v"):
        assert mine[name].shape == after_prefill[name].shape
        np.testing.assert_allclose(mine[name][:, :, :s],
                                   after_prefill[name][:, :, :s], atol=1e-5)
        np.testing.assert_allclose(mine[name], np.asarray(cache_j[name]),
                                   atol=1e-5)
    np.testing.assert_array_equal(mine["pos"], np.asarray(cache_j["pos"]))


# ------------------------------------------------------------------------- #
# mamba2 (ssm family), reduced: 8 SSD heads of p 16, n 16, chunk 32
# ------------------------------------------------------------------------- #

def test_mamba_param_count_and_tree():
    """The full config counts 781,252,608 parameters (``param_count`` leaves
    out conv_b, dt_bias and norm_g, as the reference's does); the module tree
    has the JAX tree's leaves, shapes and sizes."""
    assert get_config("mamba2-780m").param_count() == 781_252_608
    mod, cfg_j, params, model = _pair("mamba2-780m")
    assert model.layers[0].A_log.dtype == torch.float32
    converted = from_jax_params(jax.tree.map(np.asarray, params), cfg_j)
    assert set(converted) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert t.shape == converted[name].shape, name
    assert (sum(p.numel() for p in model.parameters())
            == sum(a.size for a in jax.tree.leaves(params)))


def test_mamba_forward_logits_match_jax():
    """45 tokens cross the 32-token chunk and leave a ragged tail."""
    mod, cfg_j, params, model = _pair("mamba2-780m")
    toks = _tokens(cfg_j, 2, 45)
    want, _, _ = mod.forward(params, cfg_j, jnp.asarray(toks))
    with torch.no_grad():
        got, cache = model(torch.from_numpy(toks))
    assert cache is None
    assert got.shape == (2, 45, cfg_j.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("s", [45, 2])
def test_mamba_serving_matches_forward_and_jax(s):
    """prefill + two decode steps equal the full forward and the JAX
    package's prefill/decode_step, the conv/ssm/pos cache included. s = 2 is
    shorter than the conv window (width - 1 = 3): the conv tail is padded on
    the left."""
    mod, cfg_j, params, model = _pair("mamba2-780m")
    b = 2
    toks = _tokens(cfg_j, b, s + 2, seed=1)
    with torch.no_grad():
        full, _ = model(torch.from_numpy(toks))
    cache = model.init_cache(b, 64)
    cache_j = mod.init_cache(cfg_j, b, 64, dtype=jnp.float32)
    lg, cache = model.prefill(torch.from_numpy(toks[:, :s]), cache)
    lg_j, cache_j = mod.prefill(params, cfg_j, jnp.asarray(toks[:, :s]),
                                cache_j)
    steps = [(lg, lg_j, cache_to_numpy(cache),
              jax.tree.map(np.asarray, cache_j))]
    for t in range(s, s + 2):
        lg, cache = model.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]))
        lg_j, cache_j = mod.decode_step(params, cfg_j, cache_j,
                                        jnp.asarray(toks[:, t:t + 1]))
        steps.append((lg, lg_j, cache_to_numpy(cache),
                      jax.tree.map(np.asarray, cache_j)))
    for k, (got, want, mine, theirs) in enumerate(steps):
        assert got.shape == (b, 1, cfg_j.padded_vocab)
        np.testing.assert_allclose(got[:, 0].numpy(),
                                   full[:, s - 1 + k].numpy(),
                                   atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        assert set(mine) == set(theirs) == {"conv", "ssm", "pos"}
        for name in ("conv", "ssm"):
            assert mine[name].shape == theirs[name].shape
            np.testing.assert_allclose(mine[name], theirs[name], atol=1e-5)
        np.testing.assert_array_equal(mine["pos"], theirs["pos"])


def test_mamba_prefill_overwrites_the_cache_state():
    """A prefill starts from zeros whatever the cache holds: a cache full of
    another sequence's state gives the logits and state of a fresh one."""
    _, cfg_j, _, model = _pair("mamba2-780m")
    toks = torch.from_numpy(_tokens(cfg_j, 1, 9, seed=2))
    fresh = model.init_cache(1, 64)
    lg_fresh, fresh = model.prefill(toks, fresh)
    stale = model.init_cache(1, 64)
    model.prefill(torch.from_numpy(_tokens(cfg_j, 1, 30, seed=3)), stale)
    stale["pos"].zero_()
    lg_stale, stale = model.prefill(toks, stale)
    torch.testing.assert_close(lg_stale, lg_fresh, rtol=0, atol=0)
    for name in ("conv", "ssm", "pos"):
        torch.testing.assert_close(stale[name], fresh[name], rtol=0, atol=0)


def test_mamba_decode_updates_the_cache_in_place():
    _, cfg_j, _, model = _pair("mamba2-780m")
    cache = model.init_cache(2, 64)
    _, cache = model.prefill(torch.from_numpy(_tokens(cfg_j, 2, 5)), cache)
    ptrs = {n: cache[n].data_ptr() for n in ("conv", "ssm")}
    before = {n: cache[n].clone() for n in ("conv", "ssm")}
    _, cache = model.decode_step(cache, torch.tensor([[3], [4]]))
    for name in ("conv", "ssm"):
        assert cache[name].data_ptr() == ptrs[name]
        assert not torch.equal(cache[name], before[name])
    assert cache["pos"].tolist() == [6, 6]


def test_mamba_layer_hands_the_scan_views(monkeypatch):
    """x, B and C reach ``ops.ssd_scan`` as strided views of the conv output
    in the model's layout (b, s, h, p) / (b, s, g, n): nothing transposed,
    repeated or copied on the way."""
    from repro_torch.kernels import ops
    _, cfg_j, _, model = _pair("mamba2-780m")
    seen = []
    real = ops.ssd_scan

    def spy(x, dt, A, B, C, chunk):
        seen.append((x, dt, A, B, C, chunk))
        return real(x, dt, A, B, C, chunk)
    monkeypatch.setattr(ops, "ssd_scan", spy)
    with torch.no_grad():
        model(torch.from_numpy(_tokens(cfg_j, 1, 7)))
    cfg = model.cfg
    assert len(seen) == cfg.num_layers
    x, dt, A, B, C, chunk = seen[0]
    assert x.shape == (1, 7, cfg.ssm_heads, cfg.ssm.head_dim)
    assert B.shape == C.shape == (1, 7, cfg.ssm.ngroups, cfg.ssm.state_dim)
    assert x.data_ptr() == B.data_ptr() - cfg.d_inner * x.element_size()
    assert not x.is_contiguous() and x.stride(-1) == 1
    assert dt.dtype == A.dtype == torch.float32 and (A < 0).all()
    assert chunk == cfg.ssm.chunk_size


# ------------------------------------------------------------------------- #
# zamba2 (hybrid family), reduced: 2 Mamba2 layers, the shared block after
# both (4 heads over 2 KV heads of 16, on concat(h, emb0) 128 wide); the
# "4 layers" variant has two groups, so the one shared block runs twice
# ------------------------------------------------------------------------- #

ZAMBA = "zamba2-2.7b"


def _zamba_pair(layers=None, seed=0):
    """``_pair`` for zamba2 reduced, or with ``layers`` layers (groups of
    attn_every 2) on both sides."""
    if layers is None:
        return _pair(ZAMBA, seed)
    cfg_j = dataclasses.replace(get_config_jax(ZAMBA, reduced=True),
                                num_layers=layers)
    mod = get_model_jax(cfg_j)
    params = mod.init_params(jax.random.PRNGKey(seed), cfg_j,
                             dtype=jnp.float32)
    cfg = dataclasses.replace(get_config(ZAMBA, reduced=True),
                              num_layers=layers)
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return mod, cfg_j, params, model


def test_zamba_param_count_and_tree():
    """The full config counts 2,407,693,248 parameters (``param_count``
    leaves out conv_b, dt_bias and norm_g, as the reference's does); the
    module tree has the JAX tree's leaves and sizes, and carries back to
    it."""
    from repro_torch.convert import to_jax_params
    assert get_config(ZAMBA).param_count() == 2_407_693_248
    mod, cfg_j, params, model = _zamba_pair()
    converted = from_jax_params(jax.tree.map(np.asarray, params), cfg_j)
    assert set(converted) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert t.shape == converted[name].shape, name
    assert (sum(p.numel() for p in model.parameters())
            == sum(a.size for a in jax.tree.leaves(params)))
    back = to_jax_params(model.state_dict(), model.cfg)
    assert (jax.tree.structure(jax.tree.map(lambda a: 0, back))
            == jax.tree.structure(jax.tree.map(lambda a: 0, params)))
    for (path, got), want in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree.leaves(params)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=str(path))


def test_zamba_shared_attention_weights_are_shared(monkeypatch):
    """One attention block's parameters, reused at every application
    point: ONE ``shared_attn`` (2-D ``wq``, as in the reference's tree),
    and a forward over two groups runs that one module twice."""
    from repro_torch.models.mamba import SharedAttn
    _, cfg_j, params, model = _zamba_pair(layers=4)
    assert params["shared_attn"]["attn"]["wq"].ndim == 2
    assert model.shared_attn.attn.wq.dim() == 2
    assert sum(isinstance(m, SharedAttn) for m in model.modules()) == 1
    assert not any(k.startswith("layers.") and "shared" in k
                   for k in model.state_dict())
    seen = []
    real = SharedAttn.forward

    def spy(self, *args, **kwargs):
        seen.append(self)
        return real(self, *args, **kwargs)
    monkeypatch.setattr(SharedAttn, "forward", spy)
    with torch.no_grad():
        model(torch.from_numpy(_tokens(cfg_j, 1, 5)))
    assert len(seen) == 2 and all(m is model.shared_attn for m in seen)


@pytest.mark.parametrize("layers,s", [(None, 13), (4, 45)])
def test_zamba_forward_logits_match_jax(layers, s):
    """45 tokens cross the 32-token chunk and leave a ragged tail."""
    mod, cfg_j, params, model = _zamba_pair(layers)
    toks = _tokens(cfg_j, 2, s)
    want, _, _ = mod.forward(params, cfg_j, jnp.asarray(toks))
    with torch.no_grad():
        got, cache = model(torch.from_numpy(toks))
    assert cache is None
    assert got.shape == (2, s, cfg_j.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("layers,s", [(None, 12), (4, 2)])
def test_zamba_serving_matches_forward_and_jax(layers, s):
    """A prefill then three decode steps equal the full forward and the JAX
    package's prefill/decode_step, every cache tensor included (the shared
    block's attn_k/attn_v at each group)."""
    mod, cfg_j, params, model = _zamba_pair(layers)
    b = 2
    toks = _tokens(cfg_j, b, s + 3, seed=1)
    with torch.no_grad():
        full, _ = model(torch.from_numpy(toks))
    cache = model.init_cache(b, 32)
    cache_j = mod.init_cache(cfg_j, b, 32, dtype=jnp.float32)
    lg, cache = model.prefill(torch.from_numpy(toks[:, :s]), cache)
    lg_j, cache_j = mod.prefill(params, cfg_j, jnp.asarray(toks[:, :s]),
                                cache_j)
    steps = [(lg, lg_j, cache_to_numpy(cache),
              jax.tree.map(np.asarray, cache_j))]
    for t in range(s, s + 3):
        lg, cache = model.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]))
        lg_j, cache_j = mod.decode_step(params, cfg_j, cache_j,
                                        jnp.asarray(toks[:, t:t + 1]))
        steps.append((lg, lg_j, cache_to_numpy(cache),
                      jax.tree.map(np.asarray, cache_j)))
    names = {"conv", "ssm", "attn_k", "attn_v", "pos"}
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


@pytest.mark.parametrize("arch,layers", [("mamba2-780m", None),
                                         (ZAMBA, None), (ZAMBA, 4)])
def test_mamba_loss_and_grads_match_jax(arch, layers):
    """``Mamba.loss`` (remat "dots") and the gradient of every leaf, through
    autograd over the plain scan, against ``jax.value_and_grad`` of the JAX
    package's ``loss``: 45 tokens cross the 32-token chunk."""
    mod, cfg_j, params, model = (_pair(arch) if arch != ZAMBA
                                 else _zamba_pair(layers))
    batch = _lm_batch_np(cfg_j, 2, 45, seed=34, ignore=0.2)
    (want_loss, want_parts), grads = jax.value_and_grad(
        lambda p: mod.loss(p, cfg_j, {k: jnp.asarray(v)
                                      for k, v in batch.items()}),
        has_aux=True)(params)
    loss, parts = model.loss({k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert loss.dtype == torch.float32 and parts["aux"].item() == 0.0
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(parts["ce"].item(), float(want_parts["ce"]),
                               rtol=1e-5)
    loss.backward()
    want = from_jax_params(jax.tree.map(np.asarray, grads), model.cfg)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert _leaf_err(p.grad, want[name].numpy()) <= 1e-4, name


def _zamba_wide_heads_pair(num_kv_heads, seed=0):
    """``_pair`` for a narrow zamba2 whose shared block runs the published
    head_dim 160: d_model 320, 4 query heads of 160 on concat(h, emb0)
    (640 wide), ``num_kv_heads`` KV heads, 2 Mamba2 layers and the shared
    block after both."""
    def narrow(cfg):
        return dataclasses.replace(cfg, d_model=320, num_heads=4,
                                   num_kv_heads=num_kv_heads, head_dim=160,
                                   d_ff=256)
    cfg_j = narrow(get_config_jax(ZAMBA, reduced=True))
    mod = get_model_jax(cfg_j)
    params = mod.init_params(jax.random.PRNGKey(seed), cfg_j,
                             dtype=jnp.float32)
    cfg = narrow(get_config(ZAMBA, reduced=True))
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return mod, cfg_j, params, model


@pytest.mark.parametrize("num_kv_heads", [4, 2])
def test_zamba_shared_block_at_head_dim_160_loss_and_grads_match_jax(
        num_kv_heads):
    """The training route at zamba2's head_dim 160 (the shared block MHA
    as published, and a GQA group of 2): ``Mamba.loss`` and every leaf's
    gradient, through autograd over the plain versions, against
    ``jax.value_and_grad`` of the JAX package's ``loss`` on the same
    weights and batch: the loss within 1e-5, each leaf within 1e-4 of its
    largest magnitude. 45 tokens cross the 32-token chunk."""
    mod, cfg_j, params, model = _zamba_wide_heads_pair(num_kv_heads)
    assert model.cfg.resolved_head_dim == 160
    batch = _lm_batch_np(cfg_j, 2, 45, seed=36, ignore=0.2)
    (want_loss, _), grads = jax.value_and_grad(
        lambda p: mod.loss(p, cfg_j, {k: jnp.asarray(v)
                                      for k, v in batch.items()}),
        has_aux=True)(params)
    loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    want = from_jax_params(jax.tree.map(np.asarray, grads), model.cfg)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    assert named["shared_attn.attn.wq"].shape == (640, 640)
    for name, p in named.items():
        assert _leaf_err(p.grad, want[name].numpy()) <= 1e-4, name


@pytest.mark.parametrize("policy", ["none", "full", "blocks"])
def test_zamba_remat_policies_match_dots(policy):
    """Every remat policy gives the loss and the gradients of ``dots``."""
    _, cfg_j, _, model = _zamba_pair(layers=4)
    batch = {k: torch.from_numpy(v)
             for k, v in _lm_batch_np(cfg_j, 2, 10, seed=35).items()}

    def run(remat):
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(batch, remat=remat)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}
    want_loss, want = run("dots")
    loss, got = run(policy)
    assert loss == pytest.approx(want_loss, rel=1e-6)
    for name, g in got.items():
        assert _leaf_err(g, want[name].numpy()) <= 1e-6, name


def test_zamba_engine_greedy_tokens_match_jax_engine():
    """zamba2 reduced through both engines on shared weights: prompts of
    mixed lengths, more requests than slots (a slot is refilled, its
    prefill overwriting the conv/ssm state and the shared block's K/V
    rows); greedy tokens equal token for token."""
    from repro.serve import Engine as EngineJax
    from repro.serve import EngineConfig as EngineConfigJax
    from repro.serve import Request as RequestJax
    from repro_torch.serve import Engine, EngineConfig, Request
    mod, cfg_j, params, model = _zamba_pair()
    rs = np.random.RandomState(36)
    prompts = [rs.randint(0, cfg_j.vocab_size, size=n).astype(np.int32)
               for n in (5, 2, 9, 3)]
    eng_j = EngineJax(cfg_j, params,
                      EngineConfigJax(max_batch=2, max_seq=32),
                      dtype=jnp.float32)
    eng = Engine(model.cfg, model, EngineConfig(max_batch=2, max_seq=32),
                 dtype=torch.float32, device="cpu")
    for i, p in enumerate(prompts):
        eng_j.submit(RequestJax(uid=i, prompt=p, max_new_tokens=6))
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
    want = {r.uid: r.out_tokens for r in eng_j.run_until_drained()}
    got = {r.uid: r.out_tokens for r in eng.run_until_drained()}
    assert len(got) == 4 and got == want


# ------------------------------------------------------------------------- #
# tests/test_models_smoke.py's TestArchSmoke restated for the port: every
# assigned architecture's reduced config, fp32 on the CPU
# ------------------------------------------------------------------------- #

def _smoke_batch(cfg, b=2, s=16):
    rs = np.random.RandomState(37)
    tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(b, s)))
    batch = {"tokens": tokens, "targets": tokens}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rs.randn(b, 8, cfg.d_model).astype(np.float32))
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rs.randn(
            b, cfg.vision.num_patches, cfg.d_model).astype(np.float32))
    return batch


def _assigned():
    from repro.configs import ASSIGNED_ARCHS
    return ASSIGNED_ARCHS


@pytest.mark.parametrize("arch", _assigned())
class TestArchSmoke:
    def test_train_step_finite(self, arch):
        """One step of the port's train step (init_train_state,
        make_train_step): a finite loss, a positive finite gradient norm,
        every parameter moved, and logits of the padded vocabulary."""
        from repro_torch.parallel import MemoryPlan
        from repro_torch.train import init_train_state, make_train_step
        cfg = get_config(arch, reduced=True)
        plan = MemoryPlan(1, "float32", True, "dots", 0.0, 1)
        state = init_train_state(
            cfg, plan, generator=torch.Generator().manual_seed(0),
            dtype=torch.float32, device="cpu")
        before = {n: p.detach().clone() for n, p in state["params"].items()}
        batch = _smoke_batch(cfg)
        state, metrics = make_train_step(cfg, plan)(state, batch)
        assert np.isfinite(metrics["loss"].item())
        gnorm = metrics["grad_norm"].item()
        assert np.isfinite(gnorm) and gnorm > 0
        assert all(not torch.equal(p, before[n])
                   for n, p in state["params"].items()), arch
        kw = {k: v for k, v in batch.items() if k in ("frames", "patches")}
        with torch.no_grad():
            logits, _ = state["model"](batch["tokens"], **kw)
        assert logits.shape[-1] == cfg.padded_vocab
        assert torch.isfinite(logits).all()

    def test_serving_matches_forward(self, arch):
        cfg = get_config(arch, reduced=True)
        if cfg.moe is not None:  # exact-capacity variant for determinism
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu")
        b, s = 2, 12
        batch = _smoke_batch(cfg, b, s)
        kw = {k: v for k, v in batch.items() if k in ("frames", "patches")}
        if cfg.family == "encdec":
            cache = model.init_cache(b, 32, src_len=8)
        elif cfg.family == "vlm":
            cache = model.init_cache(b, 32 + cfg.vision.num_patches)
        else:
            cache = model.init_cache(b, 32)
        tokens = batch["tokens"]
        tok_full = torch.cat([tokens, tokens[:, :1]], dim=1)
        with torch.no_grad():
            full, _ = model(tok_full, **kw)
        lg, cache = model.prefill(tokens, cache, **kw)
        lg2, cache = model.decode_step(cache, tokens[:, :1])
        off = cfg.vision.num_patches if cfg.family == "vlm" else 0
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   full[:, s - 1 + off].numpy(),
                                   atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(lg2[:, 0].numpy(),
                                   full[:, s + off].numpy(),
                                   atol=2e-3, rtol=1e-3)


def test_from_jax_params_carries_bf16_bits():
    mod, cfg_j, params, model = _pair("smollm-135m", dtype=jnp.bfloat16)
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.embed.detach().float().numpy(),
        np.asarray(params["embed"].astype(jnp.float32)))
    np.testing.assert_array_equal(
        model.layers[1].attn.wq.detach().float().numpy(),
        np.asarray(params["layers"]["attn"]["wq"][1].astype(jnp.float32)))
    toks = _tokens(cfg_j, 1, 6)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()


def test_model_init_is_seeded_and_scaled():
    cfg = get_config("smollm-135m", reduced=True)
    make = lambda seed: get_model(cfg)(
        cfg, dtype=torch.float32, device="cpu",
        generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    assert torch.equal(a.layers[0].attn.wq, b.layers[0].attn.wq)
    assert not torch.equal(a.layers[0].attn.wq, c.layers[0].attn.wq)
    wq = a.layers[0].attn.wq
    std = 1.0 / cfg.d_model ** 0.5
    assert wq.abs().max() <= 2 * std + 1e-6          # truncated at 2 sigma
    assert 0.7 * std < wq.std() < std
    assert not hasattr(a, "head")                     # tied embeddings


def test_decode_past_the_cache_end_stays_in_range():
    """A sequence whose clock has run past max_seq (an idle engine slot)
    writes and attends at the last row instead of out of range."""
    cfg = get_config("smollm-135m", reduced=True)
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu")
    cache = model.init_cache(2, 8)
    cache["pos"] = torch.tensor([3, 50], dtype=torch.int32)
    logits, cache = model.decode_step(cache, torch.tensor([[1], [2]]))
    assert torch.isfinite(logits).all()
    assert cache["pos"].tolist() == [4, 51]


def test_no_gpu_means_an_explicit_choice():
    """Entry points use the GPU unless told otherwise; without one they
    raise and do not drop to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    cfg = get_config("smollm-135m", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(cfg)(cfg, dtype=torch.float32)
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of repro_torch, and chip_smoke.py's own imports, in a
    fresh interpreter: neither ``jax`` nor ``repro`` gets loaded."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        assert len(names) >= 15, names
        assert {"repro_torch.models.encdec",
                "repro_torch.configs.zamba2_2p7b",
                "repro_torch.configs.seamless_m4t_large_v2",
                "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                "repro_torch.core.hlo",
                "repro_torch.core.op_counter"} <= set(names)
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        import torch.distributed as dist
        assert not dist.is_initialized()    # importing joins no group
        print("imported", len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported")


# ------------------------------------------------------------------------- #
# DLRM (dlrm-reduced: 4 tables of 1000 x 16, 32 lookups, MLPs 13-32-16 and
# 27-32-16-1), fp32, parameters carried from JAX by from_jax_dlrm_params
# ------------------------------------------------------------------------- #

def _dlrm_pair(seed=0, dtype=jnp.float32):
    from repro.configs import get_dlrm_config as get_dlrm_config_jax
    from repro.models import dlrm as dlrm_jax
    from repro_torch.configs import get_dlrm_config
    from repro_torch.convert import from_jax_dlrm_params
    from repro_torch.models.dlrm import DLRM
    cfg_j = get_dlrm_config_jax(reduced=True)
    params = dlrm_jax.init_params(jax.random.PRNGKey(seed), cfg_j, dtype)
    cfg = get_dlrm_config(reduced=True)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    model = DLRM(cfg, device="cpu", dtype=tdtype)
    model.load_state_dict(from_jax_dlrm_params(jax.tree.map(np.asarray,
                                                            params)))
    return dlrm_jax, cfg_j, params, model


def _dlrm_batch_np(cfg, b, seed):
    rs = np.random.RandomState(seed)
    dense = rs.randn(b, cfg.num_dense_features).astype(np.float32)
    return {"dense": dense,
            "sparse": rs.randint(0, cfg.rows_per_table, size=(
                b, cfg.num_tables, cfg.lookups_per_table)).astype(np.int32),
            "labels": (dense.sum(-1) + 0.5 * rs.randn(b) > 0).astype(np.int32)}


def _flat_jax_grads(grads) -> dict:
    flat = {"tables": np.asarray(grads["tables"])}
    for mlp in ("bottom", "top"):
        for i, layer in enumerate(grads[mlp]):
            for name in ("w", "b"):
                flat[f"{mlp}.{i}.{name}"] = np.asarray(layer[name])
    return flat


@pytest.mark.parametrize("reduced", [False, True])
def test_dlrm_config_copy_equals_reference(reduced):
    from repro.configs import get_dlrm_config as get_dlrm_config_jax
    from repro_torch.configs import get_dlrm_config
    mine, theirs = get_dlrm_config(reduced), get_dlrm_config_jax(reduced)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for fn in ("embedding_params", "mlp_params", "param_count"):
        assert getattr(mine, fn)() == getattr(theirs, fn)()
    with pytest.raises(KeyError):
        get_config(mine.arch_id)          # not a ModelConfig


def test_dlrm_tree_matches_jax():
    _, cfg_j, params, model = _dlrm_pair()
    names = [n for n, _ in model.named_parameters()]
    assert names[0] == "tables" and "bottom.1.w" in names and "top.2.b" in names
    assert set(names) == set(_flat_jax_grads(params))
    assert all(p.requires_grad for p in model.parameters())
    assert (sum(p.numel() for p in model.parameters())
            == cfg_j.param_count())


def test_dlrm_logits_loss_and_grads_match_jax():
    dlrm_jax, cfg_j, params, model = _dlrm_pair()
    batch = _dlrm_batch_np(cfg_j, 6, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want_logits = np.asarray(dlrm_jax.forward(params, cfg_j, jb["dense"],
                                              jb["sparse"]))
    (want_loss, _), grads = jax.value_and_grad(
        lambda p: dlrm_jax.loss(p, cfg_j, jb), has_aux=True)(params)
    logits = model(tb["dense"], tb["sparse"])
    assert logits.shape == (6,)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=1e-5, atol=1e-6)
    loss, aux = model.loss(tb)
    assert aux["bce"] is loss and loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    want = _flat_jax_grads(grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_dlrm_bf16_promotes_as_jax_does():
    """bf16 parameters, fp32 dense features: JAX promotes ``dense @ w`` and
    the concatenation with the bf16 bags to fp32, so the MLPs, the
    interaction and the logits are fp32 on both sides. What differs is the
    bf16 bag sums, which both round once from fp32 sums taken in another
    order (one bf16 ulp, 2^-8 of a sum, apart at most): the logits and the
    loss are held at 1e-4 of their scale, far below a bf16 ulp."""
    dlrm_jax, cfg_j, params, model = _dlrm_pair(dtype=jnp.bfloat16)
    assert model.tables.dtype == torch.bfloat16
    batch = _dlrm_batch_np(cfg_j, 6, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want_logits = dlrm_jax.forward(params, cfg_j, jb["dense"], jb["sparse"])
    assert want_logits.dtype == jnp.float32
    want_loss, _ = dlrm_jax.loss(params, cfg_j, jb)
    with torch.no_grad():
        logits = model(tb["dense"], tb["sparse"])
        loss, _ = model.loss(tb)
    assert logits.dtype == torch.float32 and logits.shape == (6,)
    scale = max(1e-3, float(np.abs(np.asarray(want_logits)).max()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)


def test_dlrm_init_is_seeded_on_its_device():
    from repro_torch.configs import get_dlrm_config
    from repro_torch.models.dlrm import DLRM
    cfg = get_dlrm_config(reduced=True)
    a, b, c = (DLRM(cfg, seed=s, device="cpu") for s in (0, 0, 1))
    assert torch.equal(a.tables, b.tables) and torch.equal(a.top[0].w,
                                                           b.top[0].w)
    assert not torch.equal(a.tables, c.tables)
    assert 0.015 < a.tables.std().item() < 0.025        # embed_init: 0.02
    assert a.bottom[0].b.abs().max() == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DLRM(cfg)


# ------------------------------------------------------------------------- #
# Training: the loss, its gradients and the remat policies, fp32 on the CPU
# (attention and RMSNorm through their autograd Functions: the plain forward
# and the plain backward). Loss 1e-5 relative; every gradient leaf within
# 1e-4 of its largest magnitude.
# ------------------------------------------------------------------------- #

def _lm_batch_np(cfg, b, s, seed, ignore=0):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    targets = toks[:, 1:].copy()
    if ignore:
        targets[rs.rand(b, s) < ignore] = -1
    return {"tokens": toks[:, :-1], "targets": targets}


def _leaf_err(got: torch.Tensor, want: np.ndarray) -> float:
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got.detach().numpy() - want).max()) / scale


def test_cross_entropy_loss_matches_jax():
    rs = np.random.RandomState(30)
    logits = (3 * rs.randn(3, 7, 50)).astype(np.float32)
    targets = rs.randint(0, 50, size=(3, 7)).astype(np.int32)
    targets[0, :3] = -1
    targets[2, 6] = -1
    want = float(jcommon.cross_entropy_loss(jnp.asarray(logits),
                                            jnp.asarray(targets)))
    got = tcommon.cross_entropy_loss(torch.from_numpy(logits),
                                     torch.from_numpy(targets))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    every = np.full((2, 3), -1, np.int32)        # nothing to count: 0 / 1
    assert float(jcommon.cross_entropy_loss(
        jnp.asarray(logits[:2, :3]), jnp.asarray(every))) == 0.0
    assert tcommon.cross_entropy_loss(torch.from_numpy(logits[:2, :3]),
                                      torch.from_numpy(every)).item() == 0.0


@pytest.mark.parametrize("arch", ["smollm-135m", "chatglm3-6b"])
def test_loss_and_grads_match_jax(arch):
    """``Transformer.loss`` (remat "dots", the reference's default) and the
    gradient of every leaf against ``jax.value_and_grad`` of the JAX
    package's ``loss`` on the same weights and batch."""
    mod, cfg_j, params, model = _pair(arch)
    batch = _lm_batch_np(cfg_j, 2, 12, seed=31, ignore=0.2)
    (want_loss, want_parts), grads = jax.value_and_grad(
        lambda p: mod.loss(p, cfg_j, {k: jnp.asarray(v)
                                      for k, v in batch.items()}),
        has_aux=True)(params)
    loss, parts = model.loss({k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert loss.dtype == torch.float32 and parts["aux"].item() == 0.0
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(parts["ce"].item(), float(want_parts["ce"]),
                               rtol=1e-5)
    loss.backward()
    want = from_jax_params(jax.tree.map(np.asarray, grads), model.cfg)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert _leaf_err(p.grad, want[name].numpy()) <= 1e-4, name


def _counting(monkeypatch, name):
    """Count the calls of ``ops.<name>`` (a plain version the CPU route's
    autograd Functions call) while delegating to it."""
    from repro_torch.kernels import ops
    real = getattr(ops, name)
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, name, counted)
    return calls


# forward calls of attention and RMSNorm a loss and its backward, by policy:
# a recomputed layer runs its forwards again
REMAT_FORWARDS = {"none": (1, 2), "full": (2, 4), "dots": (2, 4),
                  "blocks": (2, 4)}


@pytest.mark.parametrize("policy", ["full", "dots", "blocks"])
def test_remat_policies_match_none(policy, monkeypatch):
    """Each remat policy gives the loss and every gradient of ``none``, and
    recomputes the attention and RMSNorm forwards of every layer (the final
    norm lies outside the layers)."""
    _, cfg_j, _, model = _pair("smollm-135m")
    batch = {k: torch.from_numpy(v)
             for k, v in _lm_batch_np(cfg_j, 2, 10, seed=32).items()}

    def run(remat):
        model.zero_grad(set_to_none=True)
        attn = _counting(monkeypatch, "flash_attention_forward_plain")
        norm = _counting(monkeypatch, "rmsnorm_plain")
        loss, _ = model.loss(batch, remat=remat)
        loss.backward()
        monkeypatch.undo()
        layers = model.cfg.num_layers
        per_attn, per_norm = REMAT_FORWARDS[remat]
        assert (len(attn), len(norm)) == (per_attn * layers,
                                          per_norm * layers + 1), remat
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    want_loss, want = run("none")
    loss, got = run(policy)
    assert loss == pytest.approx(want_loss, rel=1e-6)
    for name, g in got.items():
        assert _leaf_err(g, want[name].numpy()) <= 1e-6, name


def test_remat_unknown_policy_raises():
    _, cfg_j, _, model = _pair("smollm-135m")
    batch = {k: torch.from_numpy(v)
             for k, v in _lm_batch_np(cfg_j, 1, 4, seed=33).items()}
    with pytest.raises(ValueError, match="remat"):
        model.loss(batch, remat="everything")


def test_serving_keeps_parameters_out_of_autograd():
    """Parameters are trainable, but prefill and decode run under no_grad,
    so serving takes the kernels' serve route and builds no graph."""
    _, cfg_j, _, model = _pair("smollm-135m")
    assert all(p.requires_grad for p in model.parameters())
    cache = model.init_cache(2, 16)
    lg, cache = model.prefill(torch.from_numpy(_tokens(cfg_j, 2, 5)), cache)
    lg2, cache = model.decode_step(cache, torch.tensor([[1], [2]]))
    assert not lg.requires_grad and not lg2.requires_grad


# ------------------------------------------------------------------------- #
# On the card: zamba2's layer stack at full width (d 2560, the shared block
# on 5120 with 32 heads of 160, 80 SSD heads) through the kernels against
# the same weights on the CPU, fp32
# ------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_zamba_stack_on_the_card_matches_the_cpu(cuda_device):
    """4 layers in 2 groups, a small vocabulary: a 70-token prefill (the
    scan's kernels, the shared block's prefill attention at d 160) and two
    decode ticks (its decode attention) against the plain versions on the
    CPU on the same weights: logits within 2e-3."""
    from repro_torch.kernels import ops
    from repro_torch.models.mamba import Mamba
    cfg = dataclasses.replace(get_config(ZAMBA), num_layers=4,
                              vocab_size=2048,
                              hybrid=dataclasses.replace(
                                  get_config(ZAMBA).hybrid, attn_every=2))
    cpu = Mamba(cfg, dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(0))
    gpu = Mamba(cfg, dtype=torch.float32, device=cuda_device,
                generator=torch.Generator().manual_seed(0))
    toks = _tokens(cfg, 2, 72, seed=9)
    outs = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = model.device
        cache = model.init_cache(2, 128)
        before = (ops.flash_attention.launches, ops.ssd_scan.launches)
        lg, cache = model.prefill(torch.from_numpy(toks[:, :70]).to(dev),
                                  cache)
        got = [lg]
        for t in (70, 71):
            lg, cache = model.decode_step(
                cache, torch.from_numpy(toks[:, t:t + 1]).to(dev))
            got.append(lg)
        outs[name] = [g.float().cpu() for g in got]
        if name == "gpu":
            assert (ops.flash_attention.launches - before[0],
                    ops.ssd_scan.launches - before[1]) == (2 * 3, 4)
    for got, want in zip(outs["gpu"], outs["cpu"]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 2e-3
