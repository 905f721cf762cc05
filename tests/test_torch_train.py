"""repro_torch.train.optimizer against the JAX package's, on the CPU, and
three DLRM training steps (loss -> backward -> apply_updates) against the
JAX package's own composition on JAX-made batches.

Tolerances: the learning rate 1e-6 relative (the reference computes it in
fp32, the port in float64); one ``apply_updates`` 1e-6 per leaf (the port
fuses the same operations in place, a few fp32 ulps apart); three DLRM steps
1e-5 (the losses and the final parameters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_dlrm_config as get_dlrm_config_jax
from repro.data.pipeline import DataConfig as DataConfigJax
from repro.data.pipeline import dlrm_batch as dlrm_batch_jax
from repro.models import dlrm as dlrm_jax
from repro.train import optimizer as opt_jax
from repro_torch.configs import get_dlrm_config
from repro_torch.convert import from_jax_dlrm_params
from repro_torch.models.dlrm import DLRM
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)


def _cfgs(**kw):
    return opt_jax.AdamWConfig(**kw), opt.AdamWConfig(**kw)


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 2500, 9999, 10_000,
                                  20_000])
def test_lr_schedule_matches_jax(step):
    cj, ct = _cfgs()
    want = float(opt_jax.lr_schedule(cj, jnp.asarray(step)))
    assert opt.lr_schedule(ct, step) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_lr_schedule_short_run_matches_jax():
    """The DLRM run's schedule: warmup 2, 20 steps."""
    cj, ct = _cfgs(lr=3e-3, warmup_steps=2, total_steps=20)
    for step in range(0, 22):
        want = float(opt_jax.lr_schedule(cj, jnp.asarray(step)))
        assert opt.lr_schedule(ct, step) == pytest.approx(want, rel=1e-6,
                                                          abs=1e-12)


def _tree(seed, dtype=np.float32, grad_scale=1.0):
    rs = np.random.RandomState(seed)
    shapes = {"w": (6, 5), "b": (5,), "emb": (3, 4, 2), "g": (7,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (grad_scale * rs.randn(*s)).astype(np.float32)
             for k, s in shapes.items()}
    return params, grads


def test_global_norm_matches_jax():
    _, grads = _tree(0)
    want = float(opt_jax.global_norm({k: jnp.asarray(v)
                                      for k, v in grads.items()}))
    got = opt.global_norm({k: torch.from_numpy(v) for k, v in grads.items()})
    assert got.dtype == torch.float32
    assert got.item() == pytest.approx(want, rel=1e-6)


def _to_torch(tree, dtype):
    """Copies: apply_updates works in place, the numpy arrays stay."""
    return {k: torch.from_numpy(v).to(dtype, copy=True)
            for k, v in tree.items()}


@pytest.mark.parametrize("mode", ["fp32_master", "fp32_no_master",
                                  "bf16_master", "fp32_clipped"])
def test_apply_updates_matches_jax(mode):
    """Two updates in a row (the second sees non-zero moments and step 2),
    every leaf of params and state compared."""
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=100)
    kw["use_master"] = mode != "fp32_no_master"
    grad_scale = 100.0 if mode == "fp32_clipped" else 0.1
    cj, ct = _cfgs(**kw)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if mode == "bf16_master"
                else (jnp.float32, torch.float32))
    params, _ = _tree(1)
    pj = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    pt = _to_torch(params, tdt)
    sj, st = opt_jax.init_state(pj, cj), opt.init_state(pt, ct)
    for step in range(2):
        _, grads = _tree(10 + step, grad_scale=grad_scale)
        pj, sj, mj = opt_jax.apply_updates(
            pj, {k: jnp.asarray(v).astype(jdt) for k, v in grads.items()},
            sj, cj)
        pt2, st2, mt = opt.apply_updates(pt, _to_torch(grads, tdt), st, ct)
        assert pt2 is pt and st2 is st
        assert mt["lr"] == pytest.approx(float(mj["lr"]), rel=1e-6)
        assert mt["grad_norm"].item() == pytest.approx(float(mj["grad_norm"]),
                                                       rel=1e-5)
    if mode == "fp32_clipped":
        assert float(mj["grad_norm"]) > 10 * cj.grad_clip
    assert int(st["step"]) == int(sj["step"]) == 2
    groups = [("param", pt, pj), ("m", st["m"], sj["m"]),
              ("v", st["v"], sj["v"])]
    if kw["use_master"]:
        groups.append(("master", st["master"], sj["master"]))
    else:
        assert "master" not in st
    for what, mine, theirs in groups:
        for k in params:
            assert mine[k].dtype == (tdt if what == "param" else torch.float32)
            np.testing.assert_allclose(
                mine[k].float().numpy(),
                np.asarray(theirs[k].astype(jnp.float32)), atol=1e-6,
                rtol=1e-6, err_msg=f"{mode} {what} {k}")


def test_decay_only_where_ndim_at_least_2():
    """Zero gradients: Adam's step is 0, so only the decay moves a leaf,
    by lr * weight_decay, and only a leaf of two or more dims."""
    params, grads = _tree(2)
    ct = opt.AdamWConfig(lr=0.1, warmup_steps=0, use_master=False)
    pt = _to_torch(params, torch.float32)
    zeros = {k: torch.zeros_like(v) for k, v in pt.items()}
    opt.apply_updates(pt, zeros, opt.init_state(pt, ct), ct)
    lr = opt.lr_schedule(ct, 1)
    for k, v in params.items():
        want = v * (1 - lr * ct.weight_decay) if v.ndim >= 2 else v
        np.testing.assert_allclose(pt[k].numpy(), want, rtol=1e-6, atol=1e-7)


def test_bf16_states_no_master_uses_stochastic_rounding():
    w = {"w": torch.ones(8, dtype=torch.bfloat16)}
    ct = opt.AdamWConfig(state_dtype="bfloat16", use_master=False,
                         warmup_steps=0)
    st = opt.init_state(w, ct)
    assert "master" not in st and st["m"]["w"].dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    w2, st2, _ = opt.apply_updates(
        w, {"w": torch.ones(8, dtype=torch.bfloat16)}, st, ct, generator=gen)
    assert w2["w"].dtype == torch.bfloat16
    assert st2["m"]["w"].dtype == torch.bfloat16
    # 1 - lr * (1 + decay 0) lies between the bf16 neighbours 1 - 2^-8 and 1
    assert set(w2["w"].float().tolist()) <= {1.0, 1.0 - 2 ** -8}


def test_stochastic_rounding_unbiased():
    """The statistical contract of tests/test_train_infra.py (the random
    stream cannot match jax.random): the mean of eight draws is x within
    2e-4, and every value is one of x's two bf16 neighbours."""
    x = torch.full((10000,), 1.0 + 2 ** -10)
    draws = [opt._stochastic_round(x, torch.Generator().manual_seed(s))
             for s in range(8)]
    est = np.mean([d.float().mean().item() for d in draws])
    assert abs(est - (1.0 + 2 ** -10)) < 2e-4
    values = set(torch.cat(draws).float().unique().tolist())
    assert values <= {1.0, 1.0078125}
    neg = opt._stochastic_round(-x, torch.Generator().manual_seed(9))
    assert set(neg.float().unique().tolist()) <= {-1.0, -1.0078125}


def test_dlrm_three_training_steps_match_jax():
    cfg_j = get_dlrm_config_jax(reduced=True)
    params = dlrm_jax.init_params(jax.random.PRNGKey(0), cfg_j)
    model = DLRM(get_dlrm_config(reduced=True), device="cpu")
    model.load_state_dict(from_jax_dlrm_params(jax.tree.map(np.asarray,
                                                            params)))
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=20, use_master=False)
    cj, ct = _cfgs(**kw)
    sj = opt_jax.init_state(params, cj)
    tparams = dict(model.named_parameters())
    st = opt.init_state(tparams, ct)
    dcfg = DataConfigJax(vocab_size=0, seq_len=0, global_batch=16, seed=0,
                         num_dense=cfg_j.num_dense_features,
                         num_tables=cfg_j.num_tables,
                         lookups=cfg_j.lookups_per_table,
                         rows=cfg_j.rows_per_table)
    losses_j, losses_t = [], []
    for step in range(3):
        batch = jax.tree.map(np.asarray, dlrm_batch_jax(dcfg, step))
        (loss_j, _), grads = jax.value_and_grad(
            lambda p: dlrm_jax.loss(p, cfg_j, batch), has_aux=True)(params)
        params, sj, _ = opt_jax.apply_updates(params, grads, sj, cj)
        losses_j.append(float(loss_j))
        loss, _ = model.loss({k: torch.from_numpy(v)
                              for k, v in batch.items()})
        loss.backward()
        opt.apply_updates(tparams, {k: p.grad for k, p in tparams.items()},
                          st, ct)
        model.zero_grad(set_to_none=True)
        losses_t.append(loss.item())
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    want = from_jax_dlrm_params(jax.tree.map(np.asarray, params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
