"""repro_torch.train against the JAX package's, on the CPU: the optimizer,
three DLRM training steps (loss -> backward -> apply_updates) against the
JAX package's own composition on JAX-made batches, the dense LM's
``make_train_step`` (two microbatches) against the JAX single-device step,
the memory planner, the trainer and ``launch.train``.

Tolerances: the learning rate 1e-6 relative (the reference computes it in
fp32, the port in float64); one ``apply_updates`` 1e-6 per leaf (the port
fuses the same operations in place, a few fp32 ulps apart); three DLRM steps
1e-5 (the losses and the final parameters); one dense-LM step: the metrics
1e-5 relative, every updated parameter and master copy 1e-5 absolute and
relative (1 % of the step's learning rate), m and v 1e-5 of their largest
magnitude.
"""

import dataclasses
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES
from repro.configs import get_config as get_config_jax
from repro.configs import get_dlrm_config as get_dlrm_config_jax
from repro.data.pipeline import DataConfig as DataConfigJax
from repro.data.pipeline import dlrm_batch as dlrm_batch_jax
from repro.models import dlrm as dlrm_jax
from repro.models import get_model as get_model_jax
from repro.parallel.policy import MemoryPlan as MemoryPlanJax
from repro.parallel.policy import plan_memory as plan_memory_jax
from repro.train import optimizer as opt_jax
from repro.train.train_step import make_train_step as make_train_step_jax
from repro_torch.configs import get_config, get_dlrm_config, list_configs
from repro_torch.convert import from_jax_dlrm_params, from_jax_params
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.models.dlrm import DLRM
from repro_torch.parallel import H100_HBM_BYTES, MemoryPlan, plan_memory
from repro_torch.train import (
    Trainer,
    TrainerConfig,
    init_train_state,
    make_train_step,
)
from repro_torch.train import optimizer as opt
from repro_torch.data import DataConfig, DataIterator

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


def test_global_norm_of_a_padded_embedding_gradient_matches_jax():
    """A (2048, 64) leaf, reduced smollm's padded embedding: the sum of
    squares must be the reference's to fp32 accuracy (a norm routine that
    loses 3.5e-5 relative here once passed the small case above)."""
    rs = np.random.RandomState(35)
    g = (rs.randn(2048, 64) * np.exp(rs.randn(2048, 1))).astype(np.float32)
    want = float(opt_jax.global_norm({"embed": jnp.asarray(g)}))
    got = opt.global_norm({"embed": torch.from_numpy(g)}).item()
    assert got == pytest.approx(want, rel=2e-6)
    assert got == pytest.approx(float(np.linalg.norm(g.astype(np.float64))),
                                rel=2e-6)


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



# ------------------------------------------------------------------------- #
# The dense LM: one step of make_train_step, the planner, the trainer and
# the launcher (reduced smollm-135m, fp32, on the CPU)
# ------------------------------------------------------------------------- #

def _lm_batch(cfg, b, s, seed):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _scaled(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = max(want.abs().max().item(), 1e-30)
    return (got.detach() - want).abs().max().item() / scale


def test_make_train_step_two_microbatches_matches_jax():
    """One step with the batch split into two microbatches, from the same
    weights, optimizer state and batch, against the JAX package's
    single-device ``make_train_step``: the metrics, every updated parameter
    and the optimizer's m, v and master copies."""
    cfg_j = get_config_jax("smollm-135m", reduced=True)
    params = get_model_jax(cfg_j).init_params(jax.random.PRNGKey(3), cfg_j,
                                              dtype=jnp.float32)
    cj, ct = _cfgs(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = _lm_batch(cfg_j, 4, 12, seed=34)
    step_j = make_train_step_jax(
        cfg_j, MemoryPlanJax(1, "float32", True, "dots", 0.0, 2), cj)
    new_j, metrics_j = step_j(
        {"params": params, "opt": opt_jax.init_state(params, cj)},
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    cfg = get_config("smollm-135m", reduced=True)
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          cfg))
    tparams = dict(model.named_parameters())
    state = {"model": model, "params": tparams,
             "opt": opt.init_state(tparams, ct)}
    step = make_train_step(cfg, MemoryPlan(1, "float32", True, "dots", 0.0, 2),
                           ct)
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                          torch.Generator().manual_seed(0))
    assert set(metrics) == set(metrics_j) == {"loss", "ce", "aux", "lr",
                                              "grad_norm"}
    for name, want in metrics_j.items():
        got = metrics[name]
        got = got.item() if torch.is_tensor(got) else got
        assert got == pytest.approx(float(want), rel=1e-5, abs=1e-12), name
    want_params = from_jax_params(jax.tree.map(np.asarray, new_j["params"]),
                                  cfg)
    for name, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
        assert p.grad is None
    for part in ("m", "v", "master"):
        want = from_jax_params(jax.tree.map(np.asarray, new_j["opt"][part]),
                               cfg)
        for name, t in state["opt"][part].items():
            if part == "master":
                np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                           atol=1e-5, rtol=1e-5,
                                           err_msg=name)
            else:
                assert _scaled(t, want[name]) <= 1e-5, (part, name)
    assert int(state["opt"]["step"]) == int(new_j["opt"]["step"]) == 1


ZAMBA_STEPS = 12


def test_zamba2_twelve_steps_follow_the_reference():
    """``train_zamba``'s recipe (AdamW at lr 3e-3 with 2 warm-up steps of
    12, ZeRO-1 fp32 with master copies, remat ``dots``) at reduced zamba2
    (two Mamba2 layers, the shared block after both) for 12 steps, from the
    same converted weights on the same batches (4 x 64 tokens, two scan
    chunks), against the reference's single-device ``make_train_step``:
    the loss at every step within 1e-5 relative, the global norm within
    1e-4, every parameter at the end within 1e-3 of its leaf's largest
    (Adam's normalised steps carry the last digits of small gradients into
    the weights: 2.7e-4 in the embedding)."""
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=ZAMBA_STEPS)
    cj, ct = _cfgs(**kw)
    cfg_j = get_config_jax("zamba2-2.7b", reduced=True)
    params = get_model_jax(cfg_j).init_params(jax.random.PRNGKey(0), cfg_j,
                                              dtype=jnp.float32)
    step_j = jax.jit(make_train_step_jax(
        cfg_j, MemoryPlanJax(1, "float32", True, "dots", 0.0, 1), cj))
    state_j = {"params": params, "opt": opt_jax.init_state(params, cj)}

    cfg = get_config("zamba2-2.7b", reduced=True)
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          cfg))
    tparams = dict(model.named_parameters())
    state = {"model": model, "params": tparams,
             "opt": opt.init_state(tparams, ct)}
    step = make_train_step(cfg, MemoryPlan(1, "float32", True, "dots", 0.0, 1),
                           ct)
    for i in range(ZAMBA_STEPS):
        batch = _lm_batch(cfg_j, 4, 64, seed=100 + i)
        state_j, metrics_j = step_j(
            state_j, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()},
                              torch.Generator().manual_seed(0))
        assert metrics["loss"].item() == pytest.approx(
            float(metrics_j["loss"]), rel=1e-5), i
        assert metrics["grad_norm"].item() == pytest.approx(
            float(metrics_j["grad_norm"]), rel=1e-4), i
    want = from_jax_params(jax.tree.map(np.asarray, state_j["params"]), cfg)
    for name, p in tparams.items():
        assert _scaled(p, want[name]) <= 1e-3, name


DENSE_ARCHS = ["smollm-135m", "chatglm3-6b", "minitron-8b", "internlm2-20b"]
MOE_VLM_ARCHS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
                 "internvl2-76b"]


@pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_VLM_ARCHS)
def test_plan_memory_matches_reference(arch):
    """The port's planner against the reference's at one H100's 80 GB, for
    every transformer config, without a shape and at each training shape,
    on one device and on a few meshes."""
    assert arch in list_configs()
    shapes = [None] + [sh for sh in SHAPES.values() if sh.kind == "train"]
    for tp, dp in ((1, 1), (4, 1), (8, 32)):
        for shape in shapes:
            mine = plan_memory(get_config(arch), tp=tp, dp=dp, shape=shape)
            ref = plan_memory_jax(get_config_jax(arch), tp=tp, dp=dp,
                                  hbm_bytes=80e9, shape=shape)
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), (
                tp, dp, shape)
    assert H100_HBM_BYTES == 80e9
    plan = plan_memory(get_config("smollm-135m"), tp=1, dp=1)
    assert (plan.remat, plan.microbatches, plan.opt_dtype) == ("dots", 1,
                                                               "float32")


def _reduced_trainer(steps, step_fn_wrap=None, **trainer_kw):
    cfg = get_config("smollm-135m", reduced=True)
    plan = plan_memory(cfg, tp=1, dp=1)
    ocfg = opt.AdamWConfig(lr=3e-3, total_steps=steps, warmup_steps=1,
                           state_dtype=plan.opt_dtype,
                           use_master=plan.use_master)
    state = init_train_state(cfg, plan, torch.Generator().manual_seed(0),
                             ocfg, dtype=torch.float32, device="cpu")
    step_fn = make_train_step(cfg, plan, ocfg)
    if step_fn_wrap is not None:
        step_fn = step_fn_wrap(step_fn)
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4, seed=0), device="cpu")
    return Trainer(step_fn, state, data,
                   TrainerConfig(total_steps=steps, **trainer_kw))


def test_trainer_loss_falls_and_watchdog_counts_a_straggler():
    """20 steps of reduced smollm: the loss falls; step 15 is made slow, and
    the watchdog (median of the last 50 once there are 10) reports it."""
    def slow_at_15(step_fn):
        calls = []

        def wrapped(state, batch, gen):
            calls.append(1)
            if len(calls) == 16:
                time.sleep(1.5)
            return step_fn(state, batch, gen)
        return wrapped

    reported = []
    trainer = _reduced_trainer(20, slow_at_15, log_interval=1)
    trainer.on_straggler = lambda step, ratio: reported.append((step, ratio))
    summary = trainer.run()
    losses = [row["loss"] for row in trainer.metrics_log]
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert summary["final_step"] == 20 and not summary["preempted"]
    assert summary["straggler_steps"] >= 1
    assert 15 in [step for step, _ in reported]
    assert all(ratio > 3.0 for _, ratio in reported)
    assert set(summary) >= {"median_step_s", "final_loss", "final_ce",
                            "final_aux", "final_lr", "final_grad_norm"}


def test_trainer_checkpoint_dir_builds_the_manager_and_commits(tmp_path):
    """A ``ckpt_dir`` builds the manager, an empty directory resumes
    nothing, and a run commits its last step."""
    trainer = _reduced_trainer(2, ckpt_dir=str(tmp_path), ckpt_interval=1)
    assert trainer.manager is not None
    assert trainer.try_resume() is False
    trainer.run()
    assert trainer.manager.latest_step() == 2
    assert _reduced_trainer(1).try_resume() is False


def test_launch_train_reduced_on_cpu(capsys):
    """``python -m repro_torch.launch.train --arch smollm-135m --reduced
    --device cpu --steps 20``: runs to its summary, the loss falls."""
    summary = launch_train.main(["--arch", "smollm-135m", "--reduced",
                                 "--device", "cpu", "--steps", "20"])
    out = capsys.readouterr().out
    logged = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step=(\d+) time_s=\S+ loss=(\S+)", out)}
    assert sorted(logged) == [10, 20]
    assert logged[20] < logged[10]
    assert summary["final_step"] == 20
    assert summary["final_loss"] == pytest.approx(logged[20], rel=1e-4)
    assert "summary:" in out


@pytest.mark.cuda
def test_launch_train_reduced_on_the_card(capsys):
    """The same command without ``--device``: on the card the reduced
    config (head_dim 16) trains through the kernels both ways, and the
    loss falls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    before = launch_train.kernel_launches()
    summary = launch_train.main(["--arch", "smollm-135m", "--reduced",
                                 "--steps", "20"])
    out = capsys.readouterr().out
    logged = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step=(\d+) time_s=\S+ loss=(\S+)", out)}
    assert sorted(logged) == [10, 20] and logged[20] < logged[10]
    assert summary["final_step"] == 20
    layers = get_config("smollm-135m", reduced=True).num_layers
    after = launch_train.kernel_launches()
    for name in ("flash_attention", "flash_attention_backward", "rmsnorm",
                 "rmsnorm_backward"):
        assert after[name] - before[name] >= 20 * layers, name
    for name in ("ssd_scan", "ssd_scan_backward"):
        assert after[name] == before[name], name
    assert "kernel launches:" in out


@pytest.mark.parametrize("flags", [["--ckpt-dir", "ckpt"],
                                   ["--resume", "auto"]])
def test_launch_train_checkpoint_flags_commit_or_start_fresh(
        flags, tmp_path, monkeypatch, capsys):
    """``--ckpt-dir`` commits the last step; ``--resume auto`` without a
    directory is a fresh start."""
    monkeypatch.chdir(tmp_path)
    summary = launch_train.main(["--reduced", "--device", "cpu", "--steps",
                                 "1", *flags])
    assert summary["final_step"] == 1
    if "--ckpt-dir" in flags:
        assert (tmp_path / "ckpt" / "step_00000001.done").exists()
    else:
        assert "resume: fresh start" in capsys.readouterr().out
