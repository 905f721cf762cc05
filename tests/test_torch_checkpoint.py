"""repro_torch.checkpoint and the trainer's restart path, on the CPU.

The crash-window cases of ``tests/test_reliability.py`` and the checkpointer
and resume cases of ``tests/test_train_infra.py`` restated for the port;
checkpoints interchanged with the JAX package's ``Checkpointer`` in both
directions, leaf for leaf and bit for bit (and file for file); a JAX train
state resumed by the port (and the reverse) gives the same loss on one numpy
batch, within 1e-5 (fp32, the tolerance of the port's loss tests).
"""

import os
import shutil
import signal
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as CheckpointerJax
from repro.configs import get_config as get_config_jax
from repro.configs import get_dlrm_config as get_dlrm_config_jax
from repro.data import DataConfig as DataConfigJax
from repro.data import DataIterator as DataIteratorJax
from repro.models import dlrm as dlrm_jax
from repro.models import get_model as get_model_jax
from repro.parallel import plan_memory as plan_memory_jax
from repro.train import Trainer as TrainerJax
from repro.train import TrainerConfig as TrainerConfigJax
from repro.train import init_train_state as init_train_state_jax
from repro.train import make_train_step as make_train_step_jax
from repro_torch.checkpoint import CheckpointManager, Checkpointer, Stacked
from repro_torch.configs import get_config, get_dlrm_config
from repro_torch.convert import (
    from_jax_dlrm_params,
    from_jax_params,
    load_jax_train_state,
    to_jax_dlrm_params,
    to_jax_params,
    to_jax_train_state,
)
from repro_torch.data import DataConfig, DataIterator
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.models.dlrm import DLRM
from repro_torch.train.optimizer import init_state
from repro_torch.parallel import plan_memory
from repro_torch.train import (
    AdamWConfig,
    Trainer,
    TrainerConfig,
    init_train_state,
    make_train_step,
)

torch.set_num_threads(1)

ARCH = "smollm-135m"
LOSS_TOL = 1e-5


# --------------------------------------------------------------------- #
# Crash windows (tests/test_reliability.py::TestCheckpointCrashWindow)
# --------------------------------------------------------------------- #

def _save(ck, step, val):
    ck.save(step, {"w": torch.full((4,), float(val))})


def test_stale_done_with_missing_dir_falls_back(tmp_path):
    ck = Checkpointer(str(tmp_path))
    _save(ck, 1, 1.0)
    _save(ck, 2, 2.0)
    # crash inside the old re-save window: dir gone, marker left
    shutil.rmtree(tmp_path / "step_00000002")
    assert ck.latest_step() == 1
    tree, _ = ck.restore()
    assert float(tree["w"][0]) == 1.0


def test_missing_meta_falls_back(tmp_path):
    ck = Checkpointer(str(tmp_path))
    _save(ck, 1, 1.0)
    _save(ck, 2, 2.0)
    os.remove(tmp_path / "step_00000002" / "meta.json")
    assert ck.latest_step() == 1
    tree, _ = ck.restore()
    assert float(tree["w"][0]) == 1.0


def test_resave_crash_window_leaves_no_stale_marker(tmp_path, monkeypatch):
    """save() must drop the commit marker before clearing the old
    directory, so no crash instant has a marker without a dir."""
    ck = Checkpointer(str(tmp_path))
    _save(ck, 5, 1.0)
    orig_rmtree = shutil.rmtree

    def boom(path, *a, **kw):
        orig_rmtree(path, *a, **kw)
        if str(path).endswith("step_00000005"):
            raise RuntimeError("crash mid-resave")

    monkeypatch.setattr(shutil, "rmtree", boom)
    with pytest.raises(RuntimeError):
        _save(ck, 5, 2.0)
    monkeypatch.undo()
    # the marker went first: nothing claims the missing dir
    assert ck.latest_step() is None


def test_orphan_tmp_gc_on_init(tmp_path):
    ck = Checkpointer(str(tmp_path))
    _save(ck, 1, 1.0)
    os.makedirs(tmp_path / "step_00000009.tmp")
    ck2 = Checkpointer(str(tmp_path))
    assert not os.path.exists(tmp_path / "step_00000009.tmp")
    assert ck2.latest_step() == 1


def test_manager_restore_latest_recovers(tmp_path):
    mgr = CheckpointManager(str(tmp_path), interval=1, keep=5,
                            async_save=False)
    mgr.maybe_save(1, {"w": torch.ones(2)})
    mgr.maybe_save(2, {"w": torch.full((2,), 2.0)})
    shutil.rmtree(tmp_path / "step_00000002")
    tree, _ = mgr.restore_latest()
    assert float(tree["w"][0]) == 1.0


def test_restore_target_mismatch_is_descriptive(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.ones(2), "b": torch.ones(2)})
    with pytest.raises(KeyError) as exc:
        ck.restore(target={"a": torch.ones(2), "c": torch.ones(2)})
    msg = str(exc.value)
    assert "missing from checkpoint" in msg and "c" in msg
    assert "unexpected in checkpoint" in msg and "b" in msg


@pytest.mark.parametrize("target", [
    {"a": torch.zeros(2, 3, dtype=torch.float64)},     # another dtype
    {"a": torch.zeros(3, 2)},                          # another shape
    {"a": torch.zeros(2, 3, dtype=torch.bfloat16)},    # same width, bf16
    {"a": np.zeros((2, 3), np.int32)},                 # a numpy leaf
])
def test_restore_into_another_dtype_or_shape_raises(tmp_path, target):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)})
    before = {k: (v.clone() if torch.is_tensor(v) else v.copy())
              for k, v in target.items()}
    with pytest.raises(ValueError, match="'a'"):
        ck.restore(target=target)
    for k, v in target.items():        # nothing was written on the way
        if torch.is_tensor(v):
            assert torch.equal(v, before[k])
        else:
            assert np.array_equal(v, before[k])


# --------------------------------------------------------------------- #
# tests/test_train_infra.py::TestCheckpointer
# --------------------------------------------------------------------- #

def test_roundtrip_into_the_target_tensors(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "p": torch.nn.Parameter(torch.randn(3, 2))}
    ck = Checkpointer(str(tmp_path))
    ck.save(3, tree, {"note": "x"})
    target = {"a": torch.zeros(2, 3, dtype=torch.int64),
              "b": {"c": torch.zeros(4, dtype=torch.bfloat16)},
              "p": torch.nn.Parameter(torch.zeros(3, 2))}
    leaves = [target["a"], target["b"]["c"], target["p"]]
    out, extra = ck.restore(target=target)
    assert extra["note"] == "x"
    assert all(x is y for x, y in zip([out["a"], out["b"]["c"], out["p"]],
                                      leaves))
    for got, want in ((out["a"], tree["a"]), (out["b"]["c"], tree["b"]["c"]),
                      (out["p"], tree["p"])):
        assert torch.equal(got, want.detach())
    assert out["p"] is target["p"] and out["p"].requires_grad


def test_crash_mid_write_ignored(tmp_path):
    """A stale .tmp dir without a .done marker must not be restored."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.ones(2)})
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert ck.latest_step() == 1


def test_retention_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), interval=1, keep=2,
                            async_save=False)
    for s in range(1, 6):
        mgr.maybe_save(s, {"a": torch.ones(2)})
    steps = sorted(int(n[5:-5]) for n in os.listdir(tmp_path)
                   if n.endswith(".done"))
    assert steps == [4, 5]


def test_async_then_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save_async(9, {"a": torch.ones(128)})
    ck.wait()
    assert ck.latest_step() == 9


def test_save_async_writes_the_values_of_the_moment_of_the_save(tmp_path):
    """The optimizer updates parameters and moments in place: a change made
    right after ``save_async`` returns must not reach the checkpoint."""
    p = torch.nn.Parameter(torch.arange(1 << 16, dtype=torch.float32))
    m = torch.full((1 << 16,), 3.0, dtype=torch.bfloat16)
    step = torch.tensor(7, dtype=torch.int32)
    tree = {"params": {"w": p}, "opt": {"m": m, "step": step}}
    want = {"w": p.detach().clone(), "m": m.clone(), "step": step.clone()}
    ck = Checkpointer(str(tmp_path))
    ck.save_async(1, tree)
    with torch.no_grad():
        p.add_(1.0)
        m.mul_(2.0)
        step.add_(1)
    ck.wait()
    flat, _ = ck.restore(1)
    assert np.array_equal(flat["params::w"], want["w"].numpy())
    assert torch.equal(flat["opt::m"], want["m"])
    assert int(flat["opt::step"]) == 7


def test_async_write_error_is_raised_by_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def fail(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", fail)
    ck.save_async(1, {"a": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()                                  # reported once
    assert ck.latest_step() is None


def test_manager_builds_the_tree_only_when_it_saves(tmp_path):
    calls = []

    def build():
        calls.append(1)
        return {"a": torch.ones(2)}

    mgr = CheckpointManager(str(tmp_path), interval=3, keep=2)
    for s in range(1, 8):
        mgr.maybe_save(s, build)
    assert mgr.maybe_save(7, build, force=True)
    assert not mgr.maybe_save(7, build, force=True)   # already committed
    mgr.wait()
    assert len(calls) == 3 and mgr.latest_step() == 7


# --------------------------------------------------------------------- #
# Interchange with the JAX package's Checkpointer
# --------------------------------------------------------------------- #

def _mixed_numpy(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "f32": rs.randn(3, 5).astype(np.float32),
        "bf16": rs.randn(4, 2).astype(ml_dtypes.bfloat16),
        "fp8": rs.randn(6).astype(ml_dtypes.float8_e4m3fn),
        "fp8b": rs.randn(2, 2).astype(ml_dtypes.float8_e5m2),
        "i32": rs.randint(-100, 100, size=(7,)).astype(np.int32),
        "nested": {"list": [rs.randn(2).astype(np.float32),
                            np.asarray(5, np.int32)]},
    }


def _torch_like(tree):
    """Zero tensors of each leaf's dtype and shape (the port's target)."""
    dtypes = {"float32": torch.float32, "int32": torch.int32,
              "bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}
    if isinstance(tree, dict):
        return {k: _torch_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_like(v) for v in tree]
    return torch.zeros(tree.shape, dtype=dtypes[str(tree.dtype)])


def _bits(x) -> bytes:
    if torch.is_tensor(x):
        x = x.detach().contiguous()
        return x.view(torch.uint8).numpy().tobytes() if x.dim() else \
            x.reshape(1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _files(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


def test_jax_checkpoint_restores_through_the_port_and_back(tmp_path):
    """JAX saves fp32, bf16, fp8, int32 and a list; the port restores them
    into tensors of those dtypes, bit for bit, and saves them again: the
    same files, byte for byte; JAX restores the port's files leaf-equal."""
    tree = _mixed_numpy()
    extra = {"step": 4, "data": {"step": 4, "seed": 0}}
    CheckpointerJax(str(tmp_path / "jax")).save(4, tree, extra)
    ck = Checkpointer(str(tmp_path / "jax"))
    target = _torch_like(tree)
    out, got_extra = ck.restore(target=target)
    assert got_extra == extra
    flat_jax = jax.tree_util.tree_leaves(tree)
    flat_port = jax.tree_util.tree_leaves(
        out, is_leaf=lambda x: torch.is_tensor(x))
    assert len(flat_jax) == len(flat_port) == 7
    for want, got in zip(flat_jax, flat_port):
        assert _bits(got) == _bits(want)
    Checkpointer(str(tmp_path / "port")).save(4, out, extra)
    assert _files(tmp_path / "port" / "step_00000004") == \
        _files(tmp_path / "jax" / "step_00000004")
    back, _ = CheckpointerJax(str(tmp_path / "port")).restore(target=tree)
    for want, got in zip(flat_jax, jax.tree_util.tree_leaves(back)):
        assert np.asarray(got).dtype == want.dtype
        assert _bits(np.asarray(got)) == _bits(want)


def test_port_checkpoint_restores_through_jax(tmp_path):
    """The reverse: the port saves tensors (and numpy arrays); JAX restores
    them leaf-equal, bit for bit; so does the port without a target."""
    tree = _mixed_numpy(seed=1)
    port_tree = {
        "f32": torch.from_numpy(tree["f32"]),
        "bf16": torch.from_numpy(tree["bf16"].view(np.int16)).view(
            torch.bfloat16),
        "fp8": tree["fp8"],                      # an ml_dtypes numpy leaf
        "fp8b": torch.from_numpy(tree["fp8b"].view(np.uint8)).view(
            torch.float8_e5m2),
        "i32": torch.from_numpy(tree["i32"]),
        "nested": {"list": [torch.from_numpy(tree["nested"]["list"][0]),
                            tree["nested"]["list"][1]]},
    }
    Checkpointer(str(tmp_path)).save(2, port_tree, {"step": 2})
    back, extra = CheckpointerJax(str(tmp_path)).restore(target=tree)
    assert extra == {"step": 2}
    for want, got in zip(jax.tree_util.tree_leaves(tree),
                         jax.tree_util.tree_leaves(back)):
        assert np.asarray(got).dtype == want.dtype
        assert _bits(np.asarray(got)) == _bits(want)
    flat, _ = Checkpointer(str(tmp_path)).restore()
    assert flat["bf16"].dtype == torch.bfloat16
    assert flat["fp8"].dtype == torch.float8_e4m3fn
    assert _bits(flat["fp8"]) == _bits(tree["fp8"])
    assert np.array_equal(flat["nested::list::0"], tree["nested"]["list"][0])
    assert flat["nested::list::1"].dtype == np.int32


# --------------------------------------------------------------------- #
# Train states: JAX <-> port, and resume within the port
# --------------------------------------------------------------------- #

def _port_trainer(steps, ckpt_dir=None, interval=5, seed=0, **kw):
    cfg = get_config(ARCH, reduced=True)
    plan = plan_memory(cfg, tp=1, dp=1)
    ocfg = AdamWConfig(state_dtype=plan.opt_dtype, use_master=plan.use_master)
    state = init_train_state(cfg, plan, torch.Generator().manual_seed(seed),
                             ocfg, dtype=torch.float32, device="cpu")
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4), device="cpu")
    return Trainer(make_train_step(cfg, plan, ocfg), state, data,
                   TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                                 ckpt_interval=interval, log_interval=1000,
                                 **kw))


def _jax_trainer(steps, ckpt_dir=None, interval=5):
    cfg = get_config_jax(ARCH, reduced=True)
    plan = plan_memory_jax(cfg, 1, 1)
    state = init_train_state_jax(cfg, plan, jax.random.PRNGKey(0),
                                 dtype=jnp.float32)
    data = DataIteratorJax(DataConfigJax(vocab_size=cfg.vocab_size,
                                         seq_len=32, global_batch=4))
    return TrainerJax(jax.jit(make_train_step_jax(cfg, plan)), state, data,
                      TrainerConfigJax(total_steps=steps, ckpt_dir=ckpt_dir,
                                       ckpt_interval=interval,
                                       log_interval=1000))


def _numpy_batch(seed=11):
    cfg = get_config(ARCH, reduced=True)
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, size=(2, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _losses(port_state, jax_params):
    batch = _numpy_batch()
    cfg_j = get_config_jax(ARCH, reduced=True)
    jl, _ = get_model_jax(cfg_j).loss(
        jax_params, cfg_j, {k: jnp.asarray(v) for k, v in batch.items()},
        remat=None)
    with torch.no_grad():
        tl, _ = port_state["model"].loss(
            {k: torch.from_numpy(v).long() for k, v in batch.items()},
            remat=None)
    return float(jl), float(tl)


def _assert_state_bits_equal(port_state, jax_state):
    flat_port = dict(jax.tree_util.tree_flatten_with_path(
        to_jax_train_state(port_state),
        is_leaf=lambda x: torch.is_tensor(x))[0])
    flat_jax = dict(jax.tree_util.tree_flatten_with_path(jax_state)[0])
    assert list(flat_port) == list(flat_jax)
    for path, leaf in flat_jax.items():
        assert _bits(flat_port[path]) == _bits(np.asarray(leaf)), path


def test_jax_train_state_resumes_in_the_port(tmp_path):
    """The JAX trainer takes 2 steps and checkpoints; a port Trainer resumes
    from its directory: the step, the data cursor, every leaf bit for bit,
    and the loss on one numpy batch within 1e-5."""
    tj = _jax_trainer(2, ckpt_dir=str(tmp_path))
    tj.run()
    tp = _port_trainer(4, ckpt_dir=str(tmp_path))
    assert tp.try_resume()
    assert tp.step == 2 and tp.data.step == 2
    assert tp.state["params"]["layers.0.attn.wq"] is \
        dict(tp.state["model"].named_parameters())["layers.0.attn.wq"]
    _assert_state_bits_equal(tp.state, tj.state)
    jl, tl = _losses(tp.state, tj.state["params"])
    assert abs(jl - tl) <= LOSS_TOL * abs(jl), (jl, tl)


def test_port_train_state_resumes_in_jax(tmp_path):
    """The reverse: the port's Trainer checkpoints after 2 steps; the JAX
    trainer resumes from it bit for bit, with the port's loss."""
    tp = _port_trainer(2, ckpt_dir=str(tmp_path))
    tp.run()
    tj = _jax_trainer(4, ckpt_dir=str(tmp_path))
    assert tj.try_resume()
    assert tj.step == 2 and tj.data.step == 2
    _assert_state_bits_equal(tp.state, tj.state)
    jl, tl = _losses(tp.state, tj.state["params"])
    assert abs(jl - tl) <= LOSS_TOL * abs(jl), (jl, tl)


def _state_leaves(state):
    opt = state["opt"]
    out = {f"params.{k}": v for k, v in state["params"].items()}
    for part in ("m", "v", "master"):
        out.update({f"{part}.{k}": v for k, v in opt.get(part, {}).items()})
    out["step"] = opt["step"]
    return out


def test_resume_is_bitwise_deterministic(tmp_path):
    """train(10) == train(5) + resume in a new Trainer + train(5), every
    leaf of params, m, v, master and step."""
    t1 = _port_trainer(10)
    t1.run()
    t2 = _port_trainer(5, ckpt_dir=str(tmp_path / "ck"), interval=5)
    t2.run()
    t3 = _port_trainer(10, ckpt_dir=str(tmp_path / "ck"), interval=5,
                       seed=1)                    # other initial weights
    assert t3.try_resume()
    assert t3.step == 5
    t3.run()
    straight, resumed = _state_leaves(t1.state), _state_leaves(t3.state)
    assert list(straight) == list(resumed)
    for name, leaf in straight.items():
        assert torch.equal(leaf, resumed[name]), name
    assert int(t3.state["opt"]["step"]) == 10


def test_data_iterator_state_travels(tmp_path):
    t = _port_trainer(7, ckpt_dir=str(tmp_path), interval=3)
    t.run()
    t2 = _port_trainer(9, ckpt_dir=str(tmp_path), interval=3)
    assert t2.try_resume()
    assert t2.step == 7 and t2.data.step == t2.step


def test_sigterm_mid_run_leaves_a_committed_checkpoint(tmp_path):
    """SIGTERM during step 3 (of 10): the loop stops after that step and the
    final forced save commits step 3; the handlers are put back."""
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers can only be installed on the main "
                    "thread; a SIGTERM here would end the test process")
    before = signal.getsignal(signal.SIGTERM)
    t = _port_trainer(10, ckpt_dir=str(tmp_path), interval=100)
    step_fn = t.step_fn
    calls = []

    def wrapped(state, batch, gen):
        calls.append(1)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return step_fn(state, batch, gen)

    t.step_fn = wrapped
    summary = t.run()
    assert summary["preempted"] and summary["final_step"] == 3
    assert len(calls) == 3
    assert Checkpointer(str(tmp_path)).latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) == before
    t2 = _port_trainer(10, ckpt_dir=str(tmp_path))
    assert t2.try_resume() and t2.step == 3 and t2.data.step == 3
    for name, leaf in _state_leaves(t.state).items():
        assert torch.equal(leaf, _state_leaves(t2.state)[name]), name


def test_launch_train_resumes_on_cpu(tmp_path, capsys):
    """``launch.train --ckpt-dir D --resume auto`` twice: a fresh start that
    checkpoints, then a run that restores it and goes on."""
    args = ["--arch", ARCH, "--reduced", "--device", "cpu",
            "--seq-len", "32", "--global-batch", "4",
            "--ckpt-dir", str(tmp_path), "--ckpt-interval", "3",
            "--resume", "auto"]
    first = launch_train.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "resume: fresh start" in out and first["final_step"] == 4
    assert Checkpointer(str(tmp_path)).latest_step() == 4
    second = launch_train.main(args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resume: restored step 4" in out
    assert second["final_step"] == 6
    assert Checkpointer(str(tmp_path)).latest_step() == 6


# --------------------------------------------------------------------- #
# The JAX layout of the trees the trainer saves
# --------------------------------------------------------------------- #

def _flat_bits_equal(got_tree, want_tree):
    got = jax.tree_util.tree_flatten_with_path(
        got_tree, is_leaf=lambda x: torch.is_tensor(x))[0]
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert _bits(g) == _bits(np.asarray(w)), path


@pytest.mark.parametrize("arch", [ARCH, "mamba2-780m"])
def test_to_jax_params_inverts_from_jax_params(arch):
    """The dense and the SSM trees: JAX params -> the port's state dict ->
    the JAX layout again, bit for bit, the layers restacked."""
    cfg_j = get_config_jax(arch, reduced=True)
    params = get_model_jax(cfg_j).init_params(jax.random.PRNGKey(3), cfg_j,
                                              dtype=jnp.bfloat16)
    cfg = get_config(arch, reduced=True)
    model = get_model(cfg)(cfg, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          cfg))
    _flat_bits_equal(to_jax_params(model.state_dict(), cfg), params)


def test_to_jax_dlrm_params_inverts_from_jax_dlrm_params():
    params = dlrm_jax.init_params(jax.random.PRNGKey(4),
                                  get_dlrm_config_jax(reduced=True),
                                  jnp.float32)
    model = DLRM(get_dlrm_config(reduced=True), device="cpu")
    model.load_state_dict(from_jax_dlrm_params(jax.tree.map(np.asarray,
                                                            params)))
    _flat_bits_equal(to_jax_dlrm_params(model.state_dict()), params)


def test_dlrm_train_state_round_trips_through_a_checkpoint(tmp_path):
    """A DLRM train state saved in the JAX layout restores into another
    DLRM's state in place: params, m, v and step bit for bit."""
    cfg = get_dlrm_config(reduced=True)

    def state(seed):
        model = DLRM(cfg, seed=seed, device="cpu")
        params = dict(model.named_parameters())
        opt = init_state(params, AdamWConfig(use_master=False))
        for t in list(opt["m"].values()) + list(opt["v"].values()):
            t.normal_(generator=torch.Generator().manual_seed(seed))
        opt["step"] = torch.tensor(5 + seed, dtype=torch.int32)
        return {"model": model, "params": params, "opt": opt}

    src, dst = state(0), state(1)
    Checkpointer(str(tmp_path)).save(5, to_jax_train_state(src))
    tree, _ = Checkpointer(str(tmp_path)).restore(
        target=to_jax_train_state(dst))
    load_jax_train_state(dst, tree)
    for name, t in _state_leaves(src).items():
        assert torch.equal(t, _state_leaves(dst)[name]), name
    assert dst["params"]["tables"] is dst["model"].tables


# --------------------------------------------------------------------- #
# The layers stacked on the host (checkpoint.Stacked)
# --------------------------------------------------------------------- #

def _train_state(arch, seed, device="cpu"):
    cfg = get_config(arch, reduced=True)
    plan = plan_memory(cfg, tp=1, dp=1)
    ocfg = AdamWConfig(state_dtype=plan.opt_dtype, use_master=plan.use_master)
    state = init_train_state(cfg, plan,
                             torch.Generator(device=device).manual_seed(seed),
                             ocfg, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 100)
    for part in ("m", "v"):
        for t in state["opt"][part].values():
            t.normal_(generator=gen)
    state["opt"]["step"] = torch.tensor(3 + seed, dtype=torch.int32)
    return state


def test_stacked_train_state_holds_the_states_own_tensors():
    """``to_jax_train_state(stack=Stacked)`` makes no copy: each stacked
    leaf's pieces are the state's own per-layer tensors (so a save stacks
    them on the host, never on their device)."""
    state = _train_state("llama4-maverick-400b-a17b", 0)
    own = {t.data_ptr() for t in _state_leaves(state).values()}
    leaves = jax.tree_util.tree_leaves(
        to_jax_train_state(state, stack=Stacked),
        is_leaf=lambda x: isinstance(x, Stacked) or torch.is_tensor(x))
    stacked = [x for x in leaves if isinstance(x, Stacked)]
    assert stacked
    for leaf in stacked:
        assert {p.data_ptr() for p in leaf.pieces} <= own
    for leaf in leaves:
        if torch.is_tensor(leaf):
            assert leaf.data_ptr() in own


@pytest.mark.parametrize("arch", [ARCH, "llama4-maverick-400b-a17b"])
def test_stacked_save_and_restore_match_the_stacked_tree(arch, tmp_path):
    """A save through ``Stacked`` leaves writes the same files, byte for
    byte, as one of the stacked tree; a restore into ``Stacked`` leaves
    copies every slice into the state's own tensors, bit for bit."""
    src, dst = _train_state(arch, 0), _train_state(arch, 1)
    Checkpointer(str(tmp_path / "a")).save(3, to_jax_train_state(src))
    Checkpointer(str(tmp_path / "b")).save(
        3, to_jax_train_state(src, stack=Stacked))
    want = _files(tmp_path / "a" / "step_00000003")
    assert _files(tmp_path / "b" / "step_00000003") == want
    own = {k: t.data_ptr() for k, t in _state_leaves(dst).items()}
    Checkpointer(str(tmp_path / "a")).restore(
        target=to_jax_train_state(dst, stack=Stacked))
    for name, t in _state_leaves(src).items():
        assert _bits(t) == _bits(_state_leaves(dst)[name]), name
        assert _state_leaves(dst)[name].data_ptr() == own[name], name


@pytest.mark.cuda
def test_trainer_save_and_restore_keep_the_device_peak_level(tmp_path):
    """On the card, the trainer's save and its restore allocate nothing
    there: the peak device memory of each stays at the live state's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: device memory is measured there")
    state = _train_state(ARCH, 0, device="cuda")
    data = DataIterator(DataConfig(vocab_size=64, seq_len=8, global_batch=2),
                        device="cpu")
    trainer = Trainer(None, state, data, TrainerConfig(
        total_steps=0, ckpt_dir=str(tmp_path)))
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer._checkpoint(force=True)
    trainer.manager.wait()
    assert torch.cuda.max_memory_allocated() == live
    assert trainer.try_resume()
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() == live
