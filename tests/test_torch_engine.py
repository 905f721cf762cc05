"""repro_torch serving engine: continuous-batching correctness on the CPU,
the cases of tests/test_engine.py restated for the port, with greedy outputs
held token for token against the JAX engine on shared weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.models import get_model as get_model_jax
from repro.serve import Engine as EngineJax
from repro.serve import EngineConfig as EngineConfigJax
from repro.serve import Request as RequestJax
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model
from repro_torch.serve import Engine, EngineConfig, Request

torch.set_num_threads(1)

# PRNGKey(0), the seed of tests/test_engine.py. Its greedy continuations are
# decided by top-2 logit gaps far above the 1e-4 the two packages may differ
# by (test_greedy_margin_is_wide checks that), so no other seed is needed.
SEED = 0


@pytest.fixture(scope="module")
def shared():
    cfg_j = get_config_jax("smollm-135m", reduced=True)
    mod = get_model_jax(cfg_j)
    params = mod.init_params(jax.random.PRNGKey(SEED), cfg_j,
                             dtype=jnp.float32)
    cfg = get_config("smollm-135m", reduced=True)
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return cfg_j, mod, params, cfg, model


def _engine(shared, **kw):
    _, _, _, cfg, model = shared
    return Engine(cfg, model, EngineConfig(**kw), dtype=torch.float32,
                  device="cpu")


def _direct_greedy(model, prompt, n, with_margin=False):
    cache = model.init_cache(1, 64)
    lg, cache = model.prefill(torch.as_tensor(prompt)[None].long(), cache)
    toks, margins = [], []
    for _ in range(n):
        top = torch.topk(lg[0, -1], 2).values
        margins.append(float(top[0] - top[1]))
        toks.append(int(torch.argmax(lg[0, -1])))
        lg, cache = model.decode_step(cache, torch.tensor([[toks[-1]]]))
    return (toks, min(margins)) if with_margin else toks


PROMPTS = [np.array([1, 2, 3, 4, 5]), np.array([7, 8]), np.array([9, 10, 11])]


def test_greedy_margin_is_wide(shared):
    for p in PROMPTS:
        _, margin = _direct_greedy(shared[4], p, 5, with_margin=True)
        assert margin > 1e-3, margin


def test_engine_matches_direct_decode_mixed_prompts(shared):
    eng = _engine(shared, max_batch=2, max_seq=64)
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=5))
    done = {r.uid: r for r in eng.run_until_drained()}
    assert len(done) == 3
    for i, p in enumerate(PROMPTS):
        want = _direct_greedy(shared[4], p, 5)
        assert done[i].out_tokens == want, (i, done[i].out_tokens, want)


@pytest.mark.parametrize("max_batch", [1, 2, 4])
def test_engine_greedy_tokens_equal_jax_engine(shared, max_batch):
    cfg_j, _, params, _, _ = shared
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, cfg_j.vocab_size, size=int(rs.randint(2, 12)))
               for _ in range(5)]
    eng_j = EngineJax(cfg_j, params,
                      EngineConfigJax(max_batch=max_batch, max_seq=64),
                      dtype=jnp.float32)
    eng_t = _engine(shared, max_batch=max_batch, max_seq=64)
    for i, p in enumerate(prompts):
        eng_j.submit(RequestJax(uid=i, prompt=p, max_new_tokens=6))
        eng_t.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=6))
    done_j = eng_j.run_until_drained()
    done_t = eng_t.run_until_drained()
    assert [r.uid for r in done_t] == [r.uid for r in done_j]   # same schedule
    want = {r.uid: r.out_tokens for r in done_j}
    for r in done_t:
        assert r.out_tokens == want[r.uid], (r.uid, r.out_tokens, want[r.uid])


def test_engine_slot_reuse(shared):
    eng = _engine(shared, max_batch=1, max_seq=64)
    for i in range(3):
        eng.submit(Request(uid=i, prompt=np.array([i + 1, i + 2]),
                           max_new_tokens=3))
    done = eng.run_until_drained()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 3 for r in done)
    # a reused slot answers as a fresh engine would: stale rows are masked
    for r in done:
        assert r.out_tokens == _direct_greedy(shared[4], r.prompt, 3)


def test_engine_decode_respects_request_temperature(shared):
    """A very hot request diverges from the greedy continuation while a
    greedy request sharing the batch stays token for token greedy."""
    prompt = np.array([1, 2, 3, 4, 5])
    want = _direct_greedy(shared[4], prompt, 24)
    eng = _engine(shared, max_batch=2, max_seq=64)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=24,
                       temperature=50.0))
    eng.submit(Request(uid=1, prompt=prompt.copy(), max_new_tokens=24,
                       temperature=0.0))
    done = {r.uid: r for r in eng.run_until_drained()}
    assert done[0].out_tokens != want, \
        "hot request reproduced the greedy continuation exactly"
    assert done[1].out_tokens == want, \
        "greedy request in a mixed-temperature batch must stay greedy"


def test_engine_all_greedy_unchanged_by_sampler(shared):
    """All-greedy batches never consume RNG, so two engines with different
    seeds emit identical tokens and leave their generators untouched."""
    outs = []
    for seed in (0, 123):
        eng = _engine(shared, max_batch=2, max_seq=64, seed=seed)
        state = eng._rng.get_state().clone()
        eng.submit(Request(uid=0, prompt=np.array([1, 2, 3]),
                           max_new_tokens=6))
        outs.append(eng.run_until_drained()[0].out_tokens)
        assert torch.equal(eng._rng.get_state(), state)
    assert outs[0] == outs[1]


def test_engine_sampling_is_seeded(shared):
    runs = []
    for seed in (7, 7, 8):
        eng = _engine(shared, max_batch=1, max_seq=64, seed=seed)
        eng.submit(Request(uid=0, prompt=np.array([1, 2, 3]),
                           max_new_tokens=12, temperature=5.0))
        runs.append(eng.run_until_drained()[0].out_tokens)
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_engine_submit_rejects_cache_overflow(shared):
    eng = _engine(shared, max_batch=1, max_seq=16)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(uid=0, prompt=np.arange(10, dtype=np.int32),
                           max_new_tokens=7))
    assert not eng.queue
    eng.submit(Request(uid=1, prompt=np.arange(10, dtype=np.int32),
                       max_new_tokens=6))
    assert len(eng.run_until_drained()) == 1


def test_engine_idle_slot_runs_past_max_seq(shared):
    """Slot 1 finishes early and then idles for far more than max_seq ticks
    while slot 0 is kept busy by a stream of requests: nothing goes out of
    range, the busy slot's answers are the direct ones, and the idle slot
    serves a late request correctly."""
    max_seq = 16
    eng = _engine(shared, max_batch=2, max_seq=max_seq)
    eng.submit(Request(uid=100, prompt=np.array([3, 4]), max_new_tokens=8))
    eng.submit(Request(uid=101, prompt=np.array([5]), max_new_tokens=2))
    done, ticks, uid = [], 0, 0
    while ticks < 3 * max_seq:
        if 0 not in eng.active and not eng.queue:
            # feed slot 0 only: slot 1 stays free because admission fills the
            # lowest free slot first
            eng.submit(Request(uid=uid, prompt=np.array([1 + uid % 7, 2]),
                               max_new_tokens=8))
            uid += 1
        done.extend(eng.tick())
        ticks += 1
        if ticks > 4:
            assert 1 not in eng.active
    assert int(eng.cache["pos"][1]) > max_seq       # the idle clock ran on
    late = Request(uid=999, prompt=np.array([9, 10, 11]), max_new_tokens=5)
    eng.submit(late)
    eng.submit(Request(uid=998, prompt=np.array([2, 2]), max_new_tokens=5))
    done.extend(eng.run_until_drained())
    assert {r.uid for r in done} >= {100, 101, 998, 999}
    for r in done:
        want = _direct_greedy(shared[4], r.prompt, r.max_new_tokens)
        assert r.out_tokens == want, (r.uid, r.out_tokens, want)


def test_engine_without_device_needs_a_gpu(shared):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    _, _, _, cfg, model = shared
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, model, EngineConfig(max_batch=1, max_seq=16))


def test_engine_rejects_model_on_another_device(shared):
    _, _, _, cfg, model = shared
    with pytest.raises(ValueError, match="lies on"):
        Engine(cfg, model, EngineConfig(), device="meta")


def test_launch_serve_runs_on_cpu(capsys):
    launch_serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                       "--num-requests", "3", "--max-new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out


# ------------------------------------------------------------------------- #
# mamba2 (ssm family), reduced: the cache is conv and ssm state per slot
# ------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def shared_mamba():
    cfg_j = get_config_jax("mamba2-780m", reduced=True)
    params = get_model_jax(cfg_j).init_params(jax.random.PRNGKey(SEED), cfg_j,
                                              dtype=jnp.float32)
    cfg = get_config("mamba2-780m", reduced=True)
    model = get_model(cfg)(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), cfg))
    return cfg_j, params, cfg, model


# prompt lengths 2..12: 2 is shorter than the conv window (width - 1 = 3)
MAMBA_PROMPTS = [np.random.RandomState(6).randint(0, 256, size=n)
                 for n in (5, 2, 12, 3, 9)]


def test_mamba_greedy_margin_is_wide(shared_mamba):
    for p in MAMBA_PROMPTS:
        _, margin = _direct_greedy(shared_mamba[3], p, 6, with_margin=True)
        assert margin > 1e-3, margin


@pytest.mark.parametrize("max_batch", [1, 2])
def test_mamba_engine_greedy_tokens_equal_jax_engine(shared_mamba, max_batch):
    """Five requests through fewer slots: every slot is reused."""
    cfg_j, params, cfg, model = shared_mamba
    eng_j = EngineJax(cfg_j, params,
                      EngineConfigJax(max_batch=max_batch, max_seq=64),
                      dtype=jnp.float32)
    eng_t = Engine(cfg, model, EngineConfig(max_batch=max_batch, max_seq=64),
                   dtype=torch.float32, device="cpu")
    for i, p in enumerate(MAMBA_PROMPTS):
        eng_j.submit(RequestJax(uid=i, prompt=p, max_new_tokens=6))
        eng_t.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=6))
    done_j = eng_j.run_until_drained()
    done_t = eng_t.run_until_drained()
    assert [r.uid for r in done_t] == [r.uid for r in done_j]
    want = {r.uid: r.out_tokens for r in done_j}
    for r in done_t:
        assert r.out_tokens == want[r.uid], (r.uid, r.out_tokens, want[r.uid])


def test_mamba_reused_slot_answers_as_a_fresh_engine(shared_mamba):
    """The slot's conv and ssm state still hold the previous request's when
    the next one is admitted; its prefill overwrites them, so the second
    request gets the tokens it gets alone in a fresh engine."""
    _, _, cfg, model = shared_mamba

    def serve(prompts):
        eng = Engine(cfg, model, EngineConfig(max_batch=1, max_seq=64),
                     dtype=torch.float32, device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=5))
        done = {r.uid: r.out_tokens for r in eng.run_until_drained()}
        return done, eng.cache

    first, second = MAMBA_PROMPTS[2], MAMBA_PROMPTS[1]
    both, _ = serve([first, second])
    alone, _ = serve([second])
    assert both[1] == alone[0]
    assert both[1] == _direct_greedy(model, second, 5)


def test_launch_serve_runs_mamba_on_cpu(capsys):
    launch_serve.main(["--arch", "mamba2-780m", "--reduced", "--device",
                       "cpu", "--num-requests", "3", "--max-new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out


def test_launch_serve_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--reduced"])
