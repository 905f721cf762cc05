"""repro_torch.data.pipeline: the contracts of the JAX package's pipeline.

``torch.Generator`` is not ``jax.random``, so the batches cannot be equal bit
for bit. What is held instead: a batch is a pure function of (seed, step,
shard, num_shards); the local batch is global // num_shards; shapes and
dtypes are the reference's; even LM positions repeat the previous token's
bucket and targets are tokens shifted by one; DLRM labels follow
dense.sum(-1); state()/restore() round-trip the cursor; and, as the
reference's code (not its docstring) does, re-sharding draws new batches.
The marginals are compared with the JAX package's on large batches.
"""

import jax
import numpy as np
import pytest
import torch

from repro.data import pipeline as pipe_jax
from repro_torch.data import DataConfig, DataIterator, dlrm_batch, lm_batch

LM = dict(vocab_size=1000, seq_len=33, global_batch=8, seed=3)
DLRM = dict(vocab_size=0, seq_len=0, global_batch=512, seed=3, num_dense=13,
            num_tables=4, lookups=5, rows=1000)


def _eq(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("fn,kw", [(lm_batch, LM), (dlrm_batch, DLRM)])
def test_batch_is_a_pure_function_of_seed_step_shard(fn, kw):
    cfg = DataConfig(**kw)
    one = fn(cfg, 5, 1, 2, device="cpu")
    assert _eq(one, fn(cfg, 5, 1, 2, device="cpu"))
    for other in (fn(cfg, 6, 1, 2, device="cpu"),
                  fn(cfg, 5, 0, 2, device="cpu"),
                  fn(DataConfig(**{**kw, "seed": 4}), 5, 1, 2, device="cpu")):
        assert not _eq(one, other)


@pytest.mark.parametrize("fn,kw", [(lm_batch, LM), (dlrm_batch, DLRM)])
def test_shapes_and_dtypes_match_jax(fn, kw):
    mine = fn(DataConfig(**kw), 0, 0, 2, device="cpu")
    jfn = getattr(pipe_jax, fn.__name__)
    theirs = jax.tree.map(np.asarray, jfn(pipe_jax.DataConfig(**kw), 0, 0, 2))
    assert mine.keys() == theirs.keys()
    for k, t in mine.items():
        assert tuple(t.shape) == theirs[k].shape, k
        assert str(t.dtype).replace("torch.", "") == str(theirs[k].dtype), k
    with pytest.raises(ValueError):
        fn(DataConfig(**kw), 0, 0, 3, device="cpu")     # 8 and 512 % 3 != 0


def test_lm_structure():
    cfg = DataConfig(**LM)
    b = lm_batch(cfg, 2, device="cpu")
    tok, tgt = b["tokens"], b["targets"]
    assert torch.equal(tgt[:, :-1], tok[:, 1:])       # shifted by one
    full = torch.cat([tok, tgt[:, -1:]], dim=1)       # the S + 1 stream
    assert torch.equal(full[:, 2::2], full[:, 1:-1:2])  # even repeats previous
    assert int(full.min()) >= 0 and int(full.max()) < cfg.vocab_size


def test_lm_marginals_follow_jax():
    """Zipf-ish: the squared uniform puts mean V/3 and median V/4."""
    kw = {**LM, "global_batch": 256, "seq_len": 255}
    mine = lm_batch(DataConfig(**kw), 0, device="cpu")["tokens"].double()
    theirs = np.asarray(pipe_jax.lm_batch(pipe_jax.DataConfig(**kw),
                                          0)["tokens"], np.float64)
    v = kw["vocab_size"]
    for stat in (np.mean, np.median):
        assert abs(stat(mine.numpy()) - stat(theirs)) < 0.02 * v
    assert abs(mine.mean().item() - v / 3) < 0.02 * v


def test_dlrm_structure_and_labels_follow_dense_sum():
    cfg = DataConfig(**{**DLRM, "global_batch": 4096})
    b = dlrm_batch(cfg, 1, device="cpu")
    sp = b["sparse"]
    assert sp.dtype == torch.int32
    assert int(sp.min()) >= 0 and int(sp.max()) < cfg.rows
    assert abs(b["dense"].mean().item()) < 0.05
    assert abs(b["dense"].std().item() - 1) < 0.05
    s = b["dense"].sum(-1)
    lab = b["labels"].float()
    assert set(b["labels"].unique().tolist()) <= {0, 1}
    corr = torch.corrcoef(torch.stack([s, lab]))[0, 1].item()
    theirs = jax.tree.map(np.asarray, pipe_jax.dlrm_batch(
        pipe_jax.DataConfig(**{**DLRM, "global_batch": 4096}), 1))
    corr_j = np.corrcoef(theirs["dense"].sum(-1), theirs["labels"])[0, 1]
    assert corr > 0.7 and abs(corr - corr_j) < 0.05
    assert abs(lab.mean().item() - theirs["labels"].mean()) < 0.05
    # labels = [dense.sum + 0.5 N(0, 1) > 0]: they agree with the sign of
    # the sum wherever |sum| is past four noise deviations
    far = s.abs() > 2.0
    assert torch.equal(lab[far], (s[far] > 0).float())


def test_iterator_state_restore_round_trip():
    it = DataIterator(DataConfig(**DLRM), kind="dlrm", device="cpu")
    first = [next(it) for _ in range(3)]
    saved = it.state()
    assert saved == {"step": 3, "seed": 3}
    fourth = next(it)
    it2 = DataIterator(DataConfig(**DLRM), kind="dlrm", device="cpu")
    it2.restore(saved)
    assert _eq(next(it2), fourth)
    assert _eq(first[0], dlrm_batch(DataConfig(**DLRM), 0, device="cpu"))
    lm = DataIterator(DataConfig(**LM), device="cpu")
    assert _eq(next(lm), lm_batch(DataConfig(**LM), 0, device="cpu"))


def test_reshard_draws_new_batches():
    """R5: the reference's docstring promises that re-sharding splits the
    same global batch differently, but its code folds the shard into the key,
    so the shards of another degree are new draws. The port follows the code:
    the two shards of 2 are not the halves of the one shard of 1."""
    cfg = DataConfig(**LM)
    it = DataIterator(cfg, step=4, device="cpu")
    halves = [next(it.reshard(s, 2)) for s in (0, 1)]
    assert it.reshard(1, 2).step == 4 and it.reshard(1, 2).num_shards == 2
    whole = next(it)
    assert halves[0]["tokens"].shape == (4, cfg.seq_len)
    joined = torch.cat([h["tokens"] for h in halves])
    assert not torch.equal(joined, whole["tokens"])
    assert not torch.equal(halves[1]["tokens"], whole["tokens"][4:])


def test_batches_need_a_device_choice_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_batch(DataConfig(**LM), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(DataIterator(DataConfig(**DLRM), kind="dlrm"))
