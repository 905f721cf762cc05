"""repro_torch.parallel over real process groups: gloo on the CPU.

``tests/test_distributed.py``'s pattern: each job starts its ranks as
``python -c`` subprocesses (``PYTHONPATH=src``, ``OMP_NUM_THREADS=1``),
which meet through a ``file://`` store under the test's temporary directory
(so parallel workers never collide); each rank writes its checks' results
as JSON, and the tests here read them. A job has its own timeout of 180 s
and kills every rank as soon as one fails, so a hang fails the tests
instead of stalling the suite. Two jobs: four ranks (the sharded step on
the reduced smollm-135m against the port's one-process ``make_train_step``,
itself held to ``jax.grad`` in ``tests/test_torch_train.py`` — the
reference's own sharded step raises on this JAX (R2); ZeRO's shards, the
global norm, ``compressed_psum``'s five cases of ``tests/test_compression.py``
against the reference's function, ``gpipe`` against the sequential stages
forward and against autograd through them backward (R3), the elastic
restart, a pod axis, a layer held whole by one rank), and one rank (the
sharded step bitwise equal to ``make_train_step``).

Tolerances: a sharded step's loss 2e-4 and every parameter 5e-3 absolute
and relative after two steps (``test_dp_tp_grad_equivalence``'s), its
global norm 1e-5 relative; ``gpipe`` 1e-5; the compressed sums as
``tests/test_compression.py``; the elastic restore and the one-rank step
bit for bit.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel.compression import compressed_psum as compressed_psum_jax
from repro.parallel.compression import dequantize_int8 as dequantize_jax
from repro.parallel.compression import quantize_int8 as quantize_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT_S = 180

_PRELUDE = """
import json, os, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + out + "/store",
                        rank=rank, world_size=world)

from repro_torch.configs import get_config
from repro_torch.parallel import build_mesh
from repro_torch.parallel.policy import MemoryPlan
from repro_torch.train import (gather_train_state, init_train_state,
                               make_train_step, shard_train_state,
                               sharded_train_step)
from repro_torch.train.optimizer import AdamWConfig

CFG = get_config("smollm-135m", reduced=True)
OPT = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
results = {}
SRC_LEN = 24    # the encdec's source frames, unlike its targets' length


def family_inputs(b, rs):
    \"\"\"CFG's family's input beside the tokens, drawn from ``rs``: the
    encdec's ``frames`` (b, SRC_LEN, d), the VLM's ``patches`` (b, p, d);
    none for the others.\"\"\"
    draw = lambda rows: torch.from_numpy(
        rs.randn(b, rows, CFG.d_model).astype(np.float32))
    if CFG.family == "encdec":
        return {"frames": draw(SRC_LEN)}
    if CFG.family == "vlm":
        return {"patches": draw(CFG.vision.num_patches)}
    return {}


def lm_batch(b, s, seed):
    rs = np.random.RandomState(seed)
    toks = torch.from_numpy(rs.randint(0, CFG.vocab_size, size=(b, s + 1)))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            **family_inputs(b, rs)}


def fresh(plan, seed=3):
    return init_train_state(CFG, plan, torch.Generator().manual_seed(seed),
                            OPT, dtype=torch.float32, device="cpu")


def scaled_err(got, want):
    return max(((got[n] - t.detach()).abs().max()
                / max(t.abs().max().item(), 1e-30)).item()
               for n, t in want.items())


SERVE_B, SERVE_S, SERVE_TICKS, SERVE_MAX = 4, 12, 3, 32
KV_CACHES = ("k", "v", "self_k", "self_v", "cross_k", "cross_v", "attn_k",
             "attn_v")


def serve_pair(shape, axes=("data", "model")):
    \"\"\"A prefill (with CFG's ``family_inputs``) and SERVE_TICKS greedy
    decode ticks of CFG's reduced model split over ``shape``
    (``shard_model``, the cache as ``cache_shardings`` lays it out) against the whole model in this
    process: the largest logit difference at each call, whether this
    rank's greedy tokens equal the whole model's for its rows, this rank's
    cache shapes and each cache gathered whole against the whole model's
    (its largest error over its largest magnitude).\"\"\"
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import (batch_spec, cache_shardings,
                                               gather_full, local_shard)
    from repro_torch.train import shard_model
    plan = MemoryPlan(1, "float32", True, "dots", 0.0)
    make = lambda: get_model(CFG)(CFG, dtype=torch.float32, device="cpu",
                                  generator=torch.Generator().manual_seed(7))
    ref, model = make(), make()
    mesh = build_mesh(shape, axes, "cpu")
    shard_model(CFG, plan, model, mesh, batch_rows=SERVE_B)
    rs = np.random.RandomState(11)
    toks = torch.from_numpy(rs.randint(0, CFG.vocab_size,
                                       size=(SERVE_B, SERVE_S)))
    extra = family_inputs(SERVE_B, rs)
    rows = batch_spec(mesh, (SERVE_B,))
    mine = local_shard(toks, batch_spec(mesh, tuple(toks.shape)), mesh)
    mine_extra = {k: local_shard(v, batch_spec(mesh, tuple(v.shape)), mesh)
                  for k, v in extra.items()}
    whole = ref.init_cache(SERVE_B, SERVE_MAX, *(
        [SRC_LEN] if CFG.family == "encdec" else []))
    specs = cache_shardings(CFG, mesh, whole)
    specs["pos"] = rows
    cache = {n: local_shard(t, specs[n], mesh).clone()
             for n, t in whole.items()}
    out = {"logit_err": [], "tokens_equal": [], "logit_shape_ok": []}
    with torch.no_grad():
        lg, cache = model.prefill(mine, cache, **mine_extra)
        lr, whole = ref.prefill(toks, whole, **extra)
        for t in range(SERVE_TICKS + 1):
            want = local_shard(lr, batch_spec(mesh, tuple(lr.shape)), mesh)
            out["logit_err"].append((lg - want).abs().max().item())
            out["logit_shape_ok"].append(tuple(lg.shape) == tuple(want.shape))
            mine_next = lg[:, -1].argmax(-1, keepdim=True)
            ref_next = lr[:, -1].argmax(-1, keepdim=True)
            out["tokens_equal"].append(bool(torch.equal(
                mine_next, local_shard(ref_next, rows + (None,), mesh))))
            if t < SERVE_TICKS:
                lg, cache = model.decode_step(cache, mine_next)
                lr, whole = ref.decode_step(whole, ref_next)
    out["local_shapes"] = {n: list(t.shape) for n, t in cache.items()}
    gathered = {n: gather_full(cache[n], specs[n], mesh)
                for n in whole if n != "pos"}
    err = lambda got, want, scale: ((got - want).abs().max()
                                    / max(scale.abs().max().item(),
                                          1e-30)).item()
    out["cache_err"] = {n: err(g, whole[n], whole[n])
                        for n, g in gathered.items()}
    # each KV head of a K/V cache (L, b, s, hkv, d) alone: where the rules
    # replicate the KV heads, a rank writes only the one it reads
    out["kv_head_err"] = {
        n: [err(g[:, :, :, h], whole[n][:, :, :, h], whole[n])
            for h in range(g.shape[3])]
        for n, g in gathered.items() if n in KV_CACHES}
    out["pos_equal"] = bool(torch.equal(
        gather_full(cache["pos"], specs["pos"], mesh), whole["pos"]))
    return out


def step_pair(shape, axes=("data", "model"), zero_stage=1, micro=2,
              batch=4, steps=2):
    \"\"\"``steps`` sharded steps against make_train_step from one state.\"\"\"
    plan = MemoryPlan(zero_stage, "float32", True, "dots", 0.0, micro)
    ref, step_ref = fresh(plan), make_train_step(CFG, plan, OPT)
    mesh = build_mesh(shape, axes, "cpu")
    state = shard_train_state(CFG, plan, fresh(plan), mesh)
    step = sharded_train_step(CFG, plan, mesh, OPT)
    out = {"loss": [], "ref_loss": [], "grad_norm": [], "ref_grad_norm": []}
    for i in range(steps):
        b = lm_batch(batch, 16, seed=10 + i)
        ref, mr = step_ref(ref, b)
        state, ms = step(state, b)
        for k in ("loss", "grad_norm"):
            out[k].append(ms[k].item())
            out["ref_" + k].append(mr[k].item())
    full = gather_train_state(state, mesh)
    out["param_abs_err"] = max(
        (full["params"][n] - p.detach()).abs().max().item()
        for n, p in ref["params"].items())
    out["param_scale"] = max(p.abs().max().item()
                             for p in ref["params"].values())
    for part in ("m", "v", "master"):
        out[part + "_scaled_err"] = scaled_err(full["opt"][part],
                                               ref["opt"][part])
    out["local_param_numel"] = sum(p.numel() for p in state["params"].values())
    out["full_param_numel"] = sum(p.numel() for p in ref["params"].values())
    return out
"""

_FOUR_RANKS = """
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import to_jax_train_state
from repro_torch.launch.elastic import remesh_state
from repro_torch.parallel import dp_axes, dp_size, mp_size, plan_memory
from repro_torch.parallel.compression import compressed_psum
from repro_torch.parallel.pipeline import gpipe
from repro_torch.parallel.sharding import (all_gather_stacked, batch_spec,
                                           gather_full, local_shard,
                                           param_shardings, shard_shape)
from repro_torch.parallel.zero import opt_state_shardings
from repro_torch.train.train_step import _reduce_grad

# -- the sharded step against one process --------------------------------
results["dp2_tp2"] = step_pair((2, 2))
results["dp2_tp2_zero3"] = step_pair((2, 2), zero_stage=3)
results["dp4_zero3"] = step_pair((4, 1), zero_stage=3, batch=8)
results["tp4_shared_kv"] = step_pair((1, 4), micro=1)
results["pod2_dp2"] = step_pair((2, 2, 1), ("pod", "data", "model"), batch=8)
# 3 query heads over 2 model ranks: the attention replicated, its weights'
# gradient split over the axis (parallel.tensor.project)
import dataclasses
_whole = CFG
CFG = dataclasses.replace(CFG, num_heads=3, num_kv_heads=1)
results["dp2_tp2_replicated_attn"] = step_pair((2, 2))
CFG = _whole

# -- serving split over the model axis against one process ----------------
results["serve_dp2_tp2"] = serve_pair((2, 2))
results["serve_tp4_shared_kv"] = serve_pair((1, 4))

# -- the collectives a dense DP x TP step counts on rank 0 ----------------
from repro_torch.core.op_counter import OpCounter
plan = MemoryPlan(1, "float32", True, "none", 0.0, 1)
mesh = build_mesh((2, 2), ("data", "model"), "cpu")
state = shard_train_state(CFG, plan, fresh(plan), mesh)
step = sharded_train_step(CFG, plan, mesh, OPT)
with OpCounter() as counter:
    step(state, lm_batch(4, 16, seed=40))
results["counted_step"] = {
    "coll": counter.cost.coll,
    "c10d": {k: v for k, v in counter.by_op.items() if k.startswith("c10d.")}}

# -- a MoE model under ZeRO-3 against ZeRO-1, (4 data, 1 model) -----------
# (both route the global batch over the data axis, each rank weighing the
# global auxiliary loss by its share of the targets: the same function of
# the batch, so ZeRO-3's gathered leaves must give ZeRO-1's step)
moe_cfg = get_config("granite-moe-3b-a800m", reduced=True)
moe_out = {}
for zero_stage in (1, 3):
    plan = MemoryPlan(zero_stage, "float32", True, "dots", 0.0, 1)
    mesh = build_mesh((4, 1), ("data", "model"), "cpu")
    state = shard_train_state(moe_cfg, plan, init_train_state(
        moe_cfg, plan, torch.Generator().manual_seed(5), OPT,
        dtype=torch.float32, device="cpu"), mesh)
    state, m = sharded_train_step(moe_cfg, plan, mesh, OPT)(
        state, lm_batch(8, 16, 4))
    moe_out[zero_stage] = (m["loss"].item(), m["grad_norm"].item(),
                           gather_train_state(state, mesh))
z3, z1 = moe_out[3][2], moe_out[1][2]
results["moe_zero3"] = {
    "loss": [moe_out[3][0], moe_out[1][0]],
    "grad_norm": [moe_out[3][1], moe_out[1][1]],
    "param_abs_err": max((z3["params"][n] - t).abs().max().item()
                         for n, t in z1["params"].items()),
    **{part + "_scaled_err": scaled_err(z3["opt"][part], z1["opt"][part])
       for part in ("m", "v", "master")}}

# -- ZeRO-1 on (4 data, 1 model): the moments' pieces ---------------------
plan = plan_memory(CFG, tp=1, dp=4)
mesh = build_mesh((4, 1), ("data", "model"), "cpu")
whole = fresh(plan)
full_bytes = {n: t.numel() * t.element_size()
              for n, t in whole["opt"]["m"].items()}
state = shard_train_state(CFG, plan, whole, mesh)
results["zero1"] = {
    "zero_stage": plan.zero_stage,
    "wq": [[state["opt"]["m"][n].numel() * 4, full_bytes[n]]
           for n in full_bytes if n.endswith("attn.wq")],
    "param_numel": sum(p.numel() for p in state["params"].values()),
    "full_param_numel": sum(full_bytes.values()) // 4}

# -- the (2 pod, 2 data, 1 model) mesh's batch split -----------------------
mesh = build_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
rows = torch.arange(8).reshape(8, 1)
results["pod_split"] = {
    "dp_axes": list(dp_axes(mesh)), "dp_size": dp_size(mesh),
    "mp_size": mp_size(mesh),
    "spec": list(batch_spec(mesh, (8, 16))),
    "rows": local_shard(rows, batch_spec(mesh, (8, 1)), mesh)[:, 0].tolist()}

# -- compressed_psum over the world, N = 4 ---------------------------------
group = dist.group.WORLD
rs = np.random.RandomState(0)
xs = rs.randn(4, 64).astype(np.float32)
total, err = compressed_psum(torch.from_numpy(xs[rank]), group)
gathered = all_gather_stacked(total, group)
xs_small = (rs.randn(4, 16) * 0.37).astype(np.float32)
acc_fb, errors = np.zeros(16), torch.zeros(16)
for _ in range(50):
    t, errors = compressed_psum(torch.from_numpy(xs_small[rank]), group,
                                errors)
    acc_fb += t.numpy()
t_nofb, _ = compressed_psum(torch.from_numpy(xs_small[rank]), group)
t_bf16, _ = compressed_psum(torch.from_numpy(xs[rank]).bfloat16(), group)
results["compressed_psum"] = {
    "total": total.tolist(), "new_error": err.tolist(),
    "same_on_every_rank": all(torch.equal(g, gathered[0]) for g in gathered),
    "acc_fb": acc_fb.tolist(), "nofb": t_nofb.tolist(),
    "bf16_dtype": str(t_bf16.dtype)}

# -- gpipe: S 4, M 8, mb 2, d 16 ------------------------------------------
mesh = build_mesh((4,), ("pipe",), "cpu")
S, M, mb, d = 4, 8, 2, 16
rs = np.random.RandomState(1)
ws = torch.from_numpy((rs.randn(S, d, d) * 0.5).astype(np.float32))
x = torch.from_numpy(rs.randn(M, mb, d).astype(np.float32))


def stage(p, xm):
    return torch.tanh(xm @ p["w"])


w_mine = ws[rank].clone().requires_grad_(True)
y = gpipe(stage, {"w": w_mine}, x, mesh=mesh)
y.sum().backward()
w_all = ws.clone().requires_grad_(True)
ref = x
for i in range(S):
    ref = stage({"w": w_all[i]}, ref)
ref.sum().backward()
results["gpipe"] = {
    "forward_err": (y - ref).abs().max().item(),
    "grad_err": (w_mine.grad - w_all.grad[rank]).abs().max().item(),
    "grad_abs_sum": w_mine.grad.abs().sum().item()}

# -- a layer held whole by one rank (mamba2's per-layer vectors on 2 x 2) --
mesh = build_mesh((2, 2), ("data", "model"), "cpu")
mcfg = get_config("mamba2-780m")
leaves = {f"layers.{i}.A_log": torch.empty(48) for i in (5, 30)}
zplan = MemoryPlan(1, "float32", True, "dots", 0.0)
o_sh = opt_state_shardings(mcfg, leaves, mesh, zplan)
p_sh = param_shardings(mcfg, leaves, mesh)
owned = {}
for name in leaves:
    whole_t = torch.arange(48, dtype=torch.float32) + 100 * int(
        name.split(".")[1])
    piece = local_shard(whole_t, o_sh[name], mesh)
    back = gather_full(piece, o_sh[name], mesh)
    g = torch.full((24,), float(rank + 1))           # a grad of ('model',)
    reduced = _reduce_grad(g, p_sh[name], o_sh[name], mesh)
    owned[name] = {"owner": list(o_sh[name].owner),
                   "param_spec": list(p_sh[name].spec),
                   "piece_shape": list(piece.shape),
                   "round_trip": torch.equal(back, whole_t),
                   "reduced": reduced.tolist()}
results["owned"] = owned

# -- elastic: save under (4, 1), restore onto (2, 2) -----------------------
ckdir = os.path.join(out, "ckpt")
plan = plan_memory(CFG, tp=1, dp=4)
mesh_a = build_mesh((4, 1), ("data", "model"), "cpu")
state = shard_train_state(CFG, plan, fresh(plan), mesh_a)
state, _ = sharded_train_step(CFG, plan, mesh_a, OPT)(state,
                                                      lm_batch(8, 16, 3))
full = gather_train_state(state, mesh_a)
if rank == 0:
    mgr = CheckpointManager(ckdir, interval=1, keep=2, async_save=False)
    saved = mgr.maybe_save(
        3, to_jax_train_state({"model": state["model"], **full}),
        extra={"tokens_seen": 123})
    assert saved
dist.barrier()
mgr = CheckpointManager(ckdir, interval=1, keep=2, async_save=False)
new_plan = plan_memory(CFG, tp=2, dp=2)
mesh_b = build_mesh((2, 2), ("data", "model"), "cpu")
restored, extra, sh = remesh_state(CFG, new_plan, mgr, fresh(plan, seed=9),
                                   mesh_b)
back = gather_train_state(restored, mesh_b)
differing, shapes_ok, leaves = [], True, 0
for part in ("params", "m", "v", "master"):
    mine = back["params"] if part == "params" else back["opt"][part]
    want = full["params"] if part == "params" else full["opt"][part]
    pieces = (restored["params"] if part == "params"
              else restored["opt"][part])
    places = sh["params"] if part == "params" else sh["opt"][part]
    for n, t in want.items():
        leaves += 1
        if not torch.equal(mine[n], t):
            differing.append(part + "." + n)
        shapes_ok &= tuple(pieces[n].shape) == shard_shape(places[n], mesh_b)
split = sum(restored["params"][n].numel() < t.numel()
            for n, t in full["params"].items())
try:
    remesh_state(CFG, new_plan, CheckpointManager(
        tempfile.mkdtemp(dir=out), async_save=False), fresh(plan), mesh_b)
    raised = None
except FileNotFoundError as e:
    raised = type(e).__name__
results["elastic"] = {
    "extra": extra, "leaves": leaves, "differing": differing,
    "step": [int(restored["opt"]["step"]), int(full["opt"]["step"])],
    "shapes_as_spec": bool(shapes_ok), "params_split_on_new_mesh": split,
    "without_checkpoint": raised}
"""

_ONE_RANK = """
plan = MemoryPlan(1, "float32", True, "dots", 0.0, 2)
ref, step_ref = fresh(plan), make_train_step(CFG, plan, OPT)
mesh = build_mesh((1, 1), ("data", "model"), "cpu")
state = shard_train_state(CFG, plan, fresh(plan), mesh)
step = sharded_train_step(CFG, plan, mesh, OPT)
equal_metrics = []
for i in range(3):
    b = lm_batch(4, 16, seed=20 + i)
    ref, mr = step_ref(ref, b)
    state, ms = step(state, b)
    equal_metrics.append(all(torch.equal(ms[k], mr[k])
                             for k in ("loss", "ce", "aux", "grad_norm")))
differing = [n for n, p in ref["params"].items()
             if not torch.equal(p, state["params"][n])]
for part in ("m", "v", "master"):
    differing += [part + "." + n for n, t in ref["opt"][part].items()
                  if not torch.equal(t, state["opt"][part][n])]
try:
    build_mesh((2, 1), ("data", "model"), "cpu")
    wrong_size = None
except ValueError as e:
    wrong_size = str(e)
results["one_rank"] = {"equal_metrics": equal_metrics,
                       "differing": differing,
                       "leaves": 4 * len(ref["params"]),
                       "wrong_size": wrong_size}
"""

_TWO_RANKS = """
results["serve_tp2"] = serve_pair((1, 2))
"""

_EPILOGUE = """
with open(os.path.join(out, f"result_{rank}.json"), "w") as f:
    json.dump(results, f)
dist.barrier()
dist.destroy_process_group()
"""


def _run_job(body: str, world: int, out) -> list:
    """Start ``world`` ranks of ``body``; wait for all of them, killing
    every rank as soon as one fails or the job outlasts its timeout.
    Returns each rank's results."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    code = textwrap.dedent(_PRELUDE) + body + _EPILOGUE
    logs = [open(out / f"rank_{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(world), str(out)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env, cwd=REPO)
             for r in range(world)]
    deadline = time.monotonic() + JOB_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        tails = "\n".join(f"--- rank {r} (exit {c}):\n"
                          + (out / f"rank_{r}.log").read_text()[-3000:]
                          for r, c in enumerate(codes))
        raise AssertionError(f"job of {world} ranks failed or timed out "
                             f"({JOB_TIMEOUT_S} s): exits {codes}\n{tails}")
    return [json.loads((out / f"result_{r}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run_job(_FOUR_RANKS, 4, tmp_path_factory.mktemp("four_ranks"))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run_job(_TWO_RANKS, 2, tmp_path_factory.mktemp("two_ranks"))


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    return _run_job(_ONE_RANK, 1, tmp_path_factory.mktemp("one_rank"))


# ------------------------------------------------------------------------- #
# The sharded step against one process
# ------------------------------------------------------------------------- #

STEP_CASES = ["dp2_tp2", "dp2_tp2_zero3", "dp4_zero3", "tp4_shared_kv",
              "pod2_dp2", "dp2_tp2_replicated_attn"]


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_matches_one_process(four, case):
    """(2 data, 2 model) with ZeRO-1 and with ZeRO-3 (``zero_stage=3``),
    (4, 1) ZeRO-3, (1, 4) (smollm's reduced 4 heads split one a rank, its
    2 KV heads replicated and shared), (2 pod, 2 data, 1 model), (2, 2)
    with 3 heads, the attention replicated over the model axis and its
    weights' gradient split over it: two steps
    of two microbatches (one at (1, 4)), every rank's loss and the gathered
    parameters against ``make_train_step`` from the same state."""
    for res in four:
        r = res[case]
        np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=2e-4,
                                   atol=2e-4)
        assert r["param_abs_err"] <= 5e-3 * max(1.0, r["param_scale"])
        for part in ("m", "v", "master"):
            assert r[part + "_scaled_err"] <= 5e-3, part


@pytest.mark.parametrize("case", STEP_CASES)
def test_global_norm_matches_one_process(four, case):
    """Each element counted once: the norm of the whole gradient tree from
    its pieces (a 2x error hides in a replicated leaf counted per rank)."""
    for res in four:
        np.testing.assert_allclose(res[case]["grad_norm"],
                                   res[case]["ref_grad_norm"], rtol=1e-5)


def test_zero3_divides_the_parameters(four):
    """ZeRO-3 keeps pieces of the parameters between steps; ZeRO-1 and the
    pure data-parallel step keep them whole."""
    for res in four:
        z3 = res["dp4_zero3"]
        assert z3["local_param_numel"] < 0.3 * z3["full_param_numel"]
        z1 = res["zero1"]
        assert z1["param_numel"] == z1["full_param_numel"]


def test_moe_under_zero3_matches_zero1(four):
    """granite-moe (reduced) on (4, 1): ZeRO-3's experts and router,
    gathered where the MoE block reads them, give ZeRO-1's step: the loss,
    the global norm, the parameters and the moments (a gradient lost to a
    gathered leaf shows in its m and v, which one Adam step's parameters
    barely do)."""
    for res in four:
        r = res["moe_zero3"]
        np.testing.assert_allclose(r["loss"][0], r["loss"][1], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r["grad_norm"][0], r["grad_norm"][1],
                                   rtol=1e-5)
        assert r["param_abs_err"] <= 5e-3
        for part in ("m", "v", "master"):
            assert r[part + "_scaled_err"] <= 5e-3, part


def test_zero1_shards_the_moments(four):
    """(4, 1) ZeRO-1: each rank's piece of a layer's ``attn.wq`` moment is
    at most a quarter of the whole, plus 1 KiB
    (``test_zero_sharding_reduces_per_device_bytes``)."""
    for res in four:
        assert res["zero1"]["zero_stage"] == 1
        assert res["zero1"]["wq"]
        for piece, whole in res["zero1"]["wq"]:
            assert piece <= whole // 4 + 1024, (piece, whole)


def test_pod_axis_splits_the_batch(four):
    for rank, res in enumerate(four):
        r = res["pod_split"]
        assert r["dp_axes"] == ["pod", "data"]
        assert (r["dp_size"], r["mp_size"]) == (4, 1)
        assert r["spec"] == [["pod", "data"], None]
        assert r["rows"] == [2 * rank, 2 * rank + 1]


def test_layer_held_whole_by_one_rank(four):
    """mamba2's ``A_log`` of layers 5 and 30 on (2 data, 2 model) under
    ZeRO-1: the state's stacked spec (data, model) gives layer i to data
    coordinate i // 24; its owners hold their model half, the others
    nothing; the piece gathers back whole on every rank, and a gradient
    reduces onto the owners alone (the sum over the data axis)."""
    for rank, res in enumerate(four):
        data, model = divmod(rank, 2)
        for layer, holder in ((5, 0), (30, 1)):
            r = res["owned"][f"layers.{layer}.A_log"]
            assert r["owner"] == ["data", holder]
            assert r["param_spec"] == ["model"]
            assert r["round_trip"]
            if data == holder:
                assert r["piece_shape"] == [24]
                assert r["reduced"] == [float(model + 1 + model + 3)] * 24
            else:
                assert r["piece_shape"] == [0] and r["reduced"] == []


# ------------------------------------------------------------------------- #
# compressed_psum: the five cases of tests/test_compression.py, at N = 4,
# against the reference's function on the same inputs
# ------------------------------------------------------------------------- #

N = 4


def _xs():
    rs = np.random.RandomState(0)
    return rs.randn(N, 64).astype(np.float32), (
        rs.randn(N, 16) * 0.37).astype(np.float32)


def _reference_psum(xs, errors=None):
    if errors is None:
        return jax.vmap(lambda x: compressed_psum_jax(x, "dp"),
                        axis_name="dp")(jnp.asarray(xs))
    return jax.vmap(lambda x, e: compressed_psum_jax(x, "dp", e),
                    axis_name="dp")(jnp.asarray(xs), jnp.asarray(errors))


def test_compressed_psum_matches_exact_sum_and_reference(four):
    xs, _ = _xs()
    exact = xs.sum(axis=0)
    scale = np.abs(xs).max() / 127.0
    want, _ = _reference_psum(xs)
    for res in four:
        total = np.asarray(res["compressed_psum"]["total"], np.float32)
        np.testing.assert_allclose(total, exact, atol=N * scale)
        np.testing.assert_allclose(total, np.asarray(want[0]), rtol=1e-6,
                                   atol=1e-6)


def test_compressed_psum_same_total_on_every_rank(four):
    totals = [res["compressed_psum"]["total"] for res in four]
    for res in four:
        assert res["compressed_psum"]["same_on_every_rank"]
    assert all(t == totals[0] for t in totals)


def test_compressed_psum_new_error_is_the_residual(four):
    xs, _ = _xs()
    for rank, res in enumerate(four):
        q, scale = quantize_jax(jnp.asarray(xs[rank]))
        want = xs[rank] - np.asarray(dequantize_jax(q, scale))
        np.testing.assert_allclose(res["compressed_psum"]["new_error"], want,
                                   atol=1e-6)


def test_compressed_psum_error_feedback_removes_the_bias(four):
    """50 sums of the same gradients: with error feedback the accumulated
    output stays within two quantization steps of the accumulated true sum,
    and beats the uncompensated bias where that grows."""
    _, xs = _xs()
    exact = xs.sum(axis=0)
    steps = 50
    one_step = N * np.abs(xs).max() / 127.0
    for res in four:
        r = res["compressed_psum"]
        err_fb = np.abs(np.asarray(r["acc_fb"]) - steps * exact).max()
        err_nofb = np.abs(steps * np.asarray(r["nofb"]) - steps * exact).max()
        assert err_fb <= 2 * one_step
        if err_nofb > 4 * one_step:
            assert err_fb < err_nofb / 4


def test_compressed_psum_keeps_the_dtype(four):
    for res in four:
        assert res["compressed_psum"]["bf16_dtype"] == "torch.bfloat16"


# ------------------------------------------------------------------------- #
# gpipe, the elastic restart, and one rank
# ------------------------------------------------------------------------- #

def test_gpipe_matches_the_sequential_stages(four):
    """S 4, M 8, mb 2, d 16: every rank's outputs within 1e-5 of the four
    stages run in turn, and each stage's weight gradient within 1e-5 of
    autograd through them (R3: the reference's ``jax.grad`` half fails)."""
    for res in four:
        r = res["gpipe"]
        assert r["forward_err"] <= 1e-5
        assert r["grad_err"] <= 1e-5
        assert r["grad_abs_sum"] > 0


def test_remesh_restores_the_state_on_a_new_mesh(four):
    """Saved whole under (4 data, 1 model), restored onto (2, 2):
    ``remesh_state`` gives every leaf of params, m, v and master back bit
    for bit, each rank's piece of the shape its new placement says, the
    split parameters divided, ``extra`` kept; with no checkpoint it raises
    FileNotFoundError, not a cold start."""
    for res in four:
        r = res["elastic"]
        assert r["extra"] == {"tokens_seen": 123}
        assert r["leaves"] > 0 and r["differing"] == []
        assert r["step"] == [1, 1]
        assert r["shapes_as_spec"]
        assert r["params_split_on_new_mesh"] > 0
        assert r["without_checkpoint"] == "FileNotFoundError"


def test_one_rank_sharded_step_is_bitwise_make_train_step(one):
    """A (1, 1) mesh: every collective is an identity, so three sharded
    steps give make_train_step's bits: metrics, params, m, v, master. A mesh
    that the world does not fill raises."""
    r = one[0]["one_rank"]
    assert r["equal_metrics"] == [True] * 3
    assert r["differing"] == []
    assert r["wrong_size"] and "processes" in r["wrong_size"]


# ------------------------------------------------------------------------- #
# Serving split over the model axis (ROADMAP Queue 1 item 15)
# ------------------------------------------------------------------------- #

def _check_serving(r):
    """fp32: every call's logits within the serving tests' 1e-4 (against
    the JAX package) of the whole model's, the greedy tokens equal."""
    assert r["logit_shape_ok"] == [True] * (SERVE_TICKS + 1)
    assert max(r["logit_err"]) <= 1e-4, r["logit_err"]
    assert r["tokens_equal"] == [True] * (SERVE_TICKS + 1)


SERVE_TICKS = 3


@pytest.mark.parametrize("case,heads", [("serve_dp2_tp2", 1),
                                        ("serve_tp4_shared_kv", 2)])
def test_serving_split_over_the_model_axis_matches_one_process(four, case,
                                                               heads):
    """(2 data, 2 model): the KV heads split one a rank, the batch over the
    data axis; (1, 4): the reduced smollm's 2 KV heads replicated, each
    rank reading and writing the one its query head shares. A prefill and
    three greedy ticks; the logits are all-gathered over the model axis, as
    the reference's serving steps return them replicated."""
    for res in four:
        _check_serving(res[case])
        assert res[case]["local_shapes"]["k"][3] == heads


def test_serving_split_over_two_ranks_matches_one_process(two):
    for res in two:
        _check_serving(res["serve_tp2"])
        assert res["serve_tp2"]["local_shapes"]["k"][3] == 1


# ------------------------------------------------------------------------- #
# The op counter's collectives: a fake group against gloo, and a closed form
# ------------------------------------------------------------------------- #

def _closed_form_collectives(b: int, s: int) -> dict:
    """The bytes (output shape, per rank) of every collective of one
    sharded step of the reduced smollm at (2 data, 2 model), ZeRO-1, fp32,
    remat "none", one microbatch of ``b`` local rows of ``s`` tokens,
    written from the config and the sharding rules: the model axis sums the
    embedding, every attention and FFN output and, backward, the gradients
    at their inputs and at the head's (fp32 activations, b x s x d each);
    the vocabulary-split loss sums three (b, s) rows; the data axis sums the
    target counts (1), the loss parts (3) and, over the world, the squared
    norm (1); each gradient is reduce-scattered onto its moments' half
    where ZeRO-1 divides them (and the updated half all-gathered back),
    else summed whole."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.parallel.mesh import MeshSpec
    from repro_torch.parallel.policy import MemoryPlan
    from repro_torch.parallel.sharding import param_shardings, shard_shape
    from repro_torch.parallel.zero import opt_state_shardings
    cfg = get_config("smollm-135m", reduced=True)
    mesh = MeshSpec((2, 2), ("data", "model"))
    plan = MemoryPlan(1, "float32", True, "none", 0.0, 1)
    params = dict(get_model(cfg)(cfg, dtype=torch.float32,
                                 device="meta").named_parameters())
    p_sh = param_shardings(cfg, params, mesh)
    o_sh = opt_state_shardings(cfg, params, mesh, plan)
    act, row = b * s * cfg.d_model * 4, b * s * 4
    out = {"all-reduce": 2 * act * (1 + 2 * cfg.num_layers) + 3 * row
           + 4 * (1 + 3 + 1), "reduce-scatter": 0, "all-gather": 0}
    for name in params:
        piece = math.prod(shard_shape(p_sh[name], mesh)) * 4
        if "data" in o_sh[name].axes() and "data" not in p_sh[name].axes():
            out["reduce-scatter"] += piece // 2
            out["all-gather"] += piece
        else:
            out["all-reduce"] += piece
    return out


def test_the_counter_sees_the_same_collectives_on_a_fake_group(four):
    """The dense DP x TP step at (2, 2), counted on rank 0 of four gloo
    processes and in this process as rank 0 of a fake group of four on
    ``meta`` state: the same c10d operators, calls and bytes, and the
    closed form above."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config
    from repro_torch.core.op_counter import OpCounter
    from repro_torch.parallel import build_mesh
    from repro_torch.parallel.policy import MemoryPlan
    from repro_torch.train import (init_train_state, shard_train_state,
                                   sharded_train_step)
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get_config("smollm-135m", reduced=True)
    plan = MemoryPlan(1, "float32", True, "none", 0.0, 1)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = build_mesh((2, 2), ("data", "model"), "cpu")
        state = shard_train_state(cfg, plan, init_train_state(
            cfg, plan, None, opt, dtype=torch.float32, device="meta"), mesh)
        batch = {k: torch.empty((4, 16), dtype=torch.int64, device="meta")
                 for k in ("tokens", "targets")}
        with OpCounter() as counter:
            sharded_train_step(cfg, plan, mesh, opt)(state, batch)
    finally:
        dist.destroy_process_group()
    gloo = four[0]["counted_step"]
    fake = {k: list(v) for k, v in counter.by_op.items()
            if k.startswith("c10d.")}
    assert fake == gloo["c10d"]
    assert counter.cost.coll == gloo["coll"]
    assert counter.cost.coll == _closed_form_collectives(2, 16)
