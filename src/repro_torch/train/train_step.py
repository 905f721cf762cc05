"""The training step: loss -> backward (accumulated over microbatches) ->
AdamW, on one device or sharded over a mesh, and its sharding contract.

Counterpart of ``src/repro/train/train_step.py``. ``make_train_step`` binds
(config, memory plan, optimizer config) into a ``(state, batch, generator)
-> (state, metrics)`` function, as the reference's does with a JAX key in
place of the generator. The state is ``{"model", "params", "opt"}``: the
module that computes the loss, its parameters by leaf name (the module's own
tensors) and the optimizer state. The step updates them IN PLACE and returns
the same dictionary.

Gradient accumulation as the reference's: ``plan.microbatches`` slices of
the batch along its first axis, each gradient cast to the accumulator type
(``bfloat16`` when the plan concedes bf16 moments, else fp32) and divided by
the count before it is added; the loss and its parts are averaged the same
way. The gradients reach the optimizer in fp32.

``state_shardings`` gives every state leaf's placement on a mesh
(``parallel.sharding`` and ``parallel.zero``); ``shard_train_state`` keeps
this rank's pieces of a whole state; ``sharded_train_step`` is the
counterpart of the reference's ``jit_train_step``, one process a device,
the collectives explicit:

  * the global batch is cut into microbatches as the reference cuts it
    (``plan.microbatches`` blocks of consecutive rows), and each rank takes
    its rows of each (``batch_spec``), so that the ranks' microbatch i is
    the reference's. Where a microbatch's rows do not divide over the data
    ranks and its sequence divides the data axis, each data rank takes its
    block of every row's positions instead, of the tokens and the targets
    alike (``batch_spec``'s ``seq_shard``, which the reference gives the
    tokens; each rank's loss needs its positions' targets): the model runs
    the block (its ``seq_block``, a ``parallel.sharding.SeqBlock``), every
    family (the encdec's frames and the VLM's patches whole on every rank,
    as the reference leaves them); where neither divides, every data rank
    runs the whole microbatch.
    It runs the microbatched forward and backward on its
    shards (tensor parallelism: ``parallel.tensor``, the MoE's experts by
    expert or by hidden layer; ZeRO-3's parameters gathered over the data
    axis where they are read, a layer held whole by one rank broadcast from
    it: ``parallel.zero``);
  * a rank's loss is weighted by its share of the microbatch's targets, so
    the sum over the data-parallel ranks is the reference's mean over the
    global microbatch, and each gradient element counts once in that sum
    where ranks hold the same positions (every rank in the whole case; the
    pod axis's ranks under a split of the data axis alone); a MoE layer
    routes the global microbatch (its capacity pick and auxiliary loss over
    every data rank's tokens: ``parallel.tensor.route_over``, or over the
    data axis alone under a sequence split, whose pod ranks hold the same
    positions: ``moe_block``'s ``seq``), so its auxiliary loss is the same
    on every rank and, weighted alike, sums to the reference's;
  * each gradient is reduce-scattered onto its optimizer-state shard (the
    reference's gradient sharding constraint, ``train_step.py:83-86,128``)
    and summed over the data-parallel axes it is not divided over;
  * the global norm counts every element once: squares summed over the
    shards of a divided leaf, a replicated leaf counted on one rank;
  * AdamW runs on the shards, and the updated pieces are all-gathered over
    the data axis (ZeRO-1) or stay divided (ZeRO-3).

With fp32 parameters no draw is involved, and a one-rank mesh gives the bits
of ``make_train_step``. A bf16 plan without master copies draws its
stochastic rounding per shard, so it is not bitwise the one-device step's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.parallel.mesh import (
    MODEL_AXIS,
    dp_axes,
    mesh_spec,
    mp_size,
)
from repro_torch.parallel.policy import MemoryPlan
from repro_torch.parallel.sharding import (
    SEQ_AXIS,
    Placement,
    SeqBlock,
    batch_spec,
    entry_axes,
    gather_full,
    local_shard,
    param_shardings,
    reduce_scatter_dim,
    rows_divide,
    shard_shape,
)
from repro_torch.parallel.tensor import apply_tensor_parallel, route_over
from repro_torch.parallel.zero import gather_on_use, opt_state_shardings
from repro_torch.train.optimizer import (
    AdamWConfig,
    _sum_of_squares,
    apply_updates,
    init_state,
)

_OPT_TREES = ("m", "v", "master")


def _default_opt(plan: MemoryPlan) -> AdamWConfig:
    return AdamWConfig(state_dtype=plan.opt_dtype, use_master=plan.use_master)


def _forward_backward(model, params: Dict[str, torch.Tensor],
                      batch: Dict[str, torch.Tensor], m: int,
                      acc_dtype: torch.dtype, remat: str,
                      weights: Optional[torch.Tensor] = None):
    """(loss, parts, fp32 gradients) of ``batch`` in ``m`` microbatches;
    ``weights``: a factor for each microbatch's loss (its share of the
    targets), or None."""
    def run(mb, i):
        loss, parts = model.loss(mb, remat=remat)
        if weights is not None:
            loss = loss * weights[i]
            parts = {k: v * weights[i] for k, v in parts.items()}
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    if m <= 1:
        loss, parts = run(batch, 0)
        grads = {n: p.grad.float() for n, p in params.items()}
    else:
        device = next(iter(params.values())).device
        loss = torch.zeros((), dtype=torch.float32, device=device)
        parts = {"ce": torch.zeros_like(loss), "aux": torch.zeros_like(loss)}
        grads = {n: torch.zeros(p.shape, dtype=acc_dtype, device=device)
                 for n, p in params.items()}
        for i in range(m):
            mb = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
                  for k, v in batch.items()}
            mb_loss, mb_parts = run(mb, i)
            for n, p in params.items():
                grads[n].add_(p.grad.to(acc_dtype) / m)
                p.grad = None
            loss = loss + mb_loss / m
            parts = {k: parts[k] + mb_parts[k] / m for k in parts}
        grads = {n: g.float() for n, g in grads.items()}
    for p in params.values():
        p.grad = None
    return loss, parts, grads


def _acc_dtype(plan: MemoryPlan) -> torch.dtype:
    return torch.bfloat16 if plan.opt_dtype == "bfloat16" else torch.float32


def make_train_step(cfg: ModelConfig, plan: MemoryPlan,
                    opt_cfg: Optional[AdamWConfig] = None) -> Callable:
    """(state, batch, generator) -> (state, metrics); metrics ``loss``,
    ``ce``, ``aux``, ``lr`` and ``grad_norm`` (``lr`` a host number, the
    others fp32 tensors on the device). ``generator`` draws the stochastic
    rounding of bf16 parameters that have no master copy."""
    opt_cfg = opt_cfg or _default_opt(plan)
    m = max(1, plan.microbatches)

    def train_step(state: dict, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        params = state["params"]
        loss, parts, grads = _forward_backward(
            state["model"], params, batch, m, _acc_dtype(plan), plan.remat)
        _, _, opt_metrics = apply_updates(params, grads, state["opt"], opt_cfg,
                                          generator)
        return state, {"loss": loss, **parts, **opt_metrics}

    return train_step


def init_train_state(cfg: ModelConfig, plan: MemoryPlan,
                     generator: Optional[torch.Generator] = None,
                     opt_cfg: Optional[AdamWConfig] = None,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> dict:
    """The model drawn from ``generator`` (on its device, then moved to
    ``device``, the GPU unless the caller names another) and a fresh
    optimizer state for it."""
    opt_cfg = opt_cfg or _default_opt(plan)
    model = get_model(cfg)(cfg, dtype=dtype, device=device,
                           generator=generator)
    params = dict(model.named_parameters())
    return {"model": model, "params": params,
            "opt": init_state(params, opt_cfg)}


# ----------------------------------------------------------------------- #
# Sharded over a mesh
# ----------------------------------------------------------------------- #

def state_shardings(cfg: ModelConfig, plan: MemoryPlan, state: dict,
                    mesh) -> dict:
    """The placement of every leaf of a whole train state (or of anything
    with its ``params`` and ``opt`` keys and their shapes): ``params``,
    the optimizer's ``m``, ``v`` (and ``master``) and ``step``, as the
    reference's ``state_shardings``."""
    params = state["params"]
    o_sh = opt_state_shardings(cfg, params, mesh, plan)
    opt = {"m": o_sh, "v": o_sh, "step": Placement((), ())}
    if "master" in state["opt"]:
        opt["master"] = o_sh
    return {"params": param_shardings(cfg, params, mesh, fsdp=plan.fsdp),
            "opt": opt}


def _refuse_unported(mesh) -> None:
    """Raise for a mesh with no processes behind it."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a sharded step runs on a device mesh over a "
                        f"process group (parallel.build_mesh), not {mesh!r}")


def shard_model(cfg: ModelConfig, plan: MemoryPlan, model, mesh,
                placements: Optional[Dict[str, Placement]] = None,
                batch_rows: Optional[int] = None) -> Dict[str, Placement]:
    """This rank's pieces of a whole model's parameters (every rank holding
    the same model), in place: each parameter keeps its object and takes its
    piece as data; the model is pointed at the model axis's group (its
    heads, FFN columns, experts or SSD heads and its vocabulary block) and,
    under ZeRO-3, it gathers its parameters where it reads them. Returns the
    placements (``placements``, else ``param_shardings``'s). Serving and
    training alike; raises, before anything is changed, as
    ``shard_train_state``.

    ``batch_rows``: the global batch's rows, where known. Where they divide
    over the data-parallel ranks (or are not given), each rank serves or
    trains its block of them and the MoE layers route the global batch
    (``route_over`` the data-parallel groups). Where they do not (serving
    long_500k's one row), every data rank runs the whole batch and the MoE
    layers route it alone; its cache's pieces (``parallel.sharding.
    shard_cache``) then name the caches split along the sequence over the
    data axis, and their group, and a prefill whose prompt's length divides
    the data axis runs this rank's block of it (the model's
    ``prompt_group``)."""
    _refuse_unported(mesh)
    params = dict(model.named_parameters())
    sh = placements or param_shardings(cfg, params, mesh, fsdp=plan.fsdp)
    with torch.no_grad():
        for name, p in params.items():
            p.data = local_shard(p.data, sh[name], mesh).clone()
    if mp_size(mesh) > 1:
        apply_tensor_parallel(model, sh, mesh.get_group(MODEL_AXIS))
    sizes = mesh_spec(mesh).shape
    whole = batch_rows is not None and not rows_divide(mesh, batch_rows)
    route_over(model, [] if whole else [mesh.get_group(a)
                                        for a in dp_axes(mesh)
                                        if sizes[a] > 1])
    if hasattr(model, "prompt_group"):
        model.prompt_group = (mesh.get_group(SEQ_AXIS)
                              if whole and sizes.get(SEQ_AXIS, 1) > 1
                              else None)
    if plan.fsdp:
        gather_on_use(model, sh, mesh)
    return sh


def shard_train_state(cfg: ModelConfig, plan: MemoryPlan, state: dict,
                      mesh) -> dict:
    """This rank's pieces of a whole train state (every rank holding the
    same one, e.g. from ``init_train_state`` with one seed), in place: the
    parameters as ``shard_model`` takes them, each optimizer leaf replaced
    by its piece. Returns ``{"model", "params", "opt", "shardings"}``."""
    _refuse_unported(mesh)
    sh = state_shardings(cfg, plan, state, mesh)
    opt = state["opt"]
    with torch.no_grad():
        for part in _OPT_TREES:
            for name, t in opt.get(part, {}).items():
                opt[part][name] = local_shard(t, sh["opt"][part][name],
                                              mesh).clone()
    shard_model(cfg, plan, state["model"], mesh, sh["params"])
    return {"model": state["model"], "params": state["params"], "opt": opt,
            "shardings": sh}


def gather_train_state(state: dict, mesh) -> dict:
    """The whole ``params`` and optimizer trees of a sharded state, on every
    rank (new tensors; the step counter as it is)."""
    sh = state["shardings"]
    opt = state["opt"]
    out = {"params": {n: gather_full(t.detach(), sh["params"][n], mesh)
                      for n, t in state["params"].items()},
           "opt": {"step": opt["step"]}}
    for part in _OPT_TREES:
        if part in opt:
            out["opt"][part] = {n: gather_full(t, sh["opt"][part][n], mesh)
                                for n, t in opt[part].items()}
    return out


def _beyond(param: Placement, state: Placement, mesh) -> Placement:
    """What an optimizer-state placement divides beyond its parameter's: a
    placement of the parameter's local piece (ZeRO-1's data axis)."""
    spec = tuple(s if p is None else None
                 for p, s in zip(param.spec, state.spec))
    owner = state.owner if param.owner is None else None
    return Placement(spec, shard_shape(param, mesh), owner)


def _reduce_grad(g: torch.Tensor, param: Placement, state: Placement,
                 mesh) -> torch.Tensor:
    """A rank's gradient of its parameter piece -> the sum over the
    data-parallel ranks, on its optimizer-state piece: reduce-scattered
    over the axes the state divides beyond the parameter, then all-reduced
    over the data-parallel axes that divide neither."""
    beyond = _beyond(param, state, mesh)
    partial = [a for a in dp_axes(mesh) if a not in param.axes()]
    for d, entry in enumerate(beyond.spec):
        for a in entry_axes(entry):
            g = reduce_scatter_dim(g, d, mesh.get_group(a))
            partial.remove(a)
    if beyond.owner is not None:
        a, holder = beyond.owner
        group = mesh.get_group(a)
        g = g.contiguous()
        dist.reduce(g, dist.get_global_rank(group, holder), group=group)
        if mesh.get_local_rank(a) != holder:
            g = g.narrow(0, 0, 0)
        partial.remove(a)
    for a in partial:
        if g.numel():                    # a group's ranks all hold, or none
            dist.all_reduce(g, group=mesh.get_group(a))
    return g


def _global_norm(grads: Dict[str, torch.Tensor],
                 placements: Dict[str, Placement], mesh) -> torch.Tensor:
    """sqrt of the sum of squares of every element of the whole gradient
    tree, from its pieces: a rank adds the leaves whose pieces it holds
    first along every axis that does not divide them (so a replicated
    element counts once), then the sums are added over the world."""
    names = mesh_spec(mesh).axis_names
    device = next(iter(grads.values())).device
    # (1,), not (): gloo's all-reduce of a CUDA tensor fails on a 0-d one
    total = torch.zeros((1,), dtype=torch.float32, device=device)
    for name, g in grads.items():
        held = placements[name].axes()
        if all(mesh.get_local_rank(a) == 0 for a in names if a not in held):
            total = total + _sum_of_squares(g)
    dist.all_reduce(total)
    return torch.sqrt(total).reshape(())


def _seq_block(mesh, spec, shape) -> Optional[SeqBlock]:
    """The ``SeqBlock`` of a microbatch whose ``spec`` (``batch_spec``'s,
    of its tokens of ``shape``) splits the sequence over the data axis, or
    None."""
    if len(spec) < 2 or spec[1] != SEQ_AXIS:
        return None
    rows = shape[1] // mesh_spec(mesh).shape[SEQ_AXIS]
    return SeqBlock(mesh.get_group(SEQ_AXIS),
                    mesh.get_local_rank(SEQ_AXIS) * rows)


def sharded_train_step(cfg: ModelConfig, plan: MemoryPlan, mesh,
                       opt_cfg: Optional[AdamWConfig] = None) -> Callable:
    """(state, batch, generator) -> (state, metrics) on a device mesh, for a
    state from ``shard_train_state`` on the same mesh and the global batch
    (every rank passes the whole batch; each takes its rows, or its block
    of every row's positions, of each microbatch). The metrics are
    ``make_train_step``'s, global (the same on every rank)."""
    _refuse_unported(mesh)
    opt_cfg = opt_cfg or _default_opt(plan)
    m = max(1, plan.microbatches)
    dp_groups = [mesh.get_group(a) for a in dp_axes(mesh)]
    sizes = mesh_spec(mesh).shape
    routed = [mesh.get_group(a) for a in dp_axes(mesh) if sizes[a] > 1]

    def train_step(state: dict, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        params, opt, sh = state["params"], state["opt"], state["shardings"]
        # microbatch i is rows [i B / m, (i + 1) B / m) (the reference's
        # reshape to (m, B / m)), split over the data-parallel ranks by rows
        # or, where they do not divide, along the sequence
        tokens = batch["tokens"]
        shape = (tokens.shape[0] // m,) + tuple(tokens.shape[1:])
        seq_spec = batch_spec(mesh, shape, seq_shard=True)
        seq = _seq_block(mesh, seq_spec, shape)
        local = {}
        for k, v in batch.items():
            mbs = v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
            spec = (seq_spec if k in ("tokens", "targets")
                    else batch_spec(mesh, tuple(mbs.shape[1:])))
            mine = local_shard(mbs, (None,) + spec, mesh)
            local[k] = mine.reshape((-1,) + tuple(mine.shape[2:]))
        state["model"].seq_block = seq
        # a microbatch split by rows routes its MoE tokens over the data
        # ranks; one split along the sequence over the data axis alone
        # (the model's seq_block), one whole on every data rank alone
        route_over(state["model"], [] if seq_spec[0] is None else routed)
        counts = (local["targets"] != -1).reshape(m, -1).sum(1).float()
        totals = counts.clone()
        for group in dp_groups:
            dist.all_reduce(totals, group=group)
        weights = counts / totals.clamp(min=1.0)
        try:
            loss, parts, grads = _forward_backward(
                state["model"], params, local, m, _acc_dtype(plan),
                plan.remat, weights)
        finally:
            state["model"].seq_block = None
        summed = torch.stack([loss, parts["ce"], parts["aux"]])
        for group in dp_groups:
            dist.all_reduce(summed, group=group)
        loss, ce, aux = summed.unbind()

        o_sh = sh["opt"]["m"]
        grads = {n: _reduce_grad(g, sh["params"][n], o_sh[n], mesh)
                 for n, g in grads.items()}
        gnorm = _global_norm(grads, o_sh, mesh)
        beyond = {n: _beyond(sh["params"][n], o_sh[n], mesh) for n in params}
        pieces = {n: local_shard(p.detach(), beyond[n], mesh)
                  for n, p in params.items()}
        _, _, opt_metrics = apply_updates(pieces, grads, opt, opt_cfg,
                                          generator, grad_norm=gnorm)
        with torch.no_grad():
            for n, p in params.items():
                if beyond[n].axes():
                    p.copy_(gather_full(pieces[n], beyond[n], mesh))
        return state, {"loss": loss, "ce": ce, "aux": aux, **opt_metrics}

    return train_step
