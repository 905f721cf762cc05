"""COMET §III-A / §IV-A: model -> per-layer GEMM decomposition.

The port's copy of the JAX package's ``core/workload.py``, held to its
decompositions by ``tests/test_torch_core.py`` (the digests of
``tests/golden_decompose.json`` among them).

``decompose(cfg, shape, mp, dp, pp, ep)`` turns a
:class:`repro_torch.configs.ModelConfig` into a :class:`Workload`: an ordered list
of :class:`LayerSpec`, each holding

  * the per-node forward GEMMs / explicit ops (already sharded for the given
    MP degree, with the per-replica batch ``global_batch / (dp * ep)``),
  * the derived input-gradient (IG) and weight-gradient (WG) ops,
  * the communication events per phase (blocking MP collectives in FP/IG,
    non-blocking DP collectives in WG — paper §III-C3),
  * per-node weight bytes and output-activation bytes (footprint model input).

The transformer decomposition follows the paper's Table II (Megatron-style
MP: column-parallel QKV/FFN-in, row-parallel proj/FFN-out, vocab-parallel
embeddings); the additional families (MoE/EP, SSD, hybrid, enc-dec, VLM)
extend the same scheme — each is documented inline.

Four-axis strategies (Megatron-LM / GSPMD style):

  * **PP** — ``pp > 1`` partitions the layer stack into ``pp`` contiguous
    stages balanced by FLOPs (``LayerSpec.stage``), with blocking
    point-to-point activation transfers (``CommEvent("p2p", ..., "pp")``) at
    every stage boundary.  The microbatch count rides on the Workload
    (``num_microbatches``, default ``4 * pp`` capped at the per-replica
    batch) and drives the simulator's GPipe/1F1B bubble accounting.
  * **EP** — ``ep > 1`` shards MoE experts over a dedicated EP mesh axis
    (all-to-all dispatch/combine over scope ``"ep"`` instead of the legacy
    MP-group approximation); non-expert layers treat the EP group as extra
    data parallelism (per-replica batch divides by ``dp * ep``, dense
    gradients all-reduce across it, expert gradients across DP only).

``pp=1, ep=1`` is bit-for-bit the pre-PP/EP decomposition.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.gemm import CommEvent, ExplicitOp, Gemm, PhaseCost, phase_cost

Op = Union[Gemm, ExplicitOp]

BYTES = 2  # bf16/fp16 operands throughout (paper assumes fp16 activations)


class InfeasibleStrategyError(ValueError):
    """Strategy degrees incompatible with this model — e.g. ``ep`` not
    dividing ``num_experts``, or ``pp`` exceeding the layer count.  The
    study engine turns this into an infeasible record instead of aborting
    the sweep."""


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class LayerSpec:
    """One model layer on one node, for one (MP, DP, PP, EP) strategy."""

    name: str
    fwd: List[Op] = dataclasses.field(default_factory=list)
    ig: List[Op] = dataclasses.field(default_factory=list)
    wg: List[Op] = dataclasses.field(default_factory=list)
    comm_fwd: List[CommEvent] = dataclasses.field(default_factory=list)
    comm_ig: List[CommEvent] = dataclasses.field(default_factory=list)
    comm_wg: List[CommEvent] = dataclasses.field(default_factory=list)
    weight_bytes: int = 0          # per-node fp16 weight bytes
    act_out_bytes: int = 0         # per-node output activation bytes
    repeat: int = 1                # layer-stack multiplier
    # Optimizer-update traffic override (bytes). None -> dense Adam accounting
    # (28 B/param on the ZeRO-sharded slice). Sparse layers (embedding bags)
    # set this to the touched-rows traffic instead.
    optim_bytes: Optional[int] = None
    stage: int = 0                 # pipeline stage owning this layer
    # Portion of weight_bytes that is expert-sharded over the EP axis: its
    # gradients all-reduce across DP only ("edp" scope), while the dense
    # remainder syncs across the full DP x EP data group.
    expert_bytes: int = 0

    def add_gemm(self, g: Gemm, has_weight: bool = True) -> None:
        self.fwd.append(g)
        if has_weight:
            self.ig.append(g.transposed_for_ig())
            self.wg.append(g.transposed_for_wg())
            self.weight_bytes += g.k * g.n * g.bytes_per_element
        else:
            # No weights: both gradient GEMMs belong to the IG phase.
            self.ig.append(g.transposed_for_ig())
            self.ig.append(g.transposed_for_wg())

    def phase_cost(self, phase: str, sram_bytes: int) -> PhaseCost:
        ops = {"fp": self.fwd, "ig": self.ig, "wg": self.wg}[phase]
        total = PhaseCost()
        for op in ops:
            total = total + phase_cost(op, sram_bytes)
        return total

    def comm(self, phase: str) -> List[CommEvent]:
        return {"fp": self.comm_fwd, "ig": self.comm_ig, "wg": self.comm_wg}[phase]


@dataclasses.dataclass
class Workload:
    """Ordered per-node layer list + aggregate footprint inputs.

    With ``pp > 1`` the list covers *every* stage (``LayerSpec.stage`` says
    which node group owns a layer; ``stage_layers()`` splits them), so the
    ``total_*`` aggregates describe the whole pipeline's share of one
    replica, not a single node — per-stage views live in
    ``repro_torch.core.memory.stage_footprints``.
    """

    name: str
    layers: List[LayerSpec]
    mp: int
    dp: int
    per_replica_batch: int
    seq_len: int
    pp: int = 1
    ep: int = 1
    num_microbatches: int = 1      # pipeline microbatches (1 when pp == 1)
    schedule: str = "1f1b"         # "gpipe" | "1f1b" | "interleaved"
    virtual_stages: int = 1        # v chunks per node (interleaved only)

    # ------------------------------------------------------------------ #
    def compiled(self):
        """The lowered form of this workload (flat NumPy op/event arrays,
        :class:`repro_torch.core.compiled.CompiledWorkload`), built on first use
        and memoized on the instance — the strategy-dependent half of a
        study cell's cost, paid once per decomposition no matter how many
        cluster cells it is timed against.  The layer list must not be
        mutated after the first call."""
        cw = getattr(self, "_compiled_cache", None)
        if cw is None:
            from repro_torch.core.compiled import compile_workload
            cw = compile_workload(self)
            object.__setattr__(self, "_compiled_cache", cw)
        return cw

    # ------------------------------------------------------------------ #
    def stage_layers(self) -> List[List[LayerSpec]]:
        """Layers grouped by pipeline stage (one group when pp == 1)."""
        if self.pp <= 1:
            return [list(self.layers)]
        out: List[List[LayerSpec]] = [[] for _ in range(self.pp)]
        for ly in self.layers:
            out[ly.stage].append(ly)
        return out

    def comm_events(self):
        """Iterate ``(layer_index, layer, phase, event)`` over every
        communication event, in layer order — ``phase`` is ``"fp"`` /
        ``"ig"`` / ``"wg"``."""
        for i, layer in enumerate(self.layers):
            for phase, events in (("fp", layer.comm_fwd),
                                  ("ig", layer.comm_ig),
                                  ("wg", layer.comm_wg)):
                for ev in events:
                    yield i, layer, phase, ev

    def total_weight_bytes(self) -> int:
        return sum(ly.weight_bytes * ly.repeat for ly in self.layers)

    def total_activation_bytes(self) -> int:
        return sum(ly.act_out_bytes * ly.repeat for ly in self.layers)

    def activation_working_bytes(self) -> int:
        """Activation Working Memory (§IV-B): intermediates between two
        consecutive checkpoints ~= the largest single layer's activations."""
        return max((ly.act_out_bytes for ly in self.layers), default=0)

    def phase_cost(self, phase: str, sram_bytes: int) -> PhaseCost:
        total = PhaseCost()
        for ly in self.layers:
            c = ly.phase_cost(phase, sram_bytes)
            total = total + PhaseCost(c.flops * ly.repeat, c.traffic * ly.repeat)
        return total

    def total_flops(self, sram_bytes: int = 1 << 62) -> int:
        return sum(self.phase_cost(p, sram_bytes).flops for p in ("fp", "ig", "wg"))


# ====================================================================== #
# Transformer-family building blocks (paper Table II, + GQA extension)
# ====================================================================== #

def _shard(n: int, ways: int) -> int:
    """Per-node column count when a dimension is sharded ``ways``-way.

    The analytical model shards fractionally (ceil) even when not evenly
    divisible, as the paper's sub_ff / sub_vocab / per-node-heads terms do.
    (The runtime falls back to replication instead — parallel/sharding.py —
    which only matters for the measured dry-run path, not here.)"""
    if ways <= 1:
        return n
    return _ceil_div(n, ways)


def _attention_layer(
    name: str,
    cfg: ModelConfig,
    batch: int,
    seq_q: int,
    seq_kv: int,
    mp: int,
    d_in: Optional[int] = None,
    d_out: Optional[int] = None,
) -> LayerSpec:
    """Self/cross attention block: QKV proj, scores, context, out proj.

    MP sharding: heads split across MP (column-parallel QKV, row-parallel
    out-proj) -> one blocking all-reduce of the block output in FP and IG.
    Score/context GEMMs are per-sample per-head (Table II's M=b*seq,
    N=b*seq entry is read as the per-sample seq x seq GEMM batched over b).
    """
    d_model = cfg.d_model
    d_in = d_in or d_model
    d_out = d_out or d_model
    hd = cfg.resolved_head_dim
    h_local = _shard(cfg.num_heads, mp)
    kv_local = _shard(cfg.num_kv_heads, mp)
    tokens = batch * seq_q
    kv_tokens = batch * seq_kv
    spec = LayerSpec(name)
    # Projections
    spec.add_gemm(Gemm(tokens, d_in, h_local * hd))                 # Q
    spec.add_gemm(Gemm(kv_tokens, d_in, kv_local * hd))             # K
    spec.add_gemm(Gemm(kv_tokens, d_in, kv_local * hd))             # V
    # Scores + context, batched per (sample, local head) (no weights)
    bh = batch * h_local
    spec.add_gemm(Gemm(seq_q, hd, seq_kv, batch=bh), has_weight=False)
    spec.add_gemm(Gemm(seq_q, seq_kv, hd, batch=bh), has_weight=False)
    # Softmax (element-wise over scores)
    score_elems = bh * seq_q * seq_kv
    spec.fwd.append(ExplicitOp(flops=4 * score_elems,
                               bytes_moved=2 * score_elems * BYTES))
    spec.ig.append(ExplicitOp(flops=4 * score_elems,
                              bytes_moved=2 * score_elems * BYTES))
    # Out projection (row-parallel)
    spec.add_gemm(Gemm(tokens, h_local * hd, d_out))
    # Block output all-reduce across MP (Megatron "g"): blocking
    out_bytes = tokens * d_out * BYTES
    if mp > 1:
        spec.comm_fwd.append(CommEvent("all-reduce", out_bytes, "mp", blocking=True))
        spec.comm_ig.append(CommEvent("all-reduce", tokens * d_in * BYTES, "mp", blocking=True))
    spec.act_out_bytes = out_bytes + tokens * (h_local + 2 * kv_local) * hd * BYTES
    return spec


def _ffn_layer(name: str, cfg: ModelConfig, tokens: int, mp: int,
               d_ff: Optional[int] = None) -> LayerSpec:
    d_ff = d_ff or cfg.d_ff
    ff_local = _shard(d_ff, mp)
    spec = LayerSpec(name)
    spec.add_gemm(Gemm(tokens, cfg.d_model, ff_local))              # up
    if cfg.activation == "swiglu":
        spec.add_gemm(Gemm(tokens, cfg.d_model, ff_local))          # gate
        spec.fwd.append(ExplicitOp(flops=4 * tokens * ff_local,
                                   bytes_moved=3 * tokens * ff_local * BYTES))
    else:
        spec.fwd.append(ExplicitOp(flops=2 * tokens * ff_local,
                                   bytes_moved=2 * tokens * ff_local * BYTES))
    spec.add_gemm(Gemm(tokens, ff_local, cfg.d_model))              # down (row-par)
    out_bytes = tokens * cfg.d_model * BYTES
    if mp > 1:
        spec.comm_fwd.append(CommEvent("all-reduce", out_bytes, "mp", blocking=True))
        spec.comm_ig.append(CommEvent("all-reduce", out_bytes, "mp", blocking=True))
    spec.act_out_bytes = out_bytes + tokens * ff_local * BYTES
    return spec


def _norm_layer(name: str, cfg: ModelConfig, tokens: int) -> LayerSpec:
    spec = LayerSpec(name)
    nbytes = tokens * cfg.d_model * BYTES
    spec.fwd.append(ExplicitOp(flops=5 * tokens * cfg.d_model, bytes_moved=2 * nbytes))
    spec.ig.append(ExplicitOp(flops=8 * tokens * cfg.d_model, bytes_moved=3 * nbytes))
    spec.wg.append(ExplicitOp(flops=2 * tokens * cfg.d_model, bytes_moved=nbytes))
    spec.weight_bytes = cfg.d_model * BYTES
    spec.act_out_bytes = nbytes
    return spec


def _moe_layer(name: str, cfg: ModelConfig, tokens: int, mp: int,
               ep: int = 1) -> LayerSpec:
    """MoE FFN.

    With ``ep > 1``: experts shard over the dedicated EP mesh axis
    (requires num_experts % ep == 0); dispatch + combine are blocking
    all-to-alls over scope ``"ep"`` in FP and again in IG, and each local
    expert's d_ff additionally shards over MP (expert-TP) with the usual
    row-parallel all-reduce.  Expert weight bytes are flagged in
    ``expert_bytes`` so their gradients sync across DP only.

    With ``ep == 1`` (legacy rule, unchanged): EP-over-MP when
    num_experts % mp == 0 (experts spread over the MP group; two blocking
    all-to-alls in FP — dispatch + combine — and two in IG); expert-TP
    otherwise (each expert's d_ff sharded over MP; all-reduce like a dense
    FFN).  Matches parallel/sharding.py's runtime rule.
    """
    moe = cfg.moe
    assert moe is not None
    spec = LayerSpec(name)
    e = moe.num_experts
    mult = 3 if cfg.activation == "swiglu" else 2
    # Router (replicated)
    spec.add_gemm(Gemm(tokens, cfg.d_model, e))
    spec.fwd.append(ExplicitOp(flops=6 * tokens * e,
                               bytes_moved=2 * tokens * e * BYTES))
    routed = tokens * moe.top_k

    def expert_gemms(per_expert: int, d_ff: int, n_experts: int) -> None:
        """Up(+gate) and down GEMMs for n_experts local experts, batched
        (the weight-bytes accounting follows add_gemm's single-instance
        convention, shared by every branch)."""
        spec.add_gemm(Gemm(per_expert, cfg.d_model, d_ff,
                           batch=n_experts * (mult - 1)))
        spec.add_gemm(Gemm(per_expert, d_ff, cfg.d_model, batch=n_experts))

    def dispatch_a2a(size: float, scope: str) -> None:
        """Blocking dispatch + combine all-to-alls, in FP and again in IG."""
        for comm in (spec.comm_fwd, spec.comm_ig):
            comm.append(CommEvent("all-to-all", int(size), scope, True))
            comm.append(CommEvent("all-to-all", int(size), scope, True))

    def mp_allreduce(out_bytes: int) -> None:
        """Row-parallel expert output all-reduce (expert-TP within MP)."""
        if mp > 1:
            spec.comm_fwd.append(CommEvent("all-reduce", out_bytes, "mp", True))
            spec.comm_ig.append(CommEvent("all-reduce", out_bytes, "mp", True))

    if ep > 1:
        if e % ep:
            raise InfeasibleStrategyError(
                f"{name}: num_experts={e} is not divisible by ep={ep}")
        # Balanced routing: each node dispatches its `routed` tokens into
        # the EP all-to-all and receives ~capacity_factor x as many back.
        local_experts = e // ep
        local_tokens = int(routed * moe.capacity_factor)
        w0 = spec.weight_bytes
        expert_gemms(_ceil_div(local_tokens, max(local_experts, 1)),
                     _shard(moe.d_ff, mp), local_experts)
        spec.expert_bytes = spec.weight_bytes - w0
        dispatch_a2a(routed * cfg.d_model * BYTES, "ep")
        mp_allreduce(local_tokens * cfg.d_model * BYTES)
    elif (e % mp == 0) and mp > 1:
        # Legacy EP-over-MP: capacity-factor share of routed tokens.
        local_tokens = int(routed / mp * moe.capacity_factor)
        local_experts = e // mp
        expert_gemms(_ceil_div(local_tokens, max(local_experts, 1)),
                     moe.d_ff, local_experts)
        dispatch_a2a(routed * cfg.d_model * BYTES / mp, "mp")
    else:
        # Expert-TP: every expert's hidden dim sharded over MP.
        expert_gemms(_ceil_div(routed, e), _shard(moe.d_ff, mp), e)
        mp_allreduce(tokens * cfg.d_model * BYTES)
    if moe.shared_expert:
        ff_local = _shard(moe.shared_d_ff, mp)
        spec.add_gemm(Gemm(tokens, cfg.d_model, ff_local, batch=mult - 1))
        spec.add_gemm(Gemm(tokens, ff_local, cfg.d_model))
    spec.act_out_bytes = (routed + tokens) * cfg.d_model * BYTES
    return spec


def _ssm_layer(name: str, cfg: ModelConfig, tokens: int, mp: int) -> LayerSpec:
    """Mamba2 SSD block as chunked GEMMs (state-space duality).

    Heads shard over MP (in_proj column-parallel, out_proj row-parallel ->
    one blocking all-reduce per phase, like attention)."""
    ssm = cfg.ssm
    assert ssm is not None
    d = cfg.d_model
    n = ssm.state_dim
    p = ssm.head_dim
    heads = cfg.ssm_heads
    h_local = _shard(heads, mp)
    di_local = h_local * p
    lc = min(ssm.chunk_size, tokens)
    nchunks = _ceil_div(tokens, lc)
    spec = LayerSpec(name)
    # in_proj: z, x, B, C, dt  (column-parallel)
    n_in = 2 * di_local + 2 * ssm.ngroups * n + h_local
    spec.add_gemm(Gemm(tokens, d, n_in))
    # depthwise conv on (x, B, C)
    conv_ch = di_local + 2 * ssm.ngroups * n
    spec.fwd.append(ExplicitOp(flops=2 * tokens * conv_ch * ssm.conv_width,
                               bytes_moved=2 * tokens * conv_ch * BYTES))
    spec.ig.append(ExplicitOp(flops=4 * tokens * conv_ch * ssm.conv_width,
                              bytes_moved=3 * tokens * conv_ch * BYTES))
    # SSD chunked scan, per local head x chunk:
    #   G = C @ B^T            (lc x n) @ (n x lc)
    #   Y_intra = (G * L) @ X  (lc x lc) @ (lc x p)
    #   S = B^T @ X            (n x lc) @ (lc x p)     [state build]
    #   Y_inter = C @ S_prev   (lc x n) @ (n x p)      [state apply]
    bhc = h_local * nchunks
    spec.add_gemm(Gemm(lc, n, lc, batch=bhc), has_weight=False)
    spec.add_gemm(Gemm(lc, lc, p, batch=bhc), has_weight=False)
    spec.add_gemm(Gemm(n, lc, p, batch=bhc), has_weight=False)
    spec.add_gemm(Gemm(lc, n, p, batch=bhc), has_weight=False)
    # gated norm + out_proj (row-parallel)
    spec.fwd.append(ExplicitOp(flops=7 * tokens * di_local,
                               bytes_moved=3 * tokens * di_local * BYTES))
    spec.add_gemm(Gemm(tokens, di_local, d))
    out_bytes = tokens * d * BYTES
    if mp > 1:
        spec.comm_fwd.append(CommEvent("all-reduce", out_bytes, "mp", True))
        spec.comm_ig.append(CommEvent("all-reduce", out_bytes, "mp", True))
    spec.act_out_bytes = out_bytes + tokens * (n_in + di_local) * BYTES
    return spec


def _embedding_layers(cfg: ModelConfig, tokens: int, mp: int):
    """Vocab-parallel input lookup + output projection (Table II rows 1/14)."""
    sub_vocab = _shard(cfg.padded_vocab, mp)
    d = cfg.d_model
    inp = LayerSpec("input_embedding")
    inp.fwd.append(ExplicitOp(flops=0, bytes_moved=2 * tokens * d * BYTES))
    inp.wg.append(ExplicitOp(flops=tokens * d, bytes_moved=2 * tokens * d * BYTES))
    inp.weight_bytes = sub_vocab * d * BYTES
    inp.act_out_bytes = tokens * d * BYTES
    if mp > 1:
        # partial lookup (masked vocab shard) -> all-reduce of embeddings
        inp.comm_fwd.append(CommEvent("all-reduce", tokens * d * BYTES, "mp", True))
    out = LayerSpec("output_embedding")
    out.add_gemm(Gemm(tokens, d, sub_vocab))
    if cfg.tie_embeddings:
        out.weight_bytes = 0  # shared with input table
    # vocab-parallel softmax/CE: all-reduce of per-token scalars (fp32)
    if mp > 1:
        out.comm_fwd.append(CommEvent("all-reduce", tokens * 4, "mp", True))
        out.comm_ig.append(CommEvent("all-reduce", tokens * d * BYTES, "mp", True))
    out.act_out_bytes = tokens * sub_vocab * BYTES
    return inp, out


def _clone_layer(template: LayerSpec, name: str) -> LayerSpec:
    """A per-instance copy of a template layer.

    ``decompose`` builds each *distinct* layer shape once per strategy and
    stamps the repeated blocks out as clones: the op lists are immutable
    after construction and stay shared (the compiled lowering dedupes on
    exactly that identity), while the comm lists and the ``stage`` slot
    are per-instance — later passes append stage-boundary p2p and DP-grad
    events layer by layer."""
    return dataclasses.replace(
        template, name=name,
        comm_fwd=list(template.comm_fwd),
        comm_ig=list(template.comm_ig),
        comm_wg=list(template.comm_wg))


def _dp_grad_events(layers: Sequence[LayerSpec], dp: int, ep: int = 1) -> None:
    """Attach the WG-phase non-blocking DP gradient collectives (§III-C3).

    ZeRO-2 (os+g) distributes optimizer states and gradients across DP with
    no extra communication volume vs. a plain all-reduce (paper §IV-B), so
    the event stays an all-reduce of the per-node fp16 gradient bytes.

    With ``ep > 1`` dense (non-expert) weights are replicated across the
    whole DP x EP data group, so their gradients all-reduce over scope
    ``"dp"`` (which the collective model sizes as ``dp * ep``); expert
    weights are already EP-sharded and sync across DP only (``"edp"``)."""
    if dp * max(ep, 1) <= 1:
        return
    for ly in layers:
        dense = ly.weight_bytes - ly.expert_bytes
        if dense > 0:
            ly.comm_wg.append(
                CommEvent("all-reduce", dense, "dp", blocking=False))
        if ly.expert_bytes and dp > 1:
            ly.comm_wg.append(
                CommEvent("all-reduce", ly.expert_bytes, "edp", blocking=False))


# ====================================================================== #
# Pipeline-stage partitioning
# ====================================================================== #

def _layer_flops(ly: LayerSpec) -> int:
    """Stage-balancing cost: the layer's FLOPs through the same phase_cost
    accounting the simulator uses (sram irrelevant for the flops term)."""
    return sum(ly.phase_cost(p, 1 << 62).flops for p in ("fp", "ig", "wg"))


def _partition_stages(layers: List[LayerSpec], pp: int,
                      boundary_bytes: int) -> List[LayerSpec]:
    """Partition the layer stack into ``pp`` contiguous FLOP-balanced stages.

    Repeated layers (``repeat > 1``, the enc-dec stacks) are unrolled so a
    stack can straddle a stage boundary.  Each boundary gets a blocking
    point-to-point hidden-state transfer: the sending stage's last layer
    forwards activations in FP, the receiving stage's first layer returns
    the activation gradient in IG (both on scope ``"pp"``).
    """
    expanded: List[LayerSpec] = []
    for ly in layers:
        if ly.repeat == 1:
            expanded.append(ly)
        else:
            for _ in range(ly.repeat):
                expanded.append(dataclasses.replace(
                    ly, repeat=1,
                    comm_fwd=list(ly.comm_fwd), comm_ig=list(ly.comm_ig),
                    comm_wg=list(ly.comm_wg)))
    if pp > len(expanded):
        raise InfeasibleStrategyError(
            f"pp={pp} exceeds the {len(expanded)} partitionable layers")
    costs = [_layer_flops(ly) for ly in expanded]
    remaining = sum(costs)
    n = len(expanded)
    idx = 0
    for s in range(pp):
        stages_left = pp - s
        max_end = n - (stages_left - 1)   # leave >= 1 layer per later stage
        target = remaining / stages_left
        acc = 0
        j = idx
        while j < max_end:
            acc += costs[j]
            j += 1
            if acc >= target:
                break
        j = max(j, idx + 1)
        for k in range(idx, j):
            expanded[k].stage = s
        remaining -= acc
        idx = j
    for k in range(idx, n):              # numerical-edge leftovers
        expanded[k].stage = pp - 1
    stages = [[ly for ly in expanded if ly.stage == s] for s in range(pp)]
    for s in range(pp - 1):
        stages[s][-1].comm_fwd.append(
            CommEvent("p2p", boundary_bytes, "pp", blocking=True))
        stages[s + 1][0].comm_ig.append(
            CommEvent("p2p", boundary_bytes, "pp", blocking=True))
    return expanded


def _resolve_microbatches(num_microbatches: Optional[int],
                          shape: ShapeConfig, pp: int, b_local: int) -> int:
    """Microbatch count: explicit arg > shape knob > 4*pp heuristic, capped
    at the per-replica batch (a microbatch holds >= 1 sample)."""
    if pp <= 1:
        return 1
    m = num_microbatches or getattr(shape, "num_microbatches", 0) or 4 * pp
    return max(1, min(m, b_local))


# ====================================================================== #
# Public decompositions
# ====================================================================== #

def decompose(cfg: ModelConfig, shape: ShapeConfig, mp: int = 1, dp: int = 1,
              pp: int = 1, ep: int = 1,
              override_batch: Optional[int] = None,
              override_seq: Optional[int] = None,
              num_microbatches: Optional[int] = None,
              schedule: str = "1f1b",
              virtual_stages: Optional[int] = None) -> Workload:
    """ModelConfig + shape + (MP, DP, PP, EP) -> per-node Workload.

    ``pp=1, ep=1`` (the defaults) reproduce the pre-PP/EP decomposition
    bit-for-bit; see the module docstring for the four-axis semantics.
    ``schedule="interleaved"`` models Megatron-LM's interleaved 1F1B:
    each node runs ``virtual_stages`` (default 2) non-contiguous model
    chunks, shrinking the pipeline bubble to (pp-1)/(v*m + pp-1) at the
    price of v-fold stage-boundary p2p volume (charged here)."""
    for axis, v in (("mp", mp), ("dp", dp), ("pp", pp), ("ep", ep)):
        if v < 1:
            raise ValueError(f"{axis} must be >= 1, got {v}")
    if schedule not in ("gpipe", "1f1b", "interleaved"):
        raise ValueError(f"schedule must be 'gpipe', '1f1b' or "
                         f"'interleaved', got {schedule!r}")
    if virtual_stages is not None and virtual_stages < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {virtual_stages}")
    if schedule == "interleaved":
        vstages = virtual_stages if virtual_stages is not None else 2
    else:
        vstages = 1                # the knob is interleaved-only
    if pp <= 1:                    # no pipeline: schedule has no effect
        schedule, vstages = "1f1b", 1
    batch = override_batch if override_batch is not None else shape.global_batch
    seq = override_seq if override_seq is not None else shape.seq_len
    # Non-expert layers see the EP group as extra data parallelism.
    b_local = max(1, batch // max(dp * ep, 1))
    decode = shape.kind == "decode"
    # Decode: one new query token per sample attending to a seq-long cache.
    seq_q = 1 if decode else seq
    layers: List[LayerSpec] = []

    if cfg.family == "encdec":
        assert cfg.encdec is not None
        src = int(seq * cfg.encdec.source_frac)
        tgt = seq - src
        tgt_q = 1 if decode else tgt
        t_src, t_tgt = b_local * src, b_local * tgt_q
        inp, out = _embedding_layers(cfg, t_tgt, mp)
        layers.append(inp)
        if not decode:  # decode reuses the precomputed encoder output
            enc = [
                _norm_layer("enc_norm", cfg, t_src),
                _attention_layer("enc_self_attn", cfg, b_local, src, src, mp),
                _ffn_layer("enc_ffn", cfg, t_src, mp),
            ]
            for ly in enc:
                ly.repeat = cfg.encdec.encoder_layers
            layers += enc
        dec = [
            _norm_layer("dec_norm", cfg, t_tgt),
            _attention_layer("dec_self_attn", cfg, b_local, tgt_q, tgt, mp),
            _attention_layer("dec_cross_attn", cfg, b_local, tgt_q, src, mp),
            _ffn_layer("dec_ffn", cfg, t_tgt, mp),
        ]
        for ly in dec:
            ly.repeat = cfg.encdec.decoder_layers
        layers += dec
        layers.append(out)
    else:
        eff_seq, eff_q = seq, seq_q
        if cfg.family == "vlm":
            assert cfg.vision is not None
            eff_seq = seq + cfg.vision.num_patches
            eff_q = 1 if decode else eff_seq
        tokens = b_local * eff_q
        inp, out = _embedding_layers(cfg, tokens, mp)
        layers.append(inp)
        # The block stack repeats a handful of distinct layer shapes; build
        # each shape once and stamp the stack out as clones (identical
        # content — the decompose goldens fingerprint every op dim — at a
        # fraction of the construction cost; this is the strategy-side
        # half of a study cell, so it is squarely on the hot path).
        templates: dict = {}

        def stamp(key: str, name: str, build) -> LayerSpec:
            t = templates.get(key)
            if t is None:
                t = templates[key] = build()
            return _clone_layer(t, name)

        for i in range(cfg.num_layers):
            if cfg.family in ("ssm", "hybrid"):
                layers.append(stamp(
                    "norm", f"norm_{i}",
                    lambda: _norm_layer("norm", cfg, tokens)))
                layers.append(stamp(
                    "ssm", f"ssm_{i}",
                    lambda: _ssm_layer("ssm", cfg, tokens, mp)))
                if (cfg.family == "hybrid" and cfg.hybrid is not None
                        and (i + 1) % cfg.hybrid.attn_every == 0):
                    d_in = (2 * cfg.d_model
                            if cfg.hybrid.attn_concat_embedding else cfg.d_model)
                    layers.append(stamp(
                        "shared_attn", f"shared_attn_{i}",
                        lambda: _attention_layer(
                            "shared_attn", cfg, b_local, eff_q, eff_seq, mp,
                            d_in=d_in, d_out=cfg.d_model)))
            elif cfg.family == "moe":
                assert cfg.moe is not None
                layers.append(stamp(
                    "norm", f"norm_attn_{i}",
                    lambda: _norm_layer("norm", cfg, tokens)))
                layers.append(stamp(
                    "attn", f"attn_{i}",
                    lambda: _attention_layer(
                        "attn", cfg, b_local, eff_q, eff_seq, mp)))
                layers.append(stamp(
                    "norm", f"norm_ffn_{i}",
                    lambda: _norm_layer("norm", cfg, tokens)))
                is_moe = (i % cfg.moe.moe_every) == (cfg.moe.moe_every - 1)
                if is_moe:
                    layers.append(stamp(
                        "moe", f"moe_{i}",
                        lambda: _moe_layer("moe", cfg, tokens, mp, ep)))
                else:
                    layers.append(stamp(
                        "ffn", f"ffn_{i}",
                        lambda: _ffn_layer("ffn", cfg, tokens, mp)))
            else:  # dense / vlm
                layers.append(stamp(
                    "norm", f"norm_attn_{i}",
                    lambda: _norm_layer("norm", cfg, tokens)))
                layers.append(stamp(
                    "attn", f"attn_{i}",
                    lambda: _attention_layer(
                        "attn", cfg, b_local, eff_q, eff_seq, mp)))
                layers.append(stamp(
                    "norm", f"norm_ffn_{i}",
                    lambda: _norm_layer("norm", cfg, tokens)))
                layers.append(stamp(
                    "ffn", f"ffn_{i}",
                    lambda: _ffn_layer("ffn", cfg, tokens, mp)))
        layers.append(out)

    if pp > 1:
        # Boundary tensor between stages: the per-replica hidden state of
        # the trunk (decoder trunk for enc-dec).
        if cfg.family == "encdec":
            tgt = seq - int(seq * cfg.encdec.source_frac)
            boundary_tokens = b_local * (1 if decode else tgt)
        else:
            boundary_tokens = b_local * (1 if decode else seq)
            if cfg.family == "vlm":
                assert cfg.vision is not None
                boundary_tokens = b_local * (
                    1 if decode else seq + cfg.vision.num_patches)
        # Interleaved 1F1B: every microbatch crosses each node boundary
        # once per virtual-stage chunk -> v-fold p2p volume.
        layers = _partition_stages(
            layers, pp, boundary_tokens * cfg.d_model * BYTES * vstages)
    _dp_grad_events(layers, dp, ep)
    suffix = f"_pp{pp}_ep{ep}" if (pp > 1 or ep > 1) else ""
    return Workload(
        name=f"{cfg.arch_id}@{shape.name}[mp{mp}_dp{dp}{suffix}]",
        layers=layers, mp=mp, dp=dp, pp=pp, ep=ep,
        num_microbatches=_resolve_microbatches(num_microbatches, shape,
                                               pp, b_local),
        schedule=schedule, virtual_stages=vstages,
        per_replica_batch=b_local, seq_len=seq,
    )


def decompose_dlrm(dlrm_cfg, global_batch: int, nodes: int) -> Workload:
    """DLRM hybrid strategy (§V-C, Rashidi et al.): embedding tables sharded
    across all nodes (table-wise MP, all-to-all FP/IG), MLPs data-parallel
    (all-reduce WG)."""
    b_local = max(1, global_batch // nodes)
    e = dlrm_cfg.emb_dim
    layers: List[LayerSpec] = []

    # Embedding lookup: each node owns tables/nodes tables, does lookups for
    # the *global* batch on its shard, then all-to-alls pooled vectors.
    local_tables = max(1, dlrm_cfg.num_tables // nodes) \
        if dlrm_cfg.num_tables >= nodes else dlrm_cfg.num_tables / nodes
    emb = LayerSpec("embedding_lookup")
    lookup_rows = int(global_batch * local_tables * dlrm_cfg.lookups_per_table)
    emb.fwd.append(ExplicitOp(flops=lookup_rows * e,  # pooled sum
                              bytes_moved=2 * lookup_rows * e * 4))
    emb.wg.append(ExplicitOp(flops=lookup_rows * e,
                             bytes_moved=2 * lookup_rows * e * 4))
    emb.weight_bytes = int(local_tables * dlrm_cfg.rows_per_table * e * 4)
    # Sparse row-wise Adagrad: only touched rows are updated.
    emb.optim_bytes = int(lookup_rows * e * 12)
    a2a = int(global_batch * local_tables * e * 4)
    # DLRM's node group is consecutive ranks (fills pods first) -> "mp" scope.
    emb.comm_fwd.append(CommEvent("all-to-all", a2a, "mp", blocking=True))
    emb.comm_ig.append(CommEvent("all-to-all", a2a, "mp", blocking=True))
    emb.act_out_bytes = a2a
    layers.append(emb)

    def _mlp(name: str, dims: Sequence[int]) -> None:
        for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            spec = LayerSpec(f"{name}_{j}")
            spec.add_gemm(Gemm(b_local, a, b, bytes_per_element=4))
            spec.act_out_bytes = b_local * b * 4
            layers.append(spec)

    _mlp("bottom_mlp", (dlrm_cfg.num_dense_features,) + dlrm_cfg.bottom_mlp)
    n_feat = dlrm_cfg.num_tables + 1
    interact = LayerSpec("feature_interaction")
    interact.fwd.append(ExplicitOp(
        flops=2 * b_local * n_feat * n_feat * e,
        bytes_moved=2 * b_local * n_feat * e * 4))
    interact.ig.append(ExplicitOp(
        flops=4 * b_local * n_feat * n_feat * e,
        bytes_moved=3 * b_local * n_feat * e * 4))
    interact.act_out_bytes = b_local * (n_feat * (n_feat - 1) // 2) * 4
    layers.append(interact)
    top_in = n_feat * (n_feat - 1) // 2 + dlrm_cfg.bottom_mlp[-1]
    _mlp("top_mlp", (top_in,) + dlrm_cfg.top_mlp)

    # DP all-reduce for MLP grads only (tables update locally).
    for ly in layers:
        if ly.weight_bytes and not ly.name.startswith("embedding"):
            ly.comm_wg.append(CommEvent("all-reduce", ly.weight_bytes, "mp", False))

    return Workload(name=f"{dlrm_cfg.arch_id}[n{nodes}]", layers=layers,
                    mp=nodes, dp=nodes, per_replica_batch=b_local,
                    seq_len=1)
