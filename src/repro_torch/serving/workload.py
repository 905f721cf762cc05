"""Analytic serving-replica model: prefill/decode roofline phases + KV memory.

The port's copy of the JAX package's ``serving/workload.py``, held to it
value for value by ``tests/test_torch_serving.py``.

One *replica* is ``nodes_per_replica`` nodes holding a full copy of the
model and up to ``max_batch`` KV-cache slots, running the static-slot
continuous-batching loop of :mod:`repro_torch.serve.engine`: each tick admits
queued requests into free slots (one single-sequence prefill each, which
stalls the whole batch) and then runs one decode step for every active
slot.

The two phases sit on opposite ends of the roofline:

* **prefill** — one request's prompt as M = prompt_len GEMMs; high
  operational intensity, compute-bound on every registry node;
* **decode** — one token per active slot (M = batch GEMMs) plus the KV
  reads (``context * kv_bytes_per_token`` per slot per tick); OI of order
  the batch size, memory-bandwidth-bound until the slots fill up — the
  utilization axis.

KV-cache footprint is the memory axis: ``2 * L * S * H_kv * d * bytes``
per slot (k and v, every layer, ``max_seq`` positions), gated like
:mod:`repro_torch.core.memory` gates training footprints — against
``total_cap`` including expanded-memory pods, with the decode roofline
slope degraded by :func:`repro_torch.core.memory.effective_memory_bw` when the
working set spills past local HBM.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cluster import NodeConfig
from repro_torch.core.gemm import ExplicitOp, Gemm, PhaseCost, phase_cost
from repro_torch.core.memory import FootprintReport, effective_memory_bw
from repro_torch.core.roofline import RooflinePoint, compute_delay


@dataclasses.dataclass(frozen=True)
class ServingModel:
    """The sweepable serving knobs (dotted-path axes resolve here).

    ``kv_bytes`` overrides the per-token per-slot KV-cache bytes derived
    from the model config (``2 * L * H_kv * d * bytes_per_element``);
    0 means derive.  ``nodes_per_replica`` spreads one replica's weights
    and KV slots over several nodes (tensor-parallel serving); phase
    times assume the shards run in parallel."""

    max_batch: int = 16
    max_seq: int = 2048
    prompt_len: int = 512
    max_new_tokens: int = 64
    bytes_per_element: int = 2
    kv_bytes: float = 0.0
    nodes_per_replica: int = 1

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.nodes_per_replica < 1:
            raise ValueError("nodes_per_replica must be >= 1, "
                             f"got {self.nodes_per_replica}")
        if self.prompt_len + self.max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt_len {self.prompt_len} + max_new_tokens "
                f"{self.max_new_tokens} exceeds max_seq {self.max_seq}")


@dataclasses.dataclass(frozen=True)
class TickTrace:
    """The engine-shaped schedule of one replica draining a request list:
    how many prefills ran, how many decode ticks, and the batch occupancy
    of each — the structure ``tests/test_torch_serving.py`` and
    ``chip_smoke.py``'s ``serve`` phase lock against
    :class:`repro_torch.serve.engine.Engine`."""

    occupancy: Tuple[int, ...]          # active slots at each decode tick
    admitted: Tuple[int, ...]           # prefills folded into each tick
    prefills: int

    @property
    def ticks(self) -> int:
        return len(self.occupancy)


Op = Union[Gemm, ExplicitOp]


class ServingWorkload:
    """Roofline-priced analytic model of one serving replica."""

    def __init__(self, cfg: ModelConfig, serving: ServingModel) -> None:
        self.cfg = cfg
        self.serving = serving

    # -- memory axis ---------------------------------------------------- #
    @property
    def kv_bytes_per_token(self) -> float:
        """Per-slot KV bytes for one cached position: 2 (k and v) * L *
        H_kv * d * bytes, or the ``serving.kv_bytes`` override."""
        if self.serving.kv_bytes > 0:
            return self.serving.kv_bytes
        cfg = self.cfg
        return float(2 * cfg.num_layers * cfg.num_kv_heads
                     * cfg.resolved_head_dim * self.serving.bytes_per_element)

    @property
    def kv_slot_bytes(self) -> float:
        """Full per-slot KV footprint: the engine allocates ``max_seq``
        positions per slot up front (static slots, no paging)."""
        return self.kv_bytes_per_token * self.serving.max_seq

    @property
    def weight_bytes(self) -> float:
        return float(self.cfg.param_count()) * self.serving.bytes_per_element

    def kv_bytes_for(self, tokens: int) -> float:
        """KV bytes actually written for ``tokens`` cached positions (the
        prefill->decode transfer size under disaggregation)."""
        return self.kv_bytes_per_token * tokens

    def replica_bytes(self, batch: Optional[int] = None) -> float:
        """Per-node working set: this node's shard of the weights plus its
        share of ``batch`` full KV slots."""
        b = self.serving.max_batch if batch is None else batch
        return (self.weight_bytes + b * self.kv_slot_bytes) \
            / self.serving.nodes_per_replica

    def slots_that_fit(self, node: NodeConfig) -> int:
        """How many KV slots a replica on ``node`` can actually hold
        (capped at ``max_batch``), gating against ``total_cap`` so
        expanded-memory pods count their pool."""
        free = node.total_cap * self.serving.nodes_per_replica \
            - self.weight_bytes
        if free < self.kv_slot_bytes:
            return 0
        return min(self.serving.max_batch, int(free // self.kv_slot_bytes))

    def fits(self, node: NodeConfig) -> bool:
        return self.slots_that_fit(node) >= 1

    def replica_report(self, node: NodeConfig,
                       batch: Optional[int] = None) -> FootprintReport:
        """``memory``-style feasibility report for one replica node:
        model states = the weight shard, working memory = the KV slots."""
        b = self.serving.max_batch if batch is None else batch
        npr = self.serving.nodes_per_replica
        states = self.weight_bytes / npr
        kv = b * self.kv_slot_bytes / npr
        total = states + kv
        return FootprintReport(states, kv, total,
                               fits_local=total <= node.local_cap,
                               fits_total=total <= node.total_cap)

    # -- phase costs ---------------------------------------------------- #
    @property
    def decode_steps(self) -> int:
        """Decode ticks one request occupies a slot for.  Mirrors the
        engine: prefill emits the first token and sets ``remaining =
        max_new_tokens - 1``; the next tick always decodes once before
        checking, so a one-token request still costs one decode tick."""
        return max(1, self.serving.max_new_tokens - 1)

    @property
    def mean_context(self) -> int:
        """Expected cached context mid-generation."""
        ctx = self.serving.prompt_len + self.decode_steps // 2
        return min(ctx, self.serving.max_seq)

    def _linear_ops(self, m: int) -> List[Op]:
        """The per-layer projection/FFN GEMMs for ``m`` token rows, plus
        the LM head — everything except attention itself."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        bpe = self.serving.bytes_per_element
        qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
        per_layer: List[Op] = [
            Gemm(m, cfg.d_model, qkv_out, bytes_per_element=bpe),
            Gemm(m, cfg.num_heads * hd, cfg.d_model, bytes_per_element=bpe),
        ]
        ffn_mats = 3 if cfg.activation == "swiglu" else 2
        up = ffn_mats - 1
        per_layer += [Gemm(m, cfg.d_model, cfg.d_ff, bytes_per_element=bpe)
                      for _ in range(up)]
        per_layer += [Gemm(m, cfg.d_ff, cfg.d_model, bytes_per_element=bpe)]
        ops: List[Op] = per_layer * cfg.num_layers
        ops.append(Gemm(m, cfg.d_model, cfg.vocab_size, bytes_per_element=bpe))
        return ops

    def prefill_ops(self, prompt_len: Optional[int] = None) -> List[Op]:
        """One request's prompt pass: M = prompt_len GEMMs plus the
        quadratic attention score/value GEMMs per head per layer."""
        cfg = self.cfg
        s = self.serving.prompt_len if prompt_len is None else prompt_len
        hd = cfg.resolved_head_dim
        bpe = self.serving.bytes_per_element
        ops = self._linear_ops(s)
        ops += [Gemm(s, hd, s, batch=cfg.num_heads, bytes_per_element=bpe),
                Gemm(s, s, hd, batch=cfg.num_heads, bytes_per_element=bpe)
                ] * cfg.num_layers
        return ops

    def decode_ops(self, batch: int,
                   context: Optional[int] = None) -> List[Op]:
        """One decode tick for ``batch`` active slots: M = batch GEMMs
        (weights stream once per tick) plus the per-slot KV reads, priced
        through ``kv_bytes_per_token`` so a ``serving.kv_bytes`` sweep
        moves footprint and decode traffic coherently."""
        cfg = self.cfg
        ctx = self.mean_context if context is None else context
        ops = self._linear_ops(batch)
        attn_flops = 4 * batch * cfg.num_heads * cfg.resolved_head_dim * ctx
        kv_read = batch * ctx * self.kv_bytes_per_token / cfg.num_layers
        ops += [ExplicitOp(attn_flops, int(kv_read))] * cfg.num_layers
        return ops

    def _cost(self, ops: Sequence[Op], node: NodeConfig) -> PhaseCost:
        total = PhaseCost()
        npr = self.serving.nodes_per_replica
        for op in ops:
            total = total + phase_cost(op, int(node.sram_bytes))
        if npr > 1:  # shards run in parallel across the replica's nodes
            total = PhaseCost(total.flops // npr, total.traffic // npr)
        return total

    def prefill_point(self, node: NodeConfig,
                      prompt_len: Optional[int] = None) -> RooflinePoint:
        return compute_delay(self._cost(self.prefill_ops(prompt_len), node),
                             node)

    def decode_point(self, node: NodeConfig, batch: int,
                     context: Optional[int] = None,
                     mem_bw: Optional[float] = None) -> RooflinePoint:
        """Roofline point of one decode tick at ``batch`` occupancy.  The
        slope defaults to :func:`effective_memory_bw` at the replica's
        working set, so slots spilling into expanded memory slow every
        tick — the capacity/bandwidth trade the EM studies sweep."""
        if mem_bw is None:
            mem_bw = effective_memory_bw(node, self.replica_bytes(batch))
        return compute_delay(self._cost(self.decode_ops(batch, context),
                                        node), node, mem_bw=mem_bw)

    def prefill_time(self, node: NodeConfig,
                     prompt_len: Optional[int] = None) -> float:
        return self.prefill_point(node, prompt_len).delay

    def decode_time(self, node: NodeConfig, batch: int,
                    context: Optional[int] = None) -> float:
        return self.decode_point(node, batch, context).delay

    def decode_curve(self, node: NodeConfig,
                     max_batch: Optional[int] = None) -> Tuple[float, ...]:
        """Tick time at every occupancy 1..max_batch (the utilization
        axis, ready for the fleet queue)."""
        b = self.serving.max_batch if max_batch is None else max_batch
        return tuple(self.decode_time(node, i) for i in range(1, b + 1))

    # -- engine-shaped schedule ----------------------------------------- #
    def engine_schedule(self, num_requests: int,
                        new_tokens: Optional[Sequence[int]] = None,
                        max_batch: Optional[int] = None) -> TickTrace:
        """Mirror the :class:`repro_torch.serve.engine.Engine` tick loop exactly
        (FIFO admission into free slots, one decode step for all active
        slots per tick, retire at ``remaining <= 0``) for a backlog of
        ``num_requests`` requests all queued up front.  ``new_tokens``
        gives per-request ``max_new_tokens`` (default: the workload's)."""
        cap = self.serving.max_batch if max_batch is None else max_batch
        budgets = [max(1, n - 1) for n in (
            new_tokens if new_tokens is not None
            else [self.serving.max_new_tokens] * num_requests)]
        queue = list(range(len(budgets)))
        active: dict[int, int] = {}          # slot -> remaining decode ticks
        occupancy: List[int] = []
        admitted: List[int] = []
        prefills = 0
        while queue or active:
            admit_now = 0
            for slot in range(cap):
                if slot in active or not queue:
                    continue
                active[slot] = budgets[queue.pop(0)]
                prefills += 1
                admit_now += 1
            occupancy.append(len(active))
            admitted.append(admit_now)
            for slot in list(active):
                active[slot] -= 1
                if active[slot] <= 0:
                    del active[slot]
        return TickTrace(tuple(occupancy), tuple(admitted), prefills)

    def schedule_time(self, trace: TickTrace, node: NodeConfig) -> float:
        """Roofline wall-clock of an engine-shaped schedule: every prefill
        stalls the batch, every tick decodes at its occupancy."""
        curve = self.decode_curve(node, max_batch=max(trace.occupancy,
                                                      default=1))
        pre = self.prefill_time(node)
        return trace.prefills * pre + sum(curve[occ - 1]
                                          for occ in trace.occupancy if occ)
