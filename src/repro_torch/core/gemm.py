"""COMET §III-A / §III-C2: GEMM workload primitives and the memory-traffic model.

The port's copy of the JAX package's ``core/gemm.py``. Every model layer is
a GEMM between input activations (M x K) and weights (K x N), or an
explicit op with stated FLOPs and bytes moved (embedding lookups,
element-wise ops). The memory traffic of a GEMM on a node with an on-chip
buffer of S bytes is the paper's linear tiling estimate:

    traffic = min(Psi_1, Psi_2) + W
    Psi_1   = ceil(U / S) * V + U        # tile operand U, stream V
    Psi_2   = ceil(V / S) * U + V        # tile operand V, stream U

where U, V are the input operand sizes in bytes and W the output size.
"""

from __future__ import annotations

import dataclasses
import math

def gemm_traffic_bytes(u: int, v: int, w: int, sram_bytes: int) -> int:
    """Paper Eqn (traffic): min{Psi1, Psi2} + W for on-chip buffer S."""
    if u == 0 or v == 0:
        return u + v + w
    s = max(int(sram_bytes), 1)
    psi1 = math.ceil(u / s) * v + u
    psi2 = math.ceil(v / s) * u + v
    return min(psi1, psi2) + w


@dataclasses.dataclass(frozen=True)
class Gemm:
    """One (M x K) @ (K x N) GEMM; ``batch`` repeats it (e.g. per-head)."""

    m: int
    k: int
    n: int
    batch: int = 1
    bytes_per_element: int = 2  # bf16/fp16 compute

    def flops(self) -> int:
        return 2 * self.batch * self.m * self.k * self.n

    @property
    def a_bytes(self) -> int:
        return self.batch * self.m * self.k * self.bytes_per_element

    @property
    def b_bytes(self) -> int:
        return self.batch * self.k * self.n * self.bytes_per_element

    @property
    def out_bytes(self) -> int:
        return self.batch * self.m * self.n * self.bytes_per_element

    def traffic(self, sram_bytes: int) -> int:
        # Each batch instance is tiled independently (per-head working sets).
        per = gemm_traffic_bytes(
            self.m * self.k * self.bytes_per_element,
            self.k * self.n * self.bytes_per_element,
            self.m * self.n * self.bytes_per_element,
            sram_bytes,
        )
        return self.batch * per

    def transposed_for_ig(self) -> "Gemm":
        """Input-gradient GEMM: dX = dY @ W^T -> (M x N) @ (N x K)."""
        return Gemm(self.m, self.n, self.k, self.batch, self.bytes_per_element)

    def transposed_for_wg(self) -> "Gemm":
        """Weight-gradient GEMM: dW = X^T @ dY -> (K x M) @ (M x N)."""
        return Gemm(self.k, self.m, self.n, self.batch, self.bytes_per_element)


@dataclasses.dataclass(frozen=True)
class ExplicitOp:
    """Non-GEMM op: embedding lookup, element-wise, softmax, conv, ...

    Encoded per §III-A by its FLOPs and the bytes moved between memory and
    the compute unit (no tiling model — these ops are streaming).
    """

    flops: int
    bytes_moved: int

    def traffic(self, sram_bytes: int) -> int:  # noqa: ARG002 (streaming)
        return self.bytes_moved


@dataclasses.dataclass(frozen=True)
class PhaseCost:
    """Aggregate FLOPs + traffic of one layer in one training phase."""

    flops: int = 0
    traffic: int = 0

    def __add__(self, other: "PhaseCost") -> "PhaseCost":
        return PhaseCost(self.flops + other.flops, self.traffic + other.traffic)

    @property
    def operational_intensity(self) -> float:
        """OI (FLOPs/byte), paper Eqn (1)."""
        if self.traffic == 0:
            return float("inf")
        return self.flops / self.traffic


def phase_cost(op, sram_bytes: int) -> PhaseCost:
    """PhaseCost of a single Gemm/ExplicitOp on a node with buffer S."""
    if isinstance(op, Gemm):
        return PhaseCost(op.flops(), op.traffic(sram_bytes))
    if isinstance(op, ExplicitOp):
        return PhaseCost(op.flops, op.bytes_moved)
    raise TypeError(f"unknown op type {type(op)!r}")


@dataclasses.dataclass(frozen=True)
class CommEvent:
    """One collective issued by a layer in a phase.

    scope: which mesh dimension the collective spans —
      "mp" (model-parallel group),
      "dp" (data-parallel group; spans DP x EP when an EP axis exists),
      "ep" (expert-parallel group; with ep == 1 it maps onto the mp group),
      "pp" (pipeline axis: the stage-boundary "p2p" transfers),
      "edp" (expert-gradient group: DP only, experts being EP-sharded).
    blocking: True -> on the critical path (FP/IG MP collectives);
              False -> overlappable with compute (WG DP collectives).
    """

    collective: str  # all-reduce | all-gather | reduce-scatter | all-to-all | p2p
    size_bytes: int
    scope: str
    blocking: bool

    def scaled(self, factor: float) -> "CommEvent":
        return dataclasses.replace(self, size_bytes=int(self.size_bytes * factor))
