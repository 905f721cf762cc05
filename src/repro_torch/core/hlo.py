"""Measured-frontend COMET: roofline terms from the port's own counted step.

Counterpart of ``src/repro/core/hlo.py``. The paper estimates FLOPs and
bytes analytically (§III-C1, Eqns 1-2); this frontend feeds the *same*
roofline arithmetic with what the real program does:

    compute term    = FLOPs / (chips * peak_FLOP/s)
    memory term     = HBM_bytes / (chips * HBM_bw)
    collective term = collective_bytes / (chips * link_bw)

The reference reads them from an XLA executable compiled for a TPU
(``cost_analysis()`` and the HLO text). Here the op counter
(``core/op_counter.py``) counts them from the port's eager step as
PyTorch's dispatcher runs it: on ``meta`` tensors over a fake process group
for a mesh this machine is not (``launch/dryrun.py``), or on the card,
where the counted terms can be held against the step's measured time.

The default rates are one H100 SXM's published dense figures, not COMET's
modelled clusters (``core/cluster.py``'s ``_H100`` holds Table III's
sparse 1979e12, an input of the paper's model, not this card's roofline):
3.35 TB/s of HBM, 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32
(cuBLAS runs fp32 products without TF32 here), 450 GB/s of NVLink 4 a
direction a GPU. A caller passes the peak of its step's compute dtype
(``PEAK_FLOPS``). NVLink joins the 8 GPUs of one node only: a 256- or
512-GPU mesh crosses nodes, whose links are slower, so there the collective
term is a lower bound.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

H100_HBM_BW = 3.35e12            # bytes/s
H100_BF16_FLOPS = 989e12         # dense, tensor cores
H100_FP32_FLOPS = 67e12          # outside the tensor cores
H100_NVLINK_BW = 450e9           # bytes/s a direction a GPU (NVLink 4)

PEAK_FLOPS = {torch.bfloat16: H100_BF16_FLOPS, torch.float32: H100_FP32_FLOPS}

# The reference's opcodes, the keys of every collective breakdown.
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(coll: Mapping[str, float]) -> Dict[str, int]:
    """A counter's collective record (bytes of the output shape a call, per
    device, by opcode) -> every opcode of ``COLLECTIVES`` and its sum."""
    return {op: int(coll.get(op, 0)) for op in COLLECTIVES}


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Per-device roofline terms (seconds) for one counted step."""

    flops: float                   # total FLOPs (all devices)
    hbm_bytes: float               # total bytes accessed
    coll_bytes: float              # total collective bytes
    chips: int
    peak_flops: float = H100_BF16_FLOPS
    hbm_bw: float = H100_HBM_BW
    link_bw: float = H100_NVLINK_BW
    coll_breakdown: Optional[Dict[str, int]] = None

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * self.hbm_bw)

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / (self.chips * self.link_bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """Fraction of the step bound spent in useful compute: how close the
        dominant term sits to the pure-compute roofline."""
        if self.bound_s == 0:
            return 0.0
        return self.compute_s / self.bound_s

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "roofline_fraction": self.roofline_fraction(),
        }


def terms_from_counts(cost, chips: int, **hw_overrides) -> RooflineTerms:
    """RooflineTerms from an op counter's per-device ``Cost``
    (``core/op_counter.py``), multiplied by the chip count as the
    reference multiplies its per-device HLO costs. ``hw_overrides``:
    ``peak_flops``, ``hbm_bw``, ``link_bw``."""
    coll = collective_bytes(cost.coll)
    return RooflineTerms(flops=float(cost.flops) * chips,
                         hbm_bytes=float(cost.bytes) * chips,
                         coll_bytes=float(sum(coll.values())) * chips,
                         chips=chips, coll_breakdown=coll, **hw_overrides)


def model_flops_util(model_flops: float, terms: RooflineTerms) -> float:
    """MODEL_FLOPS / counted FLOPs — how much of the counted compute is
    useful (catches remat/redundancy waste)."""
    if terms.flops == 0:
        return 0.0
    return model_flops / terms.flops
