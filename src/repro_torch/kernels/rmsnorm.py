"""RMSNorm: the plain PyTorch version and the launch of the CUDA kernel.

Counterpart of ``src/repro/kernels/rmsnorm.py``. Both functions compute
``x * rsqrt(mean(x^2, -1) + eps) * gamma`` in fp32 and round once into
``x.dtype``. The backward (for training; the JAX package has no Pallas
backward, ``jax.grad`` of ``models/common.py``'s ``rms_norm`` is its oracle)
gives ``dx`` and ``dgamma`` in fp32, each rounded once into its type.

On the card the backward runs ``BACKWARD_STAGES``, one kernel each, on the
launch plan of ``rmsnorm_backward_plan`` (a function of rows, d and dtype
alone, so every call at a shape sums dgamma in the same order):

    rows    a team of ``team_warps`` warps owns a row at a time, each lane
            ``lane_units`` 16-byte units of it in registers; block b walks
            rows [b rows_per_block, (b + 1) rows_per_block), its team t rows
            t, t + teams, ... of them in order; dx, and the block's partial
            row of dgamma (its teams' register sums added in team order)
            into ``part`` (blocks, units * per) fp32
    dgamma  per column, warp w of 8 adds partial rows w, w + 8, ... in
            order, then the 8 sums in order
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW_BYTES = 232448 // 4   # four rows share one block's shared memory

BACKWARD_STAGES = ("rows", "dgamma")
BACKWARD_KERNELS_PER_CALL = len(BACKWARD_STAGES)
# The backward's plan on an H100 (132 SMs): a team is the fewest warps (up
# to 8) whose lanes hold a row in registers with room for the next row's
# loads (the widest rows, d <= _BWD_MAX_D, take up to 16 fp32 / 8 bf16
# units a lane, without); a block is up to 8 warps, fewer where the rows are
# too few to give every SM a block, and the grid at most one wave of the
# blocks an SM holds (``_bwd_registers``).
_SMS = 132
_BWD_MAX_WARPS = 8            # a block, and a team
_BWD_MAX_D = 16384


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); gamma: (d,). Plain PyTorch, any device; fp32 inside
    (fp64 for fp64 inputs)."""
    wt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(wt)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.to(wt)).to(x.dtype)


def forward_work(rows: int, d: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(flops, bytes) of one forward call over ``rows`` rows of ``d``: x
    read and the output written once, gamma read once; 4 flops an element
    (square, sum, scale, gain)."""
    return 4 * rows * d, (2 * rows * d + d) * dtype.itemsize


def backward_work(rows: int, d: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(flops, bytes) of one backward call: x, dy read and dx written once,
    gamma read and dgamma written once; 10 flops an element."""
    return 10 * rows * d, (3 * rows * d + 2 * d) * dtype.itemsize


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. Raises on anything
    the kernel does not take; never computes the result another way."""
    if not (x.is_cuda and gamma.is_cuda and x.device == gamma.device):
        raise ValueError(
            f"rmsnorm kernel: x on {x.device}, gamma on {gamma.device}; "
            "both must lie on one CUDA device")
    if x.dtype not in _DTYPE_CODE or gamma.dtype != x.dtype:
        raise TypeError(
            f"rmsnorm kernel takes float32 or bfloat16 with gamma of the same "
            f"type, got x {x.dtype}, gamma {gamma.dtype}")
    if x.dim() < 1 or gamma.shape != x.shape[-1:]:
        raise ValueError(
            f"rmsnorm kernel: gamma {tuple(gamma.shape)} does not match the "
            f"last dim of x {tuple(x.shape)}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and gamma")
    d = x.shape[-1]
    if d == 0 or d * x.element_size() > _MAX_ROW_BYTES:
        raise ValueError(
            f"rmsnorm kernel: a row of {d} x {x.dtype} does not fit the "
            f"{_MAX_ROW_BYTES} bytes of shared memory a warp has")
    rows = x.numel() // d
    if rows == 0:
        raise ValueError("rmsnorm kernel: x has no rows")
    out = torch.empty_like(x)
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _build.lib().repro_rmsnorm(
            x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows, d,
            float(eps), _DTYPE_CODE[x.dtype], stream)
    _build.check(code, "rmsnorm kernel launch")
    return out


def rmsnorm_backward_plain(x: torch.Tensor, gamma: torch.Tensor,
                           dy: torch.Tensor, eps: float = 1e-5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dgamma), plain PyTorch, any device: with x^ = x * rstd and
    g = dy * gamma, dx = rstd * (g - x^ * mean(g * x^)) and dgamma = the
    sum over rows of dy * x^, in fp32 (fp64 for fp64 inputs), each rounded
    once into its input's type."""
    wt = torch.promote_types(x.dtype, torch.float32)
    d = x.shape[-1]
    xf = x.to(wt)
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xh = xf * rstd
    dyf = dy.to(wt)
    g = dyf * gamma.to(wt)
    dx = rstd * (g - xh * (g * xh).mean(dim=-1, keepdim=True))
    dgamma = (dyf * xh).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dgamma.to(gamma.dtype)


@dataclasses.dataclass(frozen=True)
class RMSNormBackwardPlan:
    """One backward launch (see the module's docstring). A unit is 16
    bytes of a row, ``per`` elements; the last one may be ragged."""
    rows: int
    d: int
    per: int
    team_warps: int
    lane_units: int
    teams: int
    blocks: int
    rows_per_block: int

    @property
    def units(self) -> int:
        return -(-self.d // self.per)

    @property
    def part_shape(self) -> Tuple[int, int]:
        return (self.blocks, self.units * self.per)

    def team_rows(self, block: int, team: int) -> range:
        """The rows team ``team`` of block ``block`` walks, in order."""
        r0 = block * self.rows_per_block
        return range(r0 + team, min(self.rows, r0 + self.rows_per_block),
                     self.teams)

    def lane_units_of(self, warp: int, lane: int) -> list:
        """The units lane ``lane`` of warp ``warp`` of a team holds."""
        stride = 32 * self.team_warps
        slot = warp * 32 + lane
        return [slot + j * stride for j in range(self.lane_units)
                if slot + j * stride < self.units]


def _bwd_registers(lane_units: int, per: int) -> Tuple[int, bool]:
    """(blocks of 8 warps an SM holds, whether a lane loads the next row
    early) for ``lane_units`` units of ``per`` elements, as ``BwdRegs`` in
    ``csrc/rmsnorm.cu`` reckons them for its launch bounds (a CPU test holds
    the two together): x and dy take 4 registers a unit each, the fp32
    dgamma sums ``per``; up to 96 such registers, the launch bounds promise
    two blocks an SM (128 registers a thread), and the next row's x and dy
    (8 a unit) are loaded early where gamma's units (4 each) and they fit
    the 96 too."""
    base = lane_units * (8 + per)
    if base > 96:
        return 1, False
    return 2, base + 12 * lane_units <= 96


def rmsnorm_backward_plan(rows: int, d: int,
                          dtype: torch.dtype) -> RMSNormBackwardPlan:
    """The backward's launch plan, a function of the shape alone: a team
    is the fewest warps whose lanes load the next row early (8 where none
    do), a block ``teams`` teams, and the grid at most one wave of blocks,
    each a run of whole rounds of its teams (the last block's may be
    short)."""
    per = 16 // dtype.itemsize
    units = -(-d // per)
    lane_units = lambda tw: -(-units // (32 * tw))
    tw = 1
    while (tw < _BWD_MAX_WARPS
           and not _bwd_registers(lane_units(tw), per)[1]):
        tw *= 2
    teams = max(1, min(_BWD_MAX_WARPS // tw, rows // _SMS))
    max_blocks = (_SMS * _bwd_registers(lane_units(tw), per)[0]
                  * _BWD_MAX_WARPS // (teams * tw))
    rounds = -(-rows // (teams * min(max_blocks, -(-rows // teams))))
    rows_per_block = teams * rounds
    return RMSNormBackwardPlan(
        rows=rows, d=d, per=per, team_warps=tw, lane_units=lane_units(tw),
        teams=teams, blocks=-(-rows // rows_per_block),
        rows_per_block=rows_per_block)


def _check_backward(x: torch.Tensor, gamma: torch.Tensor,
                    dy: torch.Tensor) -> Tuple[int, int]:
    """(rows, d) of a backward the kernels take; raises otherwise."""
    if not (x.is_cuda and gamma.device == x.device and dy.device == x.device):
        raise ValueError(
            f"rmsnorm backward: x on {x.device}, gamma on {gamma.device}, "
            f"dy on {dy.device}; all must lie on one CUDA device")
    if x.dtype not in _DTYPE_CODE or gamma.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(
            f"rmsnorm backward takes float32 or bfloat16, one type for x, "
            f"gamma and dy; got {x.dtype}, {gamma.dtype}, {dy.dtype}")
    if x.dim() < 1 or gamma.shape != x.shape[-1:] or dy.shape != x.shape:
        raise ValueError(
            f"rmsnorm backward: x {tuple(x.shape)}, gamma "
            f"{tuple(gamma.shape)}, dy {tuple(dy.shape)} do not fit")
    if not (x.is_contiguous() and gamma.is_contiguous() and dy.is_contiguous()):
        raise ValueError("rmsnorm backward takes contiguous x, gamma and dy")
    d = x.shape[-1]
    if d == 0 or d > _BWD_MAX_D:
        raise ValueError(
            f"rmsnorm backward: a row of {d}; the kernels take 1 to "
            f"{_BWD_MAX_D} (a team of {_BWD_MAX_WARPS} warps holds the "
            "row in registers)")
    rows = x.numel() // d
    if rows == 0:
        raise ValueError("rmsnorm backward: x has no rows")
    return rows, d


def rmsnorm_backward_buffers(x: torch.Tensor,
                             gamma: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The outputs ``dx`` and ``dgamma`` and the scratch ``part`` of x's
    plan, uninitialised, on x's device."""
    d = x.shape[-1]
    plan = rmsnorm_backward_plan(x.numel() // d, d, x.dtype)
    return {"dx": torch.empty_like(x), "dgamma": torch.empty_like(gamma),
            "part": torch.empty(plan.part_shape, dtype=torch.float32,
                                device=x.device)}


def rmsnorm_backward_stages_cuda(x: torch.Tensor, gamma: torch.Tensor,
                                 dy: torch.Tensor, eps: float,
                                 buffers: Dict[str, torch.Tensor],
                                 stages=BACKWARD_STAGES) -> None:
    """Launch the named stage kernels, in ``BACKWARD_STAGES``' order, on
    PyTorch's current stream, writing ``buffers`` (as
    ``rmsnorm_backward_buffers`` makes them): the dgamma stage reads the
    partial rows the rows stage wrote. For the card's timings of one
    stage."""
    rows, d = _check_backward(x, gamma, dy)
    unknown = set(stages) - set(BACKWARD_STAGES)
    if unknown:
        raise ValueError(f"rmsnorm backward: no stage {sorted(unknown)}")
    plan = rmsnorm_backward_plan(rows, d, x.dtype)
    part = buffers["part"]
    if not (buffers["dx"].shape == x.shape and buffers["dx"].dtype == x.dtype
            and buffers["dx"].is_contiguous()
            and buffers["dgamma"].shape == gamma.shape
            and buffers["dgamma"].dtype == gamma.dtype
            and part.shape == plan.part_shape and part.dtype == torch.float32
            and part.is_contiguous()
            and all(t.device == x.device for t in buffers.values())):
        raise ValueError("rmsnorm backward: buffers do not fit the call")
    mask = sum(1 << i for i, name in enumerate(BACKWARD_STAGES)
               if name in stages)
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _build.lib().repro_rmsnorm_backward(
            x.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
            buffers["dx"].data_ptr(), buffers["dgamma"].data_ptr(),
            part.data_ptr(), rows, d, float(eps), plan.team_warps,
            plan.lane_units, plan.teams, plan.blocks, plan.rows_per_block,
            mask, _DTYPE_CODE[x.dtype], stream)
    _build.check(code, "rmsnorm backward launch")


def rmsnorm_backward_cuda(x: torch.Tensor, gamma: torch.Tensor,
                          dy: torch.Tensor, eps: float = 1e-5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward's ``BACKWARD_KERNELS_PER_CALL`` kernels on
    PyTorch's current stream: (dx, dgamma). Deterministic (no atomics; the
    plan fixes every sum's order). Raises on anything the kernels do not
    take; never computes the result another way."""
    _check_backward(x, gamma, dy)
    buffers = rmsnorm_backward_buffers(x, gamma)
    rmsnorm_backward_stages_cuda(x, gamma, dy, eps, buffers)
    return buffers["dx"], buffers["dgamma"]
