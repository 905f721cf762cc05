"""GPipe-style pipeline parallelism over a mesh axis's process group.

Counterpart of ``src/repro/parallel/pipeline.py``. Opt-in capability (the
assigned production mesh uses DP x TP; PP becomes profitable past ICI-domain
limits — COMET's collective model quantifies the crossover). The schedule is
the classic GPipe fill-drain: M microbatches over S stages, M + S - 1 ticks,
bubble fraction (S-1)/(M+S-1).

Each rank of the ``pipe`` group holds its own stage's parameters. Every tick
each stage runs once and hands its output to the next rank of the ring
(``_RingShift``, the reference's ``ppermute``: a send to the next and a
receive from the previous rank in one ``batch_isend_irecv``); its backward
sends the gradient the reverse way, so ``loss.backward()`` runs the reversed
schedule with no hand-written backward pipeline. The final stage's outputs
reach every rank through a sum in which the other ranks add zeros (the
reference's masked ``psum``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.parallel.tensor import reduce_from_region

PIPE_AXIS = "pipe"


def _shift(t: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``t`` to the rank ``step`` places on in the group's ring and
    return what the rank ``step`` places back sent."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t.contiguous(),
                      dist.get_global_rank(group, (me + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _shift(t, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def gpipe(
    stage_fn: Callable,            # (stage_params, x_mb) -> y_mb
    stage_params,                  # this rank's stage's parameters
    x: torch.Tensor,               # (M, mb, ...) microbatched input, every rank
    *,
    mesh,
    axis: str = PIPE_AXIS,
) -> torch.Tensor:
    """Returns the (M, mb, ...) outputs of the final stage, on every rank of
    the ``axis`` group."""
    group = mesh.get_group(axis)
    s, idx = dist.get_world_size(group), dist.get_rank(group)
    m = x.shape[0]
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == s - 1, device=x.device)
    state = torch.zeros_like(x[0])       # the activation received last tick
    outs = [None] * m
    for t in range(m + s - 1):
        mb = min(t, m - 1)
        # Selections, not branches: every rank builds the same graph (the
        # received state enters stage 0's with weight 0, each rank's output
        # the result's), so every rank runs every shift's backward, in one
        # order.
        y = stage_fn(stage_params, torch.where(first, x[mb], state))
        out_mb = t - (s - 1)
        if out_mb >= 0:
            outs[out_mb] = torch.where(last, y, torch.zeros_like(y))
        if s > 1 and t < m + s - 2:      # the last tick's output goes nowhere
            state = _RingShift.apply(y, group)
    return reduce_from_region(torch.stack(outs), group)


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
