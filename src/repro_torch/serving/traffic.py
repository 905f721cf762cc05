"""Arrival processes and the discrete-time serving-fleet queue.

The port's copy of the JAX package's ``serving/traffic.py``, held to it
value for value by ``tests/test_torch_serving.py``; the arrivals draw from
numpy's ``default_rng(seed)``, as the reference's do.

:class:`TrafficTrace` generates request arrival times from its knobs
(kind/rate/num_requests/seed), so it is a frozen dataclass that
dotted-path axes rewrite like any other: ``dataclasses.replace(trace,
rate=32.0)`` — i.e. an ``Axis(path="trace.rate")`` — regenerates the
arrivals from the same seed.  "Millions of users" is a requests/s sweep:
the trace is the load curve, the fleet queue converts it into SLO
metrics.

The fleet queue replays the engine tick loop per replica against the
trace: :func:`simulate_colocated` (every replica prefills *and* decodes,
admissions stall the batch — the engine's actual behavior) and
:func:`simulate_disaggregated` (dedicated prefill servers feed dedicated
decode replicas, each request paying a KV-transfer delay between
phases).  Both emit :class:`FleetMetrics`: TTFT percentiles, mean TPOT,
and goodput — requests meeting *both* SLO terms per second of makespan.
"""

from __future__ import annotations

import dataclasses
import heapq
from functools import cached_property
from typing import Dict, List, Sequence, Tuple

import numpy as np

TRACE_KINDS: Tuple[str, ...] = ("poisson", "uniform", "bursty")


@dataclasses.dataclass(frozen=True)
class TrafficTrace:
    """An arrival process: ``num_requests`` arrivals at ``rate`` req/s.

    * ``poisson`` — exponential interarrivals (the M/... baseline);
    * ``uniform`` — deterministic 1/rate spacing (closed-form sanity);
    * ``bursty``  — two-state Markov-modulated Poisson: bursts arrive at
      ``burst_factor`` x the quiet rate, the chain spends ``burst_frac``
      of its time bursting, and the mix averages back to ``rate``.
    """

    kind: str = "poisson"
    rate: float = 8.0
    num_requests: int = 64
    seed: int = 0
    burst_factor: float = 4.0
    burst_frac: float = 0.25

    def __post_init__(self) -> None:
        if self.kind not in TRACE_KINDS:
            raise ValueError(f"kind must be one of {TRACE_KINDS}, "
                             f"got {self.kind!r}")

    @cached_property
    def arrivals(self) -> Tuple[float, ...]:
        """Sorted arrival times in seconds from t=0."""
        if self.rate <= 0 or self.num_requests <= 0:
            raise ValueError(
                f"trace needs rate > 0 and num_requests > 0, got "
                f"rate={self.rate}, num_requests={self.num_requests}")
        n = self.num_requests
        if self.kind == "uniform":
            step = 1.0 / self.rate
            return tuple(i * step for i in range(n))
        rng = np.random.default_rng(self.seed)
        if self.kind == "poisson":
            gaps = rng.exponential(1.0 / self.rate, size=n)
            gaps[0] = 0.0
            return tuple(np.cumsum(gaps).tolist())
        # bursty: stationary burst probability burst_frac, sticky states.
        quiet = self.rate / (1.0 - self.burst_frac
                             + self.burst_frac * self.burst_factor)
        rates = (quiet, quiet * self.burst_factor)
        state = 1 if rng.random() < self.burst_frac else 0
        t, out = 0.0, [0.0]
        for _ in range(n - 1):
            t += float(rng.exponential(1.0 / rates[state]))
            out.append(t)
            if rng.random() < 0.1:   # sticky sojourns: ~10 arrivals/state
                state = 1 if rng.random() < self.burst_frac else 0
        return tuple(out)

    @property
    def duration(self) -> float:
        return self.arrivals[-1] if self.arrivals else 0.0


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """The service-level objective both phases are judged against:
    time-to-first-token (queueing + prefill) and time-per-output-token
    (decode cadence, KV transfer and stalls included)."""

    ttft: float = 2.0     # seconds
    tpot: float = 0.1     # seconds per generated token


@dataclasses.dataclass(frozen=True)
class ReplicaProfile:
    """One replica as the fleet queue sees it: prefill service time per
    request, decode tick time at every occupancy (``decode_curve[b-1]``),
    and the slot count.  ``count`` stamps out identical replicas."""

    prefill_time: float
    decode_curve: Tuple[float, ...]
    max_batch: int
    count: int = 1

    def decode_time(self, occupancy: int) -> float:
        return self.decode_curve[min(occupancy, len(self.decode_curve)) - 1]


@dataclasses.dataclass(frozen=True)
class FleetMetrics:
    """SLO-native outcome of one trace against one fleet."""

    ttft_p50: float
    ttft_p99: float
    tpot: float                  # mean seconds per generated token
    goodput: float               # SLO-met requests per second of makespan
    throughput: float            # completed requests per second of makespan
    completed: int
    slo_met: int


def _pct(values: Sequence[float], q: float) -> float:
    if not values:
        return float("inf")
    ordered = sorted(values)
    idx = int(round(q * (len(ordered) - 1)))
    return ordered[idx]


def _metrics(arrivals: Sequence[float], ttft: List[float],
             finish: List[float], first: List[float],
             decode_steps: int, slo: SLOSpec) -> FleetMetrics:
    tpots = [(finish[i] - first[i]) / decode_steps
             for i in range(len(finish))]
    met = sum(1 for i in range(len(finish))
              if ttft[i] <= slo.ttft and tpots[i] <= slo.tpot)
    makespan = max(finish) - min(arrivals) if finish else float("inf")
    span = makespan if makespan > 0 else float("inf")
    return FleetMetrics(
        ttft_p50=_pct(ttft, 0.50), ttft_p99=_pct(ttft, 0.99),
        tpot=sum(tpots) / len(tpots) if tpots else float("inf"),
        goodput=met / span, throughput=len(finish) / span,
        completed=len(finish), slo_met=met)


def _expand(replicas: Sequence[ReplicaProfile]) -> List[ReplicaProfile]:
    out: List[ReplicaProfile] = []
    for r in replicas:
        out.extend([dataclasses.replace(r, count=1)] * r.count)
    return out


def simulate_colocated(replicas: Sequence[ReplicaProfile],
                       decode_steps: int,
                       trace: TrafficTrace,
                       slo: SLOSpec) -> FleetMetrics:
    """Engine-faithful colocated fleet: each tick a replica admits from
    the shared FIFO queue (each admission one serial prefill, stalling
    every slot), then decodes all active slots once.  Admission prefill
    interference is exactly why disaggregation exists."""
    fleet = _expand(replicas)
    if not fleet:
        raise ValueError("simulate_colocated needs at least one replica")
    arrivals = trace.arrivals
    n = len(arrivals)
    ttft = [0.0] * n
    first = [0.0] * n
    finish = [0.0] * n
    nxt = 0                                   # arrival cursor
    queue: List[int] = []
    # replica state: (clock, idx); active[idx]: slot -> (req, remaining)
    clocks = [(0.0, i) for i in range(len(fleet))]
    heapq.heapify(clocks)
    active: List[Dict[int, Tuple[int, int]]] = [{} for _ in fleet]
    done = 0
    while done < n:
        clock, ri = heapq.heappop(clocks)
        rep = fleet[ri]
        while nxt < n and arrivals[nxt] <= clock:
            queue.append(nxt)
            nxt += 1
        slots = active[ri]
        if not slots and not queue:
            if nxt >= n:
                continue                      # idle replica, trace drained
            heapq.heappush(clocks, (max(clock, arrivals[nxt]), ri))
            continue
        t = clock
        for slot in range(rep.max_batch):
            if slot in slots or not queue:
                continue
            req = queue.pop(0)
            t += rep.prefill_time
            first[req] = t
            ttft[req] = t - arrivals[req]
            slots[slot] = (req, decode_steps)
        if slots:
            t += rep.decode_time(len(slots))
            for slot in list(slots):
                req, remaining = slots[slot]
                if remaining - 1 <= 0:
                    finish[req] = t
                    done += 1
                    del slots[slot]
                else:
                    slots[slot] = (req, remaining - 1)
        heapq.heappush(clocks, (t, ri))
    return _metrics(arrivals, ttft, finish, first, decode_steps, slo)


def simulate_disaggregated(prefill: Sequence[ReplicaProfile],
                           decode: Sequence[ReplicaProfile],
                           decode_steps: int,
                           trace: TrafficTrace,
                           slo: SLOSpec,
                           kv_delay: float = 0.0) -> FleetMetrics:
    """Two-stage fleet: dedicated prefill servers (serial, one request at
    a time — no batch to stall) hand finished prompts to decode replicas
    after a per-request ``kv_delay`` (the KV-cache transfer over the pod
    fabric).  Decode replicas run pure decode ticks, never prefilling."""
    pre = _expand(prefill)
    dec = _expand(decode)
    if not pre or not dec:
        raise ValueError("simulate_disaggregated needs at least one "
                         "prefill and one decode replica")
    arrivals = trace.arrivals
    n = len(arrivals)
    ttft = [0.0] * n
    first = [0.0] * n
    finish = [0.0] * n
    # Stage 1: earliest-free prefill server, serial service.
    free = [(0.0, i) for i in range(len(pre))]
    heapq.heapify(free)
    ready: List[Tuple[float, int]] = []       # (decode-ready time, req)
    for req, arr in enumerate(arrivals):
        t0, si = heapq.heappop(free)
        t = max(arr, t0) + pre[si].prefill_time
        first[req] = t
        ttft[req] = t - arr
        heapq.heappush(free, (t, si))
        ready.append((t + kv_delay, req))
    ready.sort()
    # Stage 2: decode replicas tick over the ready queue.
    clocks = [(0.0, i) for i in range(len(dec))]
    heapq.heapify(clocks)
    active: List[Dict[int, Tuple[int, int]]] = [{} for _ in dec]
    queue: List[int] = []
    nxt = 0
    done = 0
    while done < n:
        clock, ri = heapq.heappop(clocks)
        rep = dec[ri]
        while nxt < n and ready[nxt][0] <= clock:
            queue.append(ready[nxt][1])
            nxt += 1
        slots = active[ri]
        if not slots and not queue:
            if nxt >= n:
                continue
            heapq.heappush(clocks, (max(clock, ready[nxt][0]), ri))
            continue
        for slot in range(rep.max_batch):
            if slot in slots or not queue:
                continue
            slots[slot] = (queue.pop(0), decode_steps)
        t = clock + rep.decode_time(len(slots))
        for slot in list(slots):
            req, remaining = slots[slot]
            if remaining - 1 <= 0:
                finish[req] = t
                done += 1
                del slots[slot]
            else:
                slots[slot] = (req, remaining - 1)
        heapq.heappush(clocks, (t, ri))
    return _metrics(arrivals, ttft, finish, first, decode_steps, slo)
