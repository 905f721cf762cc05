"""Discrete-event fleet timeline over per-group node capacities.

The port's copy of the JAX package's ``fleet/simulator.py``: pure host
code (Python floats, a heap), held to the reference event for event and to
the bit by ``tests/test_torch_fleet.py``. The
:class:`~repro_torch.core.placement.ScheduleModel` prices a job as
``waves * iter_time`` on an otherwise-empty fleet. The
:class:`FleetSimulator` generalizes that to a timeline: jobs arrive,
queue, preempt each other, grow and shrink their DP width, and lend the
fleet to bursting tenants — every transition priced by the checkpoint and
reshard cost model in :mod:`repro_torch.fleet.resize`.

Design contract (the degenerate-equivalence golden): admission is
*plan-sticky*.  When a job's instances enter the queue they are planned
with the exact fixed ``ScheduleModel`` greedy against the currently
free nodes, and stay on their planned group at the planned concurrency
until an event (preemption, lend, resize) disturbs them.  Undisturbed
wave successions compute finish times as ``anchor + wave * duration``
(multiplication, never accumulation), so a static single-job no-event
trace reproduces ``ScheduleModel.schedule`` makespan bit-for-bit —
work-stealing between groups would beat the analytic model and is
deliberately not done.

Policies (:class:`FleetModel.policy`):

* ``static`` — queue + plan-sticky admission only: the timeline twin of
  a static ``ScheduleModel`` allocation;
* ``elastic`` — adds priority preemption, elastic DP grow (into idle
  nodes, when the saved compute outweighs the resize delay) and shrink
  (shedding nodes to admit waiting higher-priority work);
* ``elastic+burst`` — additionally lets a job's marked burst phase
  borrow lower-priority tenants' nodes for its first ``burst_iters``
  iterations (lend/return hand-offs priced as checkpoint/restore plus
  ``lend_overhead``).

Fault injection: a :class:`repro_torch.reliability.FailureTrace`
passed to the simulator downs nodes mid-timeline.  A failure first
absorbs idle capacity; the remainder kills running instances
(lowest-priority, latest-arrival first), whose work rolls back to the
last *interval-quantized* checkpoint boundary — the cadence is the
fixed ``FleetModel.ckpt_interval_s`` or the per-segment Young–Daly
optimum, and every running segment's iteration time is inflated by
``1 + C/tau`` to charge the checkpoint writes themselves.  Capacity
returns at the repair event.  The per-job degradation policy
(``on_failure``, defaulting to ``FleetModel.degradation``) chooses
wait-for-repair (re-queue at the base width) vs shrink-to-survive
(re-queue at the narrowest menu width).  With no trace (or a disabled
one) every inflation factor is exactly 1.0 and no new events enter the
heap: the timeline is bit-for-bit the failure-free one.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.placement import (JobSpec, Placement, ScheduleModel,
                                        get_placement)
from repro_torch.fleet.jobs import FleetJob
from repro_torch.fleet.resize import checkpoint_delay, remesh_delay
from repro_torch.reliability.trace import FailureEvent, FailureTrace

FLEET_POLICIES: Tuple[str, ...] = ("static", "elastic", "elastic+burst")
DEGRADATION_POLICIES: Tuple[str, ...] = ("wait", "shrink")


@dataclasses.dataclass(frozen=True)
class FleetModel:
    """The sweepable fleet knobs (``fleet.*`` dotted paths).

    ``checkpoint_bw`` / ``reshard_bw`` feed the one
    :func:`repro_torch.fleet.resize.remesh_delay` formula; ``lend_overhead``
    is the fixed per-hand-off tax a burst lend/return adds on top of
    the checkpoint/restore pair.  ``preemption`` only takes effect
    under the elastic policies — ``static`` is the pure
    ``ScheduleModel``-equivalent baseline.

    ``degradation`` is the fleet-default failure policy a job without
    an ``on_failure`` override inherits (``"wait"`` re-queues a killed
    instance at its base width; ``"shrink"`` re-queues it at the
    narrowest menu width so it can restart on degraded capacity).
    ``ckpt_interval_s`` fixes the checkpoint cadence fault injection
    quantizes rollback to; 0 picks the per-segment Young–Daly optimum
    from the active failure trace's rate.  Both are inert without a
    failure trace."""

    policy: str = "elastic+burst"
    checkpoint_bw: float = 40e9
    reshard_bw: float = 100e9
    preemption: bool = True
    lend_overhead: float = 1.0
    degradation: str = "wait"
    ckpt_interval_s: float = 0.0

    def __post_init__(self) -> None:
        if self.policy not in FLEET_POLICIES:
            raise ValueError(f"policy must be one of {FLEET_POLICIES}, "
                             f"got {self.policy!r}")
        if self.degradation not in DEGRADATION_POLICIES:
            raise ValueError(
                f"degradation must be one of {DEGRADATION_POLICIES}, "
                f"got {self.degradation!r}")
        if self.ckpt_interval_s < 0:
            raise ValueError(f"ckpt_interval_s must be >= 0 (0 = "
                             f"Young–Daly), got {self.ckpt_interval_s}")

    @property
    def elastic(self) -> bool:
        return self.policy != "static"

    @property
    def burst(self) -> bool:
        return self.policy == "elastic+burst"

    @property
    def preempt(self) -> bool:
        return self.preemption and self.policy != "static"


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """One timeline transition, with the post-event per-group
    allocation snapshot (the capacity-conservation witness)."""

    time: float
    kind: str        # arrive|start|finish|complete|preempt|resume|grow|
    #                  shrink|lend|return|fail|fail_node|repair|fault
    job: str
    group: int
    width: int
    alloc: Tuple[int, ...]


@dataclasses.dataclass
class JobOutcome:
    """Per-job fate over the timeline."""

    name: str
    uid: int
    arrival: float
    priority: int
    first_start: float = math.inf
    finish: float = math.inf
    completed: bool = False
    feasible: bool = True
    preemptions: int = 0
    resizes: int = 0
    bursts: int = 0
    failures: int = 0

    @property
    def turnaround(self) -> float:
        return self.finish - self.arrival


def _pct(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (the serving convention)."""
    if not values:
        return math.inf
    s = sorted(values)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


@dataclasses.dataclass(frozen=True)
class FleetResult:
    """The timeline's outcome: per-job fates, the full event log, and
    the aggregate columns a fleet study emits."""

    outcomes: Tuple[JobOutcome, ...]
    events: Tuple[FleetEvent, ...]
    capacities: Tuple[int, ...]
    makespan: float
    busy_node_seconds: float
    useful_node_seconds: float = 0.0
    lost_node_seconds: float = 0.0

    @property
    def turnarounds(self) -> Tuple[float, ...]:
        return tuple(o.turnaround for o in self.outcomes if o.completed)

    @property
    def turnaround_p50(self) -> float:
        return _pct(self.turnarounds, 0.50)

    @property
    def turnaround_p99(self) -> float:
        return _pct(self.turnarounds, 0.99)

    @property
    def fleet_util(self) -> float:
        cap = sum(self.capacities)
        if cap <= 0 or self.makespan <= 0:
            return 0.0
        return self.busy_node_seconds / (cap * self.makespan)

    @property
    def preemptions(self) -> int:
        return sum(o.preemptions for o in self.outcomes)

    @property
    def resize_events(self) -> int:
        return sum(o.resizes for o in self.outcomes)

    @property
    def burst_events(self) -> int:
        return sum(o.bursts for o in self.outcomes)

    @property
    def jobs_completed(self) -> int:
        return sum(1 for o in self.outcomes if o.completed)

    @property
    def failures(self) -> int:
        """Instance kills charged to node failures (not preemptions)."""
        return sum(o.failures for o in self.outcomes)

    @property
    def lost_work_frac(self) -> float:
        """Failure-discarded compute as a fraction of busy node-time."""
        if self.busy_node_seconds <= 0:
            return 0.0
        return self.lost_node_seconds / self.busy_node_seconds

    @property
    def goodput(self) -> float:
        """Credited-iteration compute as a fraction of busy node-time
        (checkpoint writes, restores, remeshes and rework are the
        complement)."""
        if self.busy_node_seconds <= 0:
            return 0.0
        return self.useful_node_seconds / self.busy_node_seconds

    @property
    def feasible(self) -> bool:
        return all(o.feasible for o in self.outcomes) \
            and all(o.completed for o in self.outcomes)


# --------------------------------------------------------------------- #
# Internal runtime state
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class _GroupView:
    """The free-node view ScheduleModel plans against."""

    num_nodes: int


@dataclasses.dataclass
class _Job:
    job: FleetJob
    outcome: JobOutcome
    instances: List["_Inst"] = dataclasses.field(default_factory=list)
    arrived: bool = False
    burst_done: bool = False

    @property
    def priority(self) -> int:
        return self.job.spec.priority

    @property
    def done(self) -> bool:
        return all(i.state == "done" for i in self.instances)


@dataclasses.dataclass
class _Inst:
    job: _Job
    idx: int
    remaining: int
    state: str = "queued"        # queued | running | blocked | done
    group: int = -1              # planned / hosting group (-1 = unplanned)
    width: int = 0               # current/pending width
    alloc: int = 0               # nodes actually held
    conc_cap: int = 1            # planned concurrency cap on the group
    it: float = 0.0              # per-iteration seconds at current width
    anchor: float = 0.0          # wave timing origin
    wave: int = 0                # finish = anchor + wave * dur
    dur: float = 0.0             # one full run at current width, seconds
    compute_start: float = 0.0
    pending: float = 0.0         # restore/reshard delay before next segment
    burst_width: int = 0         # > 0: next segment is the burst phase
    seg_iters: int = 0           # iterations covered by the running segment
    resizing: bool = False       # a remesh is in flight
    epoch: int = 0               # invalidates stale heap events
    f: float = 1.0               # checkpoint-cadence inflation (1 + C/tau)
    tau: float = math.inf        # checkpoint interval for this segment

    @property
    def key(self) -> Tuple[int, float, int, int]:
        return (-self.job.priority, self.job.outcome.arrival,
                self.job.job.uid, self.idx)


class FleetSimulator:
    """Replay a set of :class:`FleetJob` over per-group node capacities
    under a :class:`FleetModel` policy."""

    def __init__(self, capacities: Sequence[int],
                 model: Optional[FleetModel] = None,
                 placement: object = None,
                 schedule_model: Optional[ScheduleModel] = None,
                 failures: Optional[FailureTrace] = None,
                 pod_sizes: Optional[Sequence[int]] = None) -> None:
        if not capacities or any(c < 1 for c in capacities):
            raise ValueError(
                f"capacities must be positive per group, got {capacities}")
        self.capacities: Tuple[int, ...] = tuple(int(c) for c in capacities)
        self.model = model or FleetModel()
        self.placement: Optional[Placement] = get_placement(placement)
        self.scheduler = schedule_model or ScheduleModel()
        self.failures = failures
        self.pod_sizes: Optional[Tuple[int, ...]] = \
            tuple(int(p) for p in pod_sizes) if pod_sizes is not None \
            else None
        if self.pod_sizes is not None \
                and len(self.pod_sizes) != len(self.capacities):
            raise ValueError(
                f"pod_sizes must match capacities per group, got "
                f"{len(self.pod_sizes)} vs {len(self.capacities)}")

    # ------------------------------------------------------------------ #
    def run(self, jobs: Sequence[FleetJob]) -> FleetResult:
        st = _RunState(self, jobs)
        return st.run()


class _RunState:
    """One timeline execution (FleetSimulator stays reusable)."""

    def __init__(self, sim: FleetSimulator, jobs: Sequence[FleetJob]) -> None:
        self.sim = sim
        self.model = sim.model
        self.cap = list(sim.capacities)
        self.free = list(sim.capacities)
        self.jobs: List[_Job] = []
        for j in jobs:
            out = JobOutcome(name=j.spec.name, uid=j.uid,
                             arrival=j.spec.arrival,
                             priority=j.spec.priority)
            job = _Job(job=j, outcome=out)
            for k in range(j.spec.instances):
                job.instances.append(
                    _Inst(job=job, idx=k, remaining=j.spec.iterations,
                          width=j.spec.base_width))
            self.jobs.append(job)
        self.heap: List[Tuple[float, int, str, object]] = []
        self.seq = 0
        self.now = 0.0
        self.events: List[FleetEvent] = []
        self.busy = 0.0
        self._last_t = 0.0
        # (job uid, group, width, dur) -> (anchor, wave) wave-succession
        # hints left by finish events, consumed by same-timestamp admission
        self.hints: Dict[Tuple[int, int, int, float], Tuple[float, int]] = {}
        # --- fault injection (all zero / empty when no trace) ---------- #
        self.ftrace = sim.failures
        self.rel = self.ftrace is not None and self.ftrace.enabled
        self.down = [0] * len(self.cap)          # nodes currently failed
        self.transit_down = [0] * len(self.cap)  # failed while ckpt-writing
        self.useful = 0.0                        # credited compute node-s
        self.lost = 0.0                          # failure-discarded node-s
        if self.rel and self.ftrace is not None:
            for fe in self.ftrace.materialize(self.cap, sim.pod_sizes):
                self._push(fe.time, "fail_node", fe)

    # --- bookkeeping --------------------------------------------------- #
    def _advance(self, t: float) -> None:
        used = sum(self.cap) - sum(self.free) - sum(self.down)
        self.busy += used * (t - self._last_t)
        self._last_t = t
        self.now = t

    def _push(self, t: float, kind: str, payload: object) -> None:
        heapq.heappush(self.heap, (t, self.seq, kind, payload))
        self.seq += 1

    def _emit(self, kind: str, job: str, group: int, width: int) -> None:
        alloc = tuple(c - f for c, f in zip(self.cap, self.free))
        self.events.append(FleetEvent(self.now, kind, job, group, width,
                                      alloc))

    def _delay(self, bytes_: float) -> float:
        return checkpoint_delay(bytes_, self.model.checkpoint_bw)

    def _remesh(self, bytes_: float) -> float:
        return remesh_delay(bytes_, self.model.checkpoint_bw,
                            self.model.reshard_bw)

    def _ckpt(self, job: "_Job", width: int) -> Tuple[float, float]:
        """(inflation factor, checkpoint interval) for a segment of
        ``job`` at ``width``: the fixed ``FleetModel.ckpt_interval_s``
        cadence or the per-segment Young–Daly optimum at the trace's
        node failure rate.  Exactly ``(1.0, inf)`` without failures —
        the bit-for-bit degenerate."""
        if not self.rel or self.ftrace is None:
            return 1.0, math.inf
        tau = self.model.ckpt_interval_s
        if tau <= 0:
            lam = width * self.ftrace.rate_per_node
            if lam <= 0:
                return 1.0, math.inf    # explicit trace, no cadence set
            write = self._delay(job.job.state_bytes)
            tau = math.sqrt(2.0 * write / lam) if write > 0 else math.inf
        if not (tau > 0) or math.isinf(tau):
            return 1.0, math.inf
        return 1.0 + self._delay(job.job.state_bytes) / tau, tau

    # --- planning ------------------------------------------------------ #
    def _plan(self, job: _Job, avail: Sequence[int], width: int,
              queued: List[_Inst]) -> Optional[Tuple[List[int], List[int],
                                                     bool]]:
        """ScheduleModel greedy against an availability vector: returns
        (counts, conc, feasible) per group, or None when nothing can be
        assigned at all."""
        prof = job.job.profile(width)
        views = [_GroupView(n) for n in avail]
        spec = JobSpec(instances=len(queued), nodes_per_instance=width,
                       max_nodes=job.job.spec.max_nodes,
                       name=job.job.spec.name)
        try:
            sched = self.sim.scheduler.schedule(
                spec, views, list(prof.iter_times), fits=list(prof.fits),
                placement=self.sim.placement)
        except ValueError:
            return None
        counts = [0] * len(avail)
        conc = [0] * len(avail)
        for g in sched.groups:
            counts[g.group] = g.instances
            conc[g.group] = max(1, g.concurrent)
        return counts, conc, sched.feasible

    def _admissible(self, counts: Sequence[int], conc: Sequence[int],
                    width: int, avail: Sequence[int]) -> bool:
        """Would this plan's first wave actually obtain nodes?  (The
        legacy oversubscribed fallback clamps an instance to the whole
        group, so ``min(width, cap)`` is the allocation unit.)"""
        return any(c > 0 and avail[g] >= min(width, self.cap[g])
                   for g, c in enumerate(counts) if conc[g] > 0)

    def _assign(self, job: _Job, queued: List[_Inst], counts: Sequence[int],
                conc: Sequence[int], width: int, feasible: bool) -> None:
        it = 0
        for g, n in enumerate(counts):
            for _ in range(n):
                inst = queued[it]
                inst.group = g
                inst.width = width
                inst.conc_cap = conc[g]
                it += 1
        job.outcome.feasible = job.outcome.feasible and feasible

    def _reclaimable(self, pred: "Callable[[_Inst], int]") -> List[int]:
        """Per-group nodes recoverable from running instances matching
        ``pred`` (used for shrink/preempt/lend planning)."""
        out = [0] * len(self.cap)
        for job in self.jobs:
            for inst in job.instances:
                if inst.state == "running":
                    out[inst.group] += pred(inst)
        return out

    # --- event loop ---------------------------------------------------- #
    def run(self) -> FleetResult:
        for job in self.jobs:
            self._push(job.job.spec.arrival, "arrive", job)
        while self.heap:
            t, _, kind, payload = heapq.heappop(self.heap)
            self._advance(t)
            if kind == "arrive":
                self._on_arrive(payload)          # type: ignore[arg-type]
            elif kind == "finish":
                self._on_finish(payload)          # type: ignore[arg-type]
            elif kind == "free":
                self._on_free(payload)            # type: ignore[arg-type]
            elif kind == "resize":
                self._on_resize(payload)          # type: ignore[arg-type]
            elif kind == "fail_node":
                self._on_fail_node(payload)       # type: ignore[arg-type]
            elif kind == "repair":
                self._on_repair(payload)          # type: ignore[arg-type]
            self.hints.clear()
        makespan = max((o.finish for o in self.outcomes() if o.completed),
                       default=0.0)
        return FleetResult(outcomes=tuple(self.outcomes()),
                           events=tuple(self.events),
                           capacities=tuple(self.cap),
                           makespan=makespan,
                           busy_node_seconds=self.busy,
                           useful_node_seconds=self.useful,
                           lost_node_seconds=self.lost)

    def outcomes(self) -> List[JobOutcome]:
        return [j.outcome for j in self.jobs]

    # --- handlers ------------------------------------------------------ #
    def _on_arrive(self, job: _Job) -> None:
        job.arrived = True
        self._emit("arrive", job.job.spec.name, -1, job.job.spec.base_width)
        if self.model.burst and job.job.spec.burst_iters > 0 \
                and not job.burst_done and job.job.spec.instances == 1:
            self._try_burst(job)
        self._dispatch()

    def _on_finish(self, payload: object) -> None:
        inst, epoch = payload  # type: ignore[misc]
        if epoch != inst.epoch:
            return
        job = inst.job
        inst.remaining -= inst.seg_iters
        self.useful += inst.seg_iters * (inst.it / inst.f) * inst.alloc
        self.free[inst.group] += inst.alloc
        was_burst = inst.burst_width > 0
        if was_burst:
            inst.burst_width = 0
            job.burst_done = True
            self._emit("return", job.job.spec.name, inst.group, inst.width)
        if inst.remaining <= 0:
            inst.state = "done"
            # wave-succession hint: an identical queued sibling admitted
            # at this exact timestamp inherits (anchor, wave) so its
            # finish stays anchor + (wave+1) * dur — multiplication, not
            # accumulation.
            if not was_burst:
                self.hints[(job.job.uid, inst.group, inst.width, inst.dur)] \
                    = (inst.anchor, inst.wave)
            self._emit("finish", job.job.spec.name, inst.group, inst.width)
            if job.done:
                job.outcome.finish = self.now
                job.outcome.completed = True
                self._emit("complete", job.job.spec.name, inst.group,
                           inst.width)
        else:
            # burst phase over: re-queue the tail at base width, paying
            # the reshard back down.
            inst.state = "queued"
            inst.group = -1
            inst.alloc = 0
            inst.width = job.job.spec.base_width
            inst.pending = self._remesh(job.job.state_bytes)
        inst.epoch += 1
        self._dispatch()

    def _on_free(self, payload: object) -> None:
        """Checkpoint write finished after a preempt/lend: the nodes
        come back (unless a failure downed them mid-write — those are
        already counted in ``down`` and return at their repair)."""
        group, nodes = payload  # type: ignore[misc]
        taken = min(nodes, self.transit_down[group])
        self.transit_down[group] -= taken
        self.free[group] += nodes - taken
        self._dispatch()

    def _on_resize(self, payload: object) -> None:
        """Grow/shrink redistribution finished: apply the new width and
        restart the compute segment."""
        inst, epoch, new_width = payload  # type: ignore[misc]
        if epoch != inst.epoch:
            return
        job = inst.job
        prof = job.job.profile(new_width)
        # allocation is always clamped to the hosting group (the
        # oversubscribed legacy convention): a shrink whose new width
        # still exceeds the group frees nothing extra.
        unit = min(new_width, self.cap[inst.group])
        if unit < inst.alloc:
            self.free[inst.group] += inst.alloc - unit
        inst.alloc = unit
        inst.width = new_width
        inst.f, inst.tau = self._ckpt(job, new_width)
        inst.it = prof.iter_times[inst.group] * inst.f
        inst.anchor = self.now
        inst.wave = 1
        inst.dur = inst.remaining * inst.it
        inst.seg_iters = inst.remaining
        inst.compute_start = self.now
        inst.resizing = False
        inst.epoch += 1
        self._push(inst.anchor + inst.dur, "finish", (inst, inst.epoch))
        self._dispatch()

    # --- fault injection ----------------------------------------------- #
    def _on_fail_node(self, ev: FailureEvent) -> None:
        """``ev.nodes`` nodes of group ``ev.group`` go down: idle
        capacity absorbs the hit first, then running instances die
        (lowest-priority, latest-arrival first).  Nodes mid-checkpoint
        (a preempt/lend write in flight) are downed via the transit
        debt their pending free event settles."""
        g = ev.group
        want = min(ev.nodes, self.cap[g] - self.down[g])
        if want <= 0:
            return
        self.down[g] += want
        absorbed = min(want, self.free[g])
        self.free[g] -= absorbed
        need = want - absorbed
        if need > 0:
            victims = sorted(
                (i for j in self.jobs for i in j.instances
                 if i.state == "running" and i.group == g and i.alloc > 0),
                key=lambda i: i.key, reverse=True)
            for v in victims:
                if need <= 0:
                    break
                hit = min(need, v.alloc)
                need -= hit
                self._kill(v, hit)
        # any leftover lands on nodes whose checkpoint write is in flight
        self.transit_down[g] += need
        self._emit("fail_node", "fleet", g, want)
        self._push(self.now + ev.repair_s, "repair", (g, want))
        self._dispatch()

    def _on_repair(self, payload: object) -> None:
        """Repaired nodes rejoin the pool: outstanding transit debt is
        cancelled first (those nodes free when their write event
        fires), the rest move down -> free."""
        group, nodes = payload  # type: ignore[misc]
        taken = min(nodes, self.transit_down[group])
        self.transit_down[group] -= taken
        self.down[group] -= taken
        back = min(nodes - taken, self.down[group])
        self.down[group] -= back
        self.free[group] += back
        self._emit("repair", "fleet", group, nodes)
        self._dispatch()

    def _kill(self, inst: _Inst, down_nodes: int) -> None:
        """A node failure kills this instance: work rolls back to the
        last interval-quantized checkpoint boundary, surviving nodes
        free immediately (the job died — no checkpoint write), and the
        instance re-queues per its degradation policy with the restore
        charge."""
        job = inst.job
        self._fail_credit(inst)
        self.free[inst.group] += inst.alloc - down_nodes
        group = inst.group
        if inst.burst_width > 0:
            inst.burst_width = 0
            job.burst_done = True
        job.outcome.failures += 1
        inst.alloc = 0
        inst.resizing = False
        if inst.remaining <= 0:
            # the last interval boundary already committed the segment
            inst.state = "done"
            self._emit("finish", job.job.spec.name, group, inst.width)
            if job.done:
                job.outcome.finish = self.now
                job.outcome.completed = True
                self._emit("complete", job.job.spec.name, group, inst.width)
            return
        policy = job.job.spec.on_failure or self.model.degradation
        width = job.job.spec.width_menu[0] if policy == "shrink" \
            else job.job.spec.base_width
        inst.state = "queued"
        inst.group = -1
        inst.width = width
        inst.pending = self._delay(job.job.state_bytes)
        self._emit("fault", job.job.spec.name, group, width)

    def _fail_credit(self, inst: _Inst) -> None:
        """Interval-quantized rollback: only whole checkpoint intervals
        before the failure are committed; everything since the last
        boundary is discarded into ``lost``."""
        elapsed = max(0.0, self.now - inst.compute_start)
        done = 0
        if inst.it > 0 and elapsed > 0 and inst.tau > 0 \
                and not math.isinf(inst.tau):
            committed = math.floor(elapsed / inst.tau) * inst.tau
            done = min(inst.seg_iters, int(committed / inst.it))
        inst.remaining -= done
        self.useful += done * (inst.it / inst.f) * inst.alloc
        self.lost += max(0.0, elapsed - done * inst.it) * inst.alloc
        inst.epoch += 1

    # --- admission ----------------------------------------------------- #
    def _queued(self, job: _Job, planned: Optional[bool] = None
                ) -> List[_Inst]:
        out = [i for i in job.instances if i.state == "queued"]
        if planned is None:
            return out
        return [i for i in out if (i.group >= 0) == planned]

    def _dispatch(self) -> None:
        progress = True
        while progress:
            progress = False
            # 1. plan jobs with unplanned queued instances, priority first
            for job in sorted((j for j in self.jobs if j.arrived
                               and self._queued(j, planned=False)),
                              key=lambda j: (-j.priority, j.outcome.arrival,
                                             j.job.uid)):
                if self._plan_job(job):
                    progress = True
            # 2. admit planned queued instances into free nodes
            for inst in sorted((i for j in self.jobs if j.arrived
                                for i in self._queued(j, planned=True)),
                               key=lambda i: i.key):
                if self._try_start(inst):
                    progress = True
        if self.model.elastic:
            self._try_grow()

    def _plan_job(self, job: _Job) -> bool:
        queued = self._queued(job, planned=False)
        if not queued:
            return False
        width = queued[0].width
        plan = self._plan(job, self.free, width, queued)
        if plan is not None and plan[2] and self._admissible(
                plan[0], plan[1], width, self.free):
            self._assign(job, queued, *plan[:2], width, plan[2])
            return True
        # not feasibly placeable on what's free: reclaim via shrink,
        # then preemption
        if self.model.elastic and self._reclaim_for(job, width, queued):
            return True
        # can it ever run?  Plan against full capacity: if even that is
        # infeasible, adopt the legacy oversubscribed convention (flagged
        # infeasible — record parity with ScheduleModel); a job that IS
        # feasible at full capacity instead waits for its fitting groups
        # to free rather than squatting on a non-fitting one.
        full = self._plan(job, self.cap, width, queued)
        if full is None:
            job.outcome.feasible = False
            job.outcome.completed = False
            for i in queued:
                i.state = "done"
                i.remaining = 0
            self._emit("fail", job.job.spec.name, -1, width)
            return False
        if not full[2] and plan is not None and self._admissible(
                plan[0], plan[1], width, self.free):
            self._assign(job, queued, *plan[:2], width, plan[2])
            return True
        return False

    def _reclaim_for(self, job: _Job, width: int, queued: List[_Inst]
                     ) -> bool:
        """Free nodes for ``job`` by shrinking elastic lower-priority
        tenants, then preempting them outright (policy permitting)."""
        pr = job.priority

        def shrinkable(inst: _Inst) -> int:
            menu = inst.job.job.spec.width_menu
            if inst.job.priority >= pr or not inst.job.job.spec.elastic \
                    or inst.burst_width > 0 or inst.resizing:
                return 0
            return max(0, inst.alloc - min(menu[0], self.cap[inst.group]))

        def preemptable(inst: _Inst) -> int:
            if inst.job.priority >= pr \
                    or not inst.job.job.spec.preemptible \
                    or inst.burst_width > 0 or inst.resizing:
                return 0
            return inst.alloc

        for pred, action in ((shrinkable, self._shrink),
                             (preemptable, self._preempt)):
            if pred is preemptable and not self.model.preempt:
                continue
            extra = self._reclaimable(pred)
            avail = [f + e for f, e in zip(self.free, extra)]
            plan = self._plan(job, avail, width, queued)
            if plan is None or not plan[2] \
                    or not self._admissible(plan[0], plan[1], width, avail):
                continue
            counts, conc, feas = plan
            # reclaim in each group this plan lands on, neediest first
            for g, c in enumerate(counts):
                need = conc[g] * min(width, self.cap[g]) - self.free[g]
                if c == 0 or need <= 0:
                    continue
                victims = sorted(
                    (i for job2 in self.jobs for i in job2.instances
                     if i.state == "running" and i.group == g and pred(i)),
                    key=lambda i: (i.job.priority, i.job.outcome.arrival))
                freed = 0
                for v in victims:
                    if freed >= need:
                        break
                    freed += action(v)
            self._assign(job, queued, counts, conc, width, feas)
            return True
        return False

    def _try_start(self, inst: _Inst) -> bool:
        g = inst.group
        job = inst.job
        unit = min(inst.width, self.cap[g])
        running = sum(1 for i in job.instances
                      if i.state == "running" and i.group == g
                      and i.burst_width == 0)
        if inst.burst_width == 0 and running >= inst.conc_cap:
            return False
        if self.free[g] < unit:
            return False
        self.free[g] -= unit
        inst.alloc = unit
        inst.state = "running"
        width = inst.burst_width or inst.width
        prof = job.job.profile(width)
        inst.f, inst.tau = self._ckpt(job, width)
        inst.it = prof.iter_times[g] * inst.f
        inst.seg_iters = min(inst.remaining, job.job.spec.burst_iters) \
            if inst.burst_width else inst.remaining
        inst.dur = inst.seg_iters * inst.it
        hint = self.hints.pop((job.job.uid, g, inst.width, inst.dur), None) \
            if inst.pending == 0.0 and not inst.burst_width else None
        if hint is not None:
            inst.anchor, inst.wave = hint[0], hint[1] + 1
        else:
            inst.anchor = self.now + inst.pending
            inst.wave = 1
        inst.pending = 0.0
        inst.compute_start = inst.anchor + (inst.wave - 1) * inst.dur
        inst.epoch += 1
        self._push(inst.anchor + inst.wave * inst.dur, "finish",
                   (inst, inst.epoch))
        if job.outcome.first_start > self.now:
            job.outcome.first_start = self.now
        if inst.burst_width:
            job.outcome.bursts += 1
            self._emit("lend", job.job.spec.name, g, inst.burst_width)
        self._emit("start", job.job.spec.name, g, width)
        return True

    # --- disturbances -------------------------------------------------- #
    def _interrupt(self, inst: _Inst) -> None:
        """Stop a running segment at the current iteration boundary:
        credit completed iterations, invalidate the pending finish."""
        done = 0
        if self.now > inst.compute_start and inst.it > 0:
            done = min(inst.seg_iters,
                       int((self.now - inst.compute_start) / inst.it))
        inst.remaining -= done
        self.useful += done * (inst.it / inst.f) * inst.alloc
        inst.epoch += 1

    def _preempt(self, inst: _Inst, kind: str = "preempt") -> int:
        """Checkpoint a running instance off its nodes; they free once
        the write completes, the victim re-queues with the restore
        charge (plus the lend hand-off tax when this is a burst lend)."""
        self._interrupt(inst)
        job = inst.job
        nodes, group = inst.alloc, inst.group
        bytes_ = job.job.state_bytes
        tax = self.model.lend_overhead if kind == "lend" else 0.0
        self._push(self.now + self._delay(bytes_) + tax, "free",
                   (group, nodes))
        inst.state = "queued"
        inst.group = -1
        inst.alloc = 0
        inst.width = job.job.spec.base_width
        inst.pending = self._delay(bytes_) + tax
        job.outcome.preemptions += 1
        self._emit(kind, job.job.spec.name, group, inst.width)
        return nodes

    def _lend(self, inst: _Inst) -> int:
        return self._preempt(inst, kind="lend")

    def _shrink(self, inst: _Inst) -> int:
        """Elastic shed to the narrowest width: nodes free once the
        remesh completes."""
        self._interrupt(inst)
        job = inst.job
        new = job.job.spec.width_menu[0]
        freed = inst.alloc - min(new, self.cap[inst.group])
        inst.state = "running"
        inst.resizing = True
        job.outcome.resizes += 1
        self._emit("shrink", job.job.spec.name, inst.group, new)
        self._push(self.now + self._remesh(job.job.state_bytes), "resize",
                   (inst, inst.epoch, new))
        return freed

    def _try_grow(self) -> None:
        """Grow elastic tenants into idle nodes when nothing is queued
        and the saved compute outweighs the remesh delay."""
        if any(self._queued(j) for j in self.jobs if j.arrived):
            return
        for job in self.jobs:
            if not job.job.spec.elastic:
                continue
            for inst in job.instances:
                if inst.state != "running" or inst.burst_width > 0 \
                        or inst.resizing:
                    continue
                if self.now < inst.compute_start or inst.it <= 0:
                    continue
                g = inst.group
                menu = job.job.spec.width_menu
                left = inst.seg_iters - int(
                    (self.now - inst.compute_start) / inst.it)
                cost = self._remesh(job.job.state_bytes)
                best = 0
                for w in menu:
                    # only grow into real nodes: a width beyond the
                    # hosting group would claim speedup it cannot host.
                    if w <= inst.width or w > self.cap[g] \
                            or w - inst.alloc > self.free[g]:
                        continue
                    prof = job.job.profile(w)
                    if not prof.fits[g]:
                        continue
                    f_w, _ = self._ckpt(job, w)
                    gain = left * (inst.it - prof.iter_times[g] * f_w)
                    if gain > cost:
                        best = w
                if best:
                    self._interrupt(inst)
                    self.free[g] -= best - inst.alloc
                    inst.alloc = best
                    inst.resizing = True
                    job.outcome.resizes += 1
                    self._emit("grow", job.job.spec.name, g, best)
                    self._push(self.now + cost, "resize",
                               (inst, inst.epoch, best))

    def _try_burst(self, job: _Job) -> None:
        """On arrival of a burst-marked job: pick the widest obtainable
        width on the best group (free nodes + what lower-priority
        tenants can lend) and pause the lenders."""
        spec = job.job.spec
        inst = job.instances[0]
        menu = spec.width_menu
        pr = spec.priority

        def lendable(i: _Inst) -> int:
            if i.job.priority >= pr or not i.job.job.spec.preemptible \
                    or i.burst_width > 0 or i.resizing:
                return 0
            return i.alloc

        lend = self._reclaimable(lendable)
        best_g, best_w = -1, 0
        for g in range(len(self.cap)):
            budget = min(self.free[g] + lend[g],
                         spec.max_nodes or self.cap[g])
            for w in menu:
                prof = job.job.profile(w)
                if w <= budget and prof.fits[g] and w > best_w:
                    best_g, best_w = g, w
        if best_g < 0 or best_w <= spec.base_width:
            return    # bursting buys nothing; take the normal path
        need = best_w - self.free[best_g]
        if need > 0:
            victims = sorted(
                (i for j2 in self.jobs for i in j2.instances
                 if i.state == "running" and i.group == best_g
                 and lendable(i)),
                key=lambda i: (i.job.priority, i.job.outcome.arrival))
            freed = 0
            for v in victims:
                if freed >= need:
                    break
                freed += self._lend(v)
        inst.group = best_g
        inst.width = best_w
        inst.burst_width = best_w
        inst.conc_cap = 1
        inst.pending = self._remesh(job.job.state_bytes)


__all__ = ["DEGRADATION_POLICIES", "FLEET_POLICIES", "FleetEvent",
           "FleetModel", "FleetResult", "FleetSimulator", "JobOutcome"]
