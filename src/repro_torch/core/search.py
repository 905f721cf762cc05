"""Design-space *search* over studies: Pareto fronts and real optimizers.

The port's copy of the JAX package's ``core/search.py``, held to it
record for record, frontier for frontier and trace for trace by
``tests/test_torch_search.py``. The grid runner
(:func:`repro_torch.core.study.run_study`) prices every cell of an axis
product; this module spends evaluations where they matter:

* :func:`pareto_front` — non-dominated enumeration over any objective
  columns, default the paper triple (time, TCO, energy).  Every record is
  annotated with ``pareto_rank`` (0 = frontier, NSGA-style peeled fronts)
  and ``pareto_optimal``; the returned :class:`StudyResult` keeps only
  the frontier cells.
* :func:`successive_halving` — rung-by-rung fidelity scaling (the
  shape's ``global_batch``); each rung keeps the best ``1/eta`` cells,
  the last rung runs survivors at full fidelity.
* :func:`evolutionary_search` — a seeded mutation/tournament loop over
  the *joint* (strategy x cluster-axis) genome.

Each rung or generation is one call of the runner's
``_run_cells_compiled`` with fresh memos (a raising cell leaves nothing
behind that could poison a later batch), so its strategies' environments
are timed in one batch on ``device`` (the caller's, else the GPU). Both
optimizers return a :class:`SearchResult` whose ``trace`` and ``final``
are ordinary :class:`StudyResult` objects — every evaluated cell carries
``search_round`` / ``search_fidelity`` / ``search_score`` columns
(reserved in :class:`StudySpec`), so ``select``/``pivot``/``to_csv`` and
the R1xx rules (:mod:`repro_torch.analysis.rules_search`) work on search
output unchanged.  Scores are minimization-normalized:
``Objective.score`` negates ``maximize`` columns, so "lower is better"
uniformly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.placement import get_placement
from repro_torch.core.study import (
    CellResult,
    StudyResult,
    StudySpec,
    _cells,
    _run_cells_compiled,
    as_strategy_space,
)

__all__ = [
    "DEFAULT_OBJECTIVES",
    "Objective",
    "SearchResult",
    "dominates",
    "evolutionary_search",
    "pareto_front",
    "pareto_rank",
    "successive_halving",
]


# ===================================================================== #
# Objectives
# ===================================================================== #

@dataclasses.dataclass(frozen=True)
class Objective:
    """One ranking column.  ``score`` is minimization-normalized (the
    negation of a ``maximize`` column), so every consumer — dominance,
    halving, evolution — uniformly treats lower as better.  Missing or
    non-numeric values score ``+inf`` (never selected, never dominant)."""

    column: str
    maximize: bool = False
    label: Optional[str] = None

    @property
    def name(self) -> str:
        return self.label or self.column

    def score(self, record: Mapping[str, Any]) -> float:
        v = record.get(self.column)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return math.inf
        v = float(v)
        if math.isnan(v):
            return math.inf
        return -v if self.maximize else v


#: The paper triple: iteration time, total cost of ownership, energy
#: dollars (all runner-written record columns, all minimized).
DEFAULT_OBJECTIVES: Tuple[Objective, ...] = (
    Objective("total", label="time"),
    Objective("tco"),
    Objective("energy_usd", label="energy"),
)


def _scores(record: Mapping[str, Any],
            objectives: Sequence[Objective]) -> Tuple[float, ...]:
    return tuple(o.score(record) for o in objectives)


def _participates(record: Mapping[str, Any],
                  objectives: Sequence[Objective]) -> bool:
    """Feasible and finite on every objective — the cells dominance is
    defined over.  Everything else gets ``pareto_rank=None``."""
    if not record.get("feasible", True):
        return False
    return all(math.isfinite(s) for s in _scores(record, objectives))


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """Pareto dominance on minimization-normalized score vectors:
    ``a`` no worse everywhere and strictly better somewhere."""
    return all(x <= y for x, y in zip(a, b)) \
        and any(x < y for x, y in zip(a, b))


def pareto_rank(records: Sequence[Mapping[str, Any]],
                objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
                ) -> List[Optional[int]]:
    """Non-dominated sorting: rank 0 is the frontier, rank 1 the frontier
    after removing rank 0, and so on (NSGA-style peeling).  Infeasible
    records and records non-finite on any objective get ``None``."""
    scores = [_scores(r, objectives) for r in records]
    alive = [i for i, r in enumerate(records)
             if _participates(r, objectives)]
    ranks: List[Optional[int]] = [None] * len(records)
    depth = 0
    while alive:
        front = [i for i in alive
                 if not any(dominates(scores[j], scores[i])
                            for j in alive if j != i)]
        for i in front:
            ranks[i] = depth
        alive = [i for i in alive if i not in set(front)]
        depth += 1
    return ranks


def pareto_front(result: StudyResult,
                 objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
                 ) -> StudyResult:
    """Annotate every record of ``result`` with ``pareto_rank`` /
    ``pareto_optimal`` (in place, like ``normalize``) and return the
    frontier cells as a new :class:`StudyResult` on the same spec."""
    objectives = tuple(objectives)
    if not objectives:
        raise ValueError("pareto_front needs at least one objective")
    ranks = pareto_rank(result.records, objectives)
    for cell, rank in zip(result.cells, ranks):
        cell.record["pareto_rank"] = rank
        cell.record["pareto_optimal"] = rank == 0
    kept = [c for c, r in zip(result.cells, ranks) if r == 0]
    return StudyResult(spec=result.spec, cells=kept)


# ===================================================================== #
# Search results
# ===================================================================== #

@dataclasses.dataclass
class SearchResult:
    """Optimizer output: the full evaluation ``trace`` plus the ``final``
    round/rung, both plain :class:`StudyResult` objects (records carry
    ``search_round`` / ``search_fidelity`` / ``search_score``)."""

    spec: StudySpec
    objectives: Tuple[Objective, ...]
    trace: StudyResult
    final: StudyResult
    evaluations: int

    @property
    def records(self) -> List[Dict[str, Any]]:
        return self.trace.records

    def best(self) -> CellResult:
        """Feasible cell with the lowest (minimization-normalized)
        ``search_score`` among *full-fidelity* evaluations — scores from
        reduced-batch halving rungs are not comparable to final ones."""
        pool = [c for c in self.trace.cells
                if c.record.get("feasible", True)
                and c.record.get("search_fidelity", 1.0) == 1.0
                and math.isfinite(c.record.get("search_score", math.inf))]
        if not pool:
            raise ValueError("search produced no feasible full-fidelity "
                             "evaluation")
        return min(pool, key=lambda c: c.record["search_score"])


def _annotate(cells: Sequence[CellResult], rnd: int, fidelity: float,
              objective: Objective) -> None:
    for c in cells:
        c.record["search_round"] = rnd
        c.record["search_fidelity"] = fidelity
        c.record["search_score"] = objective.score(c.record)


# ===================================================================== #
# Successive halving
# ===================================================================== #

def _fidelity_schedule(rungs: int, min_fidelity: float) -> List[float]:
    if rungs < 1:
        raise ValueError(f"rungs must be >= 1, got {rungs}")
    if not 0.0 < min_fidelity <= 1.0:
        raise ValueError(f"min_fidelity must be in (0, 1], "
                         f"got {min_fidelity}")
    if rungs == 1:
        return [1.0]
    return [min_fidelity ** (1.0 - r / (rungs - 1)) for r in range(rungs)]


def _at_fidelity(spec: StudySpec, fidelity: float) -> StudySpec:
    if fidelity == 1.0:
        return spec
    shape = spec.shape
    gb = max(1, int(round(shape.global_batch * fidelity)))
    return dataclasses.replace(
        spec, shape=dataclasses.replace(shape, global_batch=gb))


def successive_halving(spec: StudySpec,
                       objective: Objective = Objective("total"),
                       eta: int = 3,
                       rungs: int = 3,
                       min_fidelity: float = 0.25,
                       device=None) -> SearchResult:
    """Rung-by-rung elimination over the spec's full cell product.

    Rung ``r`` evaluates the surviving cells at fidelity ``f_r`` (a
    geometric ramp from ``min_fidelity`` to 1.0 applied to
    ``shape.global_batch``) and keeps the best ``ceil(n / eta)`` by
    ``objective``; the last rung always runs at full fidelity, so the
    ``final`` result is authoritative.  Cells infeasible at a rung rank
    last (standard SHA behavior: they are culled, not retried).

    Requires the default workload builder (``spec.model`` +
    ``spec.shape``): the batch is the fidelity lever.  Keep
    ``min_fidelity`` a power-of-two fraction when strategies carry large
    DP degrees, so scaled batches stay divisible."""
    if spec.model is None or spec.shape is None or spec.workload is not None:
        raise ValueError(
            "successive_halving scales shape.global_batch, so the study "
            "must use the default workload builder (model + shape set, "
            "no custom workload)")
    if eta < 2:
        raise ValueError(f"eta must be >= 2, got {eta}")
    device = resolve_device(device)
    cells = _cells(spec)
    if not cells:
        raise ValueError(f"study {spec.name!r} has no cells to search")
    trace: List[CellResult] = []
    final: List[CellResult] = []
    alive = list(range(len(cells)))
    evals = 0
    for rnd, fidelity in enumerate(_fidelity_schedule(rungs, min_fidelity)):
        rung_spec = _at_fidelity(spec, fidelity)
        results = _run_cells_compiled(rung_spec, [cells[i] for i in alive],
                                      {}, {}, device)
        evals += len(results)
        _annotate(results, rnd, fidelity, objective)
        trace.extend(results)
        order = sorted(range(len(alive)),
                       key=lambda k: results[k].record["search_score"])
        if rnd == rungs - 1:
            final = [results[k] for k in order]
        else:
            keep = max(1, math.ceil(len(alive) / eta))
            alive = [alive[k] for k in order[:keep]]
    return SearchResult(spec=spec, objectives=(objective,),
                        trace=StudyResult(spec=spec, cells=trace),
                        final=StudyResult(spec=spec, cells=final),
                        evaluations=evals)


# ===================================================================== #
# Evolutionary search
# ===================================================================== #

# A genome is one integer per cluster/placement axis (an index into the
# axis's value tuple) plus one strategy gene (an index into the strategy
# space resolved against the genome's own overridden cluster — the list
# length varies per cluster, so the gene is taken modulo it).
_Genome = Tuple[Tuple[int, ...], int]


def _genome_cell(spec: StudySpec, genome: _Genome) -> tuple:
    axis_idx, strat_idx = genome
    space = as_strategy_space(spec.strategies)
    cluster = spec.cluster
    pl = get_placement(spec.placement)
    point: Dict[str, Any] = {}
    for axis, vi in zip(spec.axes, axis_idx):
        value = axis.values[vi]
        if axis.kind == "placement":
            pl = get_placement(value)
            point[axis.name] = pl.label if pl is not None else None
        else:
            point[axis.name] = value
            cluster = axis.override(cluster, value)
    if space is None:
        return (None, point, cluster, pl)
    strategies = space.specs(cluster.num_nodes if cluster is not None else 0)
    if not strategies:
        return None
    return (strategies[strat_idx % len(strategies)], point, cluster, pl)


def _cell_key(cell: tuple) -> tuple:
    """Canonical identity of a resolved cell: distinct genomes whose
    strategy genes agree modulo the strategy-list length (or whose axis
    values coincide) are the *same* evaluation and must share one
    simulation."""
    strategy, point, _, placement = cell
    return (str(strategy), tuple(sorted(point.items())),
            placement.label if placement is not None else None)


def _mutate(rng: np.random.Generator, genome: _Genome, spec: StudySpec,
            rate: float) -> _Genome:
    axis_idx, strat_idx = genome
    out = list(axis_idx)
    for k, axis in enumerate(spec.axes):
        n = len(axis.values)
        if n > 1 and rng.random() < rate:
            step = 1 if rng.random() < 0.5 else -1
            out[k] = int((out[k] + step) % n)
    if rng.random() < rate:
        # Strategy lists are cluster-dependent, so the gene mutates in a
        # fixed large index space and resolves modulo the actual length.
        strat_idx = int(rng.integers(0, 1 << 16))
    return (tuple(out), strat_idx)


def evolutionary_search(spec: StudySpec,
                        objective: Objective = Objective("total"),
                        population: int = 16,
                        generations: int = 8,
                        mutation_rate: float = 0.35,
                        elite_frac: float = 0.25,
                        seed: int = 0,
                        device=None) -> SearchResult:
    """Seeded (mu + lambda)-style loop over the joint strategy x cluster
    axes.  Each generation batch-evaluates its unseen genomes through
    ``_run_cells_compiled`` (one device batch per generation), keeps the
    ``elite_frac`` best, and refills by mutating tournament-selected
    parents.  Deterministic for a fixed ``seed`` (``np.random.
    default_rng``, so a seed draws the reference's genomes).  The trace
    holds every *evaluation*: genomes are memoized by their resolved cell
    (strategy, axis point, placement), so no cell is ever simulated twice
    — even when distinct raw genes alias the same strategy modulo the
    cluster-dependent list length."""
    if population < 2:
        raise ValueError(f"population must be >= 2, got {population}")
    if generations < 1:
        raise ValueError(f"generations must be >= 1, got {generations}")
    rng = np.random.default_rng(seed)
    dims = [len(a.values) for a in spec.axes]
    if spec.cluster is None and not any(a.kind != "placement"
                                        for a in spec.axes):
        raise ValueError(
            "evolutionary_search needs a cluster (StudySpec.cluster or a "
            "cluster-valued axis) to resolve strategies against")
    device = resolve_device(device)

    def random_genome() -> _Genome:
        return (tuple(int(rng.integers(0, d)) for d in dims),
                int(rng.integers(0, 1 << 16)))

    seen: Dict[tuple, CellResult] = {}
    keys: Dict[_Genome, Optional[tuple]] = {}
    trace: List[CellResult] = []
    evals = 0
    pop = [random_genome() for _ in range(population)]
    fitness: Dict[_Genome, float] = {}
    last_gen: List[CellResult] = []
    for gen in range(generations):
        batch: List[Tuple[tuple, tuple]] = []   # (key, cell) to simulate
        for g in dict.fromkeys(pop):
            if g in keys:
                continue
            cell = _genome_cell(spec, g)
            if cell is None:     # empty strategy list for this cluster
                keys[g] = None
                fitness[g] = math.inf
                continue
            key = _cell_key(cell)
            keys[g] = key
            if key not in seen and all(k != key for k, _ in batch):
                batch.append((key, cell))
        if batch:
            results = _run_cells_compiled(spec, [c for _, c in batch],
                                          {}, {}, device)
            evals += len(results)
            _annotate(results, gen, 1.0, objective)
            trace.extend(results)
            for (key, _), res in zip(batch, results):
                seen[key] = res
        for g in pop:
            if g not in fitness and keys[g] is not None:
                r = seen[keys[g]].record
                fitness[g] = (r["search_score"]
                              if r.get("feasible", True) else math.inf)
        ranked = sorted(dict.fromkeys(pop), key=lambda g: fitness[g])
        done = set()
        last_gen = []
        for g in ranked:
            key = keys[g]
            if key is not None and key not in done:
                done.add(key)
                last_gen.append(seen[key])
        if gen == generations - 1:
            break
        elites = ranked[:max(1, int(round(elite_frac * population)))]
        nxt = list(elites)
        while len(nxt) < population:
            a, b = (ranked[int(rng.integers(0, len(ranked)))]
                    for _ in range(2))
            parent = a if fitness[a] <= fitness[b] else b
            nxt.append(_mutate(rng, parent, spec, mutation_rate))
        pop = nxt
    return SearchResult(spec=spec, objectives=(objective,),
                        trace=StudyResult(spec=spec, cells=trace),
                        final=StudyResult(spec=spec, cells=last_gen),
                        evaluations=evals)
