"""Diagnostics framework: rule registry, severities, reports.

The port's copy of the JAX package's ``analysis/diagnostics.py``, with a
registry of its own that holds the reference's eight packs (workload,
compiled, study, cluster, serving, search, fleet, reliability).

A *rule* is a pure function over existing IR (a Workload, a
CompiledWorkload, a StudySpec, a cluster) that yields findings without
running the simulator.  Rules register under a short code (``W101``,
``C103``, ...) grouped into packs; :func:`run_pack` executes one pack
against a target and returns :class:`Diagnostic` records.  Per-rule
enable/severity overrides live in :class:`RuleConfig`.

Severity contract:

* ``error``   — the object violates an invariant the engines rely on; a
  study over it would crash or produce wrong numbers.  The command line
  (``python -m repro_torch.analysis``) exits non-zero on any
  error-severity finding, and ``run_study(validate="error")`` refuses to
  run it.
* ``warning`` — suspicious but representable (a degenerate communicator,
  an empty strategy space, a bandwidth inversion).
* ``info``    — advisory (e.g. a cluster with no cost model attached).
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, FrozenSet, Iterable, List, Mapping,
                    Optional, Sequence, Tuple)

SEVERITIES: Tuple[str, ...] = ("info", "warning", "error")
_SEV_RANK: Dict[str, int] = {s: i for i, s in enumerate(SEVERITIES)}

PACKS: Tuple[str, ...] = ("workload", "compiled", "study", "cluster",
                          "serving", "search", "fleet", "reliability")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: a rule code, its effective severity, where, and what."""

    code: str
    severity: str
    location: str
    message: str

    def __str__(self) -> str:
        return f"{self.severity}[{self.code}] {self.location}: {self.message}"

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


# A check receives (target, context) and yields (location, message) pairs.
CheckFn = Callable[[Any, Dict[str, Any]], Iterable[Tuple[str, str]]]


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    pack: str
    severity: str          # default severity; RuleConfig may override
    description: str
    check: CheckFn


_REGISTRY: Dict[str, Rule] = {}


def rule(code: str, pack: str, severity: str,
         description: str) -> Callable[[CheckFn], CheckFn]:
    """Register a check function under ``code`` in ``pack``."""
    if severity not in SEVERITIES:
        raise ValueError(f"unknown severity {severity!r} "
                         f"(expected one of {SEVERITIES})")
    if pack not in PACKS:
        raise ValueError(f"unknown pack {pack!r} (expected one of {PACKS})")

    def deco(fn: CheckFn) -> CheckFn:
        if code in _REGISTRY:
            raise ValueError(f"duplicate rule code {code!r}")
        _REGISTRY[code] = Rule(code, pack, severity, description, fn)
        return fn

    return deco


def list_rules(pack: Optional[str] = None) -> List[Rule]:
    """All registered rules (optionally one pack), sorted by code."""
    rules = sorted(_REGISTRY.values(), key=lambda r: r.code)
    if pack is None:
        return rules
    return [r for r in rules if r.pack == pack]


@dataclasses.dataclass(frozen=True)
class RuleConfig:
    """Per-rule suppression and severity overrides.

    ``disable`` names rule codes to skip entirely; ``severity`` remaps a
    rule's default severity (e.g. promote ``W102`` to ``error`` in a
    strict CI lane, or demote ``K102`` to ``info`` for a deliberately
    inverted hierarchy)."""

    disable: FrozenSet[str] = frozenset()
    severity: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        for code, sev in self.severity.items():
            if sev not in SEVERITIES:
                raise ValueError(f"unknown severity {sev!r} for {code!r}")

    def enabled(self, code: str) -> bool:
        return code not in self.disable

    def severity_of(self, r: Rule) -> str:
        return self.severity.get(r.code, r.severity)


def run_pack(pack: str, target: Any,
             ctx: Optional[Dict[str, Any]] = None,
             config: Optional[RuleConfig] = None) -> List[Diagnostic]:
    """Run every enabled rule of ``pack`` against ``target``."""
    cfg = config if config is not None else RuleConfig()
    context = ctx if ctx is not None else {}
    out: List[Diagnostic] = []
    for r in list_rules(pack):
        if not cfg.enabled(r.code):
            continue
        sev = cfg.severity_of(r)
        for location, message in r.check(target, context):
            out.append(Diagnostic(r.code, sev, location, message))
    return out


def max_severity(diags: Sequence[Diagnostic]) -> Optional[str]:
    if not diags:
        return None
    return max((d.severity for d in diags), key=lambda s: _SEV_RANK[s])


def has_errors(diags: Sequence[Diagnostic]) -> bool:
    return any(d.severity == "error" for d in diags)


def format_report(diags: Sequence[Diagnostic]) -> str:
    """Human-readable report, most severe first, stable within severity."""
    ordered = sorted(enumerate(diags),
                     key=lambda p: (-_SEV_RANK[p[1].severity], p[0]))
    lines = [str(d) for _, d in ordered]
    counts = {s: sum(1 for d in diags if d.severity == s) for s in SEVERITIES}
    summary = ", ".join(f"{counts[s]} {s}" for s in reversed(SEVERITIES))
    lines.append(f"-- {len(diags)} diagnostic(s): {summary}")
    return "\n".join(lines)


class AnalysisError(RuntimeError):
    """Raised by ``run_study(validate='error')`` on error-severity findings.

    Carries the full diagnostic list (not just the errors) on
    ``.diagnostics``."""

    def __init__(self, diagnostics: Sequence[Diagnostic]) -> None:
        self.diagnostics: List[Diagnostic] = list(diagnostics)
        errors = [d for d in self.diagnostics if d.severity == "error"]
        super().__init__(
            f"{len(errors)} error-severity diagnostic(s):\n"
            + "\n".join(str(d) for d in errors))
