"""COMET's study runner on the port's evaluator: not ported yet.

The JAX package's ``core/study.py`` runs studies through its own engines,
which cannot take the port's. Until the port has its runner (ROADMAP Queue
1 item 18), time a lowered strategy over a batch of environments with
:func:`repro_torch.core.simulator.time_compiled`.
"""

from __future__ import annotations


def run_study(spec, engine: str = "torch", **kwargs):
    raise NotImplementedError(
        "run_study on the port's engine is not ported yet: ROADMAP Queue 1 "
        "item 18 (core/study.py); repro_torch.core.simulator.time_compiled "
        "is the port's batch evaluator")
