"""repro_torch.reliability: failure-aware cluster DSE, in closed form.

The port's copy of the JAX package's ``reliability`` package. At COMET's
target scale (thousands of nodes, week-long runs) node MTBF, checkpoint
bandwidth and restart policy are provisioning axes like compute and network.
:class:`FailureModel` and the Young–Daly optimal checkpoint interval turn
every training study cell into ``ckpt_interval_s / ckpt_overhead_frac /
expected_restarts / goodput_frac`` columns (``StudySpec.reliability``
attaches the model; ``reliability.*`` dotted-path axes sweep it), and
``goodput_per_dollar`` re-ranks clusters failure-aware.
:class:`FailureTrace` is the deterministic event stream the fleet timeline
(:class:`repro_torch.fleet.FleetSimulator`) injects: interval-quantized
rollback and wait-vs-shrink degradation, with the ``failures /
lost_work_frac / goodput`` columns of a :class:`repro_torch.fleet.FleetSpec`
(``dse.reliability_fleet_study``).
"""

from repro_torch.reliability.trace import (BLAST_RADII, FAILURE_TRACE_KINDS,
                                           FailureEvent, FailureTrace)
from repro_torch.reliability.model import (FailureModel, daly_interval,
                                           goodput_frac, overhead,
                                           reliability_columns)

__all__ = [
    "BLAST_RADII",
    "FAILURE_TRACE_KINDS",
    "FailureEvent",
    "FailureModel",
    "FailureTrace",
    "daly_interval",
    "goodput_frac",
    "overhead",
    "reliability_columns",
]
