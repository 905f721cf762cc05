"""repro_torch.serving — analytic serving-fleet design-space exploration.

The port's copy of the JAX package's ``serving`` package: the serving twin of
the training DSE stack. Prefill/decode roofline workloads
(:mod:`~repro_torch.serving.workload`), arrival-process traffic and the SLO
fleet queue (:mod:`~repro_torch.serving.traffic`), disaggregation as a
placement (:mod:`~repro_torch.serving.placement`), and the ``run_study``
wiring (:mod:`~repro_torch.serving.spec`). All of it is host code (numpy and
Python); ``ServingWorkload.engine_schedule`` reproduces the schedule of
:class:`repro_torch.serve.engine.Engine` tick for tick.
"""

from repro_torch.serving.placement import (COLOCATED, DISAGGREGATED,
                                           ColocatedPlacement,
                                           DisaggregatedPlacement, PhasePlan,
                                           get_serving_placement,
                                           kv_transfer_time,
                                           list_serving_placements)
from repro_torch.serving.spec import (SERVING_COLUMNS, ServingPoint,
                                      ServingSpec, ServingStudy,
                                      is_serving_axis, serving_placement_axis,
                                      serving_record)
from repro_torch.serving.traffic import (FleetMetrics, ReplicaProfile,
                                         SLOSpec, TrafficTrace,
                                         simulate_colocated,
                                         simulate_disaggregated)
from repro_torch.serving.workload import (ServingModel, ServingWorkload,
                                          TickTrace)

__all__ = [
    "COLOCATED", "DISAGGREGATED", "ColocatedPlacement",
    "DisaggregatedPlacement", "FleetMetrics", "PhasePlan", "ReplicaProfile",
    "SERVING_COLUMNS", "SLOSpec", "ServingModel", "ServingPoint",
    "ServingSpec", "ServingStudy", "ServingWorkload", "TickTrace",
    "TrafficTrace", "get_serving_placement", "is_serving_axis",
    "kv_transfer_time", "list_serving_placements", "serving_placement_axis",
    "serving_record", "simulate_colocated", "simulate_disaggregated",
]
