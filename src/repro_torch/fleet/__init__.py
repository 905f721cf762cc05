"""repro_torch.fleet: the multi-tenant timeline layer.

The port's copy of the JAX package's ``fleet`` package, held to it by
``tests/test_torch_fleet.py``. COMET's §V-C scheduling story
(``ScheduleModel``: waves x iteration time) priced a *static* fleet. This
package makes the schedule a timeline: heterogeneous jobs arrive on a
trace, queue per node group, preempt each other by priority, grow/shrink
their DP width elastically, and lend the fleet to bursting tenants — every
transition priced by the checkpoint and reshard cost model
(:mod:`repro_torch.fleet.resize`). ``FleetSpec`` lowers straight into
``run_study`` (``fleet.*`` / ``ftrace.*`` / ``fail.*`` dotted-path axes),
so fleet policy is a study axis like any cluster knob. A
:class:`repro_torch.reliability.FailureTrace` injects node failures into the
timeline (interval-quantized rollback, wait-vs-shrink degradation) and
surfaces ``failures / lost_work_frac / goodput`` columns.

The jobs' per-width iteration times come from the port's compiled evaluator
on the device ``run_study`` resolved; the event timeline runs on the host.
"""

from repro_torch.fleet.jobs import FleetJob, FleetJobSpec, WidthProfile
from repro_torch.fleet.resize import (checkpoint_delay, instance_state_bytes,
                                      remesh_delay)
from repro_torch.fleet.simulator import (DEGRADATION_POLICIES, FLEET_POLICIES,
                                         FleetEvent, FleetModel, FleetResult,
                                         FleetSimulator, JobOutcome)
from repro_torch.fleet.spec import (FLEET_COLUMNS, FleetPoint, FleetSpec,
                                    FleetStudy, build_workload, fleet_record,
                                    is_fleet_axis)
from repro_torch.fleet.trace import FLEET_TRACE_KINDS, FleetTrace

__all__ = [
    "DEGRADATION_POLICIES",
    "FLEET_COLUMNS",
    "FLEET_POLICIES",
    "FLEET_TRACE_KINDS",
    "FleetEvent",
    "FleetJob",
    "FleetJobSpec",
    "FleetModel",
    "FleetPoint",
    "FleetResult",
    "FleetSimulator",
    "FleetSpec",
    "FleetStudy",
    "FleetTrace",
    "JobOutcome",
    "WidthProfile",
    "build_workload",
    "checkpoint_delay",
    "fleet_record",
    "instance_state_bytes",
    "is_fleet_axis",
    "remesh_delay",
]
