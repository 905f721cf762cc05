"""repro_torch.fleet: the fleet's resize and preemption cost formula.

So far only :mod:`repro_torch.fleet.resize`, which the closed-form
reliability columns (:mod:`repro_torch.reliability`) price a checkpoint write
with. The rest of the JAX package's ``fleet`` package, the multi-tenant
timeline (``jobs``, ``trace``, ``simulator``, ``spec``: ``FleetJobSpec``,
``FleetTrace``, ``FleetSimulator``, ``FleetSpec``), is still to be ported
(ROADMAP Queue 1 item 23's fleet half).
"""

from repro_torch.fleet.resize import (checkpoint_delay, instance_state_bytes,
                                      remesh_delay)

__all__ = ["checkpoint_delay", "instance_state_bytes", "remesh_delay"]
