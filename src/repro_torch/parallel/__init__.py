"""Distribution layer: mesh axes, sharding rules, ZeRO, pipeline, int8
compression, tensor parallelism, and the memory planner.

Counterpart of ``src/repro/parallel`` on ``torch.distributed``: one process
a device, a ``DeviceMesh`` with the reference's axis names, the collectives
explicit. ``tensor`` is the port's own: the reference leaves the
partitioning of the compute to GSPMD."""

from repro_torch.parallel.mesh import (  # noqa: F401
    MODEL_AXIS,
    MeshSpec,
    build_mesh,
    dp_axes,
    dp_size,
    fsdp_axes,
    mp_size,
)
from repro_torch.parallel.policy import (  # noqa: F401
    H100_HBM_BYTES,
    MemoryPlan,
    plan_memory,
)
from repro_torch.parallel.sharding import (  # noqa: F401
    batch_shardings,
    cache_shardings,
    param_shardings,
    param_spec,
)
from repro_torch.parallel.zero import opt_state_shardings  # noqa: F401
