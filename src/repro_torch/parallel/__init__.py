"""Distribution layer. Ported so far: the memory planner (``policy``); the
mesh, sharding rules, ZeRO and the pipeline wait for their slice (ROADMAP
Queue 1)."""

from repro_torch.parallel.policy import (  # noqa: F401
    H100_HBM_BYTES,
    MemoryPlan,
    plan_memory,
)
