"""COMET's analytic evaluator and study runner in the PyTorch package.

The port's copies of the JAX package's jax-free analytic modules
(``topology``, ``collectives``, ``gemm``, ``workload``, ``compiled``,
``memory``, ``cluster``, ``placement``, ``roofline``), held equal to the
reference by ``tests/test_torch_core.py``, ``tests/test_torch_placement.py``
and ``tests/test_torch_serving.py``; the port
of its batch evaluator, ``torch_engine`` (the JAX package's ``jax_engine``)
under the compiled half of ``simulator``; and its study runner
(``study.run_study``) with the paper's case studies and their wrappers
(``dse``, ``strategy``) and the search over them (``search``), held record
for record by ``tests/test_torch_study.py``,
``tests/test_torch_paper_claims.py`` and ``tests/test_torch_search.py``.
``simulator.time_compiled``, ``study.run_study`` and everything that calls
it run on the GPU unless the caller asks for ``device="cpu"``.
"""

from repro_torch.core.cluster import (  # noqa: F401
    ClusterConfig,
    ClusterSpec,
    CostModel,
    NodeConfig,
    PodSpec,
    get_cluster,
    list_clusters,
)
from repro_torch.core.topology import (  # noqa: F401
    HierarchicalSwitch,
    SingleSwitch,
    Topology,
    Torus,
)
from repro_torch.core.placement import (  # noqa: F401
    EMAwarePlacement,
    ExplicitPlacement,
    JobSpec,
    PaperPlacement,
    Placement,
    Schedule,
    ScheduleModel,
    get_placement,
    list_placements,
)
from repro_torch.core.simulator import (  # noqa: F401
    IterationBreakdown,
    group_breakdowns_compiled,
    simulate_iteration_compiled,
    time_compiled,
)
from repro_torch.core.study import (  # noqa: F401
    Axis,
    ExplicitSpace,
    FactorizationSpace,
    GridSpace,
    ParallelSpec,
    PowerOfTwoSpace,
    StrategySpace,
    StudyResult,
    StudySpec,
    get_by_path,
    placement_axis,
    run_study,
    set_by_path,
)
from repro_torch.core.strategy import best_strategy, sweep_strategies  # noqa: F401
from repro_torch.core.search import (  # noqa: F401
    DEFAULT_OBJECTIVES,
    Objective,
    SearchResult,
    evolutionary_search,
    pareto_front,
    successive_halving,
)
from repro_torch.core.workload import Workload, decompose, decompose_dlrm  # noqa: F401
