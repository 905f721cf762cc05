"""Production mesh definitions.

Counterpart of ``src/repro/launch/mesh.py``. The meshes are ``MeshSpec``s,
axis names and sizes with no process behind them, so importing or calling
these creates no process group: they evaluate the sharding rules for a
cluster this machine is not (``parallel.sharding``, ``parallel.zero``). A
run on devices builds its mesh with ``parallel.build_mesh``.
"""

from __future__ import annotations

from repro_torch.parallel.mesh import MeshSpec


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """Single pod: 256 chips as (data=16, model=16).
    Multi-pod: 2 pods = 512 chips as (pod=2, data=16, model=16)."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))


def make_debug_mesh(data: int = 2, model: int = 2) -> MeshSpec:
    """A small (data, model) mesh, as the tests' process groups use."""
    return MeshSpec((data, model), ("data", "model"))
