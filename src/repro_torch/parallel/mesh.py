"""Mesh construction and axis conventions.

Counterpart of ``src/repro/parallel/mesh.py``. Axis convention (the COMET
paper's MP/DP vocabulary):
  "pod"   — inter-pod data parallelism (the slow links between pods)
  "data"  — intra-pod data parallelism
  "model" — tensor/expert parallelism (the paper's MP)

DP degree = pod * data; MP degree = model.

Two kinds of mesh: ``build_mesh`` returns a ``torch.distributed`` device
mesh over the processes of an initialised group (one process a device);
``MeshSpec`` is a mesh's axis names and sizes alone, with no process behind
it. The rule functions (here, in ``sharding`` and in ``zero``) read only the
names and the sizes, so they take either: a ``MeshSpec`` evaluates the rules
for a production mesh on one machine, as the reference does with an
abstract mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple, Union

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXES: Tuple[str, ...] = ("pod", "data")
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis sizes and names, in the order of the reference's
    ``AbstractMesh(sizes, axis_names)``."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.sizes)} sizes for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))


Mesh = Union[MeshSpec, DeviceMesh]


def mesh_spec(mesh: Mesh) -> MeshSpec:
    """The names and sizes of a device mesh (a ``MeshSpec`` as it is)."""
    if isinstance(mesh, MeshSpec):
        return mesh
    return MeshSpec(tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names))


def build_mesh(shape: Sequence[int], axes: Sequence[str],
               device_type: str = None) -> DeviceMesh:
    """A device mesh of ``shape`` over the initialised process group, its
    dimensions named ``axes``; ``device_type`` defaults to ``cuda``. Raises
    if no process group has been initialised or if the world is not the
    size of the mesh: it never carries on as one process."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} "
                         f"processes; the group has {dist.get_world_size()}")
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=axes)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The data-parallel axes present in this mesh, outermost first."""
    names = mesh_spec(mesh).axis_names
    return tuple(a for a in DATA_AXES if a in names)


def dp_size(mesh: Mesh) -> int:
    shape = mesh_spec(mesh).shape
    n = 1
    for a in dp_axes(mesh):
        n *= shape[a]
    return n


def mp_size(mesh: Mesh) -> int:
    return mesh_spec(mesh).shape.get(MODEL_AXIS, 1)


def fsdp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes used for FSDP-style parameter sharding: the intra-pod data axis
    only (all-gathering parameters over the inter-pod links every step
    would be prohibitive — the COMET network model quantifies exactly
    this)."""
    return ("data",) if "data" in mesh_spec(mesh).axis_names else ()
