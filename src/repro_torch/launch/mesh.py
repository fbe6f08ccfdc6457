"""Meshes of the launch plan: the JAX package's ``launch/mesh.py``.

A ``MeshSpec`` names a mesh's axes and sizes and touches no device and no
process group, so the plan (``launch.sharding``, ``launch.specs``,
``launch.dryrun``) works out every device's shard on one host.  Each
device of a mesh is read as one H100.  ``device_mesh`` builds the
``torch.distributed`` mesh of the same names over the current process
group, for placing tensors with ``sharding.placements``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{self.axis_names} against sizes {self.shape}")

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """One pod = 16 x 16 = 256 devices; multi-pod adds a leading ``pod``
    data-parallel axis across 2 pods (512 devices).  The JAX package's
    layouts, so the two packages' plans line up record for record."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def mesh_name(multi_pod: bool) -> str:
    """The records' name of a production mesh."""
    return "pod2x16x16" if multi_pod else "pod16x16"


def data_axes(mesh: MeshSpec) -> Tuple[str, ...]:
    """The batch-parallel axes of a mesh (('pod','data') or ('data',))."""
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def make_test_mesh(data: int = 2, model: int = 2) -> MeshSpec:
    """A small mesh, for tests on a few processes."""
    return MeshSpec(("data", "model"), (data, model))


def device_mesh(spec: MeshSpec, device: Optional[str] = None):
    """The ``torch.distributed.device_mesh.DeviceMesh`` of ``spec`` over the
    current process group, ranks laid out row-major as ``jax.make_mesh``
    lays out devices.  Raises where the group's size is not the mesh's:
    the mesh is never padded or shrunk.  ``device`` as ``resolve_device``:
    the card unless asked."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.utils.device import resolve_device

    dev = resolve_device(device)
    world = dist.get_world_size()
    if world != spec.size:
        raise ValueError(f"mesh {dict(spec.axis_sizes)} needs {spec.size} "
                         f"ranks; the group has {world}")
    return init_device_mesh(dev.type, spec.shape,
                            mesh_dim_names=spec.axis_names)
