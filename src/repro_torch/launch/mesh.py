"""Device meshes — the port of ``repro.launch.mesh``.

A ``Mesh`` is the reference's mesh as the sharding rules read it: axis
names and a shape (``mesh.axis_names``, ``mesh.devices.shape``).  It holds
no process group, so the spec functions and the byte estimates run at the
production sizes (16 x 16 and 2 x 16 x 16) on any machine.  ``bind``
attaches it to the running ``torch.distributed`` job: a ``DeviceMesh``
over the same axis names (for the state's DTensor layouts) and one process
group per model group and per data group (for the explicit collectives of
``sharding/comm.py``).  Ranks map to mesh coordinates in row-major order,
as ``init_device_mesh`` maps them.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.models.transformer import ShardCtx


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device_mesh: Any = None             # torch DeviceMesh once bound
    groups: Any = None                  # {axes tuple: process group}

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match axes "
                             f"{self.axis_names}")

    @property
    def devices(self) -> np.ndarray:
        """An object array of the mesh's shape (the reference reads
        ``mesh.devices.shape`` and ``.size``)."""
        return np.empty(self.shape, dtype=object)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    # ------------------------------------------------------------ binding
    @property
    def bound(self) -> bool:
        return self.device_mesh is not None

    def bind(self, device_type: str = "cuda") -> "Mesh":
        """This mesh over the ranks of the initialised default process
        group (``torch.distributed.init_process_group``): raises unless its
        world size equals the mesh size."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized():
            raise RuntimeError("Mesh.bind needs an initialised "
                               "torch.distributed process group")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, "
                             f"the process group has {world}")
        dm = init_device_mesh(device_type, self.shape,
                              mesh_dim_names=self.axis_names)
        groups = {}
        # every rank creates every group, in the same order
        for axes in self._group_axes():
            for key, ranks in sorted(self._rank_lists(axes).items()):
                g = dist.new_group(ranks)
                if dist.get_rank() in ranks:
                    groups[axes] = (g, ranks)
        return dataclasses.replace(self, device_mesh=dm, groups=groups)

    def _group_axes(self):
        names = self.axis_names
        data = tuple(a for a in names if a in ("pod", "data"))
        out = [(a,) for a in names]
        if len(data) > 1:
            out.append(data)
        return out

    def _rank_lists(self, axes: Tuple[str, ...]) -> Dict[tuple, list]:
        """{coordinates on the other axes: ranks along ``axes``, in the
        axes' major-to-minor order}."""
        idx = [self.axis_names.index(a) for a in axes]
        grid = np.arange(self.size).reshape(self.shape)
        out: Dict[tuple, list] = {}
        for coord in itertools.product(*(range(n) for n in self.shape)):
            key = tuple(c for i, c in enumerate(coord) if i not in idx)
            out.setdefault(key, []).append(int(grid[coord]))
        return out

    def group(self, axes: Tuple[str, ...]):
        """(process group, its global ranks in order) of this rank along
        ``axes``."""
        if not self.bound:
            raise RuntimeError("the mesh is not bound to a process group "
                               "(Mesh.bind)")
        return self.groups[tuple(axes)]

    def coordinate(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        """This rank's (or ``rank``'s) mesh coordinate."""
        if rank is None:
            import torch.distributed as dist
            rank = dist.get_rank()
        return tuple(int(c) for c in np.unravel_index(rank, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(shape=(1, 1), axes=("data", "model")) -> Mesh:
    """A small mesh (tests, one host)."""
    return Mesh(tuple(shape), tuple(axes))


def make_ctx(mesh: Mesh) -> ShardCtx:
    axes = mesh.axis_names
    data_axes = tuple(a for a in axes if a in ("pod", "data"))
    return ShardCtx(mesh=mesh, data_axes=data_axes, model_axis="model")
