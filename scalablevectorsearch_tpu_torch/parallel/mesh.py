"""Device meshes of one controlling process.

PyTorch counterpart of ``scalablevectorsearch_tpu/parallel/mesh.py``.  The
JAX package lays arrays over a ``jax.sharding.Mesh`` and lets XLA insert
the collectives; here one Python process drives every device: a
:class:`Mesh` is a list (or a dp x shard grid) of ``torch.device`` with
axis names, a sharded tensor is one tensor per device, and the collectives
are explicit reductions on the mesh's first device (``parallel/sharded.py``).

* ``dp`` — query / batch parallelism (the reference's query-parallel
  ``StaticPartition``, index.h:563);
* ``shard`` — dataset-row parallelism (NUMA data partitioning and IVF
  posting-list distribution).

The default device list is every CUDA device.  A device may be named more
than once, through ``devices=`` only: ``["cpu"] * 8`` in the tests, and
k x ``"cuda:0"`` to run k logical shards on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices along named axes: ``devices`` is a tuple (1-D) or a tuple of
    rows (2-D, ``axis_names[0]`` over the rows)."""

    devices: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        sizes = (len(self.devices),)
        if len(self.axis_names) == 2:
            sizes += (len(self.devices[0]),)
        return dict(zip(self.axis_names, sizes))

    @property
    def lead(self) -> torch.device:
        """The device that holds replicated state and reduces partials."""
        return self.axis_devices(self.axis_names[-1])[0]

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` (the first row or column of a 2-D
        mesh)."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has axes {self.axis_names}, not {axis!r}")
        if len(self.axis_names) == 1:
            return list(self.devices)
        if axis == self.axis_names[0]:
            return [row[0] for row in self.devices]
        return list(self.devices[0])


def _device_list(devices) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device; pass devices= (e.g. ['cpu'] * 8)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "dp", *,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA device)."""
    devs = _device_list(devices)
    n = n_devices if n_devices is not None else len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(tuple(devs[:n]), (axis_name,))


def make_mesh_2d(dp: int, shard: int,
                 names: Sequence[str] = ("dp", "shard"), *,
                 devices: Optional[Sequence] = None) -> Mesh:
    """2-D mesh: query-parallel x dataset-sharded."""
    devs = _device_list(devices)
    if dp * shard > len(devs):
        raise ValueError(f"mesh {dp}x{shard} needs {dp * shard} devices, "
                         f"have {len(devs)}")
    rows = tuple(tuple(devs[i * shard:(i + 1) * shard]) for i in range(dp))
    return Mesh(rows, tuple(names))


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a tensor lies on a mesh: in contiguous row blocks along ``axis``,
    one per device of the axis, or (``axis`` None) whole on every device
    of the mesh.  The shard views keep theirs; ``sharded._split`` lays a
    container out by one."""

    mesh: Mesh
    axis: Optional[str] = None

    @property
    def devices(self) -> list:
        if self.axis is not None:
            return self.mesh.axis_devices(self.axis)
        if len(self.mesh.axis_names) == 1:
            return list(self.mesh.devices)
        return [dev for row in self.mesh.devices for dev in row]


def replicated(mesh: Mesh) -> Layout:
    return Layout(mesh)


def row_sharded(mesh: Mesh, axis_name: str) -> Layout:
    return Layout(mesh, axis_name)
