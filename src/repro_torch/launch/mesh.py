"""Meshes: ordered named axes over a grid of devices.

The port of ``repro/launch/mesh.py``.  A :class:`Mesh` is what both halves
of the port's distribution read:

* the fingerprint index's ``all_to_all`` (``dedup/dist_index.py``) and the
  sharded service's ``mesh=`` route run in one process, as the reference's
  one controller does: a mesh there is an ordered set of named axes over a
  grid of ``torch.device``s, and a device may repeat (4 or 8 logical shards
  on one card, every shard ``cpu`` in the tests);
* parameter and activation sharding (``distributed/sharding.py``) reads only
  ``shape`` and ``axis_names``; :meth:`Mesh.to_device_mesh` turns the mesh
  into a ``torch.distributed`` ``DeviceMesh`` (one rank a device) once a
  process group is up.

Single pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2, data=16,
model=16) = 512; the gradient all-reduce crosses the pod axis.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Named axes (``shape``: axis name -> size, in order) over a grid of
    devices shaped like the mesh (``devices``, None for a mesh that only
    names its shape, as the dry run's production meshes do)."""

    def __init__(self, shape: Mapping[str, int],
                 devices: Optional[Sequence] = None):
        self.shape = {str(k): int(v) for k, v in shape.items()}
        self.axis_names = tuple(self.shape)
        self.devices = None
        if devices is not None:
            grid = np.empty(self.size, dtype=object)
            flat = list(np.asarray(devices, dtype=object).reshape(-1))
            if len(flat) != self.size:
                raise ValueError(f"{len(flat)} devices for a mesh of "
                                 f"{self.size}")
            grid[:] = [torch.device(d) for d in flat]
            self.devices = grid.reshape(tuple(self.shape.values()))

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` (index 0 on every other axis): one a
        shard of that axis."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes: "
                             f"{list(self.shape)})")
        if self.devices is None:
            raise ValueError("this mesh names no devices")
        i = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, i, 0).reshape(
            self.shape[axis], -1)[:, 0])

    def to_device_mesh(self):
        """The ``torch.distributed`` ``DeviceMesh`` of this shape, one rank a
        position (the process group's world size must equal the mesh's)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "Mesh.to_device_mesh needs a process group: call "
                "torch.distributed.init_process_group(backend, init_method, "
                "world_size=..., rank=...) first")
        kind = "cpu"
        if self.devices is not None:
            kind = self.devices.reshape(-1)[0].type
        return init_device_mesh(kind, tuple(self.shape.values()),
                                mesh_dim_names=self.axis_names)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, without devices: (16, 16) over
    ("data", "model"), or (2, 16, 16) with "pod" in front."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_host_mesh(model: int = 1, shards: Optional[int] = None,
                   device="cuda") -> Mesh:
    """A (data, model) mesh over this host's devices of ``device``'s type.

    ``shards`` sets the data axis (default: as many as the devices allow,
    at least 1).  Where the mesh has more positions than the host has
    devices, devices repeat in turn: 4 shards of one card are 4 positions
    on ``cuda:0``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh(device='cuda') needs a card; "
                               "pass device='cpu'")
        pool = ([dev] if dev.index is not None else
                [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())])
    else:
        pool = [dev]
    data = shards if shards is not None else max(1, len(pool) // model)
    n = data * model
    return Mesh({"data": data, "model": model},
                [pool[i % len(pool)] for i in range(n)])
