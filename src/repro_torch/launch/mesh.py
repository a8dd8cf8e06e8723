"""Meshes: the dry-run's production meshes and the serving engine's
tensor-parallel mesh.

``make_production_mesh`` and ``make_host_mesh`` are the counterparts of
``repro/launch/mesh.py:14-22``: the same shapes and axis names, (16, 16)
as ("data", "model"), (2, 16, 16) as ("pod", "data", "model"), and (1,
1).  Where the reference forces 512 host devices, the port builds a
``DeviceMesh`` over a ``fake`` process group of 512 ranks (PyTorch's
``torch.testing._internal.distributed.fake_pg``: collectives return at
once and move nothing), created by the first call in a process and kept
for the process; importing this module touches no process-group state.
A mesh of fewer ranks takes the world's first ones.  The dry-run lays
meta tensors out on it as DTensors, so nothing is allocated on any
device.

``make_serving_mesh`` is the counterpart of ``repro/launch/mesh.py:25-40``.
The reference is single-controller: one process drives a ("data",
"model") mesh of devices through ``shard_map``.  So is the port: one
process drives the ``model`` shards in order, each naming the
``torch.device`` that holds its heads, and launches every shard's kernels
itself.  Where the reference's tests force several host devices
(``--xla_force_host_platform_device_count``), a caller here passes an
explicit device list whose entries may repeat: two or four shards then
share one card (or the CPU), each with its own pool and per-shard
launches at its own head count.

The ``data`` axis is accepted as the reference accepts it, and adds no
work: the reference's serving specs never name ``"data"``, so its data
replicas repeat the first row's computation, which the port runs once.

Shards on more than one distinct CUDA device are refused
(``check_one_device``): no machine of this project has verified them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

# ranks of the dry-run's fake world: the multi-pod mesh's
FAKE_WORLD_SIZE = 512


@dataclass(frozen=True)
class MeshShape:
    """A named mesh: its axes and their sizes, and the ``DeviceMesh`` over
    the fake world that lays tensors out on it (None for a description
    of the shape alone, which the sharding rules take as well)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device_mesh: Any = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def _fake_world() -> None:
    """The process's fake world of ``FAKE_WORLD_SIZE`` ranks, this process
    rank 0; created on the first call.  Raises where another process
    group is already the default one."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run's meshes need the fake process "
                               "group; this process already has a "
                               f"{dist.get_backend()!r} one")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=FAKE_WORLD_SIZE)


def make_mesh(sizes, axis_names) -> MeshShape:
    """A mesh of the given axis sizes and names over the fake world's
    first ranks, row-major."""
    from torch.distributed.device_mesh import DeviceMesh
    sizes, axis_names = tuple(int(s) for s in sizes), tuple(axis_names)
    if math.prod(sizes) > FAKE_WORLD_SIZE:
        raise ValueError(f"mesh {sizes} exceeds the fake world's "
                         f"{FAKE_WORLD_SIZE} ranks")
    _fake_world()
    dm = DeviceMesh("cpu", torch.arange(math.prod(sizes)).reshape(sizes),
                    mesh_dim_names=axis_names)
    return MeshShape(axis_names, sizes, dm)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's shape and names, with no process group."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: 16 x 16 = 256 ranks, ("data", "model"); multi-pod: 2 x
    16 x 16 = 512, ("pod", "data", "model")."""
    m = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(m.sizes, m.axis_names)


def make_host_mesh() -> MeshShape:
    """The one-rank mesh with the production axis names, size 1."""
    return make_mesh((1, 1), ("data", "model"))


@dataclass(frozen=True)
class ServingMesh:
    """A (data, model) serving mesh: its shape and its ``model`` shards
    in order, each the device that holds that shard's heads."""
    shape: Tuple[int, int]
    shards: Tuple[torch.device, ...]

    @property
    def n_shards(self) -> int:
        return self.shape[1]

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The shards' devices, each once, in shard order."""
        return tuple(dict.fromkeys(self.shards))


def make_serving_mesh(shape, devices: Optional[Sequence] = None
                      ) -> Optional[ServingMesh]:
    """The engine's mesh for a (D, M) ``EngineConfig.mesh_shape``, or
    None for (1, 1): the one-device engine runs the code it ran before
    the mesh.  ``devices``: the D * M devices in (data, model) order,
    repeats allowed; by default the first D * M CUDA devices.  Raises
    ``ValueError`` where fewer than D * M devices are given or present.
    The ``model`` shards are the devices of the first data row."""
    d, m = (int(x) for x in shape)
    if d < 1 or m < 1:
        raise ValueError(f"mesh_shape {tuple(shape)}: both axes must be "
                         ">= 1")
    if d * m == 1:
        return None
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(min(avail, d * m))]
    devices = [torch.device(x) for x in devices]
    if len(devices) < d * m:
        raise ValueError(f"mesh_shape {tuple(shape)} needs {d * m} devices, "
                         f"have {len(devices)}")
    return ServingMesh((d, m), tuple(devices[:m]))


def check_one_device(mesh: Optional[ServingMesh]) -> None:
    """Raise ``NotImplementedError`` where ``mesh``'s model shards sit on
    more than one distinct device: the port serves a mesh whose shards
    share one device."""
    if mesh is None:
        return
    devs = mesh.distinct_devices()
    if len(devs) > 1:
        raise NotImplementedError(
            f"mesh_shape {mesh.shape}: model shards on {len(devs)} devices "
            f"({', '.join(map(str, devs))}); the port serves a mesh whose "
            "shards share one device")
