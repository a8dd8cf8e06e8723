"""The serving engine's tensor-parallel mesh.

Counterpart of ``repro/launch/mesh.py:25-40`` (``make_serving_mesh``).
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

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


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
