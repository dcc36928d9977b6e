"""The runtime's device meshes, the port of `repro.launch.mesh:29-50`.

A `Mesh` is a small grid of torch devices with the production axis
names ("data", "model"): the dispatch mesh holds one device per corpus
shard on the "data" axis, the "model" axis one wide. On the card its
devices are `cuda:i` for i < torch.cuda.device_count(); a mesh holds the
CPU only when the caller asks for it (`device="cpu"`). Building a mesh
touches no device.

The JAX package's production mesh and hardware peak table
(`make_production_mesh`, `HardwarePeaks`) wait with the launch tooling
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

AXIS_NAMES = ("data", "model")


class Mesh:
    """Devices on a (data, model) grid; `devices[i]` is data slice i, a
    row of `model`-axis devices (one, on the dispatch mesh)."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 axis_names: Tuple[str, ...] = AXIS_NAMES):
        self.devices = [list(row) for row in devices]
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return {"data": len(self.devices),
                "model": len(self.devices[0]) if self.devices else 0}


def local_devices(device="cuda") -> List[torch.device]:
    """The devices a mesh may hold: every local card for "cuda", the one
    CPU for "cpu"."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"no mesh over {kind!r} devices (cuda | cpu)")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("a CUDA mesh was requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_local_mesh(device="cuda") -> Mesh:
    """A 1-device mesh with the production axis names."""
    return Mesh([[local_devices(device)[0]]])


def make_dispatch_mesh(n_shards: int, device="cuda") -> Mesh:
    """The runtime's data-parallel dispatch mesh (MeshDispatcher): up to
    `n_shards` devices on the "data" axis, the model axis 1 wide; the
    local 1-device mesh on a one-card host or for one shard."""
    devs = local_devices(device)
    if len(devs) <= 1 or n_shards <= 1:
        return Mesh([[devs[0]]])
    n = min(int(n_shards), len(devs))
    return Mesh([[d] for d in devs[:n]])
