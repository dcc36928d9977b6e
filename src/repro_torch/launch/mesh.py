"""Device meshes and the hardware peak sets, the port of `repro.launch.mesh`.

A `Mesh` is a grid of torch devices with named axes. The dispatch mesh
holds one device per corpus shard on the "data" axis, the "model" axis
one wide; on the card its devices are `cuda:i` for i <
torch.cuda.device_count(), and it holds the CPU only when the caller asks
for it (`device="cpu"`). The production meshes of the dry run
(`make_production_mesh`: (data 16, model 16), or (pod 2, data 16, model
16)) are virtual: their entries are `meta` placeholders, so a dry run
reckons a pod's shardings on a machine with no card. Building a mesh
touches no device.

This module is also where the port's roofline peaks live: the dry run
(`launch/dryrun.py`) and the hand kernels' bounds (`kernels/cost.py`)
price against a `HardwarePeaks` set, and `resolve_peaks` applies the
``STRETTO_ROOFLINE_*`` overrides and names the result.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

AXIS_NAMES = ("data", "model")


class Mesh:
    """Devices on a grid with one named axis per dimension: `devices` is
    a nested list, `devices[i]` the slice at index i of the first axis
    (on the dispatch mesh, data slice i: a row of one "model" device)."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...] =
                 AXIS_NAMES):
        def nest(x, depth):
            return [nest(r, depth - 1) for r in x] if depth > 1 else list(x)
        self.axis_names = tuple(axis_names)
        self.devices = nest(devices, len(self.axis_names))
        sizes, level = [], self.devices
        for _ in self.axis_names:
            sizes.append(len(level))
            level = level[0] if level else []
        self.axis_sizes = tuple(sizes)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production mesh, virtual: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model"), each entry a
    `meta` placeholder."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return virtual_mesh(shape, axes)


def virtual_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of `meta` placeholders with these axis sizes and names."""
    def grid(dims):
        if len(dims) == 1:
            return [torch.device("meta")] * dims[0]
        return [grid(dims[1:]) for _ in range(dims[0])]
    return Mesh(grid(tuple(shape)), tuple(axes))


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


@dataclass(frozen=True)
class HardwarePeaks:
    """One hardware peak set a roofline can price against."""
    name: str           # which peak set this is ("h100-sxm", "ci-cpu", ...)
    flops: float        # FLOP/s (per chip)
    hbm_bw: float       # B/s (per chip)
    ici_bw: float = 0.0  # B/s per interconnect link (0: single chip)


# TPU v5e per-chip peaks: the JAX package's dry-run roofline prices
# against them (kept so the two packages' tables agree field by field)
TPU_V5E = HardwarePeaks("tpu-v5e", flops=197e12, hbm_bw=819e9, ici_bw=50e9)

# NVIDIA H100 SXM data-sheet peaks: bf16 dense tensor cores, HBM3, NVLink
# per direction. The port's dry run and kernel bounds price against these.
H100_SXM = HardwarePeaks("h100-sxm", flops=989e12, hbm_bw=3.35e12,
                         ici_bw=450e9)

# deliberately conservative CPU-class peaks — what the CI perf gates on
# CPU runners price against (a bound that is meaningful on the runner)
CI_CPU = HardwarePeaks("ci-cpu", flops=100e9, hbm_bw=20e9)


def resolve_peaks(default: HardwarePeaks = CI_CPU) -> HardwarePeaks:
    """The peak set a roofline run prices against: `default` unless the
    ``STRETTO_ROOFLINE_GFLOPS`` / ``STRETTO_ROOFLINE_BW_GBS`` env
    overrides are set; the returned name records that overrides applied."""
    gflops = os.environ.get("STRETTO_ROOFLINE_GFLOPS")
    bw_gbs = os.environ.get("STRETTO_ROOFLINE_BW_GBS")
    if gflops is None and bw_gbs is None:
        return default
    return HardwarePeaks(
        name=f"{default.name}+env",
        flops=float(gflops) * 1e9 if gflops else default.flops,
        hbm_bw=float(bw_gbs) * 1e9 if bw_gbs else default.hbm_bw,
        ici_bw=default.ici_bw)
