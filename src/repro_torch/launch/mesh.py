"""Meshes (port of `repro.launch.mesh`).

A mesh is the port's own record, `Mesh`: its axis names, the size of each
axis, and the torch devices it spans in row-major order. Nothing here
touches a device when the module is imported.

Every device count goes through one census, `local_devices`: the visible
CUDA devices for a CUDA device, ``[cpu]`` for the CPU. The CPU tests stand
N CPU devices in for it (they monkeypatch `local_devices`), the port's form
of the reference's ``--xla_force_host_platform_device_count``; the package
itself has no such knob. `chip_smoke.py` stands several slices of one card
in for it the same way, so that the multi-slice worlds mesh runs on a host
with one card.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device

WORLDS_AXIS = "worlds"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, axis sizes and the devices in row-major order; a
    planning shape (`make_production_mesh`) carries no devices."""

    axis_names: tuple
    axis_sizes: tuple
    devices: tuple = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.axis_sizes} differ in rank")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(
                f"a {self.shape} mesh spans {self.size} devices, got {len(self.devices)}"
            )

    @property
    def shape(self) -> dict:
        """{axis name: size}, as the reference's `mesh.shape`."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def local_devices(device=None) -> list:
    """The census: the torch devices of `device`'s type that this host
    shows (`device=None` means the card, and raises without one)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips a pod; multi_pod adds a 2-pod axis (512). A
    planning shape: no host has these devices, so the record carries the
    axes and sizes and no devices (the planning tools build on the `meta`
    device)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(model_axis: int = 1, device=None) -> Mesh:
    """Whatever this host actually has (the census of `device`'s type), as
    a (data, model) mesh.

    Raises with the actual counts when the host's device count is not a
    multiple of ``model_axis``."""
    devices = local_devices(device)
    n = len(devices)
    if model_axis < 1:
        raise ValueError(f"make_local_mesh: model_axis must be >= 1, got {model_axis}")
    if n % model_axis:
        raise ValueError(
            f"make_local_mesh: {n} local device(s) cannot form a "
            f"(data={n // model_axis}, model={model_axis}) mesh — "
            f"device_count % model_axis must be 0 (got {n} % {model_axis} "
            f"= {n % model_axis}); pick a model_axis that divides {n}"
        )
    return Mesh(("data", "model"), (n // model_axis, model_axis), tuple(devices))


def make_worlds_mesh(num_devices: int | None = None, device=None) -> Mesh:
    """1-D mesh over independent simulation worlds, the engine's scale-out
    axis (`strategy="mesh"`): grid cells split on their leading [B] axis,
    one slice a device, with nothing crossing devices.

    ``num_devices`` takes the first N devices of the census (default: all
    of them); asking for more than the host has raises with both counts."""
    devices = local_devices(device)
    n = len(devices) if num_devices is None else num_devices
    if not 1 <= n <= len(devices):
        raise ValueError(
            f"make_worlds_mesh: asked for {n} devices, host has {len(devices)}"
        )
    return Mesh((WORLDS_AXIS,), (n,), tuple(devices[:n]))


def data_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def data_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))
