"""Production mesh construction (port of ``repro.launch.mesh``).

A mesh here is a description, :class:`Mesh`: its shape, axis names and
devices. The sharding rules (``models.sharding``) read its axis names
and sizes; nothing places a tensor by it on one card. Single-pod:
(data=16, model=16) = 256 devices. Multi-pod: (pod=2, data=16,
model=16) = 512; the 'pod' axis composes with 'data' for batch and FSDP
sharding.

Functions, not module constants: importing this module touches no
device. Given real devices (the default: every CUDA device, or the CPU
on a host without one), :func:`make_production_mesh` raises when there
are fewer than the shape needs; the dry-run (``launch.dryrun``) builds
it over placeholder devices (:func:`placeholder_devices`, ``meta``)
instead, which allocate nothing and need no card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["Mesh", "make_production_mesh", "make_host_mesh",
           "placeholder_devices", "local_devices"]


@dataclass(frozen=True)
class Mesh:
    """``devices`` laid out row-major over ``axis_sizes``, one size a name
    in ``axis_names``."""

    axis_sizes: tuple
    axis_names: tuple
    devices: tuple

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.axis_sizes} and axes "
                             f"{self.axis_names} differ in length")
        if len(self.devices) != math.prod(self.axis_sizes):
            raise ValueError(f"mesh {self.axis_sizes} needs "
                             f"{math.prod(self.axis_sizes)} devices, given "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def local_devices() -> tuple:
    """Every CUDA device of this host, or the CPU on a host without one."""
    if torch.cuda.is_available():
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device("cpu"),)


def placeholder_devices(n: int) -> tuple:
    """``n`` placeholder (``meta``) devices for a mesh nothing runs on."""
    return (torch.device("meta"),) * n


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    devices = tuple(local_devices() if devices is None else devices)
    if len(devices) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {len(devices)}; the "
            f"dry-run builds it over placeholder devices "
            f"(placeholder_devices({n}))")
    return Mesh(shape, axes, devices[:n])


def make_host_mesh(num: int | None = None, axis: str = "data") -> Mesh:
    """A one-axis mesh over ``num`` (default: all) of this host's devices
    (tests, examples)."""
    devices = local_devices()
    n = num or len(devices)
    if n > len(devices):
        raise RuntimeError(f"host mesh of {n} devices, have {len(devices)}")
    return Mesh((n,), (axis,), devices[:n])
