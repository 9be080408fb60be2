"""Mesh descriptions (counterpart of ``repro.launch.mesh``).

The reference builds ``jax.sharding.Mesh`` objects over TPU chips.  The
port runs on one card and never partitions a program, so a mesh here is
a :class:`MeshSpec`: the axis names, their sizes and, where there are
any, the devices.  The sharding rules (``distributed.sharding``) are
divisibility arithmetic over the sizes alone, so the production layouts
need no devices at all, and the dry run (``launch.dryrun``) reckons each
cell's bytes per device on them.

``make_production_mesh`` describes the reference's TPU v5e pod layouts:
(16, 16) ``data`` x ``model`` chips, and (2, 16, 16) with a ``pod`` axis
in front whose traffic is the gradient all-reduce only.  They are kept
so that the rules can be held against the reference's on the same
shapes; no device of this port sits behind them.  ``make_local_mesh``
covers the CUDA devices present (one H100 on the machine this port was
measured on).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis names and sizes of a device mesh, and its devices where the
    mesh covers real ones (empty for a described layout)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Devices the mesh spans (``mesh.devices.size``)."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's TPU pod layouts, (16, 16) ``data`` x ``model``
    or, ``multi_pod``, (2, 16, 16) ``pod`` x ``data`` x ``model``: a
    description for the sharding rules and the dry run, with no
    devices."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_local_mesh(model_parallel: int = 1,
                    devices: Optional[Sequence[torch.device]] = None
                    ) -> MeshSpec:
    """(data, model) over ``devices``: by default every CUDA device
    present, raising when there is none; ``model_parallel`` is clipped to
    [1, n] as the reference clips it."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_local_mesh covers the CUDA devices "
                               "present, and there is none; pass devices=")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    mp = max(1, min(model_parallel, n))
    return MeshSpec(("data", "model"), (n // mp, mp), devices[:n // mp * mp])


def dp_axes(mesh: MeshSpec) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh ('pod' folds into DP)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mp_axis(mesh: MeshSpec) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def axis_size(mesh: MeshSpec, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def describe(mesh: MeshSpec) -> str:
    return (f"mesh axes={mesh.shape} devices={mesh.size} "
            f"dp={axis_size(mesh, dp_axes(mesh))} "
            f"mp={axis_size(mesh, mp_axis(mesh))}")
