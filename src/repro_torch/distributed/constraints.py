"""Activation sharding constraints (counterpart of
``repro.distributed.constraints``).

Under GSPMD the reference pins activations to logical axes at layer
boundaries, so that the partitioner all-gathers weights (ZeRO-3) rather
than activations.  The port runs each program on one device and has no
partitioner: :func:`constrain` returns its input unchanged, as the
reference's does when no mesh is active.  The port's models do not call
it: on one card it would change nothing.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

from repro_torch.launch.mesh import MeshSpec

_STATE = threading.local()


@contextmanager
def activation_sharding(mesh: MeshSpec):
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def active_mesh() -> Optional[MeshSpec]:
    return getattr(_STATE, "mesh", None)


def constrain(x, *logicals):
    """``x`` unchanged, with or without an active mesh: one device holds
    all of it (``logicals``, one name-or-None per dim, name the axes the
    reference pins under GSPMD)."""
    return x
