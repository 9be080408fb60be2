"""Encoder name -> class (counterpart of ``repro.encoders.registry``).

The port has a fixed set of encoders (``encoders.base.ENCODERS``); each
class is imported at its first lookup, which keeps ``IndexSpec`` free of
the kernel stack.
"""
from __future__ import annotations

import importlib

#: encoder name -> (module, class)
_CLASSES = {
    "ssh": ("repro_torch.encoders.pipeline", "SSHEncoder"),
    "ssh-cs": ("repro_torch.streaming.encoder", "StreamingSSHEncoder"),
}


def encoder_class(name: str):
    """The class that implements encoder ``name``."""
    try:
        module, cls = _CLASSES[name]
    except KeyError:
        raise ValueError(f"repro_torch implements encoders "
                         f"{tuple(_CLASSES)}, got {name!r}") from None
    return getattr(importlib.import_module(module), cls)


def make_encoder(spec, device=None):
    """The materialised encoder named by ``spec.encoder``, on ``device``
    (CUDA unless the caller asks for the CPU)."""
    return encoder_class(spec.encoder)(spec).materialize(device)
