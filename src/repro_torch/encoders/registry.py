"""Encoder registry — ``IndexSpec.encoder`` names how series are hashed
(counterpart of ``repro.encoders.registry``).

The built-ins (``"ssh"``, ``"ssh-multires"``, ``"srp"``, ``"ssh-cs"``)
register when their modules are imported, which happens at the first
lookup, so ``IndexSpec`` stays free of the kernel stack.
``register_encoder`` adds an encoder without touching the facade.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

_ENCODERS: Dict[str, Type] = {}
_BUILTINS_LOADED = False


def _ensure_builtins() -> None:
    """Import the built-in encoder modules once; the flag is set only on
    success, so a failed import shows its own error at every lookup."""
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        import repro_torch.encoders.pipeline    # noqa: F401  ssh, multires
        import repro_torch.encoders.srp         # noqa: F401  srp
        import repro_torch.streaming.encoder    # noqa: F401  ssh-cs
        _BUILTINS_LOADED = True


def register_encoder(name: str) -> Callable[[Type], Type]:
    """Class decorator: register an ``Encoder`` subclass under ``name``
    (a later registration of the same name wins)."""
    def deco(cls: Type) -> Type:
        cls.name = name
        _ENCODERS[name] = cls
        return cls
    return deco


def available_encoders() -> List[str]:
    _ensure_builtins()
    return sorted(_ENCODERS)


def encoder_class(name: str) -> Type:
    """The class that implements encoder ``name``."""
    _ensure_builtins()
    try:
        return _ENCODERS[name]
    except KeyError:
        raise ValueError(f"unknown encoder {name!r}; registered: "
                         f"{available_encoders()}") from None


def make_encoder(spec, device=None, *, length: Optional[int] = None):
    """The materialised encoder named by ``spec.encoder`` on ``device``
    (CUDA unless the caller asks for the CPU); ``length`` is the series
    length, read by encoders whose state is sized to it."""
    return encoder_class(spec.encoder)(spec).materialize(device, length)
