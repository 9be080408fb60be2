"""``IndexSpec`` — what an index *is* (counterpart of
``repro.encoders.base``): encoder name + stage params + seed.

The port serves the ``"ssh"`` and ``"ssh-cs"`` encoders.  A spec
round-trips through ``to_dict``/``from_dict`` in the reference's format,
so one spec names the same index in both packages.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Mapping

#: encoders this package implements
ENCODERS = ("ssh", "ssh-cs")


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Encoder name + stage params + seed; unset params take the encoder's
    defaults."""

    encoder: str = "ssh"
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    seed: int = 7

    def __post_init__(self):
        params = {k: tuple(v) if isinstance(v, (list, tuple)) else v
                  for k, v in dict(self.params).items()}
        object.__setattr__(self, "params", params)

    def validate(self) -> "IndexSpec":
        if self.encoder not in ENCODERS:
            raise ValueError(f"repro_torch implements encoders {ENCODERS}, "
                             f"got {self.encoder!r}")
        from repro_torch.encoders.registry import encoder_class
        encoder_class(self.encoder).validate_params(self)
        return self

    def replace(self, **changes: Any) -> "IndexSpec":
        return dataclasses.replace(self, **changes).validate()

    def with_params(self, **params: Any) -> "IndexSpec":
        return self.replace(params={**self.params, **params})

    def to_dict(self) -> Dict[str, Any]:
        return {"encoder": self.encoder, "params": dict(self.params),
                "seed": self.seed}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "IndexSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = sorted(set(d) - known)
        if extra:
            warnings.warn(f"IndexSpec.from_dict: ignoring unknown fields "
                          f"{extra}", RuntimeWarning, stacklevel=2)
        return cls(**{k: v for k, v in d.items() if k in known})
