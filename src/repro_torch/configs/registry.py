"""``--arch`` registry (counterpart of ``repro.configs.registry``): the
SSH arches as objects with ``index_spec()`` and ``search_config()``,
what ``launch.build_index`` and ``launch.serve`` read.  The rest of the
reference's ``ArchDef`` (shape cells, dry runs) is queued (ROADMAP.md
§1, benchmarks)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional

from repro_torch.db.config import SearchConfig
from repro_torch.encoders import IndexSpec

_MODULES = {
    "ssh-ecg": "repro_torch.configs.ssh_ecg",
    "ssh-randomwalk": "repro_torch.configs.ssh_randomwalk",
}


@dataclasses.dataclass(frozen=True)
class SSHArch:
    """An SSH deployment: the build-time spec (full and smoke) and the
    search-time defaults."""
    name: str
    config: IndexSpec
    smoke_config: IndexSpec
    search_defaults: SearchConfig
    family: str = "ssh"

    def index_spec(self, smoke: bool = False, **params) -> IndexSpec:
        """The ``IndexSpec`` (the smoke one when asked), with stage-param
        overrides."""
        spec = self.smoke_config if smoke else self.config
        return spec.with_params(**params) if params else spec

    def search_config(self, length: Optional[int] = None,
                      **overrides) -> SearchConfig:
        """The ``SearchConfig`` at a series length (the UCR suite's 5 %
        band: max(4, length // 20)) with per-call overrides."""
        cfg = self.search_defaults
        if length is not None:
            cfg = dataclasses.replace(cfg, band=max(4, length // 20))
        return cfg.replace(**overrides) if overrides else cfg.validate()


def list_archs() -> List[str]:
    return sorted(_MODULES)


def get_arch(name: str) -> SSHArch:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{list_archs()}")
    return importlib.import_module(_MODULES[name]).ARCH
