"""``--arch`` registry (counterpart of ``repro.configs.registry``): every
arch is a ``configs.base.ArchDef`` (shape cells, input specs), what
``launch.serve``, ``launch.steps``, ``launch.train`` and the dry run
read; an SSH arch (``SSHArch``) also answers ``index_spec()`` and
``search_config()``, what ``launch.build_index`` and ``launch.serve``
read, and has the reference's shape cells (``build``, ``query``)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional

from repro_torch.configs.base import ArchDef

_MODULES = {
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "nequip": "repro_torch.configs.nequip",
    "bst": "repro_torch.configs.bst",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "mind": "repro_torch.configs.mind",
    "dien": "repro_torch.configs.dien",
    "ssh-ecg": "repro_torch.configs.ssh_ecg",
    "ssh-randomwalk": "repro_torch.configs.ssh_randomwalk",
}


@dataclasses.dataclass(frozen=True)
class SSHArch(ArchDef):
    """An SSH deployment: an ``ArchDef`` of the ``"ssh"`` family whose
    configs are the build-time ``IndexSpec``s (full and smoke), with the
    search-time defaults and the shape cells of its build and query
    steps; every cell runs ``config``."""
    family: str = dataclasses.field(default="ssh", kw_only=True)


def list_archs(family: Optional[str] = None) -> List[str]:
    """Every arch id, or those of one family ("lm", "gnn", "recsys",
    "ssh")."""
    if family is None:
        return sorted(_MODULES)
    return [n for n in sorted(_MODULES) if get_arch(n).family == family]


def get_arch(name: str):
    """The ``SSHArch`` or ``ArchDef`` of ``name``."""
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{list_archs()}")
    return importlib.import_module(_MODULES[name]).ARCH
