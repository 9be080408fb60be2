"""Index persistence — save and load an ``SSHIndex`` with its
``SearchConfig`` (counterpart of ``repro.db.persistence``; the same
format, so a directory written by either package loads in the other).

Layout of a saved database directory::

    <dir>/ssh_db.json        # IndexSpec, array manifest, config, flags
    <dir>/index/step_*/      # repro_torch.checkpoint shards + manifest

Arrays ride the checkpoint layer (atomic publish); the meta is written
to a temporary file and renamed, so readers only see a whole database.
Stored: signatures, band keys, series, cached envelopes, and the
encoder's random state under ``encoder/<leaf>``.  On disk every array
has the reference's dtype: band keys and the ``"ssh-cs"`` hash
coefficients are uint32 (the port holds them as int32 bit patterns and
int64 values), and are viewed back on load.

``build_backend`` in the meta is the reference's kernel knob, which it
re-applies to every query encode of a loaded index.  The port writes
``"jnp"``, the reference's plain encoder (``chip_smoke.py`` counts the
sign bits on which the sketch kernel and a plain sketch differ at the
path's shapes), and keeps its own route under
``repro_torch_build_route``, a key the reference does not read.

Format v2 records the ``IndexSpec``; ``load_database`` rebuilds the
encoder through the registry and refuses a spec/artifact mismatch.  v1
directories (``"ssh"`` only: a ``params`` block and top-level
``filters``/``cws/*`` leaves) load too.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core.index import SSHIndex
from repro_torch.db.config import SearchConfig
from repro_torch.encoders import IndexSpec, SSHEncoder
from repro_torch.kernels import ops

FORMAT_VERSION = 2
META_FILE = "ssh_db.json"
ARRAYS_SUBDIR = "index"
_ENC_PREFIX = "encoder/"
#: the meta key of the port's own build route ("cuda" or "cpu")
ROUTE_KEY = "repro_torch_build_route"
#: the reference's kernel knob for encodes of an index the port built
SAVED_BACKEND = "jnp"


def _index_arrays(index: SSHIndex) -> Dict[str, np.ndarray]:
    """Host arrays in the reference's names, order and dtypes."""
    arrays: Dict[str, np.ndarray] = {
        "signatures": index.signatures.cpu().numpy(),
        "keys": index.keys.cpu().numpy().view(np.uint32),
    }
    for name, arr in index.encoder.arrays().items():
        arrays[f"{_ENC_PREFIX}{name}"] = arr
    arrays["series"] = index.series.cpu().numpy()
    if index.env_radius is not None and index.env_upper is not None:
        arrays["env_upper"] = index.env_upper.cpu().numpy()
        arrays["env_lower"] = index.env_lower.cpu().numpy()
    return arrays


def save_database(directory: str | Path, index: SSHIndex,
                  config: Optional[SearchConfig] = None,
                  n_shards: int = 1) -> Path:
    """Persist ``index`` (and ``config`` when given) under ``directory``;
    returns the directory.  A re-save publishes the next step and keeps
    the one the old meta points at until the meta flips."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    arrays = _index_arrays(index)
    prev = latest_step(directory / ARRAYS_SUBDIR)
    step = 0 if prev is None else prev + 1
    save_checkpoint(directory / ARRAYS_SUBDIR, step=step, tree=arrays,
                    keep=2, n_shards=n_shards)
    meta: Dict[str, Any] = {
        "format_version": FORMAT_VERSION,
        "checkpoint_step": step,
        "spec": index.encoder.spec.to_dict(),
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "n_series": int(index.signatures.shape[0]),
        "has_series": True,
        "with_host_buckets": index.host_buckets is not None,
        "env_radius": index.env_radius if "env_upper" in arrays else None,
        "build_backend": SAVED_BACKEND,
        ROUTE_KEY: index.build_backend,
        "config": config.to_dict() if config is not None else None,
    }
    tmp = directory / f".{META_FILE}.tmp{os.getpid()}"
    tmp.write_text(json.dumps(meta, indent=1))
    os.replace(tmp, directory / META_FILE)
    return directory


def _spec_and_encoder_arrays(meta: Dict[str, Any],
                             arrays: Dict[str, np.ndarray]):
    """(spec, encoder leaves) for either format version."""
    if meta["format_version"] >= 2:
        spec = IndexSpec.from_dict(meta["spec"])
        enc_arrays = {k[len(_ENC_PREFIX):]: v for k, v in arrays.items()
                      if k.startswith(_ENC_PREFIX)}
        return spec, enc_arrays
    # v1: the legacy SSHParams fields (seed among them) and top-level
    # filters/cws/* leaves; SSHParams.to_spec names all six stage params
    params = dict(meta["params"])
    seed = params.pop("seed", 7)
    spec = IndexSpec(encoder="ssh",
                     params={**SSHEncoder.DEFAULTS, **params}, seed=seed)
    enc_arrays = {k: v for k, v in arrays.items()
                  if k == "filters" or k.startswith("cws/")}
    return spec, enc_arrays


def load_database(directory: str | Path, device=None
                  ) -> Tuple[SSHIndex, Optional[SearchConfig]]:
    """Inverse of :func:`save_database` onto ``device`` (CUDA unless the
    caller asks for the CPU): ``(index, config)``, ``config`` None when
    the saver recorded none.  Raises ``ValueError`` on a spec/artifact
    mismatch (tampered meta, another encoder's arrays, a foreign K or
    L)."""
    dev = ops.resolve_device(device)
    directory = Path(directory)
    meta_path = directory / META_FILE
    if not meta_path.exists():
        raise FileNotFoundError(f"no SSH database at {directory} "
                                f"(missing {META_FILE})")
    meta = json.loads(meta_path.read_text())
    version = meta.get("format_version")
    if version not in (1, FORMAT_VERSION):
        raise ValueError(f"unsupported database format_version {version!r} "
                         f"(this release reads 1 and {FORMAT_VERSION})")
    if not meta.get("has_series", True) or "series" not in meta["arrays"]:
        raise ValueError(f"{directory} was saved without its series, "
                         "which the re-rank reads")
    # shapes only: meta tensors allocate nothing
    tree_like = {k: torch.empty(info["shape"], device="meta")
                 for k, info in meta["arrays"].items()}
    _, arrays = restore_checkpoint(directory / ARRAYS_SUBDIR, tree_like,
                                   step=meta.get("checkpoint_step"))
    spec, enc_arrays = _spec_and_encoder_arrays(meta, arrays)
    index = convert.index_from_arrays(
        spec.validate(), enc_arrays, arrays["signatures"], arrays["keys"],
        arrays["series"], env_upper=arrays.get("env_upper"),
        env_lower=arrays.get("env_lower"),
        env_radius=meta.get("env_radius"),
        build_backend=meta.get(ROUTE_KEY, meta.get("build_backend", "jnp")),
        device=dev)
    if meta["with_host_buckets"]:
        index.build_host_buckets()
    config = (SearchConfig.from_dict(meta["config"])
              if meta.get("config") else None)
    return index, config


def saved_config(directory: str | Path) -> Optional[SearchConfig]:
    """The search config a saved database recorded (None when none),
    read from the meta alone."""
    meta = json.loads((Path(directory) / META_FILE).read_text())
    return (SearchConfig.from_dict(meta["config"])
            if meta.get("config") else None)


def is_database_dir(directory: str | Path) -> bool:
    """True when ``directory`` holds a saved database."""
    return (Path(directory) / META_FILE).exists()
