"""Subsequence-index persistence (counterpart of
``repro.subseq.persistence``; the same format, so a directory written by
either package loads in the other)::

    <dir>/subseq_db.json     # IndexSpec, window geometry, array manifest
    <dir>/index/step_*/      # repro_torch.checkpoint shard(s) + manifest

Stored: the raw stream, the windows' signatures and band keys (uint32 on
disk, the reference's dtype) and the encoder's random state, which is
all a loaded index needs to answer bit-identically and to keep taking
``extend_stream``.  ``load_subseq`` rebuilds the encoder through the
registry and refuses a spec/artifact mismatch: foreign array shapes,
signature widths other than the spec's K and L, or a window count other
than the stored stream's geometry implies.  As in ``db.persistence`` the
meta's ``build_backend`` is the reference's knob, written as ``"jnp"``
(its plain encoder), and the port's own route sits under
``repro_torch_build_route``.
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
from repro_torch.db.persistence import ROUTE_KEY, SAVED_BACKEND
from repro_torch.encoders import IndexSpec
from repro_torch.kernels import ops
from repro_torch.subseq.rolling import num_windows

FORMAT_VERSION = 1
META_FILE = "subseq_db.json"
ARRAYS_SUBDIR = "index"
_ENC_PREFIX = "encoder/"


def save_subseq(directory, index, config: Optional[SearchConfig] = None,
                n_shards: int = 1) -> Path:
    """Persist ``index`` (and ``config`` when given) under ``directory``
    in ``n_shards`` checkpoint shards; returns the directory.  The arrays
    publish atomically, and the meta is renamed into place, so a re-save
    never leaves a torn database."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    inner = index.inner
    arrays: Dict[str, np.ndarray] = {
        "stream": index.stream.cpu().numpy(),
        "signatures": inner.signatures.cpu().numpy(),
        "keys": inner.keys.cpu().numpy().view(np.uint32),
    }
    for name, arr in inner.encoder.arrays().items():
        arrays[f"{_ENC_PREFIX}{name}"] = arr

    prev = latest_step(directory / ARRAYS_SUBDIR)
    step = 0 if prev is None else prev + 1
    save_checkpoint(directory / ARRAYS_SUBDIR, step=step, tree=arrays,
                    keep=2, n_shards=n_shards)
    meta: Dict[str, Any] = {
        "format_version": FORMAT_VERSION,
        "checkpoint_step": step,
        "spec": inner.encoder.spec.to_dict(),
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "length": int(index.length),
        "hop": int(index.hop),
        "n_windows": index.num_windows,
        "stream_length": int(index.stream.shape[0]),
        "build_backend": SAVED_BACKEND,
        ROUTE_KEY: inner.build_backend,
        "encode_seconds": float(index.encode_seconds),
        "config": config.to_dict() if config is not None else None,
    }
    tmp = directory / f".{META_FILE}.tmp{os.getpid()}"
    tmp.write_text(json.dumps(meta, indent=1))
    os.replace(tmp, directory / META_FILE)
    return directory


def _read_meta(directory: Path) -> Dict[str, Any]:
    meta_path = directory / META_FILE
    if not meta_path.exists():
        raise FileNotFoundError(f"no subsequence database at {directory} "
                                f"(missing {META_FILE})")
    meta = json.loads(meta_path.read_text())
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported subsequence database format_version "
            f"{meta.get('format_version')!r} (this release reads "
            f"{FORMAT_VERSION})")
    return meta


def load_subseq(directory, device=None
                ) -> Tuple["SubsequenceIndex", Optional[SearchConfig]]:
    """Inverse of :func:`save_subseq` onto ``device`` (CUDA unless the
    caller asks for the CPU): ``(index, config)``, ``config`` None when
    the saver recorded none."""
    from repro_torch.subseq.index import SubsequenceIndex
    dev = ops.resolve_device(device)
    directory = Path(directory)
    meta = _read_meta(directory)
    # shapes only: meta tensors allocate nothing
    tree_like = {k: torch.empty(info["shape"], device="meta")
                 for k, info in meta["arrays"].items()}
    _, arrays = restore_checkpoint(directory / ARRAYS_SUBDIR, tree_like,
                                   step=meta.get("checkpoint_step"))

    spec = IndexSpec.from_dict(meta["spec"]).validate()
    enc = convert.encoder_from_arrays(
        spec, {k[len(_ENC_PREFIX):]: v for k, v in arrays.items()
               if k.startswith(_ENC_PREFIX)}, dev)
    sigs, keys = np.asarray(arrays["signatures"]), np.asarray(arrays["keys"])
    if int(sigs.shape[-1]) != enc.num_hashes:
        raise ValueError(
            f"saved signatures have K={int(sigs.shape[-1])} but the saved "
            f"spec implies K={enc.num_hashes} — spec/artifact mismatch")
    if int(keys.shape[-1]) != enc.num_tables:
        raise ValueError(
            f"saved band keys have L={int(keys.shape[-1])} but the saved "
            f"spec implies L={enc.num_tables} — spec/artifact mismatch")
    length, hop = int(meta["length"]), int(meta["hop"])
    stream = np.asarray(arrays["stream"], np.float32).reshape(-1)
    nw = int(sigs.shape[0])
    implied = num_windows(stream.shape[0], length, hop)
    if implied != nw or int(keys.shape[0]) != nw:
        raise ValueError(
            f"saved stream of {stream.shape[0]} points implies {implied} "
            f"windows at L={length}, h={hop}, but {nw} signatures and "
            f"{int(keys.shape[0])} band keys are stored — "
            "geometry/artifact mismatch")
    if keys.dtype == np.uint32:
        keys = keys.view(np.int32)
    inner = SSHIndex(
        encoder=enc, signatures=torch.from_numpy(sigs).to(dev, torch.int32),
        keys=torch.from_numpy(keys).to(dev, torch.int32), series=None,
        build_backend=meta.get(ROUTE_KEY, meta.get("build_backend", "jnp")))
    index = SubsequenceIndex(
        inner=inner, stream=torch.from_numpy(stream.copy()).to(dev),
        length=length, hop=hop,
        encode_seconds=float(meta.get("encode_seconds", 0.0)))
    config = (SearchConfig.from_dict(meta["config"])
              if meta.get("config") else None)
    return index, config


def saved_config(directory) -> Optional[SearchConfig]:
    """The search config a saved subsequence database recorded (None
    when none), read from the meta alone."""
    meta = _read_meta(Path(directory))
    return (SearchConfig.from_dict(meta["config"])
            if meta.get("config") else None)


def is_subseq_dir(directory) -> bool:
    """True when ``directory`` holds a saved subsequence database."""
    return (Path(directory) / META_FILE).exists()
