"""Shard transfer format — checkpoints, not pickles (counterpart of
``repro.fleet.transfer``, the reference's on-disk format).

A shard moves between workers as a ``repro_torch.checkpoint`` artifact
(one atomically published ``step_*/`` directory of npz shards and a
manifest), the layer index persistence rides.  A crashed publisher never
corrupts the previous artifact, and a fetching worker sees a complete
shard or none.  Replicas fetched from the same artifact hold
bit-identical arrays — the root of the hedging soundness argument: any
replica's answer for a shard is the answer.  Either package fetches
what the other published.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.fleet.worker import ShardReplica
from repro_torch.kernels import ops


def _shard_dir(root: str | Path, shard_id: int) -> Path:
    return Path(root) / f"shard_{shard_id:05d}"


def publish_shard(root: str | Path, shard_id: int, series, signatures,
                  row_start: int, version: int = 0) -> Path:
    """Publish one shard's encoded rows (arrays or tensors) as a
    checkpoint artifact.  ``version`` is the checkpoint step:
    re-publishing after a streaming fold bumps it, and the previous
    artifact stays durable until the new one is live (``keep=2``)."""
    return save_checkpoint(
        _shard_dir(root, shard_id), step=version,
        tree={"series": series, "signatures": signatures,
              "row_start": np.asarray(row_start, np.int64)},
        keep=2)


def fetch_shard(root: str | Path, shard_id: int,
                version: Optional[int] = None, device=None) -> ShardReplica:
    """A worker receives a shard: the (latest) artifact's arrays as
    tensors on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = ops.resolve_device(device)
    d = _shard_dir(root, shard_id)
    step = latest_step(d) if version is None else version
    if step is None:
        raise FileNotFoundError(f"no published artifact for shard "
                                f"{shard_id} under {root}")
    manifest = json.loads(
        (d / f"step_{step:010d}" / "manifest.json").read_text())
    tree_like = {k: np.zeros(info["shape"], dtype=np.dtype(info["dtype"]))
                 for k, info in manifest["arrays"].items()}
    _, tree = restore_checkpoint(d, tree_like, step=step)
    return ShardReplica(
        series=torch.from_numpy(tree["series"]).to(dev),
        signatures=torch.from_numpy(tree["signatures"]).to(dev),
        row_start=int(np.asarray(tree["row_start"])))
