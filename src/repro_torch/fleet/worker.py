"""FleetWorker — one logical worker's shard replicas and the shard-local
query (counterpart of ``repro.fleet.worker``).

The shard-local math is ``distributed.dist_index.local_query``, the one
schedule the row-sharded fan-out runs too (collision count over raw
signatures, local top-C/S, shard-seed threshold, banded early-abandoning
DTW), so the fleet tier keeps SSH's sub-linear DTW count per shard.
Workers holding replicas of the same shard fetched the same checkpoint
artifact, so the same (sig, q) input gives bit-identical (ids, dists) on
every replica — which is why hedged and failed-over queries answer as
the healthy run does.

Unlike the reference, whose replicas are host arrays copied to the
device on every call, a ``ShardReplica`` holds tensors on the worker's
device; a shard call enters that device, launches on the calling
thread's current stream and returns host arrays, so its wall time (the
straggler telemetry) covers the device work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.distributed.dist_index import local_query
from repro_torch.kernels import ops


@dataclasses.dataclass
class ShardReplica:
    """One shard's encoded rows as held by a worker."""
    series: torch.Tensor        # (n_s, m) float32
    signatures: torch.Tensor    # (n_s, K) int32
    row_start: int              # global id of local row 0

    @property
    def n_rows(self) -> int:
        return int(self.signatures.shape[0])

    @property
    def device(self) -> torch.device:
        return self.signatures.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.series, self.signatures))


class FleetWorker:
    """A logical worker: named, holds shard replicas, answers shard
    queries.  Thread-safe for the fleet's concurrent fan-out (shard
    loads and drops take the lock; queries read a stable snapshot)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._shards: Dict[int, ShardReplica] = {}

    # -- shard custody ----------------------------------------------------
    def receive_shard(self, shard_id: int, replica: ShardReplica) -> None:
        with self._lock:
            self._shards[shard_id] = replica

    def drop_shard(self, shard_id: int) -> None:
        with self._lock:
            self._shards.pop(shard_id, None)

    def shard_ids(self):
        with self._lock:
            return sorted(self._shards)

    def nbytes(self) -> int:
        with self._lock:
            return sum(r.nbytes() for r in self._shards.values())

    # -- the shard-local query --------------------------------------------
    def query_shard(self, shard_id: int, sig: torch.Tensor,
                    q: torch.Tensor, *, local_c: int, topk: int, band: int,
                    abandon: bool, injector=None, compute_lock=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(global ids int64, dists float32) host arrays of this shard's
        local top-``local_c``.

        Deterministic in (shard state, sig, q): any replica of the same
        artifact returns bit-identical arrays.  ``injector`` (a
        ``FaultInjector``) gates the call on the host, before any launch.
        ``compute_lock``, when given, is held around the probe (not the
        injector's gate).
        """
        if injector is not None:
            injector.before_call(self.name)
        with self._lock:
            try:
                rep = self._shards[shard_id]
            except KeyError:
                raise KeyError(f"worker {self.name!r} holds no replica "
                               f"of shard {shard_id}") from None
        with compute_lock or contextlib.nullcontext(), \
                ops.device_scope(rep.device):
            cand, d = local_query(
                sig.to(rep.device), q.to(rep.device), rep.series,
                rep.signatures, local_c=local_c, topk=topk, band=band,
                abandon=abandon, seed_always=False)
            return (cand.cpu().numpy().astype(np.int64) + rep.row_start,
                    d.cpu().numpy().astype(np.float32))
