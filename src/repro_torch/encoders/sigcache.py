"""LRU of encoded query signatures (counterpart of
``repro.encoders.sigcache``): a repeated query skips the encode.

A :class:`SignatureCache` keys each encoded signature by the query's
content — its float32 bytes (:func:`row_bytes`), which hold its length
too — together with the ``IndexSpec``, the build route and a variant tag
(``sig``, ``keys``, ``mp<o>``), so a hit returns exactly the array the
encoder would produce and answers cannot change.  The bytes themselves
are the key, where the reference's is a blake2b digest of them
(``series_digest``, which has no counterpart here): exact, and cheaper
than a digest a row.
Values stay where the encoder made them (on the card for a CUDA index),
so a miss stores without a sync and a hit needs no copy.  One cache
lives on each index (``SSHIndex.sig_cache``, made at first use); hits
surface as ``SearchStats.sig_cache_hit``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: default capacity of a cache, in entries
DEFAULT_CAPACITY = 512


def row_bytes(queries) -> List[bytes]:
    """The content keys of a (m,) query or of each row of a (B, m) block:
    each row's float32 bytes.  Pass the host array the caller gave when
    there is one; a tensor on the card is read back once for the block."""
    if isinstance(queries, torch.Tensor):
        queries = queries.detach().cpu().numpy()
    arr = np.ascontiguousarray(queries, np.float32)
    if arr.ndim == 1:
        return [arr.tobytes()]
    return [row.tobytes() for row in arr.reshape(arr.shape[0], -1)]


class SignatureCache:
    """Bounded LRU of encoded query signatures; thread-safe."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._store: "OrderedDict[Tuple, torch.Tensor]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(content: bytes, spec: Hashable, backend: str,
            variant: str = "sig") -> Tuple:
        """(row bytes, IndexSpec, build route, variant)."""
        return (content, spec, backend, variant)

    def get(self, key: Tuple) -> Optional[torch.Tensor]:
        return self.get_many([key])[0]

    def get_many(self, keys: Sequence[Tuple]
                 ) -> List[Optional[torch.Tensor]]:
        """Each key's entry or None, counting a hit or a miss for each."""
        out = []
        with self._lock:
            for key in keys:
                sig = self._store.get(key)
                if sig is None:
                    self.misses += 1
                else:
                    self._store.move_to_end(key)
                    self.hits += 1
                out.append(sig)
        return out

    def put(self, key: Tuple, sig: torch.Tensor) -> None:
        self.put_many([key], [sig])

    def put_many(self, keys: Sequence[Tuple],
                 sigs: Sequence[torch.Tensor]) -> None:
        """Store each value as given (on its own device)."""
        with self._lock:
            for key, sig in zip(keys, sigs):
                self._store[key] = sig
                self._store.move_to_end(key)
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)
