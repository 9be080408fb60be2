"""SSH index — signatures, band keys, stored series, their envelopes and
the paper's host hash tables (counterpart of ``repro.core.index``).

Everything but the host tables lives on one device: a CUDA index encodes
its queries with the ``sketch_conv`` kernel (and ``cs_tables`` for
``"ssh-cs"``); a CPU index runs the plain versions.  Single-query and
batch encodes go through a per-index LRU of signatures keyed by query
content (``encoders.sigcache``): a hit returns the same bits, so answers
cannot change.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lower_bounds as lb
from repro_torch.encoders import Encoder, IndexSpec, make_encoder
from repro_torch.encoders.sigcache import SignatureCache, row_bytes
from repro_torch.kernels import ops

_ENV_CHUNK = 65536       # rows per envelope pass (bounds the pooling temps)


def _envelopes_chunked(series: torch.Tensor, radius: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    ups, los = zip(*(lb.envelope(series[lo:lo + _ENV_CHUNK], radius)
                     for lo in range(0, int(series.shape[0]), _ENV_CHUNK)))
    return torch.cat(ups), torch.cat(los)


class HostBuckets:
    """The paper's L hash tables on the host (``repro/core/index.py:
    191-218``), for the paper-faithful probe (``use_host_buckets``).

    The reference keeps a dict of id lists per table and ranks a query's
    bucket members with ``Counter.most_common()``: by collision count,
    ties in first-insertion order, that is by the first table whose
    bucket holds the id and then the id's place in that bucket, which is
    insertion order.  Here each table is its keys sorted stably with
    their ids beside them, so a bucket is a contiguous run in insertion
    order found by binary search, and the ranking is that order made
    explicit; the lists are the reference's element for element.
    """

    def __init__(self, num_tables: int):
        self.num_tables = int(num_tables)
        self._keys: List[np.ndarray] = [np.empty(0, np.int32)
                                        for _ in range(self.num_tables)]
        self._ids: List[np.ndarray] = [np.empty(0, np.int64)
                                       for _ in range(self.num_tables)]
        # (keys, first id) of inserts not yet merged into the tables
        self._pending: List[Tuple[np.ndarray, int]] = []

    @staticmethod
    def _host_keys(keys) -> np.ndarray:
        """int32 host keys (the uint32 bit pattern) of a tensor or an
        array."""
        if isinstance(keys, torch.Tensor):
            keys = keys.detach().cpu().numpy()
        keys = np.asarray(keys)
        return keys.view(np.int32) if keys.dtype == np.uint32 \
            else keys.astype(np.int32)

    def insert(self, keys, base_id: int = 0) -> None:
        """Append rows ``base_id, base_id + 1, ...`` with (N, L) keys;
        each goes after the members already in its bucket.  The rows wait
        for the next probe, which merges every insert since in one pass a
        table, so a run of small inserts costs one merge, not one each."""
        self._pending.append((self._host_keys(keys), int(base_id)))

    def merge(self) -> None:
        """Fold the waiting inserts into the tables (``probe`` does it
        first)."""
        if not self._pending:
            return
        keys = np.concatenate([k for k, _ in self._pending])
        ids = np.concatenate([base + np.arange(k.shape[0], dtype=np.int64)
                              for k, base in self._pending])
        self._pending = []
        for t in range(self.num_tables):
            order = np.argsort(keys[:, t], kind="stable")
            k, i = keys[order, t], ids[order]
            pos = np.searchsorted(self._keys[t], k, side="right")
            self._keys[t] = np.insert(self._keys[t], pos, k)
            self._ids[t] = np.insert(self._ids[t], pos, i)

    def probe(self, query_keys) -> np.ndarray:
        """Members of the query's L buckets (paper Alg. 2 lines 7-9) as
        int64 ids: most collisions first, ties in first-insertion
        order."""
        self.merge()
        q = self._host_keys(query_keys)
        members = []
        for t in range(self.num_tables):
            lo, hi = np.searchsorted(self._keys[t], q[t], side="left"), \
                np.searchsorted(self._keys[t], q[t], side="right")
            members.append(self._ids[t][lo:hi])
        seen = np.concatenate(members)
        if seen.size == 0:
            return np.empty(0, np.int64)
        ids, first, counts = np.unique(seen, return_index=True,
                                       return_counts=True)
        return ids[np.lexsort((first, -counts))]


@dataclasses.dataclass
class SSHIndex:
    """An encoder plus the artifacts derived from the database.

    ``env_upper``/``env_lower`` cache the Sakoe-Chiba envelopes of every
    series at ``env_radius``, which makes the cascade's LB_Keogh2 a
    gather and compare.  ``host_buckets`` holds the paper's hash tables
    when the config probes them.  ``build_backend`` records the route
    that encoded the signatures ("cuda": the kernels, "cpu": their plain
    versions); signature identity is fixed at build time
    (``repro/core/index.py:278-283``), and queries encode on the index's
    own device.  ``sig_cache`` is the query-signature LRU, made at first
    use; set it to None to empty it.
    """
    encoder: Encoder
    signatures: torch.Tensor           # (N, K) int32
    keys: torch.Tensor                 # (N, L) int32 (uint32 bit pattern)
    series: torch.Tensor               # (N, m) float32
    env_radius: Optional[int] = None
    env_upper: Optional[torch.Tensor] = None
    env_lower: Optional[torch.Tensor] = None
    build_backend: str = "cuda"
    host_buckets: Optional[HostBuckets] = None
    sig_cache: Optional[SignatureCache] = None

    @classmethod
    def build(cls, series, spec: IndexSpec, *, device=None,
              with_host_buckets: bool = False) -> "SSHIndex":
        """Paper Alg. 1: encode every series and fold band keys (and fill
        the host tables when asked).  Runs on CUDA unless
        ``device="cpu"``."""
        dev = ops.resolve_device(device)
        series = torch.as_tensor(series, dtype=torch.float32).to(dev)
        enc = make_encoder(spec, dev, length=int(series.shape[1]))
        sigs = enc.encode_chunked(series)
        idx = cls(encoder=enc, signatures=sigs, keys=enc.band_keys(sigs),
                  series=series, build_backend=dev.type)
        if with_host_buckets:
            idx.build_host_buckets()
        return idx

    def build_host_buckets(self) -> HostBuckets:
        """Fill the host tables from the stored band keys."""
        self.host_buckets = HostBuckets(self.num_tables)
        self.host_buckets.insert(self.keys)
        self.host_buckets.merge()
        return self.host_buckets

    @property
    def device(self) -> torch.device:
        return self.series.device

    @property
    def num_tables(self) -> int:
        return self.encoder.num_tables

    @property
    def num_hashes(self) -> int:
        return self.encoder.num_hashes

    def candidate_envelopes(self, radius: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(upper, lower) envelopes of every series at ``radius``; cached,
        recomputed when the radius changes."""
        stale = (self.env_radius != radius or self.env_upper is None
                 or int(self.env_upper.shape[0]) != int(self.series.shape[0]))
        if stale:
            self.env_upper, self.env_lower = _envelopes_chunked(self.series,
                                                                radius)
            self.env_radius = radius
        return self.env_upper, self.env_lower

    # -- single-query encodes (the sequential searcher) -------------------
    def query_signature(self, q: torch.Tensor) -> torch.Tensor:
        """(m,) -> (K,) int32 signature."""
        return self.encoder.encode_batch(q[None, :])[0]

    def _sig_cache(self) -> SignatureCache:
        if self.sig_cache is None:
            self.sig_cache = SignatureCache()
        return self.sig_cache

    def _cached_encode(self, q: torch.Tensor, variant: str, compute,
                       content: Optional[bytes] = None):
        """(value, hit): the LRU's entry for ``q`` and ``variant`` when
        there is one, else ``compute()`` stored (``repro/core/index.py:
        363-401``).  ``content`` is ``q``'s row bytes
        (``sigcache.row_bytes``) when the caller holds the query on the
        host; without it ``q`` is read back."""
        cache = self._sig_cache()
        if content is None:
            content = row_bytes(q)[0]
        key = cache.key(content, self.encoder.spec, self.build_backend,
                        variant)
        val = cache.get(key)
        if val is not None:
            return val, True
        val = compute()
        cache.put(key, val)
        return val, False

    def query_signature_cached(self, q: torch.Tensor,
                               content: Optional[bytes] = None):
        """(signature, cache hit)."""
        return self._cached_encode(q, "sig",
                                   lambda: self.query_signature(q), content)

    def query_keys_cached(self, q: torch.Tensor,
                          content: Optional[bytes] = None):
        """(band keys, cache hit)."""
        return self._cached_encode(q, "keys", lambda: self.query_keys(q),
                                   content)

    def query_signatures_multiprobe_cached(self, q: torch.Tensor,
                                           offsets: int,
                                           content: Optional[bytes] = None):
        """(per-offset signatures, cache hit)."""
        return self._cached_encode(
            q, f"mp{offsets}",
            lambda: self.query_signatures_multiprobe(q, offsets), content)

    def query_keys(self, q: torch.Tensor) -> torch.Tensor:
        """(m,) -> (L,) int32 band keys."""
        return self.encoder.band_keys(self.query_signature(q))

    def query_signatures_multiprobe(self, q: torch.Tensor, offsets: int
                                    ) -> torch.Tensor:
        """(m,) -> (offsets, K); row o hashes q[o:]."""
        return self.encoder.encode_batch_multiprobe(q[None, :], offsets)[0]

    def query_signatures_batch(self, qs: torch.Tensor) -> torch.Tensor:
        """(B, m) query block -> (B, K) signatures."""
        return self.encoder.encode_batch(qs)

    def query_signatures_batch_multiprobe(self, qs: torch.Tensor,
                                          offsets: int) -> torch.Tensor:
        """(B, m) -> (B, offsets, K); offset o hashes qs[:, o:]."""
        return self.encoder.encode_batch_multiprobe(qs, offsets)

    # -- growth -------------------------------------------------------------
    def insert(self, series: torch.Tensor) -> None:
        """Append and encode (m,)-rows (data-independent hashing, nothing
        to retrain); the host tables and the envelope cache stay aligned
        (``repro/core/index.py:417-431``)."""
        series = torch.as_tensor(series, dtype=torch.float32).to(
            self.device)
        sigs = self.encoder.encode_chunked(series)
        self.insert_encoded(series, sigs, self.encoder.band_keys(sigs))

    def insert_encoded(self, series: torch.Tensor, signatures: torch.Tensor,
                       keys: torch.Tensor) -> None:
        """Fold pre-encoded rows (a ``StreamIngestor`` fold) into the
        index with no re-hashing (``repro/core/index.py:433-469``)."""
        dev = self.device
        sigs = torch.as_tensor(signatures).to(dev, torch.int32)
        keys = torch.as_tensor(keys).to(dev, torch.int32)
        if int(sigs.shape[-1]) != self.num_hashes:
            raise ValueError(
                f"artifact signatures have K={int(sigs.shape[-1])}, "
                f"index expects K={self.num_hashes}")
        if int(keys.shape[-1]) != self.num_tables:
            raise ValueError(
                f"artifact keys have L={int(keys.shape[-1])}, "
                f"index expects L={self.num_tables}")
        if series is None:
            raise ValueError("index stores raw series for re-ranking; "
                             "artifacts must include them")
        series = torch.as_tensor(series, dtype=torch.float32).to(dev)
        base = int(self.signatures.shape[0])
        self.signatures = torch.cat([self.signatures, sigs])
        self.keys = torch.cat([self.keys, keys])
        self.series = torch.cat([self.series, series])
        if self.host_buckets is not None:
            self.host_buckets.insert(keys, base_id=base)
        if self.env_radius is not None and self.env_upper is not None:
            u, l = _envelopes_chunked(series, self.env_radius)
            self.env_upper = torch.cat([self.env_upper, u])
            self.env_lower = torch.cat([self.env_lower, l])

    def nbytes(self) -> int:
        """Resident bytes: artifacts plus the encoder state."""
        arrays = [self.signatures, self.keys, self.series, self.env_upper,
                  self.env_lower, *self.encoder._require_state().values()]
        return sum(a.numel() * a.element_size()
                   for a in arrays if a is not None)
