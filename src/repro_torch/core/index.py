"""SSH index — signatures, band keys, stored series, their envelopes and
the paper's host hash tables (counterpart of ``repro.core.index``).

Everything but the host tables lives on one device: a CUDA index encodes
its queries with the ``sketch_conv`` kernel (and ``cs_tables`` for
``"ssh-cs"``); a CPU index runs the plain versions.  Single-query and
batch encodes go through a per-index LRU of signatures keyed by query
content (``encoders.sigcache``): a hit returns the same bits, so answers
cannot change.

The paper's functional API sits beside the index: ``SSHParams`` (the
seven hyper-parameters), ``SSHFunctions`` (the materialised filter bank
and CWS fields), ``build_signatures``, ``band_keys``, and the device
probe ``signature_collisions`` / ``probe_topc`` and their batched forms,
which count through the ``collision_count`` kernels on CUDA.  A legacy
``SSHParams`` where an ``IndexSpec`` is expected lowers through
``_spec_from_legacy`` under a ``DeprecationWarning`` (one release), with
results identical to the spec form.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lower_bounds as lb
from repro_torch.core import minhash, shingle
from repro_torch.encoders import (Encoder, IndexSpec, encoder_class,
                                  make_encoder)
from repro_torch.encoders.sigcache import SignatureCache, row_bytes
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class SSHParams:
    """SSH hyper-parameters (paper §4.5 / §5.5)."""
    window: int = 80          # W: filter length
    step: int = 3             # δ: slide stride
    ngram: int = 15           # n: shingle length
    num_filters: int = 1      # F: filter-bank size (1 is the paper's)
    num_hashes: int = 20      # K: CWS hashes
    num_tables: int = 20      # L: hash tables (bands); rows = K / L
    seed: int = 7

    @property
    def shingle_dim(self) -> int:
        return shingle.shingle_space(self.ngram, self.num_filters)

    def validate(self) -> None:
        if self.num_hashes % self.num_tables:
            raise ValueError("num_hashes must be divisible by num_tables")
        if self.ngram > 20:
            raise ValueError("shingle space 2^n exceeds 1M bins; use n<=20")

    def to_spec(self) -> IndexSpec:
        """The ``"ssh"`` ``IndexSpec`` of these parameters; its encoder
        holds :meth:`SSHFunctions.create`'s state."""
        return IndexSpec(
            encoder="ssh",
            params=dict(window=self.window, step=self.step,
                        ngram=self.ngram, num_filters=self.num_filters,
                        num_hashes=self.num_hashes,
                        num_tables=self.num_tables),
            seed=self.seed)


def _spec_from_legacy(params, caller: str, stacklevel: int = 3
                      ) -> IndexSpec:
    """Deprecation shim: an ``IndexSpec`` passes through, a legacy
    ``SSHParams`` lowers to one under a ``DeprecationWarning`` pointing
    at the caller's call site (``repro/core/index.py:66-85``); anything
    else is a ``TypeError``."""
    if isinstance(params, IndexSpec):
        return params
    if isinstance(params, SSHParams):
        warnings.warn(
            f"passing SSHParams to {caller}() is deprecated; pass "
            "spec=repro_torch.encoders.IndexSpec(encoder='ssh', "
            "params={...}) instead (results are identical)",
            DeprecationWarning, stacklevel=stacklevel)
        return params.to_spec()
    raise TypeError(f"{caller}() needs an IndexSpec (spec=...) or a "
                    f"legacy SSHParams, got {type(params).__name__}")


@dataclasses.dataclass
class SSHFunctions:
    """The materialised random functions: the (W, F) filter bank and the
    CWS fields over (K, F·2^n), tensors on one device."""
    params: SSHParams
    filters: torch.Tensor
    cws: minhash.CWSParams

    @classmethod
    def create(cls, params: SSHParams, device=None) -> "SSHFunctions":
        """The functions of ``make_encoder(params.to_spec(), device)``
        (CUDA unless the caller asks for the CPU), as its
        ``legacy_functions()`` view."""
        params.validate()
        return make_encoder(params.to_spec(), device).legacy_functions()


def encoder_of(fns: SSHFunctions) -> Encoder:
    """The ``"ssh"`` encoder that holds ``fns``' tensors (no copy), so
    it hashes bit for bit as the encoder ``fns`` was drawn from."""
    state = {"filters": fns.filters,
             **{f"cws/{f}": getattr(fns.cws, f)
                for f in minhash.CWSParams._fields}}
    return encoder_class("ssh")(fns.params.to_spec()).load_state(state)


def build_signatures(series, fns: SSHFunctions,
                     batch: int = 256) -> torch.Tensor:
    """(N, m) -> (N, K) int32 CWS signatures on the functions' device, in
    chunks of ``batch`` rows (each chunk one ``sketch_conv`` launch on
    CUDA), through the ``"ssh"`` encoder holding ``fns`` (no copy).  The
    rows are independent, so the chunk size does not change a bit; on
    the card a 256-row chunk is host-bound, and the facade's 4,096 rows
    build 2^20 series several times faster."""
    series = torch.as_tensor(series).to(fns.filters.device, torch.float32)
    return encoder_of(fns).encode_chunked(series, batch=batch)


def band_keys(signatures: torch.Tensor, params: SSHParams) -> torch.Tensor:
    """(N, K) -> (N, L) int32 bucket keys (the uint32 bit pattern)."""
    return minhash.combine_bands(signatures, params.num_tables)


def top_c_by_count(counts: torch.Tensor, top_c: int,
                   max_count: int = ops.MAX_COUNT):
    """Each row's ``top_c`` columns by count, highest first, ties to the
    lowest column — ``lax.top_k``'s order: counts (B, N) int32 in
    [0, ``max_count``], the width of the keys they compare -> (ids
    int64, counts int32), each (B, top_c).  ``ops.top_c_select``: the
    ``topc_select`` kernels on CUDA (a histogram, a threshold and a
    stable scatter, two reads of the counts), their plain version on the
    CPU."""
    return ops.top_c_select(counts, top_c, max_count)


def signature_collisions(query_keys: torch.Tensor, db_keys: torch.Tensor
                         ) -> torch.Tensor:
    """Tables (or hashes) in which the query and each row agree: (L,) x
    (N, L) int32 -> (N,) int32, the ``collision_count`` kernel on CUDA."""
    return ops.collision_count(query_keys.contiguous(), db_keys)


def probe_topc(query_keys: torch.Tensor, db_keys: torch.Tensor, top_c: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-C rows by collision count, ties to the lowest id: (ids int64,
    counts int32), each (top_c,)."""
    ids, vals = top_c_by_count(
        signature_collisions(query_keys, db_keys)[None], top_c,
        max_count=int(query_keys.shape[-1]))
    return ids[0], vals[0]


def signature_collisions_batch(query_keys: torch.Tensor,
                               db_keys: torch.Tensor) -> torch.Tensor:
    """Batched collision counts: (B, L) x (N, L) int32 -> (B, N) int32,
    the ``collision_count_batch`` kernel on CUDA."""
    return ops.collision_count_batch(query_keys.contiguous(), db_keys)


def probe_topc_batch(query_keys: torch.Tensor, db_keys: torch.Tensor,
                     top_c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-C by collision count: (B, L) x (N, L) -> (ids,
    counts), each (B, top_c), ties to the lowest id."""
    return top_c_by_count(signature_collisions_batch(query_keys, db_keys),
                          top_c, max_count=int(query_keys.shape[-1]))

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

    def __init__(self, num_tables):
        # the table count, or a legacy SSHParams carrying it
        self.num_tables = int(getattr(num_tables, "num_tables", num_tables))
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

    @property
    def tables(self) -> List[Dict[int, List[int]]]:
        """The reference's form of the tables: for each of the L, a dict
        from the uint32 key to its bucket's ids in insertion order (a
        copy, made from the sorted arrays)."""
        self.merge()
        out = []
        for keys, ids in zip(self._keys, self._ids):
            table: Dict[int, List[int]] = {}
            for k, i in zip(keys.view(np.uint32).tolist(), ids.tolist()):
                table.setdefault(k, []).append(i)
            out.append(table)
        return out

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
    use; set it to None to empty it.  ``series`` is None for the inner
    index of a ``subseq.SubsequenceIndex``, whose rows are the windows
    of a stream it keeps itself.

    The reference's historical construction ``SSHIndex(fns=...)`` (its
    positional order too: the ``SSHFunctions`` first) gives an ``"ssh"``
    index whose encoder holds the same tensors (``encoder_of``), so it
    hashes bit for bit as an encoder-built one.  The reference makes
    that encoder lazily, at the first ``.enc``
    (``repro/core/index.py:225-312``); here it costs no copy and no
    draw, so it is made at construction, where every path reads
    ``encoder``.  ``fns`` reads back as the ``"ssh"`` encoder's view.
    """
    encoder: Optional[Encoder] = None
    signatures: Optional[torch.Tensor] = None   # (N, K) int32
    keys: Optional[torch.Tensor] = None  # (N, L) int32 (uint32 bit pattern)
    series: Optional[torch.Tensor] = None       # (N, m) float32, or None
    env_radius: Optional[int] = None
    env_upper: Optional[torch.Tensor] = None
    env_lower: Optional[torch.Tensor] = None
    build_backend: str = "cuda"
    host_buckets: Optional[HostBuckets] = None
    sig_cache: Optional[SignatureCache] = None
    fns: dataclasses.InitVar[Optional[SSHFunctions]] = None

    def __post_init__(self, fns):
        if isinstance(self.encoder, SSHFunctions):
            if fns is not None:
                raise TypeError("SSHIndex() got SSHFunctions twice")
            self.encoder, fns = None, self.encoder
        if self.encoder is None:
            if fns is None:
                raise TypeError("SSHIndex() needs encoder= or the legacy "
                                "fns=")
            self.encoder = encoder_of(fns)
        if self.signatures is None or self.keys is None:
            raise TypeError("SSHIndex() needs signatures= and keys=")

    @classmethod
    def build(cls, series, params=None, *, spec: Optional[IndexSpec] = None,
              with_host_buckets: bool = False, batch: int = 4096,
              envelope_band: Optional[int] = None, backend: str = "auto",
              device=None) -> "SSHIndex":
        """Paper Alg. 1: encode every series in chunks of ``batch`` rows
        and fold band keys; fill the host tables and the envelopes at
        ``envelope_band`` when asked.  The spec comes as ``spec=`` or in
        the ``params`` slot, where a legacy ``SSHParams`` lowers under a
        ``DeprecationWarning`` (``repro/core/index.py:260-301``).  Runs on
        CUDA unless ``device="cpu"``; ``backend`` is checked against that
        device (``"jnp"`` only on the CPU)."""
        if spec is not None:
            if params is not None:
                raise TypeError("SSHIndex.build() takes spec= or a legacy "
                                "SSHParams, not both")
        else:
            spec = _spec_from_legacy(params, "SSHIndex.build")
        dev = ops.resolve_device(device)
        ops.check_backend(backend, dev)
        series = torch.as_tensor(series, dtype=torch.float32).to(dev)
        enc = make_encoder(spec, dev, length=int(series.shape[1]))
        sigs = enc.encode_chunked(series, batch=batch)
        idx = cls(encoder=enc, signatures=sigs, keys=enc.band_keys(sigs),
                  series=series, build_backend=dev.type)
        if with_host_buckets:
            idx.build_host_buckets()
        if envelope_band is not None:
            idx.candidate_envelopes(envelope_band)
        return idx

    def _legacy_fns(self) -> Optional[SSHFunctions]:
        """The legacy ``SSHFunctions`` view of an ``"ssh"`` index's
        encoder state (no copy); None for any other encoder."""
        if self.encoder.spec.encoder != "ssh":
            return None
        return self.encoder.legacy_functions()

    @property
    def enc(self) -> Encoder:
        """The index's encoder (the reference's accessor)."""
        return self.encoder

    def build_host_buckets(self) -> HostBuckets:
        """Fill the host tables from the stored band keys."""
        self.host_buckets = HostBuckets(self.num_tables)
        self.host_buckets.insert(self.keys)
        self.host_buckets.merge()
        return self.host_buckets

    @property
    def device(self) -> torch.device:
        return self.signatures.device

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
        if self.series is None:
            raise ValueError("candidate envelopes require stored series")
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
        return self.encoder.encode(q)

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

    def insert_encoded(self, series: Optional[torch.Tensor],
                       signatures: torch.Tensor,
                       keys: torch.Tensor) -> None:
        """Fold pre-encoded rows (a ``StreamIngestor`` fold) into the
        index with no re-hashing (``repro/core/index.py:433-469``);
        ``series`` may be None only when the index stores none."""
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
        if self.series is not None:
            if series is None:
                raise ValueError("index stores raw series for re-ranking; "
                                 "artifacts must include them")
            series = torch.as_tensor(series, dtype=torch.float32).to(dev)
        base = int(self.signatures.shape[0])
        self.signatures = torch.cat([self.signatures, sigs])
        self.keys = torch.cat([self.keys, keys])
        if self.series is not None:
            self.series = torch.cat([self.series, series])
        if self.host_buckets is not None:
            self.host_buckets.insert(keys, base_id=base)
        if (self.env_radius is not None and self.env_upper is not None
                and self.series is not None):
            u, l = _envelopes_chunked(series, self.env_radius)
            self.env_upper = torch.cat([self.env_upper, u])
            self.env_lower = torch.cat([self.env_lower, l])

    def nbytes(self) -> int:
        """Resident bytes: artifacts plus the encoder state."""
        arrays = [self.signatures, self.keys, self.series, self.env_upper,
                  self.env_lower, *self.encoder._require_state().values()]
        return sum(a.numel() * a.element_size()
                   for a in arrays if a is not None)


# set after the class: ``fns`` is also the init-only argument of the
# reference's constructor above, whose default the dataclass reads from
# the class body
SSHIndex.fns = property(SSHIndex._legacy_fns,
                        doc=SSHIndex._legacy_fns.__doc__)
