"""TimeSeriesDB — the facade over the SSH pipeline (counterpart of
``repro.db.database``)::

    from repro_torch.db import SearchConfig, TimeSeriesDB
    db = TimeSeriesDB.build(series, spec, SearchConfig(band=25))  # Alg. 1
    res = db.search(query)                                      # Alg. 2
    ress = db.search_batch(queries)                             # batched
    db.add(new_series)                                          # insert
    db.add_stream(block, seq=3); db.flush()                     # ingest
    db.save("/data/ssh_ecg")                                    # persist
    db2 = TimeSeriesDB.load("/data/ssh_ecg")                    # restart

    cfg = SearchConfig(band=25, subseq_window=512, subseq_hop=1)
    sdb = TimeSeriesDB.build_stream(stream, spec, cfg)  # every window
    res = sdb.search_subsequence(query)                 # res.offsets
    sdb.extend_stream(tail)                             # grow

Runs on CUDA unless ``device="cpu"`` is passed.  ``config.searcher``
names the searcher in ``repro_torch.db.registry`` that answers queries,
made at first use: ``"batched"`` (default) through
``serving.batched.ssh_search_batch``, whose per-query results carry no
``stats``; ``"local"`` through one ``core.search.ssh_search`` per query,
each with its own ``stats``; ``"engine"`` through the dynamic-batching
``serving.engine.ServingEngine`` (:attr:`TimeSeriesDB.engine`), which
also takes ``add`` between batches; ``"distributed"`` through the
row-sharded fan-out over ``mesh`` (a sequence of ``torch.device``s,
default every visible CUDA device; a device may repeat, which puts
several shards on one card); ``"fleet"`` (and ``"distributed"`` or the
engine when ``replication > 1``) through the replicated, hedged fleet
(``repro_torch.fleet``), which :meth:`close` shuts down.  A stream-built database
(``build_stream``, ``repro_torch.subseq``) indexes every sliding window
of one stream and answers through ``search_subsequence``; the
fixed-length verbs and the stream verbs refuse each other's databases.
A saved directory is the reference's format: either package loads what
the other saved.
"""
from __future__ import annotations

from concurrent.futures import Future
from pathlib import Path
from typing import List, Optional

import torch

from repro_torch.core.index import SSHIndex, SSHParams, _spec_from_legacy
from repro_torch.core.search import SearchResult
from repro_torch.db import persistence, registry
from repro_torch.db.config import SearchConfig
from repro_torch.encoders import IndexSpec
from repro_torch.kernels import ops


class TimeSeriesDB:
    """An SSH index plus the search policy that answers queries over it.

    The envelopes of every database series are precomputed at
    ``config.band`` when the LB cascade will read them
    (``repro/db/database.py:99-103``), which makes every serving-path
    LB_Keogh2 a gather and compare; the host tables are filled when the
    config probes them.
    """

    def __init__(self, index: SSHIndex,
                 config: Optional[SearchConfig] = None, *, mesh=None):
        config = self._fit_config(index, (
            config if config is not None else SearchConfig()).validate())
        ops.check_backend(config.backend, index.device)
        self.index = index
        self.config = config
        self.mesh = mesh             # read by the "distributed" searcher
        self._searcher = None
        self._ingestor = None        # lazy shard-local StreamIngestor
        self._subseq = None          # set by build_stream and a stream load
        self._prepare_index()

    @staticmethod
    def _fit_config(index: SSHIndex, config: SearchConfig) -> SearchConfig:
        """Fold knobs the encoder cannot honour: without shift-alignment
        classes (``"srp"``) there is nothing to multiprobe, so
        ``multiprobe_offsets`` becomes 1 (``repro/db/database.py:60-69``)."""
        if (config.multiprobe_offsets > 1
                and not index.encoder.supports_multiprobe):
            config = config.replace(multiprobe_offsets=1)
        return config

    def _prepare_index(self) -> None:
        cfg = self.config
        if cfg.band is not None and cfg.use_lb_cascade \
                and self.index.series is not None:
            self.index.candidate_envelopes(cfg.band)
        if cfg.use_host_buckets and self.index.host_buckets is None:
            self.index.build_host_buckets()

    @classmethod
    def build(cls, series, params=None,
              config: Optional[SearchConfig] = None, *,
              spec: Optional[IndexSpec] = None, mesh=None,
              batch: int = 4096, device=None) -> "TimeSeriesDB":
        """Paper Alg. 1 behind the facade; ``series`` (N, m) array or
        tensor, encoded in chunks of ``batch`` rows.  The spec comes as
        ``spec=`` or in the ``params`` slot; a legacy ``SSHParams`` there
        lowers under a ``DeprecationWarning`` with identical results
        (``repro/db/database.py:72-106``).  CUDA unless ``device="cpu"``;
        ``mesh`` goes to the ``"distributed"`` searcher."""
        config = (config if config is not None else SearchConfig()) \
            .validate()
        if spec is None and params is not None:
            # lowered here so the warning names this entry point
            spec = _spec_from_legacy(params, "TimeSeriesDB.build")
            params = None
        dev = ops.resolve_device(device)
        ops.check_backend(config.backend, dev)
        # the envelopes at config.band are made by __init__
        return cls(SSHIndex.build(series, params, spec=spec, device=dev,
                                  with_host_buckets=config.use_host_buckets,
                                  batch=batch),
                   config, mesh=mesh)

    @classmethod
    def build_stream(cls, stream, params=None,
                     config: Optional[SearchConfig] = None, *,
                     spec: Optional[IndexSpec] = None, mesh=None,
                     device=None) -> "TimeSeriesDB":
        """Index every sliding window of one long stream
        (``repro_torch.subseq``; ``repro/db/database.py:108-139``):
        ``config.subseq_window`` (required) is the window length L,
        ``config.subseq_hop`` the start spacing.  One rolling encode, the
        windows never materialised; queries go through
        :meth:`search_subsequence`, growth through :meth:`extend_stream`.
        The spec slot is :meth:`build`'s.  CUDA unless ``device="cpu"``."""
        config = (config if config is not None else SearchConfig()) \
            .validate()
        if config.subseq_window is None:
            raise ValueError(
                "build_stream needs config.subseq_window (the sliding-"
                "window length L to index)")
        if spec is None and params is not None:
            spec = _spec_from_legacy(params, "TimeSeriesDB.build_stream")
        if spec is None:
            raise TypeError("TimeSeriesDB.build_stream() needs spec= "
                            "(an IndexSpec) or a legacy SSHParams")
        dev = ops.resolve_device(device)
        ops.check_backend(config.backend, dev)
        from repro_torch.subseq import SubsequenceIndex
        sub = SubsequenceIndex.build(stream, spec,
                                     length=config.subseq_window,
                                     hop=config.subseq_hop, device=dev)
        return cls._over_stream(sub, config, mesh=mesh)

    @classmethod
    def _over_stream(cls, sub, config: Optional[SearchConfig], *,
                     mesh=None) -> "TimeSeriesDB":
        db = cls(sub.inner, config, mesh=mesh)
        db._subseq = sub
        return db

    # -- search policy ----------------------------------------------------
    @property
    def searcher(self):
        """The active searcher (made at first use)."""
        if self._searcher is None:
            self._searcher = registry.make_searcher(self.index, self.config,
                                                    mesh=self.mesh)
        return self._searcher

    def reconfigure(self, **changes) -> "TimeSeriesDB":
        """Swap search-time knobs in place (the old searcher is closed);
        the index is untouched.  Returns ``self``."""
        new = self._fit_config(self.index, self.config.replace(**changes))
        ops.check_backend(new.backend, self.device)
        self.close()
        self.config = new
        self._prepare_index()
        return self

    def with_config(self, config: SearchConfig) -> "TimeSeriesDB":
        """A second facade over the same index with another policy (and
        the same mesh)."""
        return TimeSeriesDB(self.index, config, mesh=self.mesh)

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def spec(self) -> IndexSpec:
        return self.index.encoder.spec

    @property
    def params(self) -> Optional[SSHParams]:
        """The legacy ``SSHParams`` view of an ``"ssh"`` index; None for
        any other encoder (``repro/db/database.py:373-375``)."""
        fns = self.index.fns
        return fns.params if fns is not None else None

    @property
    def length(self) -> int:
        """Series length m, what a query must measure: the window length
        L on a stream-built database."""
        if self._subseq is not None:
            return int(self._subseq.length)
        return int(self.index.series.shape[1])

    def __len__(self) -> int:
        return int(self.index.signatures.shape[0])

    def __repr__(self) -> str:
        return (f"TimeSeriesDB(n={len(self)}, "
                f"encoder={self.spec.encoder!r}, "
                f"K={self.index.num_hashes}, L={self.index.num_tables}, "
                f"searcher={self.config.searcher!r}, "
                f"backend={self.config.backend!r}, device={self.device})")

    # -- stream / fixed-length guards ---------------------------------------
    def _reject_subseq(self, verb: str) -> None:
        if self._subseq is not None:
            raise ValueError(
                f"{verb}() serves fixed-length databases; this one "
                "indexes sliding windows of a single stream — use "
                "search_subsequence() to query it and extend_stream() "
                "to grow it")

    def _require_subseq(self, verb: str):
        if self._subseq is None:
            raise ValueError(
                f"{verb}() needs a stream-built database "
                "(TimeSeriesDB.build_stream); this one indexes "
                "fixed-length series — use search()/add()")
        return self._subseq

    @property
    def subseq(self):
        """The ``SubsequenceIndex`` of a stream-built database."""
        return self._require_subseq("subseq")

    # -- queries ------------------------------------------------------------
    def search(self, query) -> SearchResult:
        """Top-k for one (m,) query through the configured searcher."""
        self._reject_subseq("search")
        return self.searcher.search(query)

    def search_batch(self, queries) -> List[SearchResult]:
        """Per-query top-k for a (B, m) block; the same answers as
        ``search`` on each row."""
        self._reject_subseq("search_batch")
        return self.searcher.search_batch(queries)

    def search_subsequence(self, query,
                           config: Optional[SearchConfig] = None):
        """Top-k stream windows by banded DTW, offsets pairwise at least
        ``config.exclusion_zone`` apart (default L//2), as a
        ``SubsequenceResult`` whose ``offsets`` are the match starts;
        ``config`` replaces the database's policy for this call."""
        sub = self._require_subseq("search_subsequence")
        return sub.search(query, config if config is not None
                          else self.config)

    def submit(self, query) -> Future:
        """Asynchronous search: queued on the ``"engine"`` searcher, a
        resolved future on the others."""
        return self.searcher.submit(query)

    # -- mutation -----------------------------------------------------------
    def add(self, series) -> None:
        """Insert and encode (m,) or (B, m) series: now, or through the
        live searcher (the engine applies it before its next batch)."""
        self._reject_subseq("add")
        series = torch.as_tensor(series, dtype=torch.float32)
        series = series[None, :] if series.dim() == 1 else series
        if self._searcher is not None:
            self._searcher.insert(series)
        else:
            self.index.insert(series)

    def add_stream(self, series, *, seq: Optional[int] = None,
                   shard: str = "local") -> None:
        """Continuous ingest: encode now, fold into the index on
        :meth:`flush`.  Appends may arrive out of order, each tagged with
        its stream position ``seq``; with ``"ssh-cs"`` the pending sketch
        merges into ``cs/agg`` at the flush
        (``repro/db/database.py:243-263``)."""
        self._reject_subseq("add_stream")
        if self._ingestor is None:
            from repro_torch.streaming import StreamIngestor
            self._ingestor = StreamIngestor(self.index.encoder, shard=shard)
        self._ingestor.append(series, seq=seq)

    def extend_stream(self, tail) -> int:
        """Append points to a stream-built database; the windows they
        complete are rolling-encoded (signatures equal to a full
        rebuild's) and folded in.  Returns how many."""
        return self._require_subseq("extend_stream").extend_stream(tail)

    def flush(self) -> None:
        """Fold pending :meth:`add_stream` appends into the index (no-op
        when nothing is pending)."""
        ingestor, self._ingestor = self._ingestor, None
        if ingestor is not None and len(ingestor):
            self.apply_stream(ingestor)

    def apply_stream(self, ingestor) -> None:
        """Fold a (merged, possibly remote-shard) ``StreamIngestor`` into
        this database: no series is re-encoded, rows land in the
        ingestor's seq order, and its sketch merges into the encoder's."""
        if ingestor.encoder.spec != self.spec:
            raise ValueError(
                f"cannot fold a stream ingested under "
                f"{ingestor.encoder.spec!r} into a database built from "
                f"{self.spec!r}")
        arts = ingestor.artifacts()
        if self._searcher is not None:
            self._searcher.flush()
            self._searcher.apply_artifacts(arts)
        else:
            self.index.insert_encoded(arts.series, arts.signatures,
                                      arts.keys)
        if arts.sketch is not None:
            self.index.encoder.absorb_sketch(arts.sketch)

    # -- persistence --------------------------------------------------------
    def save(self, directory: str | Path) -> Path:
        """Persist the index and the config; pending ``add_stream``
        appends are folded in first, so the ``"ssh-cs"`` aggregate saved
        under ``encoder/cs/agg`` holds every append.  A stream-built
        database saves in the reference's subsequence format."""
        if self._subseq is not None:
            return self._subseq.save(directory, self.config)
        self.flush()
        if self._searcher is not None:
            self._searcher.flush()
        return persistence.save_database(directory, self.index, self.config)

    @classmethod
    def load(cls, directory: str | Path,
             config: Optional[SearchConfig] = None, *,
             device=None, mesh=None) -> "TimeSeriesDB":
        """Restore a saved database onto ``device`` (CUDA unless
        ``device="cpu"``).  ``config`` replaces the saved search policy
        (the saved one when omitted, defaults when none was saved).  A
        saved ``backend="jnp"`` names the plain versions, which run only
        on the CPU: loading it onto CUDA raises rather than rewrite the
        knob.  ``mesh`` goes to the ``"distributed"`` searcher."""
        from repro_torch import subseq
        dev = ops.resolve_device(device)
        stream = subseq.is_subseq_dir(directory)
        if config is None:
            cfg = (subseq.persistence.saved_config(directory) if stream
                   else persistence.saved_config(directory))
            if cfg is not None and cfg.backend == "jnp" \
                    and dev.type != "cpu":
                raise ValueError(
                    f"{directory} was saved with backend='jnp', the plain "
                    "versions, which run only on the CPU: pass config= "
                    "with another backend, or device='cpu'")
        if stream:
            sub, saved = subseq.load_subseq(directory, device=dev)
            return cls._over_stream(
                sub, config if config is not None else saved)
        index, saved = persistence.load_database(directory, device=dev)
        return cls(index, config if config is not None else saved,
                   mesh=mesh)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Close the searcher, stopping the engine's thread or shutting
        the fleet down (the next query makes a new one); idempotent."""
        if self._searcher is not None:
            self._searcher.close()
            self._searcher = None

    def __enter__(self) -> "TimeSeriesDB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def engine(self):
        """The ``ServingEngine`` of the ``"engine"`` searcher."""
        searcher = self.searcher
        if not hasattr(searcher, "engine"):
            raise AttributeError(
                f"searcher {self.config.searcher!r} has no engine; "
                "use SearchConfig(searcher='engine')")
        return searcher.engine
