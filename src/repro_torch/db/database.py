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

Runs on CUDA unless ``device="cpu"`` is passed.  ``config.searcher``
names the searcher in ``repro_torch.db.registry`` that answers queries,
made at first use: ``"batched"`` (default) through
``serving.batched.ssh_search_batch``, whose per-query results carry no
``stats``; ``"local"`` through one ``core.search.ssh_search`` per query,
each with its own ``stats``; ``"engine"`` through the dynamic-batching
``serving.engine.ServingEngine`` (:attr:`TimeSeriesDB.engine`), which
also takes ``add`` between batches.  A saved directory is the reference's
format: either package loads what the other saved.
"""
from __future__ import annotations

from concurrent.futures import Future
from pathlib import Path
from typing import List, Optional

import torch

from repro_torch.core.index import SSHIndex
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
                 config: Optional[SearchConfig] = None):
        config = self._fit_config(index, (
            config if config is not None else SearchConfig()).validate())
        ops.check_backend(config.backend, index.device)
        self.index = index
        self.config = config
        self._searcher = None
        self._ingestor = None        # lazy shard-local StreamIngestor
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
        if cfg.band is not None and cfg.use_lb_cascade:
            self.index.candidate_envelopes(cfg.band)
        if cfg.use_host_buckets and self.index.host_buckets is None:
            self.index.build_host_buckets()

    @classmethod
    def build(cls, series, spec: IndexSpec,
              config: Optional[SearchConfig] = None, *,
              device=None) -> "TimeSeriesDB":
        """Paper Alg. 1 behind the facade; ``series`` (N, m) array or
        tensor.  CUDA unless ``device="cpu"``."""
        config = (config if config is not None else SearchConfig()) \
            .validate()
        dev = ops.resolve_device(device)
        ops.check_backend(config.backend, dev)
        return cls(SSHIndex.build(series, spec, device=dev,
                                  with_host_buckets=config.use_host_buckets),
                   config)

    # -- search policy ----------------------------------------------------
    @property
    def searcher(self):
        """The active searcher (made at first use)."""
        if self._searcher is None:
            self._searcher = registry.make_searcher(self.index, self.config)
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
        """A second facade over the same index with another policy."""
        return TimeSeriesDB(self.index, config)

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def spec(self) -> IndexSpec:
        return self.index.encoder.spec

    @property
    def params(self) -> dict:
        """The encoder's stage params, defaults filled in."""
        return {**self.index.encoder.DEFAULTS, **self.spec.params}

    @property
    def length(self) -> int:
        """Series length m, what a query must measure."""
        return int(self.index.series.shape[1])

    def __len__(self) -> int:
        return int(self.index.signatures.shape[0])

    def __repr__(self) -> str:
        return (f"TimeSeriesDB(n={len(self)}, "
                f"encoder={self.spec.encoder!r}, "
                f"K={self.index.num_hashes}, L={self.index.num_tables}, "
                f"searcher={self.config.searcher!r}, "
                f"backend={self.config.backend!r}, device={self.device})")

    # -- queries ------------------------------------------------------------
    def search(self, query) -> SearchResult:
        """Top-k for one (m,) query through the configured searcher."""
        return self.searcher.search(query)

    def search_batch(self, queries) -> List[SearchResult]:
        """Per-query top-k for a (B, m) block; the same answers as
        ``search`` on each row."""
        return self.searcher.search_batch(queries)

    def submit(self, query) -> Future:
        """Asynchronous search: queued on the ``"engine"`` searcher, a
        resolved future on the others."""
        return self.searcher.submit(query)

    # -- mutation -----------------------------------------------------------
    def add(self, series) -> None:
        """Insert and encode (m,) or (B, m) series: now, or through the
        live searcher (the engine applies it before its next batch)."""
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
        if self._ingestor is None:
            from repro_torch.streaming import StreamIngestor
            self._ingestor = StreamIngestor(self.index.encoder, shard=shard)
        self._ingestor.append(series, seq=seq)

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
        under ``encoder/cs/agg`` holds every append."""
        self.flush()
        if self._searcher is not None:
            self._searcher.flush()
        return persistence.save_database(directory, self.index, self.config)

    @classmethod
    def load(cls, directory: str | Path,
             config: Optional[SearchConfig] = None, *,
             device=None) -> "TimeSeriesDB":
        """Restore a saved database onto ``device`` (CUDA unless
        ``device="cpu"``).  ``config`` replaces the saved search policy
        (the saved one when omitted, defaults when none was saved).  A
        saved ``backend="jnp"`` names the plain versions, which run only
        on the CPU: loading it onto CUDA raises rather than rewrite the
        knob."""
        dev = ops.resolve_device(device)
        if config is None:
            cfg = persistence.saved_config(directory)
            if cfg is not None and cfg.backend == "jnp" \
                    and dev.type != "cpu":
                raise ValueError(
                    f"{directory} was saved with backend='jnp', the plain "
                    "versions, which run only on the CPU: pass config= "
                    "with another backend, or device='cpu'")
        index, saved = persistence.load_database(directory, device=dev)
        return cls(index, config if config is not None else saved)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Close the searcher, stopping the engine's thread (the next
        query makes a new one); idempotent."""
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
