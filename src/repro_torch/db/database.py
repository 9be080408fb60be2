"""TimeSeriesDB — the facade over the SSH pipeline (counterpart of
``repro.db.database``)::

    from repro_torch.db import SearchConfig, TimeSeriesDB
    db = TimeSeriesDB.build(series, spec, SearchConfig(band=25))  # Alg. 1
    res = db.search(query)                                      # Alg. 2
    ress = db.search_batch(queries)                             # batched
    db.add(new_series)                                          # insert
    db.add_stream(block, seq=3); db.flush()                     # ingest

Runs on CUDA unless ``device="cpu"`` is passed.  ``config.searcher``
routes queries as the reference's ``LocalSearcher``/``BatchedSearcher``
(``repro/db/registry.py:104-137``): ``"batched"`` (default) through
``serving.batched.ssh_search_batch``, whose per-query results carry no
``stats``; ``"local"`` through one ``core.search.ssh_search`` per query,
each with its own ``stats``.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.index import SSHIndex
from repro_torch.core.search import SearchResult, ssh_search
from repro_torch.db.config import SearchConfig
from repro_torch.encoders import IndexSpec
from repro_torch.kernels import ops
from repro_torch.serving.batched import ssh_search_batch


class TimeSeriesDB:
    """An SSH index plus the search policy that answers queries over it.

    The envelopes of every database series are precomputed at
    ``config.band`` when the LB cascade will read them
    (``repro/db/database.py:99-103``), which makes every serving-path
    LB_Keogh2 a gather and compare.
    """

    def __init__(self, index: SSHIndex,
                 config: Optional[SearchConfig] = None):
        self.config = (config if config is not None
                       else SearchConfig()).validate()
        ops.check_backend(self.config.backend, index.device)
        self.index = index
        self._ingestor = None        # lazy shard-local StreamIngestor
        if self.config.band is not None and self.config.use_lb_cascade:
            index.candidate_envelopes(self.config.band)

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
        return cls(SSHIndex.build(series, spec, device=dev), config)

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def spec(self) -> IndexSpec:
        return self.index.encoder.spec

    def __len__(self) -> int:
        return int(self.index.signatures.shape[0])

    # -- queries ------------------------------------------------------------
    def search(self, query) -> SearchResult:
        """Top-k for one (m,) query through the configured searcher."""
        if self.config.searcher == "local":
            return ssh_search(query, self.index, self.config)
        q = torch.as_tensor(query, dtype=torch.float32)
        return self.search_batch(q[None, :])[0]

    def search_batch(self, queries) -> List[SearchResult]:
        """Per-query top-k for a (B, m) block; the same answers as
        ``search`` on each row."""
        if self.config.searcher == "local":
            qs = torch.as_tensor(queries, dtype=torch.float32).to(
                self.device)
            return [ssh_search(q, self.index, self.config) for q in qs]
        res = ssh_search_batch(queries, self.index, config=self.config)
        return [res.per_query(i) for i in range(res.n_queries)]

    # -- mutation -----------------------------------------------------------
    def add(self, series) -> None:
        """Insert and encode (m,) or (B, m) series now."""
        series = torch.as_tensor(series, dtype=torch.float32)
        self.index.insert(series[None, :] if series.dim() == 1 else series)

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
        self.index.insert_encoded(arts.series, arts.signatures, arts.keys)
        if arts.sketch is not None:
            self.index.encoder.absorb_sketch(arts.sketch)
