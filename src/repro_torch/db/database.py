"""TimeSeriesDB — the facade over the SSH pipeline (counterpart of
``repro.db.database``)::

    from repro_torch.db import SearchConfig, TimeSeriesDB
    db = TimeSeriesDB.build(series, spec, SearchConfig(band=25))  # Alg. 1
    res = db.search(query)                                      # Alg. 2
    ress = db.search_batch(queries)                             # batched

Runs on CUDA unless ``device="cpu"`` is passed.  Serves the reference's
default searcher, the batched one (``serving.batched.ssh_search_batch``).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.index import SSHIndex
from repro_torch.core.search import SearchResult
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

    def search(self, query) -> SearchResult:
        """Top-k for one (m,) query."""
        q = torch.as_tensor(query, dtype=torch.float32)
        return self.search_batch(q[None, :])[0]

    def search_batch(self, queries) -> List[SearchResult]:
        """Per-query top-k for a (B, m) block."""
        res = ssh_search_batch(queries, self.index, config=self.config)
        out = [res.per_query(i) for i in range(res.n_queries)]
        for r in out:
            r.stats = res.stats       # batch-aggregate counters
        return out
