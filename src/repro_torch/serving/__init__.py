"""Query serving (counterpart of ``repro.serving``).

  ssh_search_batch / batch_probe / BatchSearchResult — batched primitives
  ServingEngine                                      — dynamic batcher
  BatchedSearcher                                    — its backend
  ServingMetrics                                     — latency/throughput
  SearchConfig (``repro_torch.db.SearchConfig``)     — every search knob

The batcher's policy is ``SearchConfig.batch_policy``
(``repro_torch.db.BatchPolicy``, fixed or adaptive).  Most callers reach
the engine through the facade: ``TimeSeriesDB`` with
``SearchConfig(searcher="engine")``.  The reference's
``DistributedSearcher`` waits for the distributed tier (ROADMAP.md §1,
item 6).
"""
from repro_torch.db.config import SearchConfig
from repro_torch.serving.batched import (BatchSearchResult, batch_probe,
                                         ssh_search_batch)
from repro_torch.serving.engine import BatchedSearcher, ServingEngine
from repro_torch.serving.metrics import ServingMetrics

__all__ = [
    "BatchSearchResult", "batch_probe", "ssh_search_batch",
    "BatchedSearcher", "SearchConfig", "ServingEngine", "ServingMetrics",
]
