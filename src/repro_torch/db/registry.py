"""Searcher registry — how a ``TimeSeriesDB`` answers queries
(counterpart of ``repro.db.registry``).

A searcher turns (index, config) into answers: ``search`` gives a
``SearchResult``, ``search_batch`` one a query, ``insert`` grows the
index.  The port registers three:

* ``"local"`` — one ``core.search.ssh_search`` per query; the only one
  that probes the host buckets (``use_host_buckets``);
* ``"batched"`` — ``serving.batched.ssh_search_batch`` over the whole
  block (the default); per-query results carry no ``stats``, as the
  reference's;
* ``"engine"`` — the dynamic-batching ``serving.engine.ServingEngine``
  (a batcher thread, bucketed padding, inserts between batches), which
  adds a ``submit`` whose future resolves when the batch is served.

The reference's ``"distributed"`` and ``"fleet"`` are queued
(ROADMAP.md §1, item 6); :func:`make_searcher` refuses them by name.
``register_searcher`` adds a backend without touching the facade.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Callable, Dict, List

import torch

from repro_torch.db.config import SearchConfig

_FACTORIES: Dict[str, Callable] = {}

#: the reference's searchers that the port does not serve yet
QUEUED = ("distributed", "fleet")


def register_searcher(name: str) -> Callable:
    """Decorator: register ``factory(index, config)`` under ``name``
    (a later registration of the same name wins)."""
    def deco(factory: Callable) -> Callable:
        _FACTORIES[name] = factory
        return factory
    return deco


def available_searchers() -> List[str]:
    return sorted(_FACTORIES)


def make_searcher(index, config: SearchConfig):
    """The searcher named by ``config.searcher``."""
    name = config.searcher
    if name in _FACTORIES:
        return _FACTORIES[name](index, config)
    if name in QUEUED:
        raise ValueError(
            f"searcher {name!r} is not ported to repro_torch yet: it is "
            f"queued in ROADMAP.md §1; registered: {available_searchers()}")
    raise ValueError(f"unknown searcher {name!r}; registered: "
                     f"{available_searchers()}")


def _queries(queries, index) -> torch.Tensor:
    return torch.as_tensor(queries, dtype=torch.float32).to(index.device)


class _SearcherBase:
    """Shared plumbing: insert routing, no-op flush and close, and a
    ``submit`` that resolves at once (the reference's ``:94``)."""

    def __init__(self, index, config: SearchConfig):
        self.index = index
        self.config = config

    def insert(self, series) -> None:
        self.index.insert(series)

    def apply_artifacts(self, artifacts) -> None:
        """Fold a ``StreamIngestor``'s artifacts in without re-hashing."""
        self.index.insert_encoded(artifacts.series, artifacts.signatures,
                                  artifacts.keys)

    def flush(self) -> None:
        """Make pending inserts visible (nothing is pending here)."""

    def close(self) -> None:
        """Release background resources (none here); idempotent."""

    def submit(self, query) -> Future:
        fut: Future = Future()
        try:
            fut.set_result(self.search(query))
        except Exception as exc:            # handed to the caller
            fut.set_exception(exc)
        return fut


@register_searcher("local")
class LocalSearcher(_SearcherBase):
    """Sequential re-rank: one ``ssh_search`` per query."""

    def search(self, query):
        from repro_torch.core.search import ssh_search
        return ssh_search(query, self.index, self.config)

    def search_batch(self, queries) -> List:
        return [self.search(q) for q in _queries(queries, self.index)]


@register_searcher("batched")
class BatchedSearcher(_SearcherBase):
    """The batched path over the whole block."""

    def search_batch(self, queries) -> List:
        from repro_torch.serving.batched import ssh_search_batch
        res = ssh_search_batch(queries, self.index, config=self.config)
        return [res.per_query(i) for i in range(res.n_queries)]

    def search(self, query):
        return self.search_batch(_queries(query, self.index)[None, :])[0]


@register_searcher("engine")
class EngineSearcher(_SearcherBase):
    """The ``ServingEngine`` behind the facade
    (``repro/db/registry.py:240-288``): the batcher thread starts at the
    first query (or at ``start()``), ``close()`` drains and stops it,
    ``submit`` is the asynchronous path and ``metrics`` the engine's
    counters."""

    def __init__(self, index, config: SearchConfig):
        super().__init__(index, config)
        from repro_torch.serving.engine import ServingEngine
        self.engine = ServingEngine(index, config)

    @property
    def metrics(self):
        return self.engine.metrics

    def start(self) -> "EngineSearcher":
        self.engine.start()
        return self

    def search(self, query):
        self._ensure_started()
        return self.engine.search(query)

    def search_batch(self, queries) -> List:
        self._ensure_started()
        return self.engine.search_batch(queries)

    def submit(self, query) -> Future:
        self._ensure_started()
        return self.engine.submit(query)

    def insert(self, series) -> None:
        self.engine.insert(series)

    def apply_artifacts(self, artifacts) -> None:
        self.engine.apply_artifacts(artifacts)

    def flush(self) -> None:
        self.engine.flush_inserts()

    def close(self) -> None:
        self.engine.stop()

    def _ensure_started(self) -> None:
        if self.engine._thread is None and self.engine._state != "stopped":
            self.engine.start()
