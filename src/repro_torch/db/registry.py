"""Searcher registry — how a ``TimeSeriesDB`` answers queries
(counterpart of ``repro.db.registry``).

A searcher turns (index, config) into answers: ``search`` gives a
``SearchResult``, ``search_batch`` one a query, ``insert`` grows the
index.  The port registers the reference's five:

* ``"local"`` — one ``core.search.ssh_search`` per query; the only one
  that probes the host buckets (``use_host_buckets``);
* ``"batched"`` — ``serving.batched.ssh_search_batch`` over the whole
  block (the default); per-query results carry no ``stats``, as the
  reference's;
* ``"distributed"`` — the row-sharded fan-out over a mesh of devices
  (``serving.engine.DistributedSearcher``; the mesh defaults to every
  visible CUDA device, or the CPU for a CPU index); with
  ``config.replication > 1`` it serves through the fleet instead, as the
  fused fan-out cannot hedge or survive a shard loss;
* ``"engine"`` — the dynamic-batching ``serving.engine.ServingEngine``
  (a batcher thread, bucketed padding, inserts between batches), which
  adds a ``submit`` whose future resolves when the batch is served;
* ``"fleet"`` — the resilient tier (``repro_torch.fleet``): R-way
  replicated shards, hedged fan-out with failover, live drain and
  resize; exposes the fleet's ``injector`` and the ``fleet`` itself.

``register_searcher`` adds a backend without touching the facade.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Callable, Dict, List

import torch

from repro_torch.db.config import SearchConfig

_FACTORIES: Dict[str, Callable] = {}


def register_searcher(name: str) -> Callable:
    """Decorator: register ``factory(index, config, *, mesh=None)`` under
    ``name`` (a later registration of the same name wins)."""
    def deco(factory: Callable) -> Callable:
        _FACTORIES[name] = factory
        return factory
    return deco


def available_searchers() -> List[str]:
    return sorted(_FACTORIES)


def make_searcher(index, config: SearchConfig, *, mesh=None):
    """The searcher named by ``config.searcher``; ``mesh`` reaches every
    factory and only ``"distributed"`` reads it."""
    try:
        factory = _FACTORIES[config.searcher]
    except KeyError:
        raise ValueError(f"unknown searcher {config.searcher!r}; "
                         f"registered: {available_searchers()}") from None
    return factory(index, config, mesh=mesh)


def _queries(queries, index) -> torch.Tensor:
    return torch.as_tensor(queries, dtype=torch.float32).to(index.device)


class _SearcherBase:
    """Shared plumbing: insert routing, no-op flush and close, and a
    ``submit`` that resolves at once (the reference's ``:94``).  Every
    factory takes ``mesh`` so the registry can pass it uniformly."""

    def __init__(self, index, config: SearchConfig, *, mesh=None):
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


class _BlockSearcher(_SearcherBase):
    """A facade over a backend answering ``search_batch`` with one
    ``BatchSearchResult`` a block (the distributed fan-out, the fleet)."""

    _inner = None

    def search_batch(self, queries) -> List:
        res = self._inner.search_batch(_queries(queries, self.index))
        return [res.per_query(i) for i in range(res.n_queries)]

    def search(self, query):
        return self.search_batch(_queries(query, self.index)[None, :])[0]

    def insert(self, series) -> None:
        self._inner.insert(series)          # raises: stream + fold instead

    def apply_artifacts(self, artifacts) -> None:
        self._inner.apply_artifacts(artifacts)

    def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()


@register_searcher("distributed")
class DistributedSearcher(_BlockSearcher):
    """The row-sharded fan-out over ``mesh`` (default
    ``dist_index.default_mesh``: every visible CUDA device); band set,
    single probe, signature ranking (``serving.engine.DistributedSearcher``
    checks).  With ``replication > 1``, the fleet (``mesh`` is None)."""

    def __init__(self, index, config: SearchConfig, *, mesh=None):
        super().__init__(index, config)
        if config.replication > 1:
            from repro_torch.fleet import FleetSearcher
            self._inner = FleetSearcher(index, config)
            self.mesh = None
            return
        from repro_torch.distributed import dist_index
        from repro_torch.serving.engine import DistributedSearcher as _Dist
        if mesh is None:
            mesh = dist_index.default_mesh(index.device)
        self._inner = _Dist(index, config, mesh)
        self.mesh = self._inner.mesh

    def resize(self, mesh):
        """Elastic shard move onto a new mesh (the encoded rows move,
        nothing is re-encoded); through the fleet, an int worker count or
        a name list (live minimal-movement rebalance; returns the shards
        moved)."""
        out = self._inner.resize(mesh)
        if self.mesh is not None:
            self.mesh = self._inner.mesh
        return out


@register_searcher("fleet")
class FleetRegistrySearcher(_BlockSearcher):
    """The resilient tier behind the facade: replicated shard placement,
    hedged fan-out, failover, live drain and resize
    (``repro_torch.fleet``); ``injector`` is the fleet's fault switchboard
    and ``fleet`` the ``FleetSearcher``."""

    def __init__(self, index, config: SearchConfig, *, mesh=None):
        super().__init__(index, config)
        from repro_torch.fleet import FleetSearcher
        self._inner = FleetSearcher(index, config)

    @property
    def injector(self):
        return self._inner.injector

    @property
    def fleet(self):
        return self._inner

    def resize(self, workers) -> int:
        return self._inner.resize(workers)

    def drain(self, worker: str) -> int:
        return self._inner.drain(worker)

    def fail_worker(self, worker: str) -> int:
        return self._inner.fail_worker(worker)


@register_searcher("engine")
class EngineSearcher(_SearcherBase):
    """The ``ServingEngine`` behind the facade
    (``repro/db/registry.py:240-288``): the batcher thread starts at the
    first query (or at ``start()``), ``close()`` drains and stops it,
    ``submit`` is the asynchronous path and ``metrics`` the engine's
    counters."""

    def __init__(self, index, config: SearchConfig, *, mesh=None):
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
        """Stop the batcher, then release the engine's searcher (a
        fleet's pool, replicas and artifacts)."""
        self.engine.stop()
        close = getattr(self.engine.searcher, "close", None)
        if close is not None:
            close()

    def _ensure_started(self) -> None:
        if self.engine._thread is None and self.engine._state != "stopped":
            self.engine.start()
