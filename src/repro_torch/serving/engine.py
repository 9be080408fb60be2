"""ServingEngine — dynamic batching on top of the batched SSH search
(counterpart of ``repro.serving.engine``).

  client -> submit() -> request deque -> batcher thread -> ssh_search_batch
                          (condition var)  |                      |
                                           +--- pending inserts --+-> futures

The batcher pulls the first waiting request, then drains the queue
until the batch closes under the config's ``BatchPolicy``: ``"fixed"``
at ``max_batch`` requests or ``max_wait_ms`` after the batch opened;
``"adaptive"`` after ``BatchPolicy.wait_budget_s``, recomputed from the
queue depth, EWMAs of batch service seconds and of inter-submit gaps,
and whether the batch opened from an idle engine.  The batch is padded
to a bucket size (powers of two up to ``max_batch``) by repeating its
first query, as the reference pads; answers do not depend on the
grouping or the padding, and the metrics count only the real requests.

Queries wait on the host, as float32 numpy rows; the padded block is
stacked there and handed to ``ssh_search_batch``, which takes the
signature LRU's keys from that host copy and uploads the block once.
Results come back as host arrays, so a future holds no device memory.
The batcher thread enters the index's CUDA device (the current device
is per thread) and launches on the legacy default stream: callers of
``search_batch`` and the batcher serialise under one lock, as in the
reference, and ``ssh_search_batch`` synchronises before it returns.

Streaming inserts are applied on the batcher thread between batches,
under the same lock, so a query submitted after ``insert()`` returned
is served by an index that holds the series.  The reference's fleet
route (``replication > 1``) and its ``DistributedSearcher`` wait for
the distributed tier (ROADMAP.md §1, item 6); ``SearchConfig.validate``
refuses ``replication > 1``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.index import SSHIndex
from repro_torch.core.search import SearchResult
from repro_torch.db.config import SearchConfig
from repro_torch.serving.batched import BatchSearchResult, ssh_search_batch
from repro_torch.serving.metrics import ServingMetrics


class EngineConfig:
    """Removed alias of :class:`repro_torch.db.SearchConfig`, retired as
    in the reference: constructing it raises with migration guidance."""

    def __init__(self, *args, **kwargs):
        raise TypeError(
            "EngineConfig was removed; construct repro_torch.db.SearchConfig "
            "instead (same search fields — batcher knobs now live on "
            "SearchConfig.batch_policy as a repro_torch.db.BatchPolicy)")


class BatchedSearcher:
    """The engine's backend: ``ssh_search_batch`` over the whole block.

    Precomputes the database envelopes at ``config.band`` so every
    LB_Keogh2 of the serving path is a gather and compare;
    ``SSHIndex.insert`` keeps them aligned under streaming inserts.
    """

    def __init__(self, index: SSHIndex, config: SearchConfig):
        self.index = index
        self.config = config
        if config.band is not None and config.use_lb_cascade \
                and index.series is not None:
            index.candidate_envelopes(config.band)

    def search_batch(self, queries) -> BatchSearchResult:
        return ssh_search_batch(queries, self.index, config=self.config)

    def insert(self, series) -> None:
        self.index.insert(series)

    def apply_artifacts(self, artifacts) -> None:
        """Fold a ``StreamIngestor``'s artifacts in without re-hashing."""
        self.index.insert_encoded(artifacts.series, artifacts.signatures,
                                  artifacts.keys)


def _lb_fracs(res: BatchSearchResult):
    """The batch's LB-cascade pruning fraction (empty when no pair
    entered the cascade)."""
    return ([res.stats.lb_pruned_frac]
            if res.stats is not None and res.stats.n_in else [])


def _abandon_fracs(res: BatchSearchResult):
    """The batch's early-abandoned DTW fraction (empty when no pair
    reached the DTW stage)."""
    return ([res.stats.dtw_abandoned_frac]
            if res.stats is not None and res.stats.n_dtw else [])


def _stage_seconds(res: BatchSearchResult):
    """Per-stage seconds of the batch (None when telemetry is off)."""
    return res.stats.stage_seconds if res.stats is not None else None


def _sig_hits(res: BatchSearchResult) -> int:
    """Queries of the batch whose encode came from the signature LRU."""
    return res.stats.sig_cache_hit if res.stats is not None else 0


def _host_row(query) -> np.ndarray:
    """One (m,) query as a float32 host row (a tensor on the card is read
    back once, here, on the submitter's thread)."""
    if isinstance(query, torch.Tensor):
        query = query.detach().cpu().numpy()
    row = np.asarray(query, np.float32)
    if row.ndim != 1:
        raise ValueError(f"a query is one (m,) series, got shape "
                         f"{tuple(row.shape)}")
    return row


def _device_scope(device: torch.device):
    """The CUDA device of the index as the calling thread's current one
    (nothing to enter on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@dataclasses.dataclass
class _Request:
    query: np.ndarray
    future: Future
    t_enqueue: float


class ServingEngine:
    """Dynamic-batching query server over an ``SSHIndex``::

        cfg = SearchConfig(band=8, batch_policy=BatchPolicy(max_batch=8))
        engine = ServingEngine(index, cfg)
        with engine:                       # starts the batcher thread
            fut = engine.submit(q)         # async
            res = engine.search(q)         # sync
        engine.metrics.snapshot()

    (Or behind the facade: ``TimeSeriesDB`` with
    ``SearchConfig(searcher="engine")`` owns one.)  ``search_batch``
    serves a block the caller assembled without the queue, and records
    metrics.
    """

    _STOP = object()

    def __init__(self, index: SSHIndex,
                 config: SearchConfig = SearchConfig(),
                 searcher=None, metrics: Optional[ServingMetrics] = None):
        config.validate()                  # refuses the fleet's knobs
        self.index = index
        self.config = config
        self.searcher = searcher if searcher is not None \
            else BatchedSearcher(index, config)
        self.metrics = metrics or ServingMetrics()
        # a deque under one condition variable: submit() wakes the batcher
        # and _collect() reads the exact depth
        self._cond = threading.Condition()
        self._pending: deque = deque()
        self._inserts: "queue.Queue" = queue.Queue()
        # EWMA of batch service seconds (the stage-seconds sum when the
        # config records them, else the batch's wall time) and of the
        # gaps between submits: the adaptive policy's inputs
        self._service_ewma_s: Optional[float] = None
        self._arrival_gap_ewma_s: Optional[float] = None
        self._last_enqueue_t: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        # serialises index mutation against serving, across the batcher
        # thread and direct search_batch() callers
        self._serve_lock = threading.Lock()
        # serialises submit()/insert() against stop()'s final drain.
        # States: "new" (submits queue and are batched once the worker
        # starts), "running", "stopped" (submits serve on the caller's
        # thread)
        self._lifecycle_lock = threading.Lock()
        self._state = "new"

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ServingEngine":
        if self._thread is not None:
            return self
        with self._lifecycle_lock:
            self._state = "running"
        self.metrics.on_start()
        self._thread = threading.Thread(target=self._worker,
                                        name="ssh-serving-batcher",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        with self._cond:
            self._pending.append(self._STOP)
            self._cond.notify_all()
        self._thread.join()
        with self._lifecycle_lock:
            self._state = "stopped"
            self._thread = None
            with self._cond:
                stragglers = [r for r in self._pending
                              if r is not self._STOP]
                self._pending.clear()
        # requests that raced shutdown: resolve every future
        max_batch = self.config.batch_policy.max_batch
        for lo in range(0, len(stragglers), max_batch):
            chunk = stragglers[lo:lo + max_batch]
            try:
                results = self.search_batch(
                    np.stack([r.query for r in chunk]))
                for r, res in zip(chunk, results):
                    r.future.set_result(res)
            except Exception as exc:
                for r in chunk:
                    r.future.set_exception(exc)
        if not stragglers:
            with self._serve_lock:
                self._drain_inserts()

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API -------------------------------------------------------
    def submit(self, query) -> Future:
        """Queue one (m,) query; the future resolves to its
        ``SearchResult``.  After stop() the query is served on the
        caller's thread and the future comes back resolved."""
        fut: Future = Future()
        query = _host_row(query)
        with self._lifecycle_lock:
            enqueue = self._state != "stopped"
            if enqueue:
                with self._cond:
                    now = time.perf_counter()
                    if self._last_enqueue_t is not None:
                        gap = now - self._last_enqueue_t
                        alpha = self.config.batch_policy.ewma_alpha
                        prev = self._arrival_gap_ewma_s
                        self._arrival_gap_ewma_s = gap if prev is None \
                            else alpha * gap + (1.0 - alpha) * prev
                    self._last_enqueue_t = now
                    self._pending.append(_Request(query, fut, now))
                    depth = len(self._pending)
                    self._cond.notify_all()
        if enqueue:
            self.metrics.on_enqueue(depth)
        else:
            try:
                fut.set_result(self.search_batch(query[None, :])[0])
            except Exception as exc:
                fut.set_exception(exc)
        return fut

    def search(self, query, timeout: Optional[float] = None) -> SearchResult:
        """One query, through the batcher when it runs."""
        if self._state == "running":
            return self.submit(query).result(timeout=timeout)
        return self.search_batch(_host_row(query)[None, :])[0]

    def search_batch(self, queries) -> List[SearchResult]:
        """Serve a (B, m) block the caller assembled (no queue)."""
        if not isinstance(queries, (np.ndarray, torch.Tensor)):
            queries = np.asarray(queries, np.float32)
        t0 = time.perf_counter()
        with self._serve_lock:
            self._drain_inserts()
            res = self.searcher.search_batch(queries)
        wall = time.perf_counter() - t0
        b = int(queries.shape[0])
        self.metrics.set_index_bytes(self.index.nbytes())
        self.metrics.on_batch(
            b, [wall] * b, [0.0] * b,
            list(res.pruned_by_hash_frac[:b]),
            list(res.pruned_total_frac[:b]),
            len(self._pending),
            lb_pruned_frac=_lb_fracs(res),
            dtw_abandoned_frac=_abandon_fracs(res),
            stage_seconds=_stage_seconds(res),
            sig_cache_hits=_sig_hits(res))
        return [res.per_query(i) for i in range(b)]

    def flush_inserts(self) -> None:
        """Apply queued inserts now (``TimeSeriesDB.save`` calls this, so
        a snapshot taken right after ``insert()`` holds the series)."""
        with self._serve_lock:
            self._drain_inserts()

    def apply_artifacts(self, artifacts) -> None:
        """Fold pre-encoded streaming artifacts under the serve lock,
        after the queued inserts, so rows keep their arrival order."""
        with self._serve_lock:
            self._drain_inserts()
            self.searcher.apply_artifacts(artifacts)

    def drain(self, worker: str) -> int:
        """Retire a fleet worker while serving; only a fleet searcher
        (ROADMAP.md §1, item 6) can, so this raises ``AttributeError``
        for any other."""
        drain = getattr(self.searcher, "drain", None)
        if drain is None:
            raise AttributeError(
                f"searcher {type(self.searcher).__name__} does not "
                "support drain(); serve with config.replication > 1")
        moved = drain(worker)
        self.metrics.on_rebalance(moved)
        return moved

    def resize(self, workers) -> int:
        """Live fleet rebalance; fleet searchers only, as :meth:`drain`."""
        resize = getattr(self.searcher, "resize", None)
        if resize is None:
            raise AttributeError(
                f"searcher {type(self.searcher).__name__} does not "
                "support resize(); serve with config.replication > 1")
        moved = resize(workers)
        self.metrics.on_rebalance(moved)
        return moved

    def insert(self, series) -> None:
        """Streaming insert of (m,) or (B, m) series; visible to every
        query submitted afterwards."""
        series = torch.as_tensor(series, dtype=torch.float32)
        if series.dim() == 1:
            series = series[None, :]
        with self._lifecycle_lock:
            running = self._state == "running"
            if running:
                self._inserts.put(series)
        if not running:
            with self._serve_lock:
                self.searcher.insert(series)
        self.metrics.on_insert(int(series.shape[0]))

    @property
    def service_ewma_s(self) -> Optional[float]:
        """The adaptive policy's service-time estimate (seconds a batch;
        None until the first batch completes)."""
        return self._service_ewma_s

    @property
    def arrival_gap_ewma_s(self) -> Optional[float]:
        """The adaptive policy's inter-arrival estimate (seconds between
        submits; None until the second submit)."""
        return self._arrival_gap_ewma_s

    @property
    def queue_depth(self) -> int:
        """Requests waiting in the queue right now."""
        with self._cond:
            return sum(1 for r in self._pending if r is not self._STOP)

    # -- batcher internals ------------------------------------------------
    def _drain_inserts(self) -> None:
        while True:
            try:
                series = self._inserts.get_nowait()
            except queue.Empty:
                return
            self.searcher.insert(series)

    def _pad_batch(self, queries: List[np.ndarray]) -> np.ndarray:
        """The host block, padded to the next bucket size by repeating the
        first query."""
        b = len(queries)
        bucket = next(s for s in self.config.buckets() if s >= b)
        return np.stack(list(queries) + [queries[0]] * (bucket - b))

    def _collect(self, first: _Request,
                 opened_idle: bool = True) -> List[_Request]:
        """Grow a batch around ``first`` under the ``BatchPolicy``.

        The wait budget is recomputed whenever the state changes and
        counts from the moment the batch opened: arrivals extend the
        batch, never the deadline.  ``opened_idle`` says whether the
        worker slept for ``first`` (the adaptive policy may stretch the
        wait) or found it queued (busy: drain).  A ``_STOP`` sentinel is
        left in the deque for the worker's loop.
        """
        pol = self.config.batch_policy
        batch = [first]
        t_open = time.perf_counter()
        with self._cond:
            while len(batch) < pol.max_batch:
                while self._pending and len(batch) < pol.max_batch:
                    if self._pending[0] is self._STOP:
                        return batch
                    batch.append(self._pending.popleft())
                if len(batch) >= pol.max_batch:
                    break
                budget = pol.wait_budget_s(
                    len(batch), len(self._pending), self._service_ewma_s,
                    engine_idle=opened_idle,
                    arrival_gap_s=self._arrival_gap_ewma_s)
                remaining = t_open + budget - time.perf_counter()
                if remaining <= 0:
                    break
                if not self._cond.wait(timeout=remaining):
                    break                   # budget elapsed, nothing new
        return batch

    def _observe_service(self, res: BatchSearchResult,
                         wall_s: float) -> None:
        """Fold one batch's service time into the adaptive EWMA."""
        stage = _stage_seconds(res)
        sample = sum(stage.values()) if stage else wall_s
        alpha = self.config.batch_policy.ewma_alpha
        prev = self._service_ewma_s
        self._service_ewma_s = sample if prev is None \
            else alpha * sample + (1.0 - alpha) * prev

    def _worker(self) -> None:
        with _device_scope(self.index.device):
            self._serve_loop()

    def _serve_loop(self) -> None:
        pol = self.config.batch_policy
        while True:
            with self._cond:
                opened_idle = not self._pending
                while not self._pending:
                    self._cond.wait()
                item = self._pending.popleft()
            if item is self._STOP:
                return
            batch = self._collect(item, opened_idle)
            t0 = time.perf_counter()
            try:             # a failing insert fails the batch loudly and
                with self._serve_lock:       # keeps the worker alive
                    self._drain_inserts()
                    block = self._pad_batch([r.query for r in batch])
                    res = self.searcher.search_batch(block)
            except Exception as exc:
                for r in batch:
                    r.future.set_exception(exc)
                continue
            done = time.perf_counter()       # results are on the host
            self._observe_service(res, done - t0)
            for i, r in enumerate(batch):
                r.future.set_result(res.per_query(i))
            self.metrics.set_index_bytes(self.index.nbytes())
            self.metrics.on_batch(
                len(batch),
                [done - r.t_enqueue for r in batch],
                [t0 - r.t_enqueue for r in batch],
                list(res.pruned_by_hash_frac[:len(batch)]),
                list(res.pruned_total_frac[:len(batch)]),
                len(self._pending),
                lb_pruned_frac=_lb_fracs(res),
                dtw_abandoned_frac=_abandon_fracs(res),
                stage_seconds=_stage_seconds(res),
                sig_cache_hits=_sig_hits(res),
                batch_wait_s=t0 - batch[0].t_enqueue,
                batch_occupancy=len(batch) / pol.max_batch)
