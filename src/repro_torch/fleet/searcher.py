"""FleetSearcher — replicated, hedged, elastic shard fan-out
(counterpart of ``repro.fleet.searcher``).

The index rows are partitioned into shards; each shard is published once
as a ``repro_torch.checkpoint`` artifact and placed on
``config.replication`` distinct workers by a
:class:`~repro_torch.fleet.placement.ReplicatedShardPlan`.  A query is
encoded once (``index.encoder``, the ``sketch_conv`` kernel on the card),
fans out one shard-local probe per shard (primary replica first) on the
fleet's thread pool, and the per-shard top-C lists merge into the global
top-k by a stable sort.

Resilience mechanisms, none of which changes an answer:

* **failover** — a shard call that fails with a ``WorkerFault`` (dead
  worker, dropped response) or a ``KeyError`` (no replica there, worker
  retired) is re-issued to the next replica at once.  Any other error,
  a CUDA error among them, ends the query with its traceback;
* **hedging** — every shard call carries a deadline from the per-worker
  shard-call seconds (``StragglerPolicy`` EWMAs: at least ``hedge_ms``,
  else ``threshold x`` the fleet-median shard time; a worker already
  striking as a straggler is hedged at once).  When the deadline lapses
  the call is re-issued to the next replica and the first response wins.
  A losing call still runs to its end: nothing is cancelled on the
  device;
* **drain** — ``drain(worker)`` stops routing new shard calls to the
  worker, waits for its in-flight calls, re-homes its replica slots
  (fetched from the published artifacts) and retires it — no queued
  query is lost;
* **elasticity** — ``resize(n)`` moves only the minimal replica-slot set
  (stable placement), fetching moved shards from their artifacts.

Soundness of first-response-wins: replicas restore the same published
artifact, the shard-local probe is deterministic in (shard state, sig,
query), and the merge is a stable sort — so hedged, failed-over and
healthy runs return bit-identical ids and distances.

The logical workers hold their replicas on the index's device (one card
holds every worker by default); the pool's threads each enter it and
launch on the legacy default stream.
"""
from __future__ import annotations

import tempfile
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.bench.timing import StageTimer
from repro_torch.core.rerank import SearchStats
from repro_torch.db.config import SearchConfig
from repro_torch.distributed.dist_index import merge_topk
from repro_torch.distributed.fault_tolerance import StragglerPolicy
from repro_torch.fleet.injector import FaultInjector, WorkerFault
from repro_torch.fleet.placement import ReplicatedShardPlan
from repro_torch.fleet.transfer import fetch_shard, publish_shard
from repro_torch.fleet.worker import FleetWorker
from repro_torch.kernels import ops
from repro_torch.serving.batched import BatchSearchResult


class FleetSearcher:
    """Resilient distributed searcher over logical in-process workers.

    Serves the serving-internal contract (``search_batch`` ->
    ``BatchSearchResult``), so it stands behind the ``ServingEngine`` and
    the ``repro_torch.db`` registry unchanged.  ``close()`` shuts the
    pool down, drops the replicas and removes the artifacts.
    """

    def __init__(self, index, config: SearchConfig, *,
                 n_workers: Optional[int] = None,
                 injector: Optional[FaultInjector] = None):
        if config.band is None:
            raise ValueError("FleetSearcher requires a band radius")
        if not config.rank_by_signature or config.multiprobe_offsets > 1:
            raise ValueError(
                "FleetSearcher supports only rank_by_signature=True "
                "and multiprobe_offsets=1 (same probe as the shard_map "
                "fan-out)")
        self.index = index
        self.config = config
        self.device = index.device
        self.replication = max(1, config.replication)
        w = n_workers or config.fleet_workers or max(2, self.replication)
        if self.replication > w:
            raise ValueError(
                f"replication {self.replication} > fleet of {w} workers")
        n = int(index.signatures.shape[0])
        self.n_shards = max(1, min(w, n // max(1, config.topk)))
        names = [f"w{i}" for i in range(w)]
        self.workers: Dict[str, FleetWorker] = \
            {name: FleetWorker(name) for name in names}
        self.plan = ReplicatedShardPlan(self.n_shards, names,
                                        replication=self.replication)
        self.policy = StragglerPolicy()
        self.injector = injector if injector is not None else FaultInjector()
        # fleet-level observability (ServingMetrics mirrors these)
        self.hedged_total = 0
        self.failovers_total = 0
        self.degraded_total = 0
        self.rebalanced_shards_total = 0

        self._route_lock = threading.RLock()
        self._policy_lock = threading.Lock()
        self._cond = threading.Condition()
        self._inflight: Dict[str, int] = {}
        self._draining: set = set()
        self._version = 0
        self._tmp = tempfile.TemporaryDirectory(prefix="ssh-fleet-")
        self.artifact_root = self._tmp.name
        # spare threads beyond one a worker so hedges never starve behind
        # a sleeping straggler
        self._pool = ThreadPoolExecutor(
            max_workers=max(8, 4 * w), thread_name_prefix="ssh-fleet")
        # on the CPU the plain versions are thousands of small ops a
        # shard call, and pool threads running them at once lose more to
        # handing the interpreter lock back and forth than they overlap
        # (four threads took 4.6x the serial time on an 8-core x86
        # host): their probes take turns.  On the card each call is a
        # few launches, which overlap
        self._compute_lock = (threading.Lock() if self.device.type == "cpu"
                              else None)
        self._closed = False
        self._publish_and_place()

    # -- placement / transfer ---------------------------------------------
    def _partition(self) -> List[Tuple[int, int]]:
        """Row ranges [(start, stop)) of each shard, in shard order."""
        n = int(self.index.signatures.shape[0])
        bounds = np.linspace(0, n, self.n_shards + 1).astype(int)
        return [(int(bounds[i]), int(bounds[i + 1]))
                for i in range(self.n_shards)]

    def _fetch(self, shard: int):
        return fetch_shard(self.artifact_root, shard, device=self.device)

    def _publish_and_place(self) -> None:
        """Publish every shard artifact and hand replicas to the
        assigned workers (initial build, or full re-place after a
        streaming fold changed the row partition)."""
        with self._route_lock:
            series, sigs = self.index.series, self.index.signatures
            for s, (lo, hi) in enumerate(self._partition()):
                publish_shard(self.artifact_root, s, series[lo:hi],
                              sigs[lo:hi], lo, version=self._version)
                for name in self.plan.replicas(s):
                    self.workers[name].receive_shard(s, self._fetch(s))

    def _sync_custody(self, moved: List[Tuple[int, str]]) -> None:
        """Make every worker hold exactly its planned shards after a
        plan move: moved slots fetched from their artifacts (once, where
        the slot is still planned there), slots the plan took away
        dropped."""
        for s, name in moved:
            worker = self.workers[name]
            if (name in self.plan.replicas(s)
                    and s not in worker.shard_ids()):
                worker.receive_shard(s, self._fetch(s))
        for name, worker in self.workers.items():
            keep = set(self.plan.shards_of(name))
            for s in worker.shard_ids():
                if s not in keep:
                    worker.drop_shard(s)

    # -- hedging policy ---------------------------------------------------
    def _deadline_s(self, worker: str) -> Optional[float]:
        """Seconds to wait on ``worker`` before hedging (None = never)."""
        cfg = self.config
        if cfg.hedge_policy == "off":
            return None
        if cfg.hedge_policy == "fixed":
            return cfg.hedge_ms / 1e3
        with self._policy_lock:
            if self.policy.is_straggler(worker):
                return 0.0                 # known straggler: hedge now
            med = self.policy.median()
        if med <= 0:
            return None                    # no telemetry yet
        return max(cfg.hedge_ms / 1e3, self.policy.threshold * med)

    def _route(self, shard: int) -> List[str]:
        """Replica attempt order: plan order, draining workers last."""
        ws = self.plan.replicas(shard)
        return ([w for w in ws if w not in self._draining]
                + [w for w in ws if w in self._draining])

    # -- shard call -------------------------------------------------------
    def _guarded_call(self, name: str, shard: int, sig, q):
        with self._cond:
            self._inflight[name] = self._inflight.get(name, 0) + 1
        t0 = time.perf_counter()
        try:
            worker = self.workers[name]          # may raise post-retire
            cfg = self.config
            out = worker.query_shard(
                shard, sig, q,
                local_c=max(cfg.topk, cfg.top_c // self.n_shards),
                topk=cfg.topk, band=cfg.band,
                abandon=cfg.use_lb_cascade and cfg.early_abandon,
                injector=self.injector, compute_lock=self._compute_lock)
            dt = time.perf_counter() - t0
            with self._policy_lock:
                # the shard-call seconds are the straggler signal: every
                # completed call feeds the worker's EWMA and advances its
                # strike counter once
                self.policy.observe(name, dt)
                self.policy.step(name)
            return out
        finally:
            with self._cond:
                self._inflight[name] -= 1
                self._cond.notify_all()

    def _launch(self, name: str, shard: int, sig, q):
        return (name, self._pool.submit(
            self._guarded_call, name, shard, sig, q), time.perf_counter())

    def _resolve_shard(self, shard: int, routes: List[str], sig, q,
                       first=None):
        """First-response-wins over the replica chain.

        ``first`` is the already-launched primary attempt (the query fans
        out every shard's primary before resolving any of them, so one
        shard's failover or hedge waits overlap the other shards' work).
        Returns ((gids, dists), hedged, failovers, non_primary)."""
        primary = routes[0]
        remaining = list(routes)
        hedged = failovers = 0
        pending = []                        # [(worker, future, t_submit)]

        def launch():
            pending.append(self._launch(remaining.pop(0), shard, sig, q))

        if first is not None:
            remaining.pop(0)
            pending.append(first)
        else:
            launch()
        while True:
            for entry in list(pending):
                name, fut, _ = entry
                if not fut.done():
                    continue
                exc = fut.exception()
                if exc is None:
                    return fut.result(), hedged, failovers, name != primary
                if not isinstance(exc, (WorkerFault, KeyError)):
                    raise exc               # a fault of the program itself
                pending.remove(entry)
                failovers += 1
                if remaining:
                    launch()
            if not pending:
                raise RuntimeError(
                    f"all {len(routes)} replicas of shard {shard} failed "
                    f"({routes}); raise config.replication or revive a "
                    "worker")
            timeout = None
            if remaining:
                now = time.perf_counter()
                cutoffs = [t0 + d for name, _, t0 in pending
                           if (d := self._deadline_s(name)) is not None]
                if cutoffs:
                    timeout = min(cutoffs) - now
                    if timeout <= 0:
                        hedged += 1
                        launch()
                        continue
            wait([f for _, f, _ in pending], timeout=timeout,
                 return_when=FIRST_COMPLETED)

    # -- queries ----------------------------------------------------------
    def _query_one(self, q: torch.Tensor):
        cfg = self.config
        sig = self.index.encoder.encode_batch(q[None])[0]
        with self._route_lock:
            routes = {s: self._route(s) for s in range(self.n_shards)}
        # fan out every shard's primary before resolving any shard: a
        # failover or hedge wait on one shard overlaps the others' work
        primaries = {s: self._launch(routes[s][0], s, sig, q)
                     for s in range(self.n_shards)}
        per_shard = {}
        hedged = failovers = 0
        degraded = False
        for s in range(self.n_shards):
            out, h, f, non_primary = self._resolve_shard(
                s, routes[s], sig, q, first=primaries[s])
            per_shard[s] = out
            hedged += h
            failovers += f
            degraded = degraded or f > 0 or non_primary
        all_i = np.concatenate([per_shard[s][0]
                                for s in range(self.n_shards)])
        all_d = np.concatenate([per_shard[s][1]
                                for s in range(self.n_shards)])
        ids, dists = merge_topk(torch.from_numpy(all_i),
                                torch.from_numpy(all_d), cfg.topk)
        return ids.numpy(), dists.numpy(), hedged, failovers, degraded

    def search_batch(self, queries) -> BatchSearchResult:
        t0 = time.perf_counter()
        cfg = self.config
        timer = StageTimer(enabled=cfg.stage_timings)
        queries = torch.as_tensor(queries, dtype=torch.float32).to(
            self.device)
        n = int(self.index.signatures.shape[0])
        ids, dists = [], []
        hedged = failovers = degraded = 0
        for i in range(int(queries.shape[0])):
            # host-orchestrated fan-out, ending in host arrays: one
            # unsplittable span a query under the shard_map path's key;
            # the encode launches on the index's device
            with timer.stage("fused"), ops.device_scope(self.device):
                gid, d, h, f, deg = self._query_one(queries[i])
            ids.append(gid)
            dists.append(d)
            hedged += h
            failovers += f
            degraded += int(deg)
        with self._route_lock:
            self.hedged_total += hedged
            self.failovers_total += failovers
            self.degraded_total += degraded
        stats = SearchStats(backend=self.device.type, hedged=hedged,
                            failovers=failovers, degraded=degraded > 0)
        timer.report(stats)
        return BatchSearchResult.of_fanout(ids, dists, n, cfg.top_c, t0,
                                           stats)

    # -- mutation ---------------------------------------------------------
    def insert(self, series) -> None:
        raise NotImplementedError(
            "streaming inserts into the fleet require a re-place; stream "
            "through a StreamIngestor and fold with apply_artifacts()")

    def apply_artifacts(self, artifacts) -> None:
        """Fold pre-encoded streaming artifacts, then republish: the row
        partition changes, so every shard artifact is re-published at a
        new version and replicas re-fetch."""
        self.index.insert_encoded(artifacts.series, artifacts.signatures,
                                  artifacts.keys)
        with self._route_lock:
            self._version += 1
            self._publish_and_place()

    # -- elasticity -------------------------------------------------------
    def resize(self, workers: Union[int, List[str]]) -> int:
        """Live rebalance onto a new worker set; moves only the minimal
        replica-slot set (stable placement).  Returns the number of
        distinct shards that moved."""
        with self._route_lock:
            names = ([f"w{i}" for i in range(workers)]
                     if isinstance(workers, int) else list(workers))
            moved = self.plan.resize(names)
            for name in names:
                if name not in self.workers:
                    self.workers[name] = FleetWorker(name)
            live = set(names)
            for name in [w for w in self.workers if w not in live]:
                del self.workers[name]
            self._sync_custody(moved)
            n_moved = len({s for s, _ in moved})
            self.rebalanced_shards_total += n_moved
            return n_moved

    def fail_worker(self, worker: str) -> int:
        """Abrupt permanent loss: re-home the worker's replica slots from
        the published artifacts (no waiting).  Returns shards moved."""
        with self._route_lock:
            if worker not in self.workers:
                return 0
            moved = self.plan.fail(worker)
            del self.workers[worker]
            self._draining.discard(worker)
            self._sync_custody(moved)
            n_moved = len({s for s, _ in moved})
            self.rebalanced_shards_total += n_moved
            return n_moved

    def drain(self, worker: str) -> int:
        """Graceful retirement: stop routing to ``worker``, let its
        in-flight shard calls finish (their responses still count —
        nothing queued is lost), then re-home its replica slots and
        retire it.  Returns the number of shards moved."""
        with self._route_lock:
            if worker not in self.workers:
                return 0
            if len(self.plan.workers) - 1 < self.replication:
                raise RuntimeError(
                    f"cannot drain {worker!r}: "
                    f"{len(self.plan.workers) - 1} workers would be left "
                    f"for replication {self.replication}")
            self._draining.add(worker)
        with self._cond:
            while self._inflight.get(worker, 0):
                self._cond.wait(timeout=0.05)
        return self.fail_worker(worker)

    def nbytes(self) -> Dict[str, int]:
        """Bytes of replica tensors each worker holds."""
        with self._route_lock:
            return {name: w.nbytes() for name, w in self.workers.items()}

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        """Shut the pool down (a call still running ends on its own),
        drop every replica and remove the artifacts; idempotent."""
        if self._closed:
            return
        self._closed = True
        self._pool.shutdown(wait=False, cancel_futures=True)
        with self._route_lock:
            for worker in self.workers.values():
                for s in worker.shard_ids():
                    worker.drop_shard(s)
        self._tmp.cleanup()
