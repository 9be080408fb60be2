"""Serving metrics — latency percentiles, queue depth, throughput, pruning
(counterpart of ``repro.serving.metrics``; the same snapshot keys and
``format()``).

Single process, thread-safe.  The engine records into a
``ServingMetrics`` instance; ``snapshot()`` renders a flat dict suitable
for logging or a /metrics endpoint.  Latencies keep a bounded reservoir
(most recent ``window`` samples) so percentiles track the live traffic
rather than the whole process history.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

# the canonical pipeline stages plus the distributed fan-out's
# unsplittable "fused" program — one definition, owned by the schema
from repro_torch.bench.schema import STAGE_KEYS


class LatencyTracker:
    """Bounded reservoir of recent latencies with percentile readout."""

    def __init__(self, window: int = 4096):
        self._samples: deque = deque(maxlen=window)

    def record(self, seconds: float) -> None:
        self._samples.append(float(seconds))

    def __len__(self) -> int:
        return len(self._samples)

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the reservoir (0 when empty)."""
        if not self._samples:
            return 0.0
        xs = sorted(self._samples)
        rank = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
        return xs[rank]


class ThroughputTracker:
    """Completions-per-second over a sliding time window.

    The denominator is the observation span — elapsed time since the
    tracker was created, capped at the window — not the span between
    stamps: a single burst of completions must not divide by the
    near-zero gap to the snapshot and report absurd rates.
    """

    def __init__(self, window_seconds: float = 60.0):
        self.window_seconds = window_seconds
        self._stamps: deque = deque()
        self._t0 = time.perf_counter()

    def record(self, n: int = 1, now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        for _ in range(n):
            self._stamps.append(now)
        self._trim(now)

    def _trim(self, now: float) -> None:
        horizon = now - self.window_seconds
        while self._stamps and self._stamps[0] < horizon:
            self._stamps.popleft()

    def restart_clock(self, now: Optional[float] = None) -> None:
        """Restart the observation span (e.g. when serving begins, so
        setup/warm-up time does not dilute the rate)."""
        self._t0 = time.perf_counter() if now is None else now

    def rate(self, now: Optional[float] = None) -> float:
        now = time.perf_counter() if now is None else now
        self._trim(now)
        if not self._stamps:
            return 0.0
        span = max(min(now - self._t0, self.window_seconds), 1e-6)
        return len(self._stamps) / span


class RunningMean:
    def __init__(self):
        self.n = 0
        self.total = 0.0

    def record(self, x: float) -> None:
        self.n += 1
        self.total += float(x)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0


class ServingMetrics:
    """All engine counters behind one lock."""

    def __init__(self, latency_window: int = 4096,
                 throughput_window_seconds: float = 60.0):
        self._lock = threading.Lock()
        self.latency = LatencyTracker(latency_window)
        self.queue_latency = LatencyTracker(latency_window)
        self.throughput = ThroughputTracker(throughput_window_seconds)
        self.batch_size = RunningMean()
        # adaptive-batching observability: time each batch's head request
        # waited before dispatch, fraction of max_batch actually filled,
        # exact batch-size counts, and a windowed reservoir of queue
        # depths (sampled at every enqueue and batch dispatch) so the
        # load harness reads depth percentiles, not just the last gauge
        self.batch_wait = RunningMean()
        self.batch_occupancy = RunningMean()
        self.batch_sizes: Dict[int, int] = {}
        self.queue_depths = LatencyTracker(latency_window)
        self.pruned_by_hash = RunningMean()
        self.pruned_total = RunningMean()
        self.lb_pruned = RunningMean()     # LB-cascade fraction of top-C
        self.dtw_abandoned = RunningMean()  # early-abandoned DTW lanes
        # per-batch stage wall clock (bench.timing stage telemetry)
        self.stage_seconds = {s: RunningMean() for s in STAGE_KEYS}
        self.requests_total = 0
        self.batches_total = 0
        self.inserts_total = 0
        # queries whose encode was served from the signature LRU
        # (encoders.sigcache) — repeated-query traffic shows up
        # here instead of in the encode stage seconds
        self.sig_cache_hits = 0
        # fleet resilience counters (the fleet tier; 0 until it exists):
        # shard calls re-issued on a lapsed hedging deadline, shard
        # calls re-issued after a worker fault, queries any of whose
        # shards were answered by a non-primary replica, and shards
        # moved by drain/fail/resize rebalances
        self.hedged_total = 0
        self.failovers_total = 0
        self.degraded_total = 0
        self.rebalanced_shards_total = 0
        self.queue_depth = 0
        # resident bytes of the served index (SSHIndex.nbytes) — a gauge,
        # refreshed per batch so streaming inserts/folds show up
        self.index_bytes = 0

    # -- recording hooks (called by the engine) ---------------------------
    def on_start(self) -> None:
        with self._lock:
            self.throughput.restart_clock()

    def on_enqueue(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = depth
            self.queue_depths.record(depth)

    def on_batch(self, batch_size: int, latencies_s, queue_waits_s,
                 pruned_by_hash_frac, pruned_total_frac,
                 depth_after: int, lb_pruned_frac=(),
                 dtw_abandoned_frac=(),
                 stage_seconds: Optional[Dict[str, float]] = None,
                 sig_cache_hits: int = 0, hedged: int = 0,
                 failovers: int = 0, degraded: int = 0,
                 batch_wait_s: Optional[float] = None,
                 batch_occupancy: Optional[float] = None) -> None:
        with self._lock:
            self.sig_cache_hits += int(sig_cache_hits)
            self.hedged_total += int(hedged)
            self.failovers_total += int(failovers)
            self.degraded_total += int(degraded)
            self.batches_total += 1
            self.requests_total += batch_size
            self.batch_size.record(batch_size)
            self.batch_sizes[batch_size] = \
                self.batch_sizes.get(batch_size, 0) + 1
            if batch_wait_s is not None:
                self.batch_wait.record(batch_wait_s)
            if batch_occupancy is not None:
                self.batch_occupancy.record(batch_occupancy)
            self.queue_depth = depth_after
            self.queue_depths.record(depth_after)
            self.throughput.record(batch_size)
            for s in latencies_s:
                self.latency.record(s)
            for s in queue_waits_s:
                self.queue_latency.record(s)
            for f in pruned_by_hash_frac:
                self.pruned_by_hash.record(f)
            for f in pruned_total_frac:
                self.pruned_total.record(f)
            for f in lb_pruned_frac:
                self.lb_pruned.record(f)
            for f in dtw_abandoned_frac:
                self.dtw_abandoned.record(f)
            for stage, sec in (stage_seconds or {}).items():
                if stage in self.stage_seconds:
                    self.stage_seconds[stage].record(sec)

    def on_insert(self, n_series: int) -> None:
        with self._lock:
            self.inserts_total += n_series

    def on_rebalance(self, n_shards: int) -> None:
        """Shards moved by a drain / fail / resize rebalance."""
        with self._lock:
            self.rebalanced_shards_total += int(n_shards)

    def set_index_bytes(self, n: int) -> None:
        with self._lock:
            self.index_bytes = int(n)

    # -- readout ----------------------------------------------------------
    def batch_histogram(self) -> Dict[int, int]:
        """Exact batch-size → count histogram (copy)."""
        with self._lock:
            return dict(self.batch_sizes)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            stage_rows = {
                f"stage_{s}_us_per_batch_mean": m.mean * 1e6
                for s, m in self.stage_seconds.items() if m.n}
            return {
                **stage_rows,
                "requests_total": self.requests_total,
                "batches_total": self.batches_total,
                "inserts_total": self.inserts_total,
                "sig_cache_hits_total": self.sig_cache_hits,
                "hedged_total": self.hedged_total,
                "failovers_total": self.failovers_total,
                "degraded_total": self.degraded_total,
                "rebalanced_shards_total": self.rebalanced_shards_total,
                "queue_depth": self.queue_depth,
                "queue_depth_p50": self.queue_depths.percentile(50),
                "queue_depth_p95": self.queue_depths.percentile(95),
                "queue_depth_max": self.queue_depths.percentile(100),
                "index_bytes": self.index_bytes,
                "batch_size_mean": self.batch_size.mean,
                "batch_wait_ms_mean": self.batch_wait.mean * 1e3,
                "batch_occupancy_mean": self.batch_occupancy.mean,
                "latency_p50_ms": self.latency.percentile(50) * 1e3,
                "latency_p95_ms": self.latency.percentile(95) * 1e3,
                "latency_p99_ms": self.latency.percentile(99) * 1e3,
                "queue_wait_p50_ms": self.queue_latency.percentile(50) * 1e3,
                "throughput_qps": self.throughput.rate(),
                "pruned_by_hash_frac_mean": self.pruned_by_hash.mean,
                "pruned_total_frac_mean": self.pruned_total.mean,
                "lb_pruned_frac_mean": self.lb_pruned.mean,
                "dtw_abandoned_frac_mean": self.dtw_abandoned.mean,
            }

    def format(self) -> str:
        s = self.snapshot()
        return (f"req={s['requests_total']:.0f} "
                f"batches={s['batches_total']:.0f} "
                f"avg_batch={s['batch_size_mean']:.1f} "
                f"p50={s['latency_p50_ms']:.1f}ms "
                f"p95={s['latency_p95_ms']:.1f}ms "
                f"p99={s['latency_p99_ms']:.1f}ms "
                f"qps={s['throughput_qps']:.1f} "
                f"pruned={s['pruned_total_frac_mean']:.1%}")
