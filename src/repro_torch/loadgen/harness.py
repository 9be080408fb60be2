"""Open-loop load harness over a live ServingEngine (counterpart of
``repro.loadgen.harness``; DESIGN.md §12).

``run_trace`` replays a ``RequestTrace`` against a started engine in
open-loop fashion: each request is submitted at its *intended* arrival
time, and latency is measured from that intended time to completion —
not from the actual submit — so a stalled submitter cannot hide queueing
delay (the coordinated-omission trap).  Completion timestamps come from
future callbacks on the batcher thread's resolve, so no per-request
waiter thread is needed.

``sweep`` drives one trace shape at a ladder of offered loads, each
against a fresh engine (fresh metrics window), and derives
``max_sustainable_qps``: the highest offered load whose p99 meets the
SLO while the achieved throughput keeps up with the offered rate — past
the knee the queue grows without bound and both conditions fail
together.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.loadgen.workload import RequestTrace, generate_trace

# an offered load "keeps up" when achieved/offered stays above this —
# below it the run is queue-bound and its latencies are departure-rate
# artifacts, not service quality
SUSTAINED_FRAC = 0.9


def _percentile(xs: Sequence[float], p: float) -> float:
    if not len(xs):
        return 0.0
    xs = sorted(xs)
    rank = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
    return xs[rank]


@dataclasses.dataclass
class LoadResult:
    """One trace replay: latency distribution + engine telemetry +
    per-request answers (kept so policy A/B runs can assert
    bit-identity)."""

    offered_qps: float
    achieved_qps: float
    n_requests: int
    wall_s: float
    latency_p50_ms: float
    latency_p95_ms: float
    latency_p99_ms: float
    queue_depth_p50: float
    queue_depth_p95: float
    queue_depth_max: float
    batch_size_mean: float
    batch_wait_ms_mean: float
    batch_occupancy_mean: float
    batch_histogram: Dict[int, int]
    stage_us: Dict[str, float]
    ids: List[np.ndarray]
    dists: List[np.ndarray]

    def to_row(self) -> Dict[str, Any]:
        """Flat JSON-ready dict (per-request answers elided)."""
        row = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)
               if f.name not in ("ids", "dists", "batch_histogram",
                                 "stage_us")}
        row["batch_histogram"] = {str(k): v for k, v
                                  in sorted(self.batch_histogram.items())}
        row["stage_us"] = dict(self.stage_us)
        return row

    def same_answers(self, other: "LoadResult") -> bool:
        """Bit-identical top-k ids and distances, request by request."""
        if len(self.ids) != len(other.ids):
            return False
        return all(
            np.array_equal(a, b) and np.array_equal(c, d)
            for a, b, c, d in zip(self.ids, other.ids,
                                  self.dists, other.dists))


def run_trace(engine, trace: RequestTrace,
              pools: Mapping[int, Any],
              timeout_s: float = 300.0) -> LoadResult:
    """Replay ``trace`` against a *started* engine; block until every
    request resolves.  ``pools`` maps query length → array of shape
    ``(pool_size, length)`` (any indexable returning a 1-D query)."""
    n = len(trace)
    missing = set(int(x) for x in np.unique(trace.lengths)) - \
        set(int(k) for k in pools)
    if missing:
        raise ValueError(f"trace needs query pools for lengths "
                         f"{sorted(missing)}; pools cover "
                         f"{sorted(int(k) for k in pools)}")
    done_at: List[Optional[float]] = [None] * n

    def stamp(k: int) -> Callable:
        def _cb(_fut) -> None:
            done_at[k] = time.perf_counter()
        return _cb

    futures = []
    t0 = time.perf_counter()
    for k in range(n):
        target = t0 + float(trace.arrivals_s[k])
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        fut = engine.submit(pools[int(trace.lengths[k])]
                            [int(trace.pool_ids[k])])
        fut.add_done_callback(stamp(k))
        futures.append((k, target, fut))

    lat_ms, ids, dists = [], [], []
    for k, target, fut in futures:
        res = fut.result(timeout=timeout_s)
        topk = int(trace.topks[k])
        # per-request topk ≤ engine topk serves as a prefix truncation
        # (top-k lists are sorted, so the prefix is the exact answer)
        ids.append(np.asarray(res.ids[:topk]))
        dists.append(np.asarray(res.dists[:topk]))
        lat_ms.append((done_at[k] - target) * 1e3)
    wall_s = max(filter(None, done_at)) - t0

    snap = engine.metrics.snapshot()
    stage_us = {k.replace("stage_", "").replace("_us_per_batch_mean", ""): v
                for k, v in snap.items() if k.startswith("stage_")}
    return LoadResult(
        offered_qps=trace.spec.rate_qps,
        achieved_qps=n / wall_s,
        n_requests=n,
        wall_s=wall_s,
        latency_p50_ms=_percentile(lat_ms, 50),
        latency_p95_ms=_percentile(lat_ms, 95),
        latency_p99_ms=_percentile(lat_ms, 99),
        queue_depth_p50=snap["queue_depth_p50"],
        queue_depth_p95=snap["queue_depth_p95"],
        queue_depth_max=snap["queue_depth_max"],
        batch_size_mean=snap["batch_size_mean"],
        batch_wait_ms_mean=snap["batch_wait_ms_mean"],
        batch_occupancy_mean=snap["batch_occupancy_mean"],
        batch_histogram=engine.metrics.batch_histogram(),
        stage_us=stage_us,
        ids=ids, dists=dists)


def sweep(engine_factory: Callable[[], Any], spec, offered_loads,
          pools: Mapping[int, Any], slo_p99_ms: float,
          timeout_s: float = 300.0):
    """Replay ``spec`` at each offered load, fresh engine per point.

    ``engine_factory`` returns an *unstarted* engine (fresh metrics each
    point, so one saturated run cannot pollute the next point's
    percentiles).  Returns ``(results, max_sustainable_qps)`` —
    the latter is 0.0 when even the lowest load misses the SLO.
    """
    pool_sizes = {int(k): int(len(v)) for k, v in pools.items()}
    results: List[LoadResult] = []
    best = 0.0
    for load in offered_loads:
        trace = generate_trace(spec.replace(rate_qps=float(load)),
                               pool_sizes)
        engine = engine_factory()
        with engine:
            res = run_trace(engine, trace, pools, timeout_s=timeout_s)
        results.append(res)
        if res.latency_p99_ms <= slo_p99_ms and \
                res.achieved_qps >= SUSTAINED_FRAC * res.offered_qps:
            best = max(best, res.offered_qps)
    return results, best
