"""Open-loop serving: single queries from independent clients at a fixed
Poisson rate through ``TimeSeriesDB.submit`` on the ``"engine"``
searcher (the dynamic batcher in front of the batched search).

Traffic file keys: ``rate_qps`` (the offered load, fixed), ``arrival``
(``"poisson"``), ``policy`` (the ``BatchPolicy`` fields),
``warmup_seconds`` (an open-loop stretch at the same rate during set-up,
after one block of every padded batch size), ``drain_s``, ``pool``,
``sample``, ``trace``, ``limits``.  Each request is a distinct pool row.
End to end: ``p50_ms`` and ``p95_ms`` over every request of the window,
from its intended arrival to its completion; a request that fails counts
as missing every limit.
"""
from __future__ import annotations

import time

from portbench.harness import Harness, Outcome
from portbench.loadgen import openloop


def counters(metrics) -> dict:
    return dict(requests=metrics.requests_total,
                batches=metrics.batches_total,
                wait_n=metrics.batch_wait.n, wait_s=metrics.batch_wait.total)


def setup(h: Harness, rate: float):
    """Data, the engine's database, every padded batch shape served once
    and an open-loop warm-up at ``rate``; returns the database."""
    from repro_torch.db import BatchPolicy
    t = h.cell.traffic
    if t.get("arrival", "poisson") != "poisson":
        raise ValueError(f"unknown arrival process {t['arrival']!r}")
    policy = BatchPolicy(**t["policy"])
    buckets = policy.buckets()
    warm_arrivals = openloop.poisson_arrivals(
        rate, float(t["warmup_seconds"]), [h.seed, 3])
    h.make_data(sum(buckets) + len(warm_arrivals))
    db = h.build(searcher="engine", batch_policy=policy)
    lo = 0
    for size in buckets:
        db.engine.search_batch(h.pool.warm[lo:lo + size])
        lo += size
    warm = h.pool.warm[lo:]
    openloop.run(lambda k: db.submit(warm[k]), warm_arrivals,
                 drain_s=float(t["drain_s"]))
    return db


def window(h: Harness, db, first: int, arrivals, poll=None):
    """Requests ``first``, ``first + 1``, ... of the pool at ``arrivals``;
    returns the open-loop result and the engine's counter differences."""
    if first + len(arrivals) > len(h.pool.rows):
        raise RuntimeError(f"{len(arrivals)} arrivals from row {first} "
                           f"overrun a pool of {len(h.pool.rows)}: raise "
                           "pool_qps")
    metrics = db.engine.metrics
    before = counters(metrics)
    rows = h.pool.rows
    res = openloop.run(lambda k: db.submit(rows[first + k]), arrivals,
                       drain_s=float(h.cell.traffic["drain_s"]), poll=poll)
    after = counters(metrics)
    return res, {k: after[k] - before[k] for k in after}


def run(h: Harness) -> Outcome:
    rate = float(h.cell.traffic["rate_qps"])
    db = setup(h, rate)
    h.mark_setup()
    if h.tracer is not None:
        h.tracer.batches = lambda: db.engine.metrics.batches_total
    arrivals = openloop.poisson_arrivals(rate, h.seconds, [h.seed, 4])
    t0 = time.perf_counter()
    res, delta = window(h, db, 0, arrivals, poll=h.poll)
    t1 = time.perf_counter()
    h.end_window()
    answers = {k: (r.ids, r.dists) for k, r in enumerate(res.results)
               if r is not None}
    lat = res.latency_ms
    return Outcome(
        end_to_end={"p50_ms": openloop.percentile(lat, 50),
                    "p95_ms": openloop.percentile(lat, 95)},
        attempted=res.n, failed=res.failed, answers=answers,
        obs={"engine": delta},
        notes={"offered_qps": rate, "completed_qps": res.rate_qps,
               "late_max_ms": res.late_max_ms,
               "late_mean_ms": res.late_mean_ms,
               "p99_ms": openloop.percentile(lat, 99), "requests": res.n,
               "batch_size_mean": delta["requests"] / max(delta["batches"],
                                                          1)})
