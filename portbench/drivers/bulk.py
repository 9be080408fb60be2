"""Closed-loop bulk search: back-to-back blocks of distinct queries
through ``TimeSeriesDB.search_batch`` (the ``"batched"`` searcher), one
client that sends its next block when the last one has come back.

Traffic file keys: ``block`` (queries a block), ``pool`` (see
``data.series.query_pool``), ``warmup_blocks``, ``sample``, ``trace``,
``limits``.  End to end: ``qps``, the queries answered over the whole
window's time.
"""
from __future__ import annotations

import time

from portbench.harness import Harness, Outcome


class PoolExhausted(RuntimeError):
    pass


def run(h: Harness) -> Outcome:
    t = h.cell.traffic
    b = int(t["block"])
    n_warm = b * int(t["warmup_blocks"])
    h.make_data(n_warm)
    db = h.build(searcher="batched")
    pool = h.pool
    for lo in range(0, n_warm, b):
        db.search_batch(pool.warm[lo:lo + b])
    stats = h.recorder.batches
    h.mark_setup()
    if h.tracer is not None:
        h.tracer.batches = lambda: len(stats)
    answers = {}
    sent = 0
    t0 = time.perf_counter()
    deadline = t0 + h.seconds
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        h.poll(now - t0)
        if sent + b > len(pool.rows):
            raise PoolExhausted(
                f"the pool of {len(pool.rows)} queries ran out after "
                f"{sent}: raise pool_qps in the traffic file")
        res = db.search_batch(pool.rows[sent:sent + b])
        for j, r in enumerate(res):
            answers[sent + j] = (r.ids, r.dists)
        sent += b
    t1 = time.perf_counter()
    h.end_window()
    window = [s for tt, s in stats if t0 <= tt <= t1]
    return Outcome(end_to_end={"qps": sent / (t1 - t0)}, attempted=sent,
                   failed=0, answers=answers,
                   obs={"block_stats": window})
