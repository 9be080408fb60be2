"""The load generator's copy: its percentiles, its rate over the whole
window, and latency taken from each request's intended arrival."""
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from portbench.loadgen import openloop


@pytest.mark.parametrize("p, want", [(0, 1.0), (50, 6.0), (90, 10.0),
                                     (95, 11.0), (100, 11.0), (10, 2.0)])
def test_percentile_nearest_rank(p, want):
    xs = [float(v) for v in range(11, 0, -1)]       # 11 .. 1, unsorted
    assert openloop.percentile(xs, p) == want


def test_percentile_empty_and_inf():
    assert openloop.percentile([], 95) == 0.0
    assert openloop.percentile([1.0, 2.0, float("inf")], 100) == float("inf")


def test_poisson_arrivals_seeded_and_bounded():
    a = openloop.poisson_arrivals(500.0, 4.0, [7, 4])
    b = openloop.poisson_arrivals(500.0, 4.0, [7, 4])
    c = openloop.poisson_arrivals(500.0, 4.0, [8, 4])
    assert np.array_equal(a, b) and not np.array_equal(a[:50], c[:50])
    assert a.max() < 4.0 and np.all(np.diff(a) > 0)
    assert abs(len(a) / 4.0 - 500.0) < 60.0       # ~5 sigma of 2,000


def _server(service_s: float):
    """A one-thread server: futures resolved in order, ``service_s``
    each."""
    jobs = []
    cond = threading.Condition()

    def loop():
        while True:
            with cond:
                while not jobs:
                    cond.wait()
                fut = jobs.pop(0)
            if fut is None:
                return
            time.sleep(service_s)
            fut.set_result("ok")

    t = threading.Thread(target=loop, daemon=True)
    t.start()

    def submit(_k):
        fut = Future()
        with cond:
            jobs.append(fut)
            cond.notify()
        return fut

    def stop():
        with cond:
            jobs.append(None)
            cond.notify()
        t.join(timeout=10)
        assert not t.is_alive()
    return submit, stop


def test_latency_counts_queueing_from_the_intended_arrival():
    """Ten requests due at once on a server that takes 20 ms each: the
    k-th waits for the k before it, and its latency says so."""
    submit, stop = _server(0.02)
    try:
        res = openloop.run(submit, np.zeros(10), drain_s=10.0)
    finally:
        stop()
    lat = np.asarray(res.latency_ms)
    assert res.failed == 0 and res.n == 10
    assert np.all(np.diff(lat) > 0)
    assert lat[-1] >= 10 * 20.0 * 0.95
    assert 180.0 <= res.wall_s * 1e3 <= 1000.0
    assert res.rate_qps == pytest.approx(10 / res.wall_s)


def test_a_stalled_submitter_does_not_hide_the_delay():
    """The submitter blocks 100 ms on the first request; the second, due
    at 10 ms, is timed from 10 ms, not from when it was sent."""
    def submit(k):
        if k == 0:
            time.sleep(0.1)
        fut = Future()
        fut.set_result("ok")
        return fut
    res = openloop.run(submit, np.asarray([0.0, 0.01]), drain_s=5.0)
    assert res.latency_ms[1] >= 85.0
    assert res.late_max_ms >= 85.0


def test_a_request_that_never_comes_fails():
    def submit(k):
        fut = Future()
        if k % 2 == 0:
            fut.set_result("ok")
        return fut
    res = openloop.run(submit, np.asarray([0.0, 0.001, 0.002]), drain_s=0.2)
    assert res.failed == 1
    assert res.latency_ms[1] == float("inf")
    assert openloop.percentile(res.latency_ms, 100) == float("inf")
