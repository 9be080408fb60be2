"""Open-loop load: Poisson arrivals, latency from the intended arrival.

Copied from ``repro_torch.loadgen`` (``arrivals.poisson_arrivals``,
``harness._percentile`` and ``harness.run_trace``'s timing rule), which
the benchmark does not import.  Each request is submitted at its
intended arrival time and its latency runs from that time to the
completion callback, so a submitter that falls behind cannot hide the
queueing delay it causes (coordinated omission).  A request whose future
never resolves, or resolves with an error, counts as failed and as
missing every latency limit.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence

import numpy as np


def poisson_arrivals(rate_qps: float, seconds: float, seed) -> np.ndarray:
    """Offsets (s) of a homogeneous Poisson process at ``rate_qps``, all
    below ``seconds``, from an exponential gap stream seeded by ``seed``."""
    if rate_qps <= 0 or seconds <= 0:
        raise ValueError("rate and seconds must be > 0")
    rng = np.random.default_rng(seed)
    n = int(rate_qps * seconds * 1.2 + 100)
    out = np.cumsum(rng.exponential(1.0 / rate_qps, size=n))
    while out[-1] < seconds:
        more = out[-1] + np.cumsum(rng.exponential(1.0 / rate_qps, size=n))
        out = np.concatenate([out, more])
    return out[out < seconds]


def percentile(xs: Sequence[float], p: float) -> float:
    """Nearest-rank percentile: the value at rank round(p/100 · (n-1)) of
    the sorted sample (0 when empty)."""
    if not len(xs):
        return 0.0
    xs = sorted(xs)
    rank = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
    return xs[rank]


@dataclasses.dataclass
class OpenLoopResult:
    latency_ms: List[float]       # every request, inf for a failed one
    results: List[object]         # the future's result, None if failed
    failed: int
    wall_s: float                 # first arrival slot to last completion
    late_max_ms: float            # how far the submitter fell behind
    late_mean_ms: float

    @property
    def n(self) -> int:
        return len(self.latency_ms)

    @property
    def rate_qps(self) -> float:
        """Requests completed over the whole window's time."""
        done = self.n - self.failed
        return done / self.wall_s if self.wall_s > 0 else 0.0


def run(submit: Callable[[int], object], arrivals_s: np.ndarray,
        drain_s: float = 60.0, poll: Optional[Callable[[float], None]] = None
        ) -> OpenLoopResult:
    """Submit request k (``submit(k)`` returns a future) at
    ``arrivals_s[k]`` after the start, then wait up to ``drain_s`` past
    the last arrival for every future.  ``poll(t)`` is called with the
    time since the start before each submit (the trace window's hook)."""
    n = len(arrivals_s)
    done_at: List[Optional[float]] = [None] * n

    def stamp(k: int):
        def _cb(_fut) -> None:
            done_at[k] = time.perf_counter()
        return _cb

    futures = []
    late = []
    t0 = time.perf_counter()
    for k in range(n):
        target = t0 + float(arrivals_s[k])
        if poll is not None:
            poll(time.perf_counter() - t0)
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        late.append(max(0.0, time.perf_counter() - target))
        fut = submit(k)
        fut.add_done_callback(stamp(k))
        futures.append((k, target, fut))
    deadline = time.perf_counter() + drain_s
    lat_ms, results, failed = [], [], 0
    for k, target, fut in futures:
        try:
            res = fut.result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:        # a request that errs or never comes
            res = None
        if res is None or done_at[k] is None:
            failed += 1
            lat_ms.append(math.inf)
            results.append(None)
            continue
        lat_ms.append((done_at[k] - target) * 1e3)
        results.append(res)
    stamps = [d for d in done_at if d is not None]
    wall_s = (max(stamps) - t0) if stamps else 0.0
    late_ms = np.asarray(late) * 1e3
    return OpenLoopResult(latency_ms=lat_ms, results=results, failed=failed,
                          wall_s=wall_s,
                          late_max_ms=float(late_ms.max()) if n else 0.0,
                          late_mean_ms=float(late_ms.mean()) if n else 0.0)
