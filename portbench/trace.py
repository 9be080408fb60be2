"""One ``torch.profiler`` window over a steady part of a traced run.

The profiler drops the device records of the first launches of a window
(``repro_torch.bench.device_time``: 0 to 141 seen), so it starts at the
end of set-up with :data:`LEAD_KERNELS` spin kernels and runs to the end
of the measured window; the span it reads (a ``record_function`` named
:data:`SPAN`) lies in the window's steady part.  From the device records
(kernels, copies, fills) inside the span it reads:

* ``busy_s``: the union of the device records' intervals inside the
  span, and ``window_s``, the span's length;
* ``device_ops``: device seconds by operation name;
* ``gaps``: idle seconds between device records, by the innermost host
  operation running at the gap's middle;
* ``op_counts``: device records by operation name, so a reader takes a
  kernel's seconds and launches by fragments of its name
  (:meth:`TraceObs.kernel`).

Nothing is written to disk.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

LEAD_KERNELS = 128
SPAN = "portbench.window"
#: idle gaps attributed by host operation: the longest this many
GAPS_NAMED = 400
#: runtime calls that launch a kernel, as the profiler names them
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


@dataclasses.dataclass
class TraceObs:
    window_s: float
    busy_s: float
    device_ops: Dict[str, float]            # name -> device seconds
    op_counts: Dict[str, int]               # name -> device records
    gaps: Dict[str, float]
    batches: int = 0                        # blocks served in the span
    launch_lag_us: Optional[float] = None   # median launch -> kernel start

    def top(self, d: Dict[str, float], n: int = 10) -> List[list]:
        return [[k[:96], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:n]]

    def kernel(self, *fragments: str) -> Tuple[float, int]:
        """Device seconds and records of the operations whose names hold
        any of ``fragments``."""
        names = [k for k in self.device_ops
                 if any(f in k for f in fragments)]
        return (sum(self.device_ops[k] for k in names),
                sum(self.op_counts[k] for k in names))


class Tracer:
    """The profiler runs from the end of set-up to the end of the window
    (its start takes seconds, which inside the window would stall the
    load); the span it reads opens at ``start_s`` into the window and
    closes ``seconds`` later.  ``poll(t)`` is called by the driver
    between requests with the time since the window opened."""

    def __init__(self, start_s: float, seconds: float):
        self.start_s, self.seconds = start_s, seconds
        self.opened_at = 0.0
        self.state = "off"
        self.obs: Optional[TraceObs] = None
        self.batches_at_open = 0
        self.span_batches = 0
        self.batches = lambda: 0

    def begin(self) -> None:
        """Start profiling (set-up): the lead-in, then wait for it."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(LEAD_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self.state = "waiting"

    def poll(self, t: float) -> None:
        if self.state == "waiting" and t >= self.start_s:
            self._span = torch.autograd.profiler.record_function(SPAN)
            self._span.__enter__()
            self.batches_at_open = self.batches()
            self.opened_at = t
            self.state = "open"
        elif self.state == "open" and t >= self.opened_at + self.seconds:
            self._close_span()

    def _close_span(self) -> None:
        self._span.__exit__(None, None, None)
        self.span_batches = self.batches() - self.batches_at_open
        self.state = "closed"

    def finish(self) -> None:
        """At the window's end: close the span, stop and read."""
        if self.state == "off":
            return
        if self.state == "open":
            self._close_span()
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        if self.state == "closed":
            self.obs = read(self._prof.profiler.kineto_results.events())
            self.obs.batches = self.span_batches
        self.state = "off"
        del self._prof


def _union(iv: np.ndarray) -> Tuple[float, np.ndarray]:
    """Total length of the union of intervals (n, 2) and the gaps between
    the merged intervals (g, 2)."""
    if not len(iv):
        return 0.0, np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0])]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    m = np.asarray(merged)
    gaps = np.stack([m[:-1, 1], m[1:, 0]], 1) if len(m) > 1 else \
        np.zeros((0, 2))
    return float((m[:, 1] - m[:, 0]).sum()), gaps


def read(events) -> TraceObs:
    """The span's readings from ``kineto_results.events()``."""
    cuda = torch.autograd.DeviceType.CUDA
    span = [e for e in events if e.name() == SPAN
            and e.device_type() != cuda]
    if not span:
        raise RuntimeError(f"the profiler kept no {SPAN!r} span")
    w0 = span[0].start_ns()
    w1 = w0 + span[0].duration_ns()
    dev, host = [], []
    launches, lags = {}, []
    for e in events:
        if e.name() in _LAUNCH_CALLS:
            launches[e.correlation_id()] = e.start_ns()
    for e in events:
        if e.device_type() == cuda and e.correlation_id() in launches:
            lags.append(e.start_ns() - launches[e.correlation_id()])
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.name() == SPAN:             # the span's own device annotation
            continue
        if e.device_type() == cuda:
            if s + d > w0 and s < w1:
                dev.append((e.name(), max(s, w0), min(s + d, w1)))
        elif e.name() != SPAN and d > 0 and s < w1 and s + d > w0:
            host.append((e.name(), s, s + d))
    ops: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for name, s, e in dev:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
        counts[name] = counts.get(name, 0) + 1
    iv = np.asarray([(s, e) for _, s, e in dev], dtype=np.float64)
    busy, gaps = _union(iv)
    if len(iv):
        edges = [(w0, iv[:, 0].min()), (iv[:, 1].max(), w1)]
        gaps = np.concatenate([gaps, np.asarray(edges)])
    else:
        gaps = np.asarray([(w0, w1)], dtype=np.float64)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    named: Dict[str, float] = {}
    if len(gaps):
        order = np.argsort(gaps[:, 0] - gaps[:, 1])
        hs = np.asarray([h[1] for h in host], dtype=np.float64)
        he = np.asarray([h[2] for h in host], dtype=np.float64)
        for g in order[:GAPS_NAMED]:
            mid = 0.5 * (gaps[g, 0] + gaps[g, 1])
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = ("(Python, no recorded operation)" if not len(inside) else
                    host[inside[np.argmin(he[inside] - hs[inside])]][0])
            named[name[:96]] = named.get(name[:96], 0.0) + \
                (gaps[g, 1] - gaps[g, 0]) / 1e9
        rest = float((gaps[order[GAPS_NAMED:], 1]
                      - gaps[order[GAPS_NAMED:], 0]).sum()) / 1e9
        if rest > 0:
            named["(shorter gaps)"] = rest
    return TraceObs(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                    device_ops=ops, op_counts=counts, gaps=named,
                    launch_lag_us=float(np.median(lags)) / 1e3 if lags
                    else None)
