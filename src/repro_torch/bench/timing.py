"""Stage spans of the search hot path (counterpart of
``repro.bench.timing``).

The five stages — ``encode`` (query signatures), ``probe`` (collision
count + top-C), ``lb`` (seed DTW for the pruning threshold + the staged
LB cascade), ``lb_improved`` and ``dtw`` — are spans.  Each opens a
profiler range named ``ssh.<name>`` (:func:`profiler_range`), so that
it sits on the profiler's clock beside the device records, and takes
two readings: its host seconds (``perf_counter`` at enter and exit) and,
on a CUDA device, its stream seconds (two timing events on the current
stream).  A span opened inside another is named ``<parent>.<part>``.

Nothing synchronises.  The events are read when the timings are read,
which waits on the last event alone: by then the search has brought its
results to the host.  ``timings`` (``SearchStats.stage_seconds``) holds
the top-level stages, each its stream seconds on CUDA and its host
seconds elsewhere; ``spans`` (``SearchStats.span_seconds``) holds
every span's two readings.  The ``sync`` a stage yields is the identity.
A disabled timer opens no range, creates no event and reads no clock.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

STAGES = ("encode", "probe", "lb", "lb_improved", "dtw")
#: the profiler range of span ``name`` is ``PREFIX + name``
PREFIX = "ssh."


def _identity(value):
    return value


@contextmanager
def profiler_range(name: str):
    """A ``torch.profiler`` range ``name`` on the host's timeline.

    It is a function-scope range, not a user annotation
    (``record_function``): for an annotation the profiler also draws a
    device record from its first kernel to its last, idle time included,
    which a reader of device records would count as busy.  A range that
    a profiler's start cuts (a batcher waiting when profiling begins) is
    not recorded: the fast range refuses to close one it did not open."""
    rng = torch._C._profiler._RecordFunctionFast(name)
    rng.__enter__()
    try:
        yield
    finally:
        try:
            rng.__exit__(None, None, None)
        except RuntimeError as exc:
            if "no guard is set" not in str(exc):
                raise


class StageTimer:
    """Host and stream seconds by span, for work on ``device``."""

    def __init__(self, enabled: bool = True, prefill=(),
                 device: Optional[torch.device] = None):
        self.enabled = enabled
        self.device = device
        self._events = (enabled and device is not None
                        and device.type == "cuda")
        self._timings: Dict[str, float] = \
            {s: 0.0 for s in prefill} if enabled else {}
        self._spans: Dict[str, Dict[str, Optional[float]]] = {}
        self._pending: List[tuple] = []   # (name, top-level, start, end)
        self._open: List[str] = []

    @contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield _identity
            return
        top = not self._open
        full = name if top else f"{self._open[-1]}.{name}"
        span = self._spans.setdefault(
            full, {"host": 0.0, "device": 0.0 if self._events else None})
        self._open.append(full)
        with profiler_range(PREFIX + full):
            if self._events:
                stream = torch.cuda.current_stream(self.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            t0 = time.perf_counter()
            try:
                yield _identity
            finally:
                host = time.perf_counter() - t0
                self._open.pop()
                span["host"] += host
                if self._events:
                    end.record(stream)
                    self._pending.append((full, top, start, end))
                elif top:
                    self._timings[full] = self._timings.get(full, 0.0) + host

    def _settle(self) -> None:
        """Fold the recorded events into stream seconds, waiting on the
        last one only."""
        if not self._pending:
            return
        self._pending[-1][3].synchronize()
        for name, top, start, end in self._pending:
            seconds = start.elapsed_time(end) / 1e3
            self._spans[name]["device"] += seconds
            if top:
                self._timings[name] = self._timings.get(name, 0.0) + seconds
        self._pending.clear()

    @property
    def timings(self) -> Dict[str, float]:
        """Seconds by top-level stage: stream seconds on CUDA, host
        seconds elsewhere; 0.0 for a prefilled stage never entered."""
        self._settle()
        return self._timings

    @property
    def spans(self) -> Dict[str, Dict[str, Optional[float]]]:
        """``name -> {"host": s, "device": s or None}`` for every span."""
        self._settle()
        return self._spans

    def report(self, stats) -> None:
        """Put the timings and spans on ``stats`` (a ``SearchStats``)
        when the timer is enabled."""
        if self.enabled:
            stats.stage_seconds = dict(self.timings)
            stats.span_seconds = {n: dict(v) for n, v in self.spans.items()}


#: shared disabled timer, the default for un-instrumented callers
DISABLED = StageTimer(enabled=False)
