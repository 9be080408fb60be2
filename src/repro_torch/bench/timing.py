"""Stage timers for the search hot path (counterpart of
``repro.bench.timing``).

The five stages — ``encode`` (query signatures), ``probe`` (collision
count + top-C), ``lb`` (seed DTW for the pruning threshold + the staged
LB cascade), ``lb_improved`` and ``dtw`` — accumulate host wall-clock
seconds into ``SearchStats.stage_seconds``.  CUDA work is asynchronous,
so the ``sync`` a stage yields calls ``torch.cuda.synchronize`` before
the clock stops; on the CPU it is the identity.  A disabled timer
records nothing and synchronises nothing.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch

STAGES = ("encode", "probe", "lb", "lb_improved", "dtw")


def _identity(value):
    return value


class StageTimer:
    """Accumulates per-stage wall-clock seconds on ``device``."""

    def __init__(self, enabled: bool = True, prefill=(),
                 device: Optional[torch.device] = None):
        self.enabled = enabled
        self.device = device
        self.timings: Dict[str, float] = \
            {s: 0.0 for s in prefill} if enabled else {}

    def _sync(self, value):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return value

    @contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield _identity
            return
        t0 = time.perf_counter()
        try:
            yield self._sync
        finally:
            self.timings[name] = (self.timings.get(name, 0.0)
                                  + time.perf_counter() - t0)


#: shared disabled timer, the default for un-instrumented callers
DISABLED = StageTimer(enabled=False)
