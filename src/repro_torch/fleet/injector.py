"""Fault injection for the fleet tier — kill, delay, drop-every-Nth
(counterpart of ``repro.fleet.injector``, a copy).

Usable from tests and from ``chip_smoke.py``'s fleet phases, which
inject one dead and one 10x-slow worker.  The injector gates every shard
call a worker executes, on the host, before any launch:

* ``kill(worker)`` — every call raises :class:`WorkerKilled` until
  ``revive(worker)``;
* ``delay(worker, ms)`` — every call sleeps ``ms`` first (straggler);
* ``drop_every(worker, n)`` — every n-th call raises
  :class:`ResponseDropped` (lossy network / overloaded RPC server).

All mutators are thread-safe; a default-constructed injector is a
no-op, so the production path pays one dict lookup per shard call.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class WorkerFault(RuntimeError):
    """Base class of injected worker failures (callers fail over)."""


class WorkerKilled(WorkerFault):
    """The worker is dead: every call fails until ``revive()``."""


class ResponseDropped(WorkerFault):
    """This call's response was dropped (every-Nth-call injection)."""


class FaultInjector:
    """Per-worker fault switchboard consulted before every shard call."""

    def __init__(self):
        self._lock = threading.Lock()
        self._killed: set = set()
        self._delay_ms: Dict[str, float] = {}
        self._drop_every: Dict[str, int] = {}
        self._calls: Dict[str, int] = {}

    # -- switches ---------------------------------------------------------
    def kill(self, worker: str) -> None:
        with self._lock:
            self._killed.add(worker)

    def revive(self, worker: str) -> None:
        with self._lock:
            self._killed.discard(worker)

    def delay(self, worker: str, ms: Optional[float]) -> None:
        with self._lock:
            if ms is None or ms <= 0:
                self._delay_ms.pop(worker, None)
            else:
                self._delay_ms[worker] = float(ms)

    def drop_every(self, worker: str, n: Optional[int]) -> None:
        if n is not None and n < 1:
            raise ValueError(f"drop_every needs n >= 1, got {n}")
        with self._lock:
            if n is None:
                self._drop_every.pop(worker, None)
                self._calls.pop(worker, None)
            else:
                self._drop_every[worker] = int(n)
                self._calls.setdefault(worker, 0)

    def clear(self) -> None:
        with self._lock:
            self._killed.clear()
            self._delay_ms.clear()
            self._drop_every.clear()
            self._calls.clear()

    # -- the gate (called by FleetWorker.query_shard) ---------------------
    def before_call(self, worker: str) -> None:
        """Raise/sleep according to the faults armed for ``worker``."""
        with self._lock:
            if worker in self._killed:
                raise WorkerKilled(f"worker {worker!r} is down")
            sleep_ms = self._delay_ms.get(worker, 0.0)
            drop = False
            if worker in self._drop_every:
                self._calls[worker] += 1
                drop = self._calls[worker] % self._drop_every[worker] == 0
        if sleep_ms:
            time.sleep(sleep_ms / 1e3)
        if drop:
            raise ResponseDropped(
                f"worker {worker!r} dropped this response")
