"""Fault tolerance and elasticity policies (counterpart of
``repro.distributed.fault_tolerance``, a copy: plain Python, no tensors).

* ``ShardPlan`` — deterministic assignment of data shards to workers with
  hot-spare reassignment on failure (node-failure tolerance) and
  re-balancing on resize (elastic scaling).
* ``StragglerPolicy`` — EWMA step-time tracking; a worker is a straggler
  when slower than ``threshold`` × fleet median for ``patience``
  consecutive steps.  The fleet (``repro_torch.fleet``) feeds it every
  shard call's seconds and derives its hedging deadlines from it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class ShardPlan:
    n_shards: int
    workers: List[str]
    assignment: Dict[int, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.assignment:
            self.rebalance()

    def rebalance(self) -> None:
        """Deterministic round-robin over the sorted worker list."""
        ws = sorted(self.workers)
        self.assignment = {s: ws[s % len(ws)] for s in range(self.n_shards)}

    def shards_of(self, worker: str) -> List[int]:
        return [s for s, w in self.assignment.items() if w == worker]

    def fail(self, worker: str) -> List[int]:
        """Worker died: its shards move to the least-loaded survivors.
        Returns the migrated shard ids."""
        if worker not in self.workers:
            return []
        self.workers = [w for w in self.workers if w != worker]
        if not self.workers:
            raise RuntimeError("no workers left")
        moved = [s for s, w in self.assignment.items() if w == worker]
        for s in moved:
            load = {w: len(self.shards_of(w)) for w in self.workers}
            self.assignment[s] = min(sorted(load), key=lambda w: load[w])
        return moved

    def resize(self, new_workers: List[str]) -> int:
        """Elastic scale up/down with stable minimal movement; returns
        the number of shards that moved.

        A shard whose worker survives the resize stays put; shards on
        removed workers re-home to the least-loaded survivor, then
        shards flow from the most- to the least-loaded worker only
        until the load spread is <= 1.  Moves are bounded by
        ``ceil(n_shards / len(new_workers))`` for a one-worker change
        (vs. the old round-robin re-deal, which reshuffled nearly every
        shard whenever the worker list shifted by one).
        """
        old = dict(self.assignment)
        new = list(dict.fromkeys(new_workers))
        if not new:
            raise RuntimeError("no workers left")
        removed = [w for w in self.workers if w not in new]
        self.workers = new
        for dead in removed:
            for s in self.shards_of(dead):
                load = {w: len(self.shards_of(w)) for w in self.workers}
                self.assignment[s] = min(sorted(load),
                                         key=lambda w: load[w])
        while True:
            load = {w: len(self.shards_of(w)) for w in self.workers}
            order = sorted(load, key=lambda w: (load[w], w))
            lo, hi = order[0], order[-1]
            if load[hi] - load[lo] <= 1:
                break
            self.assignment[min(self.shards_of(hi))] = lo
        return sum(1 for s in old if old[s] != self.assignment[s])


@dataclasses.dataclass
class StragglerPolicy:
    threshold: float = 1.5         # × fleet median
    patience: int = 3
    alpha: float = 0.3             # EWMA smoothing
    ewma: Dict[str, float] = dataclasses.field(default_factory=dict)
    strikes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def observe(self, worker: str, step_seconds: float) -> None:
        prev = self.ewma.get(worker, step_seconds)
        self.ewma[worker] = (1 - self.alpha) * prev + self.alpha * \
            step_seconds

    def median(self) -> float:
        vals = sorted(self.ewma.values())
        return vals[len(vals) // 2] if vals else 0.0

    def step(self, worker: str) -> None:
        """Advance the worker's strike counter once for this step.

        The mutating half of the old ``check()``: call exactly once per
        observed step.  Reads (``is_straggler``/``stragglers``) are
        pure, so callers may poll them at any frequency — the old
        combined ``check()`` double-counted strikes when a step was
        inspected twice (e.g. ``check()`` in a loop, then
        ``stragglers()`` for the report).
        """
        med = self.median()
        if med <= 0:
            return
        if self.ewma.get(worker, 0.0) > self.threshold * med:
            self.strikes[worker] = self.strikes.get(worker, 0) + 1
        else:
            self.strikes[worker] = 0

    def is_straggler(self, worker: str) -> bool:
        """Pure read: has the worker struck out ``patience`` times?"""
        return self.strikes.get(worker, 0) >= self.patience

    def check(self, worker: str) -> bool:
        """True when the worker should be treated as a straggler.

        Back-compat combined form: advances the strike counter AND
        reads the verdict.  New callers should pair one ``step()`` per
        observed step with pure ``is_straggler()`` reads.
        """
        self.step(worker)
        return self.is_straggler(worker)

    def stragglers(self) -> List[str]:
        """Pure read of the current straggler set (no strike updates)."""
        return [w for w in list(self.ewma) if self.is_straggler(w)]
