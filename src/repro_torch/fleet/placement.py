"""R-way replicated shard placement with stable minimal-movement moves
(counterpart of ``repro.fleet.placement``).

Invariants (property-tested in ``tests/test_torch_fleet.py``):

* every shard is assigned exactly ``replication`` **distinct** live
  workers — no replica pair ever co-locates on one worker;
* replica-slot load is balanced within one slot across the fleet;
* ``fail()``/``resize()`` conserve the shard set and move only the
  minimal slot set — a surviving (shard, worker) assignment is never
  reshuffled just because the worker list changed (unlike round-robin,
  which re-deals nearly every shard when the list shifts by one).

Placement is deterministic: the initial deal and every re-home pick
workers by (load, name) order, so two controllers computing a plan from
the same inputs agree without coordination.

One deliberate difference from the reference: ``fail()`` runs
:func:`_balance` after re-homing the dead worker's slots, as ``resize()``
does.  The reference's ``fail()`` re-homes greedily and stops, which
breaks the within-one balance on 1,737 of the 6,552 plans with 1-39
shards, 2-8 workers, every R < W and every dead worker: 15 shards on 6
workers at R = 3 give loads {8, 8, 10, 10, 9} after ``fail("w1")``, and
3 shards on 6 workers at R = 3 give {3, 2, 2, 1, 1} after ``fail("w3")``
(balanced: {9, 9, 9, 9, 9} and {2, 2, 2, 2, 1}).  Where the greedy
re-home is already balanced, ``_balance`` moves nothing, so the plan
equals the reference's slot for slot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


def _balance(loads: Dict[str, List[int]],
             holders: Dict[int, List[str]]) -> List[Tuple[int, str]]:
    """Move slots from the most- to the least-loaded worker until the
    load spread is <= 1; returns the moved (shard, new_worker) slots.

    ``loads`` maps worker -> list of held shard ids (mutated in place);
    ``holders`` maps shard -> its replica workers (mutated in place).
    A donor with >= 2 more slots than a receiver always holds a shard
    the receiver lacks (else the receiver would hold a superset and at
    least the donor's load), so the loop always makes progress.
    """
    moved: List[Tuple[int, str]] = []
    while True:
        order = sorted(loads, key=lambda w: (len(loads[w]), w))
        lo, hi = order[0], order[-1]
        if len(loads[hi]) - len(loads[lo]) <= 1:
            return moved
        shard = next(s for s in sorted(loads[hi]) if lo not in holders[s])
        loads[hi].remove(shard)
        loads[lo].append(shard)
        holders[shard][holders[shard].index(hi)] = lo
        moved.append((shard, lo))


@dataclasses.dataclass
class ReplicatedShardPlan:
    """Deterministic assignment of each shard to R distinct workers.

    ``assignment[s]`` lists shard ``s``'s replica holders in preference
    order — index 0 is the primary a query routes to first; hedges and
    failovers walk the rest of the list.
    """

    n_shards: int
    workers: List[str]
    replication: int = 1
    assignment: Dict[int, List[str]] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if self.replication < 1:
            raise ValueError(
                f"replication must be >= 1, got {self.replication}")
        if self.replication > len(self.workers):
            raise ValueError(
                f"replication {self.replication} needs at least that many "
                f"workers, got {len(self.workers)}")
        if not self.assignment:
            # deal replica slots round-robin over the sorted worker list:
            # consecutive residues mod W are distinct for R <= W, and the
            # slot stream balances loads within one
            ws = sorted(self.workers)
            w = len(ws)
            self.assignment = {
                s: [ws[(s * self.replication + j) % w]
                    for j in range(self.replication)]
                for s in range(self.n_shards)}

    # -- reads ------------------------------------------------------------
    def replicas(self, shard: int) -> List[str]:
        return list(self.assignment[shard])

    def primary(self, shard: int) -> str:
        return self.assignment[shard][0]

    def shards_of(self, worker: str) -> List[int]:
        return sorted(s for s, ws in self.assignment.items()
                      if worker in ws)

    def loads(self) -> Dict[str, int]:
        return {w: len(self.shards_of(w)) for w in self.workers}

    # -- moves ------------------------------------------------------------
    def _rehome(self, dead: str) -> List[Tuple[int, str]]:
        """Re-place every replica slot held by ``dead`` on the least-
        loaded live worker not already holding that shard."""
        moved: List[Tuple[int, str]] = []
        loads = {w: len(self.shards_of(w)) for w in self.workers}
        for s in sorted(self.assignment):
            ws = self.assignment[s]
            if dead not in ws:
                continue
            candidates = [w for w in self.workers if w not in ws]
            if not candidates:
                raise RuntimeError(
                    f"cannot re-place shard {s}: {len(self.workers)} live "
                    f"workers < replication {self.replication}")
            new = min(sorted(candidates), key=lambda w: loads[w])
            ws[ws.index(dead)] = new
            loads[new] += 1
            moved.append((s, new))
        return moved

    def fail(self, worker: str) -> List[Tuple[int, str]]:
        """Worker died: its replica slots move to the least-loaded
        survivors (never co-locating with a live replica), then slots
        flow from overloaded to underloaded workers until the load
        spread is <= 1.  Returns the moved (shard, new_worker) slots."""
        if worker not in self.workers:
            return []
        self.workers = [w for w in self.workers if w != worker]
        if len(self.workers) < self.replication:
            self.workers.append(worker)      # restore; plan unchanged
            raise RuntimeError(
                f"losing {worker!r} would leave {len(self.workers) - 1} "
                f"workers < replication {self.replication}")
        moved = self._rehome(worker)
        loads = {w: self.shards_of(w) for w in self.workers}
        moved.extend(_balance(loads, self.assignment))
        return moved

    def resize(self, new_workers: List[str]) -> List[Tuple[int, str]]:
        """Elastic scale up/down with stable minimal movement.

        Surviving (shard, worker) slots stay put; slots on removed
        workers re-home, then slots flow from overloaded to underloaded
        workers (new workers start empty) only until the load spread is
        <= 1.  Returns the moved (shard, new_worker) slots.
        """
        new = list(dict.fromkeys(new_workers))      # dedupe, keep order
        if len(new) < self.replication:
            raise RuntimeError(
                f"{len(new)} workers < replication {self.replication}")
        removed = [w for w in self.workers if w not in new]
        self.workers = new
        moved: List[Tuple[int, str]] = []
        for dead in removed:
            moved.extend(self._rehome(dead))
        loads = {w: self.shards_of(w) for w in self.workers}
        moved.extend(_balance(loads, self.assignment))
        return moved
