"""repro_torch.fleet — the resilience layer of the distributed tier
(counterpart of ``repro.fleet``).

Once the index is spread over a fleet, shard failure and stragglers are
the common case.  This package makes the distributed tier survive them
without changing an answer:

* :class:`ReplicatedShardPlan` — R-way replica placement with the
  no-co-location invariant and stable, minimal-movement rebalancing.
* :class:`FleetWorker` — a logical worker holding shard replicas, as
  tensors on its device, received as ``repro_torch.checkpoint``
  artifacts (the transfer format).
* :class:`FleetSearcher` — replicated shard fan-out with hedged
  re-issue (``StragglerPolicy``-derived per-shard deadlines), failover
  on error, live ``resize()`` rebalancing and ``drain()`` for zero-loss
  worker retirement.  Results are bit-identical under faults because
  replicas hold identical encoded state and the merge is deterministic.
* :class:`FaultInjector` — kill / delay / drop-every-Nth fault
  injection for tests and ``chip_smoke.py``'s fleet phases.
"""
from repro_torch.fleet.injector import (FaultInjector, ResponseDropped,
                                        WorkerFault, WorkerKilled)
from repro_torch.fleet.placement import ReplicatedShardPlan
from repro_torch.fleet.searcher import FleetSearcher
from repro_torch.fleet.transfer import fetch_shard, publish_shard
from repro_torch.fleet.worker import FleetWorker, ShardReplica

__all__ = [
    "FaultInjector", "FleetSearcher", "FleetWorker",
    "ReplicatedShardPlan", "ResponseDropped", "ShardReplica",
    "WorkerFault", "WorkerKilled", "fetch_shard", "publish_shard",
]
