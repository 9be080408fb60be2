"""Distributed SSH index, row-sharded fan-out (counterpart of
``repro.distributed``): ``dist_index`` (the shard-local schedule over a
mesh of devices) and ``fault_tolerance`` (``ShardPlan``,
``StragglerPolicy``)."""
