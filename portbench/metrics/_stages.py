"""Shared arithmetic of the stage-time readers: ``StageTimer`` seconds a
block (``SearchStats.stage_seconds``, recorded when the run is traced)."""


def mean_ms(obs, stages) -> "float | None":
    stats = [s for s in obs.block_stats()
             if s is not None and s.stage_seconds]
    if not stats:
        return None
    total = sum(sum(s.stage_seconds.get(k, 0.0) for k in stages)
                for s in stats)
    return 1e3 * total / len(stats)
