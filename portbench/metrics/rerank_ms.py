"""ms a block in ``core/rerank.rerank_batch``: ``StageTimer`` "lb" (seed
DTW and the staged LB cascade), "lb_improved" and "dtw", synchronised."""
from portbench.metrics._stages import mean_ms


def read(obs):
    return mean_ms(obs, ("lb", "lb_improved", "dtw"))
