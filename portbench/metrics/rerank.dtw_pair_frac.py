"""Share of the candidates gathered for re-ranking that reach banded DTW:
``SearchStats.n_dtw`` over ``SearchStats.n_in``, summed over the blocks
of the window."""


def read(obs):
    stats = [s for s in obs.block_stats() if s is not None]
    n_in = sum(s.n_in for s in stats)
    if not n_in:
        return None
    return sum(s.n_dtw for s in stats) / n_in
