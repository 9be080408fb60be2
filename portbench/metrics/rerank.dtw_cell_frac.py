"""Share of the band's DP cells that the batched re-rank's pair DTW
computed, the seed DTW and the survivors' together: ``SearchStats.
dtw_cells`` over ``SearchStats.dtw_band_cells``, summed over the blocks
of the window.  Early abandoning lowers it; 1 is every cell of every
pair.  A program that counts no cells reads nothing."""


def read(obs):
    stats = [s for s in obs.block_stats()
             if s is not None and getattr(s, "dtw_band_cells", 0)]
    band = sum(s.dtw_band_cells for s in stats)
    if not band:
        return None
    return sum(s.dtw_cells for s in stats) / band
