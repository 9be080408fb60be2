"""Gcell/s of ``dtw_wavefront_pairs`` (``kernels/ops`` ->
``csrc/dtw_wavefront.cu``, both schedules): the DP cells a block's pair
DTW computed (``SearchStats.dtw_cells``, a mean over the window's
blocks) over the kernels' device seconds a block in the traced span.
The kernels count only cells they computed, so the rate is no higher
than theirs.  A program that counts no cells reads nothing."""


def read(obs):
    if obs.trace is None or not obs.trace.batches:
        return None
    stats = [s for s in obs.block_stats()
             if s is not None and getattr(s, "dtw_band_cells", 0)]
    seconds, launches = obs.trace.kernel("dtw_rows_kernel",
                                         "dtw_diag_kernel")
    if not stats or not launches or seconds <= 0:
        return None
    cells = sum(s.dtw_cells for s in stats) / len(stats)
    return 1e-9 * cells / (seconds / obs.trace.batches)
