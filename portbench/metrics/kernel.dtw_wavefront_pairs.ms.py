"""Device ms a block of ``dtw_wavefront_pairs`` (``kernels/ops`` ->
``csrc/dtw_wavefront.cu``, both schedules: the seed DTW and the
survivors' DTW of ``core/rerank``), from the profiler's records in the
traced window over the blocks served in it."""


def read(obs):
    if obs.trace is None or not obs.trace.batches:
        return None
    seconds, launches = obs.trace.kernel("dtw_rows_kernel",
                                         "dtw_diag_kernel")
    if not launches:
        return None
    return 1e3 * seconds / obs.trace.batches
