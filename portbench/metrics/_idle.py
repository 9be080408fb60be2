"""Share of the traced window in which the device ran no kernel, copy or
fill (the profiler's device records)."""


def idle(obs):
    if obs.trace is None or obs.trace.window_s <= 0:
        return None
    return 1.0 - obs.trace.busy_s / obs.trace.window_s
