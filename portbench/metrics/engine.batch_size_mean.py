"""Requests a batch of ``serving/engine`` over the window: the
difference of ``ServingMetrics.requests_total`` over the difference of
``batches_total``."""


def read(obs):
    d = obs.out.obs.get("engine")
    if not d or not d["batches"]:
        return None
    return d["requests"] / d["batches"]
