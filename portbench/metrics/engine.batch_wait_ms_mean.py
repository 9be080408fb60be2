"""ms the head request of a ``serving/engine`` batch waited before the
batch was dispatched, mean over the window: differences of
``ServingMetrics.batch_wait``'s total and count."""


def read(obs):
    d = obs.out.obs.get("engine")
    if not d or not d["wait_n"]:
        return None
    return 1e3 * d["wait_s"] / d["wait_n"]
