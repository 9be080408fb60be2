"""ms a block in the probe's top-C: ``core/search.top_c_by_count`` in
``serving/batched.batch_probe``, the ``StageTimer`` span "probe.topc"
(``SearchStats.span_seconds``), its stream time on the card and its host
time elsewhere.  A program without the span reads nothing."""

SPAN = "probe.topc"


def read(obs):
    got = [s.span_seconds[SPAN] for s in obs.block_stats()
           if getattr(s, "span_seconds", None) and SPAN in s.span_seconds]
    if not got:
        return None
    return 1e3 * sum(v["host"] if v["device"] is None else v["device"]
                     for v in got) / len(got)
