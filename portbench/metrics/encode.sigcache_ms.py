"""Host ms a block in the signature LRU's work, ``serving/batched``'s
encode: the query rows' bytes, their keys, the lookups and the stores
(``encoders/sigcache``), the ``StageTimer`` span "encode.sigcache"
(``SearchStats.span_seconds``).  A program without the span reads
nothing."""

SPAN = "encode.sigcache"


def read(obs):
    got = [s.span_seconds[SPAN]["host"] for s in obs.block_stats()
           if getattr(s, "span_seconds", None) and SPAN in s.span_seconds]
    if not got:
        return None
    return 1e3 * sum(got) / len(got)
