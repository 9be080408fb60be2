"""ms a block in ``serving/batched``'s encode stage: the signature LRU's
keys and lookups and the multiprobe encode (``encoders/pipeline``),
``StageTimer`` "encode", synchronised."""
from portbench.metrics._stages import mean_ms


def read(obs):
    return mean_ms(obs, ("encode",))
