"""Mergeable count-sketch indexing for continuous ingest (counterpart of
``repro.streaming``): the ``"ssh-cs"`` encoder, the count-sketch core and
the shard-local :class:`StreamIngestor` with its associative merge."""
from repro_torch.streaming import count_sketch
from repro_torch.streaming.encoder import (CountSketchShingler,
                                           StreamingSSHEncoder)
from repro_torch.streaming.ingest import StreamArtifacts, StreamIngestor

__all__ = ["CountSketchShingler", "StreamArtifacts", "StreamIngestor",
           "StreamingSSHEncoder", "count_sketch"]
