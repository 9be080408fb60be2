"""Shard-parallel stream ingest — encode at the edge, merge as a
reduction (counterpart of ``repro.streaming.ingest``).

A :class:`StreamIngestor` encodes each appended block at once (signatures
and band keys through the shard's encoder, on the encoder's device) and
keeps it as a seq-tagged segment, while its shard-local hierarchical
count-sketch grows.  ``merge`` concatenates segments and adds sketches,
an associative and commutative combine; ``artifacts`` emits the folded
segments in ``(seq, shard, append order)`` order, a total order that
does not depend on which shard held what.  So any merge tree over any
shard partition folds into the same index.

Unlike the reference, whose segments are host arrays, the segments stay
tensors on the encoder's device: a fold on the card never copies the
series to the host and back.
"""
from __future__ import annotations

import dataclasses
from functools import reduce
from typing import List, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class StreamArtifacts:
    """What a fold hands the index: pre-encoded rows in global seq order
    plus the combined sketch (``None`` for encoders without one).
    ``series`` is ``None`` when a segment arrived pre-encoded without its
    rows."""
    series: Optional[torch.Tensor]     # (N, m) float32, or None
    signatures: torch.Tensor           # (N, K) int32
    keys: torch.Tensor                 # (N, L) int32 (uint32 bit pattern)
    sketch: Optional[torch.Tensor]

    @property
    def num_series(self) -> int:
        return int(self.signatures.shape[0])


@dataclasses.dataclass(frozen=True)
class _Segment:
    seq: int
    shard: str
    order: int                         # per-shard append counter
    series: Optional[torch.Tensor]
    signatures: torch.Tensor
    keys: torch.Tensor


class StreamIngestor:
    """Shard-local continuous ingest for a materialised encoder.

    Blocks encode on the encoder's device, so the appended signatures are
    those a batch build on that device would have given.  ``backend`` is
    the reference's knob, checked against that device
    (``Encoder.check_backend``: ``"jnp"`` only on the CPU).
    """

    def __init__(self, encoder, *, shard: str = "shard0",
                 backend: str = "auto"):
        encoder.check_backend(backend)
        self.encoder = encoder
        self.shard = str(shard)
        self.backend = backend
        self._segments: List[_Segment] = []
        self._order = 0
        self._auto_seq = 0
        # shard-LOCAL sketch: starts at zero whatever the encoder's global
        # aggregate holds; the fold adds it in
        self._sketch = (encoder.empty_sketch()
                        if hasattr(encoder, "empty_sketch") else None)

    def _next_seq(self, seq: Optional[int]) -> int:
        if seq is None:
            seq = self._auto_seq
        self._auto_seq = max(self._auto_seq, int(seq) + 1)
        return int(seq)

    def _add(self, seq, series, sigs, keys) -> None:
        self._segments.append(_Segment(
            seq=self._next_seq(seq), shard=self.shard, order=self._order,
            series=series, signatures=sigs, keys=keys))
        self._order += 1
        if self._sketch is not None:
            self._sketch = self._sketch + self.encoder.sketch_batch(series)

    # -- appends -----------------------------------------------------------
    def append(self, series, *, seq: Optional[int] = None) -> None:
        """Encode and keep a series (``(m,)``) or block (``(B, m)``);
        ``seq`` is the block's global stream position, in any order."""
        xs = torch.as_tensor(series, dtype=torch.float32).to(
            self.encoder.device)
        if xs.dim() == 1:
            xs = xs[None, :]
        sigs = self.encoder.encode_chunked(xs)
        self._add(seq, xs, sigs, self.encoder.band_keys(sigs))

    def append_encoded(self, signatures, keys, *, series=None,
                       seq: Optional[int] = None) -> None:
        """Keep a block encoded elsewhere: signatures (B, K) and band keys
        (B, L), optionally with the rows.  A sketching encoder refuses a
        block without its rows, which its sketch could not count."""
        dev = self.encoder.device
        sigs = torch.as_tensor(signatures).to(dev, torch.int32)
        ks = torch.as_tensor(keys)
        if ks.dtype == torch.uint32:
            ks = ks.view(torch.int32)
        ks = ks.to(dev, torch.int32)
        if sigs.dim() != 2 or ks.dim() != 2 or sigs.shape[0] != ks.shape[0]:
            raise ValueError("append_encoded needs 2-D signatures/keys "
                             f"with equal rows, got {tuple(sigs.shape)} vs "
                             f"{tuple(ks.shape)}")
        k, n_tables = self.encoder.num_hashes, self.encoder.num_tables
        if sigs.shape[1] != k or ks.shape[1] != n_tables:
            raise ValueError(
                f"encoded widths {sigs.shape[1]}x{ks.shape[1]} do not "
                f"match the encoder's K={k}, L={n_tables}")
        if self._sketch is not None and series is None:
            raise ValueError(
                "sketching encoder cannot accept series-less encoded "
                "appends (the shingle aggregate would under-count); "
                "pass series= or use a non-sketching encoder")
        xs = (None if series is None else
              torch.as_tensor(series, dtype=torch.float32).to(dev))
        self._add(seq, xs, sigs, ks)

    def __len__(self) -> int:
        return sum(int(s.signatures.shape[0]) for s in self._segments)

    @property
    def sketch(self) -> Optional[torch.Tensor]:
        """The shard-local hierarchical aggregate (``None`` when the
        encoder has no sketch state, e.g. ``"ssh"``)."""
        return self._sketch

    def heavy_hitters(self, threshold: float):
        """Shard-local heavy shingles."""
        if self._sketch is None:
            raise ValueError(
                f"encoder {self.encoder.spec.encoder!r} has no sketch "
                "state; heavy hitters need the 'ssh-cs' encoder")
        return self.encoder.shingler.find_heavy_hitters(self._sketch,
                                                        threshold)

    # -- the associative combine -------------------------------------------
    def merge(self, other: "StreamIngestor") -> "StreamIngestor":
        """Segments concatenate, sketches add; the fold order comes from
        the seq tags, not from the merge order."""
        if other.encoder.spec != self.encoder.spec:
            raise ValueError(
                f"cannot merge ingestors over different specs: "
                f"{self.encoder.spec!r} vs {other.encoder.spec!r}")
        out = StreamIngestor(self.encoder,
                             shard=f"{self.shard}+{other.shard}",
                             backend=self.backend)
        out._segments = list(self._segments) + list(other._segments)
        out._auto_seq = max(self._auto_seq, other._auto_seq)
        if self._sketch is not None and other._sketch is not None:
            out._sketch = self._sketch + other._sketch
        return out

    @staticmethod
    def merge_all(ingestors: Sequence["StreamIngestor"]) -> "StreamIngestor":
        """Fold a shard set (any bracketing gives the same result)."""
        if not ingestors:
            raise ValueError("merge_all needs at least one ingestor")
        return reduce(lambda a, b: a.merge(b), ingestors)

    # -- the fold ----------------------------------------------------------
    def artifacts(self) -> StreamArtifacts:
        """Segments in global ``(seq, shard, append order)`` order, ready
        for ``SSHIndex.insert_encoded``, with no re-hashing."""
        if not self._segments:
            raise ValueError("no appended series to fold")
        segs = sorted(self._segments,
                      key=lambda s: (s.seq, s.shard, s.order))
        series = (None if any(s.series is None for s in segs) else
                  torch.cat([s.series for s in segs]))
        return StreamArtifacts(
            series=series,
            signatures=torch.cat([s.signatures for s in segs]),
            keys=torch.cat([s.keys for s in segs]),
            sketch=self._sketch)
