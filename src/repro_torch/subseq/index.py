"""Subsequence index — every sliding window of one long stream
(counterpart of ``repro.subseq.index``; DESIGN.md §10).

A :class:`SubsequenceIndex` encodes a stream once through the rolling
encoder (:mod:`repro_torch.subseq.rolling`) and keeps only the windows'
signatures and band keys beside the raw stream, which stays on the
index's device: the windows are never materialised.  A query runs

  1. the query signature through the index's LRU,
  2. the collision probe over the (nw, K) window signatures
     (``core.search.hash_probe``),
  3. the re-rank (``core.rerank.rerank``), which gathers its candidate
     windows from the stream (:class:`_LazyWindows`),

then UCR-style trivial-match suppression: returned offsets are pairwise
at least ``exclusion_zone`` apart (default L//2), picked greedily from a
DTW-ranked oversampled pool.  Matching is on the raw windows (no
per-window z-normalisation), which is what makes the rolling encode
equal to encoding each window.

``extend_stream`` appends points and encodes exactly the windows they
complete: the suffix from the first new window's offset is rolled again,
so every projection sees the operands of a full rebuild, and the new
rows fold in through ``StreamIngestor.append_encoded``.
"""
from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from repro_torch.bench.timing import STAGES, StageTimer
from repro_torch.core import rerank as rr
from repro_torch.core.index import SSHIndex, SSHParams
from repro_torch.core.search import SearchResult, hash_probe
from repro_torch.db.config import SearchConfig
from repro_torch.encoders import IndexSpec, make_encoder
from repro_torch.encoders.sigcache import row_bytes
from repro_torch.kernels import ops
from repro_torch.subseq.rolling import num_windows, rolling_signatures


@dataclasses.dataclass
class SubsequenceResult(SearchResult):
    """``SearchResult`` plus subsequence coordinates: ``ids`` are window
    indices, ``offsets`` their start positions in the stream (id · hop),
    best first."""
    offsets: Optional[np.ndarray] = None   # (k,) stream start positions
    n_windows: int = 0
    stream_length: int = 0


class _LazyWindows:
    """Stands in for ``index.series`` in the re-rank: row j is the stream
    slice [j·h, j·h + L), gathered on the stream's device only when
    indexed, so a query materialises only its candidate windows."""

    def __init__(self, stream: torch.Tensor, length: int, hop: int):
        self.stream = stream
        self.length = length
        self.hop = hop
        self.shape = (num_windows(int(stream.shape[0]), length, hop),
                      length)

    def __getitem__(self, ids) -> torch.Tensor:
        idx = torch.as_tensor(ids, device=self.stream.device)
        pos = idx[..., None] * self.hop + torch.arange(
            self.length, device=self.stream.device)
        return self.stream[pos]


#: window rows a ``band_keys`` call: its int64 temporaries are several
#: times the signatures they fold (about 20 GB at 2^24 windows at once)
_KEYS_CHUNK = 1 << 20


def _band_keys(encoder, sigs: torch.Tensor) -> torch.Tensor:
    """(nw, L) band keys of (nw, K) signatures, a chunk of rows at a
    time."""
    keys = torch.empty((sigs.shape[0], encoder.num_tables),
                       dtype=torch.int32, device=sigs.device)
    for lo in range(0, int(sigs.shape[0]), _KEYS_CHUNK):
        keys[lo:lo + _KEYS_CHUNK] = encoder.band_keys(
            sigs[lo:lo + _KEYS_CHUNK])
    return keys


def _stream_tensor(stream, device: torch.device) -> torch.Tensor:
    """A contiguous 1-D float32 copy of ``stream`` on ``device``."""
    return torch.as_tensor(stream, dtype=torch.float32).reshape(-1).to(
        device).contiguous()


@dataclasses.dataclass
class SubsequenceIndex:
    """Sliding-window index over one long stream.

    ``inner`` is an :class:`SSHIndex` whose rows are the stream's windows
    and which stores no series (the raw data is ``stream``), so the
    probe, the signature LRU and the streaming fold are the fixed-length
    index's own.
    """
    inner: SSHIndex
    stream: torch.Tensor          # (n,) float32 on the index's device
    length: int                   # window length L
    hop: int                      # window start spacing h
    encode_seconds: float = 0.0   # cumulative rolling-encode wall clock

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, stream, spec: IndexSpec, *, length: int, hop: int = 1,
              backend: str = "auto", device=None) -> "SubsequenceIndex":
        """Index every length-``length`` window (starts 0, h, 2h, …) of
        ``stream`` through one rolling encode, on CUDA unless
        ``device="cpu"``; ``backend`` is checked against that device.
        ``spec`` is an ``IndexSpec``; an ``SSHParams`` lowers by
        ``to_spec()`` (``repro/subseq/index.py:100-105``)."""
        if isinstance(spec, SSHParams):
            spec = spec.to_spec()
        dev = ops.resolve_device(device)
        ops.check_backend(backend, dev)
        stream = _stream_tensor(stream, dev)
        if num_windows(int(stream.shape[0]), length, hop) == 0:
            raise ValueError(
                f"stream of {int(stream.shape[0])} points holds no window "
                f"of length {length}")
        enc = make_encoder(spec, dev, length=length)
        t0 = time.perf_counter()
        sigs = rolling_signatures(stream, enc, length, hop)
        keys = _band_keys(enc, sigs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        inner = SSHIndex(encoder=enc, signatures=sigs, keys=keys,
                         series=None, build_backend=dev.type)
        return cls(inner=inner, stream=stream, length=length, hop=hop,
                   encode_seconds=time.perf_counter() - t0)

    # -- views -------------------------------------------------------------
    @property
    def num_windows(self) -> int:
        return int(self.inner.signatures.shape[0])

    def __len__(self) -> int:
        return self.num_windows

    @property
    def encoder(self):
        return self.inner.encoder

    @property
    def device(self) -> torch.device:
        return self.inner.device

    @property
    def build_backend(self) -> str:
        return self.inner.build_backend

    def offsets(self) -> np.ndarray:
        """(nw,) int64 stream start of every indexed window
        (``repro/subseq/index.py:140-142``)."""
        return np.arange(self.num_windows, dtype=np.int64) * self.hop

    def window(self, j: int) -> torch.Tensor:
        """Window ``j``'s points, a view of the stream on the index's
        device (``index.py:144-147``)."""
        lo = int(j) * self.hop
        return self.stream[lo:lo + self.length]

    def nbytes(self) -> int:
        """Signatures, keys and encoder state plus the stream itself."""
        return self.inner.nbytes() + self.stream.numel() * 4

    # -- search ------------------------------------------------------------
    def search(self, query, config: Optional[SearchConfig] = None
               ) -> SubsequenceResult:
        """Top-k windows by banded DTW whose offsets are pairwise at least
        ``exclusion_zone`` apart (``repro/subseq/index.py:154-240``).

        The probe and re-rank run at an oversampled topk (enough DTW'd
        windows to fill k picks when shifted near-duplicates dominate),
        then picks go greedily best first, skipping any window within
        the zone of one already picked.  Rank 1 is the minimum over the
        DTW'd pool; deeper ranks are UCR-style picks from that pool.
        """
        config = SearchConfig() if config is None else config
        config.validate()
        dev = self.device
        ops.check_backend(config.backend, dev)
        if config.subseq_window is not None \
                and config.subseq_window != self.length:
            raise ValueError(
                f"config.subseq_window={config.subseq_window} does not "
                f"match the indexed window length {self.length}")
        t0 = time.perf_counter()
        timer = StageTimer(enabled=config.stage_timings,
                           prefill=STAGES + ("encode_amortized",),
                           device=dev)
        with timer.stage("encode"):          # the LRU key, from the host copy
            content = row_bytes(query)[0]
        query = torch.as_tensor(query, dtype=torch.float32).to(dev)
        if tuple(query.shape) != (self.length,):
            raise ValueError(
                f"query must be one window of shape ({self.length},), "
                f"got {tuple(query.shape)}")
        nw = self.num_windows
        excl = (self.length // 2 if config.exclusion_zone is None
                else int(config.exclusion_zone))
        oversample = (max(2, excl // max(self.hop, 1) + 1)
                      if excl > 0 else 1)

        probe_stats: dict = {}
        cand_ids = hash_probe(query, self.inner, config.top_c,
                              rank_by_signature=config.rank_by_signature,
                              multiprobe_offsets=config.multiprobe_offsets,
                              topk=config.topk, timer=timer,
                              probe_stats=probe_stats, content=content)
        n_hash = int(cand_ids.shape[0])
        topk_eff = min(n_hash, config.topk * oversample)
        if timer.enabled:
            # the query's share of the build's rolling encode, the stage a
            # per-window encoder would pay at query time
            timer.timings["encode_amortized"] = \
                self.encode_seconds / max(nw, 1)
        adapter = SimpleNamespace(
            device=dev,
            series=_LazyWindows(self.stream, self.length, self.hop),
            env_radius=None, env_upper=None, env_lower=None)
        ids, dists, stats = rr.rerank(query, cand_ids, adapter, topk_eff,
                                      config.band,
                                      use_lb_cascade=config.use_lb_cascade,
                                      seed_size=config.seed_size,
                                      early_abandon=config.early_abandon,
                                      timer=timer)
        sel = exclusion_pick(ids * self.hop, excl, config.topk)
        out_ids, out_dists = ids[sel], dists[sel]

        stats.n_windows = nw
        stats.sig_cache_hit = probe_stats.get("sig_cache_hit", 0)
        stats.index_bytes = self.nbytes()
        return SubsequenceResult(
            ids=out_ids, dists=out_dists,
            n_candidates=stats.n_dtw, n_database=nw,
            pruned_by_hash_frac=1.0 - n_hash / nw,
            pruned_total_frac=1.0 - stats.n_dtw / nw,
            wall_seconds=time.perf_counter() - t0, stats=stats,
            offsets=out_ids * self.hop, n_windows=nw,
            stream_length=int(self.stream.shape[0]))

    # -- growth ------------------------------------------------------------
    def extend_stream(self, tail) -> int:
        """Append points and index exactly the windows they complete;
        returns how many.  Only the suffix from the first new window's
        offset is encoded, so the new signatures equal a full rebuild's
        (``repro/subseq/index.py:242-271``)."""
        from repro_torch.streaming.ingest import StreamIngestor
        tail = _stream_tensor(tail, self.device)
        if tail.numel() == 0:
            return 0
        new_stream = torch.cat([self.stream, tail])
        nw_old = self.num_windows
        n_new = num_windows(int(new_stream.shape[0]), self.length,
                            self.hop) - nw_old
        if n_new > 0:
            t0 = time.perf_counter()
            sigs = rolling_signatures(new_stream[nw_old * self.hop:],
                                      self.encoder, self.length, self.hop)
            keys = _band_keys(self.encoder, sigs)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.encode_seconds += time.perf_counter() - t0
            # the streaming fold, series-less: the stream is the raw data
            ing = StreamIngestor(self.encoder, shard="subseq")
            ing.append_encoded(sigs, keys)
            art = ing.artifacts()
            self.inner.insert_encoded(art.series, art.signatures, art.keys)
        self.stream = new_stream
        return max(n_new, 0)

    # -- persistence -------------------------------------------------------
    def save(self, directory, config: Optional[SearchConfig] = None,
             n_shards: int = 1):
        """:func:`repro_torch.subseq.persistence.save_subseq`."""
        from repro_torch.subseq.persistence import save_subseq
        return save_subseq(directory, self, config, n_shards=n_shards)

    @classmethod
    def load(cls, directory, device=None):
        """(index, config) — :func:`repro_torch.subseq.persistence.
        load_subseq`, onto CUDA unless ``device="cpu"``."""
        from repro_torch.subseq.persistence import load_subseq
        return load_subseq(directory, device=device)


def exclusion_pick(offsets: np.ndarray, zone: int, k: int) -> np.ndarray:
    """Positions of up to ``k`` offsets picked best first (the given
    order), skipping any within ``zone`` points of one already picked."""
    picked: list = []
    sel: list = []
    for i, off in enumerate(offsets.tolist()):
        if all(abs(off - p) >= zone for p in picked):
            sel.append(i)
            picked.append(off)
            if len(sel) == k:
                break
    return np.asarray(sel, np.int64)
