"""Batched end-to-end SSH search (counterpart of
``repro.serving.batched``).

One ``ssh_search_batch`` call serves a (B, m) block of queries:

  1. **encode** — signatures of every query (and every multiprobe offset)
     in one sketch launch, or none when the signature LRU holds every
     row;
  2. **probe** — one (B·O, K) x (N, K) collision count
     (``collision_count_batch``), the max over offsets, and each row's
     top-C by count with ties to the lowest id (``top_c_by_count``, the
     ``topc_select`` kernels);
  3. **re-rank** — ``core.rerank.rerank_batch``.

Per-query answers follow the reference's decisions: the same integer
counts, the same tie-breaking, the same cascade and the same DTW values.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.bench.timing import DISABLED, STAGES, StageTimer
from repro_torch.core import minhash
from repro_torch.core import rerank as rr
from repro_torch.core.index import SSHIndex
from repro_torch.core.rerank import SearchStats
from repro_torch.core.search import SearchResult, top_c_by_count
from repro_torch.db.config import SearchConfig, legacy_config
from repro_torch.encoders.sigcache import row_bytes
from repro_torch.kernels import ops


@dataclasses.dataclass
class BatchSearchResult:
    """Per-query top-k plus the batch's re-rank counters."""
    ids: np.ndarray                   # (B, k) database ids, best first
    dists: np.ndarray                 # (B, k) squared DTW costs
    n_queries: int
    n_database: int
    n_union: int                      # distinct candidates gathered
    n_candidates: np.ndarray          # (B,) candidates reaching DTW
    pruned_by_hash_frac: np.ndarray   # (B,)
    pruned_total_frac: np.ndarray     # (B,)
    wall_seconds: float
    stats: Optional[SearchStats] = None

    @property
    def dtw_evals(self) -> int:
        """DTW evaluations across the batch, the re-rank survivors
        (``repro/serving/batched.py:65-68``)."""
        return int(self.n_candidates.sum())

    @classmethod
    def of_fanout(cls, ids, dists, n_database: int, top_c: int,
                  t0: float, stats: SearchStats) -> "BatchSearchResult":
        """The result of a shard fan-out (distributed, fleet): each
        query's top-k rows stacked, ``min(top_c, N)`` candidates a query
        counted as probed and re-ranked, as the reference reports them;
        ``t0`` the ``perf_counter`` the batch started at."""
        b, c = len(ids), min(top_c, n_database)
        return cls(ids=np.stack(ids).astype(np.int64),
                   dists=np.stack(dists).astype(np.float32),
                   n_queries=b, n_database=n_database, n_union=c,
                   n_candidates=np.full(b, c, np.int64),
                   pruned_by_hash_frac=np.full(b, 1.0 - c / n_database),
                   pruned_total_frac=np.full(b, 1.0 - c / n_database),
                   wall_seconds=time.perf_counter() - t0, stats=stats)

    def per_query(self, b: int) -> SearchResult:
        """Query ``b``'s slice, filler rows (id -1) trimmed.  Its ``stats``
        stays None, as the reference's (``repro/serving/batched.py:
        70-87``): the counters are the batch's, and the per-query
        invariant ``stats.n_dtw == n_candidates`` would not hold for a
        slice; read them from ``BatchSearchResult.stats``."""
        k = int(np.sum(self.ids[b] >= 0))
        return SearchResult(
            ids=self.ids[b][:k], dists=self.dists[b][:k],
            n_candidates=int(self.n_candidates[b]),
            n_database=self.n_database,
            pruned_by_hash_frac=float(self.pruned_by_hash_frac[b]),
            pruned_total_frac=float(self.pruned_total_frac[b]),
            wall_seconds=self.wall_seconds)


def batch_probe(queries: torch.Tensor, index: SSHIndex, top_c: int,
                rank_by_signature: bool = True, multiprobe_offsets: int = 1,
                timer: StageTimer = DISABLED,
                probe_stats: Optional[dict] = None,
                contents: Optional[List[bytes]] = None):
    """Stage 1+2 for a query block: (B, m) -> ids (B, C) int64, counts
    (B, C) int32, on the index's device.

    Rows ride the index's signature LRU as the reference's
    (``repro/serving/batched.py:103-136``): when every row is cached the
    encode is skipped and ``probe_stats`` gets ``{"sig_cache_hit": B}``;
    otherwise the whole block is encoded, every row stored, and the hit
    count is 0.  ``contents`` are the rows' host bytes
    (``sigcache.row_bytes``); without them the block is read back once.
    Cached rows stay on the index's device: a miss stores views of the
    encoded block, a hit stacks them."""
    b = queries.shape[0]
    top_c = min(top_c, int(index.signatures.shape[0]))
    variant = (f"mp{multiprobe_offsets}" if multiprobe_offsets > 1
               else "sig")
    with timer.stage("encode"):
        cache = index._sig_cache()
        with timer.stage("sigcache"):
            if contents is None:
                contents = row_bytes(queries)
            spec, route = index.encoder.spec, index.build_backend
            keys = [cache.key(c, spec, route, variant) for c in contents]
            cached = cache.get_many(keys)
        hits = 0
        if all(r is not None for r in cached):
            sigs = torch.stack(cached)                         # (B, [O,] K)
            hits = b
        else:
            if multiprobe_offsets > 1:
                sigs = index.query_signatures_batch_multiprobe(
                    queries, multiprobe_offsets)               # (B, O, K)
            else:
                sigs = index.query_signatures_batch(queries)   # (B, K)
            with timer.stage("sigcache"):
                cache.put_many(keys, sigs.unbind(0))
        if probe_stats is not None:
            probe_stats["sig_cache_hit"] = hits
        sigs = sigs.reshape(-1, sigs.shape[-1])                # (B·O, K)
        if rank_by_signature:
            qk, db = sigs, index.signatures
        else:
            qk, db = minhash.combine_bands(sigs, index.num_tables), \
                index.keys
    with timer.stage("probe"):
        counts = ops.collision_count_batch(qk.contiguous(), db)  # (B·O, N)
        if multiprobe_offsets > 1:
            counts = counts.reshape(b, multiprobe_offsets, -1).amax(1)
        with timer.stage("topc"):
            ids, vals = top_c_by_count(counts, top_c)
    return ids, vals


def ssh_search_batch(queries, index: SSHIndex,
                     config: Optional[SearchConfig] = None,
                     **legacy_kwargs) -> BatchSearchResult:
    """Batched paper Alg. 2 over a (B, m) query block on the index's
    device (the ``TimeSeriesDB`` facade routes here).  The loose-kwarg
    form (``topk=..., top_c=...``) still works for one release, with
    identical results (``repro/serving/batched.py:156-186``)."""
    config = legacy_config("ssh_search_batch", config, legacy_kwargs)
    dev = index.device
    ops.check_backend(config.backend, dev)
    t0 = time.perf_counter()
    timer = StageTimer(enabled=config.stage_timings, prefill=STAGES,
                       device=dev)
    with timer.stage("encode"), timer.stage("sigcache"):
        contents = row_bytes(queries)    # the LRU keys, from the host copy
    queries = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    b = queries.shape[0]
    n = int(index.signatures.shape[0])
    c = min(config.top_c, n)

    probe_stats: dict = {}
    ids, vals = batch_probe(queries, index, c,
                            rank_by_signature=config.rank_by_signature,
                            multiprobe_offsets=config.multiprobe_offsets,
                            timer=timer, probe_stats=probe_stats,
                            contents=contents)
    valid = vals > 0                                           # (B, C)
    # top-C slots filled from each row's threshold count, its last
    tie_slots = (vals == vals[:, -1:]).sum()
    empty = ~valid.any(1)
    # degenerate rows: same fallback as the sequential path
    ids = torch.where(empty[:, None],
                      torch.arange(c, device=dev)[None, :], ids)
    valid = valid | empty[:, None]
    n_hash = valid.sum(1).cpu().numpy()

    out_ids, out_d, n_final, n_union, stats = rr.rerank_batch(
        queries, ids, valid, index, config.topk, config.band,
        use_lb_cascade=config.use_lb_cascade, seed_size=config.seed_size,
        early_abandon=config.early_abandon, timer=timer,
        tie_slots=tie_slots)
    stats.index_bytes = index.nbytes()
    stats.sig_cache_hit = probe_stats["sig_cache_hit"]
    return BatchSearchResult(
        ids=out_ids, dists=out_d, n_queries=b, n_database=n,
        n_union=n_union, n_candidates=n_final,
        pruned_by_hash_frac=1.0 - n_hash / n,
        pruned_total_frac=1.0 - n_final / n,
        wall_seconds=time.perf_counter() - t0, stats=stats)
