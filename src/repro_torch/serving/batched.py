"""Batched end-to-end SSH search (counterpart of
``repro.serving.batched``).

One ``ssh_search_batch`` call serves a (B, m) block of queries:

  1. **encode** — signatures of every query (and every multiprobe offset)
     in one sketch launch;
  2. **probe** — one (B·O, K) x (N, K) collision count
     (``collision_count_batch``), the max over offsets, and each row's
     top-C by count with ties to the lowest id;
  3. **re-rank** — ``core.rerank.rerank_batch``.

Per-query answers follow the reference's decisions: the same integer
counts, the same tie-breaking, the same cascade and the same DTW values.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.bench.timing import DISABLED, STAGES, StageTimer
from repro_torch.core import minhash
from repro_torch.core import rerank as rr
from repro_torch.core.index import SSHIndex
from repro_torch.core.rerank import SearchStats
from repro_torch.core.search import SearchResult, top_c_by_count
from repro_torch.db.config import SearchConfig
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
                timer: StageTimer = DISABLED):
    """Stage 1+2 for a query block: (B, m) -> ids (B, C) int64, counts
    (B, C) int32, on the index's device."""
    b = queries.shape[0]
    top_c = min(top_c, int(index.signatures.shape[0]))
    with timer.stage("encode") as sync:
        if multiprobe_offsets > 1:
            sigs = index.query_signatures_batch_multiprobe(
                queries, multiprobe_offsets)                   # (B, O, K)
            sigs = sigs.reshape(-1, sigs.shape[-1])            # (B·O, K)
        else:
            sigs = index.query_signatures_batch(queries)       # (B, K)
        if rank_by_signature:
            qk, db = sigs, index.signatures
        else:
            qk, db = minhash.combine_bands(sigs, index.num_tables), \
                index.keys
        sync(None)
    with timer.stage("probe") as sync:
        counts = ops.collision_count_batch(qk.contiguous(), db)  # (B·O, N)
        if multiprobe_offsets > 1:
            counts = counts.reshape(b, multiprobe_offsets, -1).amax(1)
        ids, vals = top_c_by_count(counts, top_c)
        sync(None)
    return ids, vals


def ssh_search_batch(queries, index: SSHIndex,
                     config: Optional[SearchConfig] = None
                     ) -> BatchSearchResult:
    """Batched paper Alg. 2 over a (B, m) query block on the index's
    device (the ``TimeSeriesDB`` facade routes here)."""
    config = (config if config is not None else SearchConfig()).validate()
    dev = index.device
    ops.check_backend(config.backend, dev)
    t0 = time.perf_counter()
    timer = StageTimer(enabled=config.stage_timings, prefill=STAGES,
                       device=dev)
    queries = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    b = queries.shape[0]
    n = int(index.signatures.shape[0])
    c = min(config.top_c, n)

    ids, vals = batch_probe(queries, index, c,
                            rank_by_signature=config.rank_by_signature,
                            multiprobe_offsets=config.multiprobe_offsets,
                            timer=timer)
    valid = vals > 0                                           # (B, C)
    empty = ~valid.any(1)
    # degenerate rows: same fallback as the sequential path
    ids = torch.where(empty[:, None],
                      torch.arange(c, device=dev)[None, :], ids)
    valid = valid | empty[:, None]
    n_hash = valid.sum(1).cpu().numpy()

    out_ids, out_d, n_final, n_union, stats = rr.rerank_batch(
        queries, ids, valid, index, config.topk, config.band,
        use_lb_cascade=config.use_lb_cascade, seed_size=config.seed_size,
        early_abandon=config.early_abandon, timer=timer)
    stats.index_bytes = index.nbytes()
    return BatchSearchResult(
        ids=out_ids, dists=out_d, n_queries=b, n_database=n,
        n_union=n_union, n_candidates=n_final,
        pruned_by_hash_frac=1.0 - n_hash / n,
        pruned_total_frac=1.0 - n_final / n,
        wall_seconds=time.perf_counter() - t0, stats=stats)
