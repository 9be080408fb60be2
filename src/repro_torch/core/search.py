"""End-to-end search pipelines: SSH (paper Alg. 2) sequentially, the
UCR-suite baseline, the SRP baseline and brute force (counterpart of
``repro.core.search``).

``ssh_search`` serves one query: ``hash_probe`` (single-query collision
counts, one ``collision_count`` launch per multiprobe row, the max over
rows and the lowest-id top-C; or the host tables' members) then
``core.rerank.rerank``.  The
``TimeSeriesDB`` facade routes here for ``searcher="local"``.
``ucr_search`` is the paper's exact baseline: an LB cascade over the
whole database against the k-th best of a seed, then DTW of every
survivor through the ``dtw_wavefront`` kernel.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.bench.timing import DISABLED, STAGES, StageTimer
from repro_torch.core import dtw as core_dtw
from repro_torch.core import lower_bounds as lb
from repro_torch.core import minhash
from repro_torch.core import rerank as rr
from repro_torch.core import srp as srp_mod
from repro_torch.core.index import SSHIndex, top_c_by_count
from repro_torch.core.rerank import SearchStats
from repro_torch.db.config import SearchConfig, legacy_config
from repro_torch.encoders.sigcache import row_bytes
from repro_torch.kernels import ops, ref


@dataclasses.dataclass
class SearchResult:
    ids: np.ndarray              # (k,) database ids, best first
    dists: np.ndarray            # (k,) squared DTW costs
    n_candidates: int            # candidates that reached the DTW stage
    n_database: int
    pruned_by_hash_frac: float
    pruned_total_frac: float
    wall_seconds: float
    stats: Optional[SearchStats] = None

    @property
    def dtw_evals(self) -> int:
        """DTW evaluations, the candidates that reached the DTW stage
        (``repro/core/search.py:39-41``)."""
        return self.n_candidates


def _as_tensor(x, device) -> torch.Tensor:
    """float32 tensor on ``device``; a tensor keeps its own device when
    ``device`` is None, anything else goes to CUDA unless asked."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32).to(
        ops.resolve_device(device))


def hash_probe(query: torch.Tensor, index: SSHIndex, top_c: int,
               rank_by_signature: bool = True, multiprobe_offsets: int = 1,
               use_host_buckets: bool = False, topk: int = 10,
               backend: str = "auto", timer: StageTimer = DISABLED,
               probe_stats: Optional[dict] = None,
               content: Optional[bytes] = None) -> torch.Tensor:
    """Stage 1 of Alg. 2 for one (m,) query: candidate ids (int64, on
    the index's device), most collisions first; the first ``top_c`` ids
    when nothing collides (``repro/core/search.py:44-114``).

    The device probe keeps at most ``top_c`` ids with a positive count,
    ties to the lowest id.  With ``use_host_buckets`` (and tables built)
    the members of the query's L buckets come from the host tables in
    their order (``HostBuckets.probe``), cut to ``max(top_c, topk)``.
    Encodes go through the index's signature LRU, keyed by ``content``,
    the query's host bytes (``sigcache.row_bytes``; read back from
    ``query`` when None); ``probe_stats`` receives
    ``{"sig_cache_hit": 0 or 1}``.  ``backend`` is checked against the
    index's device (``ops.check_backend``); the device picks the route,
    and the counts are integers, so the ids are the same either way."""
    ops.check_backend(backend, index.device)
    n = int(index.keys.shape[0])
    c = min(top_c, n)
    if use_host_buckets and index.host_buckets is not None:
        with timer.stage("encode"):
            qk, hit = index.query_keys_cached(query, content)
        with timer.stage("probe"):
            ids = index.host_buckets.probe(qk)[:max(top_c, topk)]
            cand_ids = torch.from_numpy(ids).to(index.device)
    else:
        with timer.stage("encode"):
            if multiprobe_offsets > 1:
                qk, hit = index.query_signatures_multiprobe_cached(
                    query, multiprobe_offsets, content)
                if not rank_by_signature:
                    qk = minhash.combine_bands(qk, index.num_tables)
            elif rank_by_signature:
                qk, hit = index.query_signature_cached(query, content)
                qk = qk[None]
            else:
                qk, hit = index.query_keys_cached(query, content)
                qk = qk[None]
            db = index.signatures if rank_by_signature else index.keys
        with timer.stage("probe"):
            # one launch per probe row, then the max over rows
            counts = ops.collision_count(qk[0].contiguous(), db)
            for row in qk[1:]:
                counts = torch.maximum(
                    counts, ops.collision_count(row.contiguous(), db))
            ids, vals = top_c_by_count(counts[None], c,
                                       max_count=int(qk.shape[-1]))
            cand_ids = ids[0][vals[0] > 0]
    if probe_stats is not None:
        probe_stats["sig_cache_hit"] = int(hit)
    if cand_ids.numel() == 0:            # degenerate: the first top_c ids
        cand_ids = torch.arange(c, device=index.device)
    return cand_ids


def ssh_search(query, index: SSHIndex,
               config: Optional[SearchConfig] = None,
               **legacy_kwargs) -> SearchResult:
    """Paper Algorithm 2 for one (m,) query on the index's device: hash
    probe, then DTW re-rank; ``stats`` carries this query's counters.
    The loose-kwarg form ``ssh_search(q, index, topk=..., band=...)``
    still works for one release, with identical results."""
    config = legacy_config("ssh_search", config, legacy_kwargs)
    dev = index.device
    ops.check_backend(config.backend, dev)
    t0 = time.perf_counter()
    timer = StageTimer(enabled=config.stage_timings, prefill=STAGES,
                       device=dev)
    with timer.stage("encode"):          # the LRU key, from the host copy
        content = row_bytes(query)[0]
    query = torch.as_tensor(query, dtype=torch.float32).to(dev)
    n = int(index.keys.shape[0])
    probe_stats: dict = {}
    cand_ids = hash_probe(query, index, config.top_c,
                          rank_by_signature=config.rank_by_signature,
                          multiprobe_offsets=config.multiprobe_offsets,
                          use_host_buckets=config.use_host_buckets,
                          topk=config.topk, timer=timer,
                          probe_stats=probe_stats, content=content)
    n_hash = int(cand_ids.shape[0])
    ids, dists, stats = rr.rerank(query, cand_ids, index, config.topk,
                                  config.band,
                                  use_lb_cascade=config.use_lb_cascade,
                                  seed_size=config.seed_size,
                                  early_abandon=config.early_abandon,
                                  timer=timer)
    stats.index_bytes = index.nbytes()
    stats.sig_cache_hit = probe_stats["sig_cache_hit"]
    return SearchResult(
        ids=ids, dists=dists, n_candidates=stats.n_dtw, n_database=n,
        pruned_by_hash_frac=1.0 - n_hash / n,
        pruned_total_frac=1.0 - stats.n_dtw / n,
        wall_seconds=time.perf_counter() - t0, stats=stats)


def _topk_ascending(d: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest values, ties to the lowest position
    (``lax.top_k(-d, k)``'s order)."""
    return torch.sort(d, stable=True).indices[:k]


def ucr_search(query, series, topk: int = 10, band: Optional[int] = None,
               seed_size: int = 64, backend: str = "auto", *,
               device=None) -> SearchResult:
    """Vectorised UCR suite: exact top-k through an LB cascade over the
    whole database against the k-th best DTW of the first ``seed_size``
    series, then exact DTW of every survivor
    (``repro/core/search.py:175-209``).  A candidate is dropped only when
    a lower bound exceeds a valid upper bound on the k-th best distance,
    so the answer is exact.  ``series`` (N, m) runs where it lies when it
    is a tensor, else on CUDA unless ``device="cpu"``; ``backend`` is
    checked against that device (``"jnp"`` only on the CPU)."""
    t0 = time.perf_counter()
    series = _as_tensor(series, device)
    ops.check_backend(backend, series.device)
    query = torch.as_tensor(query, dtype=torch.float32).to(series.device)
    n = int(series.shape[0])
    seed = rr.dtw_candidates(query, series[:seed_size], band)
    kth = torch.sort(seed).values[min(topk, int(seed.shape[0])) - 1]
    if band is None:
        # envelope bounds at a finite radius do not bound the
        # unconstrained DTW; only LB_Kim (first/last point) is sound
        keep = lb.lb_kim(query, series) < kth
    else:
        keep = lb.cascade(query, series, band, kth)
    keep[:seed_size] = True
    survivors = torch.nonzero(keep).squeeze(1)
    d = rr.dtw_candidates(query, series[survivors], band)
    order = _topk_ascending(d, min(topk, int(survivors.shape[0])))
    n_surv = int(survivors.shape[0])
    return SearchResult(
        ids=survivors[order].cpu().numpy(), dists=d[order].cpu().numpy(),
        n_candidates=n_surv, n_database=n, pruned_by_hash_frac=0.0,
        pruned_total_frac=1.0 - n_surv / n,
        wall_seconds=time.perf_counter() - t0)


def brute_force_topk(query, series, topk: int, band: Optional[int] = None,
                     *, device=None):
    """Gold standard (paper §5.3): exact DTW over the whole database
    through the plain wavefront (``kernels.ref``), independent of the
    kernels; (ids, dists) host arrays, ties to the lowest id."""
    series = _as_tensor(series, device)
    query = torch.as_tensor(query, dtype=torch.float32).to(series.device)
    d = ref.dtw_wavefront_ref(query, series, band)
    order = _topk_ascending(d, topk)
    return order.cpu().numpy(), d[order].cpu().numpy()


def srp_search(query, series, planes, db_bits, topk: int = 10, *,
               device=None) -> SearchResult:
    """The SRP baseline (paper §5.2; ``repro/core/search.py:226-241``):
    the query's sign bits against ``planes`` (one ``torch.matmul``, as the
    reference computes them outside any kernel), the ``topk`` database
    rows of the most matching bits in ``db_bits`` (N, K) (ties to the
    lowest row), then their unconstrained DTW through ``core.dtw.dtw_batch``
    (the ``dtw_wavefront`` kernel on CUDA).  No alignment, so it fails
    on warped series.  ``series`` runs where it lies when it is a tensor,
    else on CUDA unless ``device="cpu"``; the other operands follow it."""
    t0 = time.perf_counter()
    series = _as_tensor(series, device)
    dev = series.device
    query = torch.as_tensor(query, dtype=torch.float32).to(dev)
    planes = torch.as_tensor(planes, dtype=torch.float32).to(dev)
    qb = srp_mod.srp_bits(query, planes)
    ids, _ = srp_mod.srp_topk(qb, torch.as_tensor(db_bits).to(dev), topk)
    d = core_dtw.dtw_batch(query, series[ids])
    n = int(series.shape[0])
    return SearchResult(
        ids=ids.cpu().numpy(), dists=d.cpu().numpy(), n_candidates=topk,
        n_database=n, pruned_by_hash_frac=1.0 - topk / n,
        pruned_total_frac=1.0 - topk / n,
        wall_seconds=time.perf_counter() - t0)


def precision_at_k(pred_ids: np.ndarray, gold_ids: np.ndarray, k: int
                   ) -> float:
    """Paper §5.3: |top-k ∩ gold top-k| / k."""
    return len(set(pred_ids[:k].tolist()) & set(gold_ids[:k].tolist())) / k


def ndcg_at_k(pred_ids: np.ndarray, gold_ids: np.ndarray, k: int) -> float:
    """Paper §5.3 NDCG with graded relevance R_i = k - rank_gold(i)."""
    rel = {int(g): k - r for r, g in enumerate(gold_ids[:k].tolist())}
    dcg = sum(rel.get(int(p), 0) / np.log2(i + 2)
              for i, p in enumerate(pred_ids[:k].tolist()))
    idcg = sum((k - i) / np.log2(i + 2) for i in range(k))
    return float(dcg / idcg) if idcg > 0 else 0.0
