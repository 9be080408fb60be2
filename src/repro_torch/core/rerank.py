"""DTW re-rank, sequential and batched (counterpart of
``repro.core.rerank``).

``rerank`` serves one query (the sequential searcher): seed DTW over the
first ``topk`` (or ``seed_size``) hash candidates gives the best-so-far,
the staged LB cascade and then LB_Improved thin the block, the
threshold-aware DTW of the single-query kernel (``dtw_wavefront``) scores
the survivors, and a stable sort takes the top-k.  Its decisions and
counters are the reference's (``repro/core/rerank.py:267-351``).

``rerank_batch``: for a (B, C) block of hash candidates, seed DTW over each row's first
``topk`` candidates gives a per-row best-so-far; the staged LB cascade
(LB_Kim -> LB_Keogh -> LB_Keogh2 from the index's cached envelopes)
thins the block; LB_Improved thins the survivor pairs; the
threshold-aware pair DTW (``dtw_wavefront_pairs``) scores the rest; a
stable sort takes each row's top-k.  Per-row decisions are the
reference's (``repro/core/rerank.py:355-508``).

Unlike the reference, the pair bookkeeping stays on the device: the
survivor pairs, their gathered rows and their thresholds are tensors on
the index's device, and each DTW stage is one launch over all its pairs
(values are lane-independent, so no fixed-size chunking is needed — the
reference chunks only to bound XLA recompiles, and it copies the whole
database to the host, which on the card would be gigabytes per batch).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.bench.timing import DISABLED, StageTimer
from repro_torch.core import lower_bounds as lb
from repro_torch.core.dtw import BIG
from repro_torch.core.index import SSHIndex
from repro_torch.kernels import ops


@dataclasses.dataclass
class SearchStats:
    """Re-rank pruning counters; the stage counters attribute each
    pruned candidate to the first bound that fired, seeds exempt, so
    ``n_in == pruned_kim + pruned_keogh + pruned_keogh2 +
    pruned_improved + n_dtw``.  ``dtw_abandoned`` counts DTW pairs the
    threshold abandoned.  ``backend`` names the route ("cuda" kernels or
    "cpu" plain versions)."""
    n_in: int = 0
    pruned_kim: int = 0
    pruned_keogh: int = 0
    pruned_keogh2: int = 0
    pruned_improved: int = 0
    forced_kept: int = 0
    n_dtw: int = 0
    dtw_abandoned: int = 0
    backend: str = "cuda"
    stage_seconds: Optional[Dict[str, float]] = None
    index_bytes: Optional[int] = None
    sig_cache_hit: int = 0            # encodes served by the LRU

    @property
    def lb_pruned(self) -> int:
        return (self.pruned_kim + self.pruned_keogh + self.pruned_keogh2
                + self.pruned_improved)

    @property
    def lb_pruned_frac(self) -> float:
        return self.lb_pruned / self.n_in if self.n_in else 0.0

    @property
    def dtw_abandoned_frac(self) -> float:
        """Share of the DTW stage's pairs the threshold abandoned."""
        return self.dtw_abandoned / self.n_dtw if self.n_dtw else 0.0

    @property
    def stage_us(self) -> Optional[Dict[str, float]]:
        if self.stage_seconds is None:
            return None
        return {k: v * 1e6 for k, v in self.stage_seconds.items()}


def dtw_candidates(query: torch.Tensor, candidates: torch.Tensor,
                   band: Optional[int], threshold=None) -> torch.Tensor:
    """One query against a candidate block in one dispatch, (m,) x (C, m)
    -> (C,); ``threshold`` (scalar or (C,)) is the early-abandon
    contract."""
    if candidates.shape[0] == 0:
        return torch.zeros(0, dtype=torch.float32, device=candidates.device)
    return ops.dtw_rerank(query.contiguous(), candidates.contiguous(), band,
                          threshold)


def _staged_keep(query: torch.Tensor, cands: torch.Tensor, band: int,
                 best: torch.Tensor, cand_env):
    """(keep_kim, keep_keogh, keep_keogh2), each (C,) bool, for one
    query's candidate block."""
    env = () if cand_env is None else (cand_env[0][None], cand_env[1][None])
    masks = lb.cascade_staged(query[None], cands[None], band,
                              best.reshape(1), *env)
    return tuple(k[0] for k in masks)


def _count_stages(k1: torch.Tensor, k2: torch.Tensor, k3: torch.Tensor,
                  forced: torch.Tensor):
    """Survivor mask plus the first-bound-fired counters as one tensor
    (pruned_kim, pruned_keogh, pruned_keogh2, forced_kept), seeds
    exempt: the forced rows are kept and counted in no stage."""
    k1f, k2f, k3f = k1 | forced, k2 | forced, k3 | forced
    keep = k1f & k2f & k3f
    counts = torch.stack([(~k1f).sum(), (k1f & ~k2f).sum(),
                          (k1f & k2f & ~k3f).sum(),
                          (forced & ~(k1 & k2 & k3)).sum()])
    return keep, counts


def _gathered_env(index: SSHIndex, ids: torch.Tensor, band: int):
    """Candidate envelope rows when the index caches them at ``band``,
    else None (computed per block)."""
    if (index.env_radius == band and index.env_upper is not None
            and int(index.env_upper.shape[0]) == int(index.series.shape[0])):
        return index.env_upper[ids], index.env_lower[ids]
    return None


def rerank(query: torch.Tensor, cand_ids: torch.Tensor, index: SSHIndex,
           topk: int, band: Optional[int], *, use_lb_cascade: bool = True,
           seed_size: Optional[int] = None, early_abandon: bool = True,
           timer: StageTimer = DISABLED):
    """Candidate ids (C,) int64 -> (ids (k,) int64, dists (k,) f32, stats)
    as host arrays, best first; stage 2+3 of Alg. 2 for one query.

    The threshold is the topk-th best seed DTW, always a valid upper
    bound on the final k-th distance, so no pruned or abandoned
    candidate can belong to the answer.
    """
    dev = index.device
    cands = index.series[cand_ids]
    n_hash = int(cand_ids.shape[0])
    stats = SearchStats(n_in=n_hash, backend=dev.type)
    thr = None
    counters = None

    if use_lb_cascade and band is not None and n_hash > topk:
        with timer.stage("lb") as sync:
            # the seed is clamped to >= topk: a smaller one would make the
            # threshold bound a better-than-kth distance
            s = min(max(seed_size or 0, topk), n_hash)
            seed = dtw_candidates(query, cands[:s], band)
            best = torch.sort(seed).values[min(topk, s) - 1]
            env = _gathered_env(index, cand_ids, band)
            k1, k2, k3 = _staged_keep(query, cands, band, best, env)
            forced = torch.zeros(n_hash, dtype=torch.bool, device=dev)
            forced[:s] = True                 # never drop the seeded set
            keep, stage_counts = _count_stages(k1, k2, k3, forced)
            cand_ids, cands = cand_ids[keep], cands[keep]
            sync(None)
        with timer.stage("lb_improved") as sync:
            # Lemire's two-pass bound over the cascade survivors only
            lbi = lb.lb_improved(query, cands, band)
            forced_surv = forced[keep]
            pass123_surv = (k1 & k2 & k3)[keep]
            below = lbi < best
            keep2 = below | forced_surv
            counters = torch.cat([stage_counts, torch.stack([
                (~keep2).sum(), (forced_surv & pass123_surv & ~below).sum()])])
            cand_ids, cands = cand_ids[keep2], cands[keep2]
            sync(None)
        if early_abandon:
            thr = best
    stats.n_dtw = int(cands.shape[0])

    with timer.stage("dtw") as sync:
        d = dtw_candidates(query, cands, band, threshold=thr)
        k = min(topk, int(cands.shape[0]))
        # stable ascending sort: ties to the lowest candidate slot, as
        # lax.top_k(-d) breaks them
        order = torch.sort(d, stable=True).indices[:k]
        extra = [] if counters is None else [counters]
        if thr is not None:
            extra.append((d >= BIG * 0.5).sum()[None])
        host = [t.cpu() for t in (cand_ids[order], d[order], *extra)]
        sync(None)
    if counters is not None:
        (stats.pruned_kim, stats.pruned_keogh, stats.pruned_keogh2,
         stats.forced_kept, stats.pruned_improved, more) = host[2].tolist()
        stats.forced_kept += more
    if thr is not None:
        stats.dtw_abandoned = int(host[-1][0])
    if timer.enabled:
        stats.stage_seconds = dict(timer.timings)
    return host[0].numpy().astype(np.int64), host[1].numpy(), stats


def dtw_pairs(q_rows: torch.Tensor, c_rows: torch.Tensor,
              band: Optional[int],
              threshold: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-aligned pair DTW over all P pairs in one dispatch:
    (P, m) x (P, m) -> (P,)."""
    if q_rows.shape[0] == 0:
        return torch.zeros(0, dtype=torch.float32, device=q_rows.device)
    return ops.dtw_rerank_pairs(q_rows.contiguous(), c_rows.contiguous(),
                                band, threshold)


def rerank_batch(queries: torch.Tensor, ids: torch.Tensor,
                 valid: torch.Tensor, index: SSHIndex, topk: int,
                 band: Optional[int], *, use_lb_cascade: bool = True,
                 seed_size: Optional[int] = None, early_abandon: bool = True,
                 timer: StageTimer = DISABLED):
    """Batched stage 2+3 over per-query candidate blocks.

    queries (B, m); ids (B, C) int64 candidate ids; valid (B, C) bool, all
    on the index's device.  Returns host arrays (out_ids (B, k) int64,
    out_d (B, k) f32, n_final (B,) int64), n_union and the stats; filler
    slots (fewer survivors than topk) carry id -1 / dist BIG.
    """
    dev = index.device
    b, c = ids.shape
    n_hash = valid.sum(1)                                      # (B,)
    stats = SearchStats(backend=dev.type)
    k_out = min(topk, c)
    seed_k = min(max(seed_size or 0, topk), c)
    cascade_on = use_lb_cascade and band is not None
    thr_rows = None
    counters = [valid.sum()]

    if cascade_on:
        with timer.stage("lb") as sync:
            seed_ids = ids[:, :seed_k]
            seed_d = dtw_pairs(queries.repeat_interleave(seed_k, 0),
                               index.series[seed_ids.reshape(-1)],
                               band).reshape(b, seed_k)
            if seed_size is not None:
                # a widened seed may overrun a row's valid candidates
                col = torch.arange(seed_k, device=dev)[None, :]
                seed_d = torch.where(col < n_hash[:, None], seed_d,
                                     torch.inf)
                best = torch.sort(seed_d, 1).values[:, min(topk, seed_k) - 1]
            else:
                best = seed_d.max(1).values                    # kth best
            cand_series = index.series[ids]                    # (B, C, m)
            env = ()
            if index.env_radius == band and index.env_upper is not None:
                env = (index.env_upper[ids], index.env_lower[ids])
            k1, k2, k3 = lb.cascade_staged(queries, cand_series, band, best,
                                           *env)
            # the sequential path skips the cascade when n_hash <= topk
            # and never drops the seeded set
            forced = torch.zeros((b, c), dtype=torch.bool, device=dev)
            forced[:, :seed_k] = True
            forced[n_hash <= topk] = True
            enter = valid & ~forced
            pass123 = k1 & k2 & k3
            counters += [(enter & ~k1).sum(), (enter & k1 & ~k2).sum(),
                         (enter & k1 & k2 & ~k3).sum(),
                         (valid & forced & ~pass123).sum()]
            ok = valid & (forced | pass123)
            # rows whose cascade never applied get +inf: exempt from both
            # LB_Improved and early abandoning
            thr_rows = torch.where(n_hash > topk, best,
                                   torch.full_like(best, torch.inf))
            sync(None)
    else:
        ok = valid.clone()

    # flattened survivor pairs, row-major like the reference's np.nonzero
    rows_idx, cols_idx = torch.nonzero(ok, as_tuple=True)
    pair_ids = ids[rows_idx, cols_idx]
    c_rows = index.series[pair_ids]                            # (P, m)
    q_rows = queries[rows_idx]                                 # (P, m)

    if cascade_on:
        with timer.stage("lb_improved") as sync:
            lbi = lb.lb_improved_pairs(q_rows, c_rows, band)
            thr_pair = thr_rows[rows_idx]
            forced_pair = forced[rows_idx, cols_idx]
            keep = (lbi < thr_pair) | forced_pair
            counters += [(~keep).sum(),
                         (forced_pair & pass123[rows_idx, cols_idx]
                          & ~(lbi < thr_pair)).sum()]
            ok[rows_idx[~keep], cols_idx[~keep]] = False
            rows_idx, cols_idx = rows_idx[keep], cols_idx[keep]
            q_rows, c_rows = q_rows[keep], c_rows[keep]
            sync(None)

    with timer.stage("dtw") as sync:
        thr_pairs = (thr_rows[rows_idx]
                     if (cascade_on and early_abandon) else None)
        pair_d = dtw_pairs(q_rows, c_rows, band, thr_pairs)    # (P,)
        if thr_pairs is not None:
            counters.append((pair_d >= BIG * 0.5).sum())
        cand_d = torch.full((b, c), BIG, dtype=torch.float32, device=dev)
        cand_d[rows_idx, cols_idx] = pair_d
        # stable ascending sort: ties go to the lowest candidate slot, as
        # lax.top_k(-d) breaks them
        out_d, order = torch.sort(cand_d, dim=1, stable=True)
        out_d, order = out_d[:, :k_out], order[:, :k_out]
        out_ids = torch.where(out_d < BIG * 0.5, ids.gather(1, order), -1)
        n_final = ok.sum(1)
        n_union = torch.unique(pair_ids).numel()
        host = [t.cpu() for t in (out_ids, out_d, n_final,
                                  torch.stack(counters))]
        sync(None)
    out_ids, out_d, n_final, cnt = host
    cnt = cnt.tolist()
    stats.n_in = cnt[0]
    if cascade_on:
        (stats.pruned_kim, stats.pruned_keogh, stats.pruned_keogh2,
         stats.forced_kept, stats.pruned_improved) = cnt[1:6]
        stats.forced_kept += cnt[6]
        if early_abandon:
            stats.dtw_abandoned = cnt[7]
    stats.n_dtw = int(pair_d.shape[0])
    if timer.enabled:
        stats.stage_seconds = dict(timer.timings)
    return (out_ids.numpy().astype(np.int64), out_d.numpy(),
            n_final.numpy().astype(np.int64), n_union, stats)
