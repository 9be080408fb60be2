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
from repro_torch.core.dtw import BIG, PAIRWISE_CHUNK
from repro_torch.core.index import SSHIndex
from repro_torch.kernels import ops
from repro_torch.kernels.dtw_wavefront import band_cells


@dataclasses.dataclass
class SearchStats:
    """Re-rank pruning counters; the stage counters attribute each
    pruned candidate to the first bound that fired, seeds exempt, so
    ``n_in == pruned_kim + pruned_keogh + pruned_keogh2 +
    pruned_improved + n_dtw``.  ``dtw_abandoned`` counts DTW pairs the
    threshold abandoned.  ``backend`` names the route ("cuda" kernels or
    "cpu" plain versions).  The fleet tier (``repro_torch.fleet``) adds
    its resilience counters: shard calls ``hedged`` and ``failovers``,
    and ``degraded`` when any shard answered from a non-primary
    replica.  ``n_windows`` counts the sliding windows a subsequence
    search probed (``repro_torch.subseq``), 0 for whole-series search.
    With stage timings on (``bench.timing.StageTimer``), ``stage_seconds``
    has the stages and ``span_seconds`` every span; ``dtw_cells`` counts
    the DP cells the batched searcher's pair DTW computed before each
    pair ended or was abandoned, and ``dtw_band_cells`` the band's cells
    of the same pairs (0 and 0 with timings off)."""
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
    span_seconds: Optional[Dict[str, Dict[str, Optional[float]]]] = None
    index_bytes: Optional[int] = None
    sig_cache_hit: int = 0            # encodes served by the LRU
    hedged: int = 0                   # fleet: shard calls hedged
    failovers: int = 0                # fleet: shard calls failed over
    degraded: bool = False            # fleet: a non-primary answered
    n_windows: int = 0                # subseq: windows; 0 whole-series
    dtw_cells: int = 0                # DP cells the pair DTW computed
    dtw_band_cells: int = 0           # band cells of the same pairs
    topc_tie_slots: int = 0           # top-C slots the tie order filled

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
                   band: Optional[int], backend: str = "auto",
                   threshold=None) -> torch.Tensor:
    """One query against a candidate block in one dispatch, (m,) x (C, m)
    -> (C,); ``threshold`` (scalar or (C,)) is the early-abandon
    contract.  ``backend`` is checked against the candidates' device,
    which picks the route (``ops.check_backend``)."""
    ops.check_backend(backend, candidates.device)
    if candidates.shape[0] == 0:
        return torch.zeros(0, dtype=torch.float32, device=candidates.device)
    return ops.dtw_rerank(query.contiguous(), candidates.contiguous(), band,
                          threshold)


#: the reference's pair chunks (``repro/core/rerank.py:49-50``), which
#: keep XLA to two compiled programs; nothing recompiles here, so the
#: port's pair functions chunk at :data:`~repro_torch.core.dtw.PAIRWISE_CHUNK`
PAIR_CHUNK = 256
PAIR_CHUNK_SMALL = 32


def _pair_spans(p: int):
    """[(lo, hi), ...]: P pairs cut into launches of at most
    ``PAIRWISE_CHUNK``, the bound on a launch's (P, m) row blocks that
    ``dtw_pairwise`` uses."""
    return [(lo, min(lo + PAIRWISE_CHUNK, p))
            for lo in range(0, p, PAIRWISE_CHUNK)]


def dtw_pairs_chunked(q_rows: torch.Tensor, c_rows: torch.Tensor,
                      band: Optional[int], backend: str = "auto",
                      threshold=None) -> np.ndarray:
    """Row-aligned pair DTW (P, m) x (P, m) -> (P,) f32 as a host array
    (``repro/core/rerank.py:146-186``), through ``ops.dtw_rerank_pairs``
    (the ``dtw_wavefront_pairs`` kernel on CUDA tensors, its plain version
    on the CPU) in launches of at most ``PAIRWISE_CHUNK`` pairs.  The
    values are lane-independent, so they equal the reference's padded
    256/32-pair chunks.  ``threshold`` (scalar or (P,)) applies the
    early-abandon contract.  ``backend`` is the ``SearchConfig`` knob
    ("jnp" names the plain versions, on the CPU only)."""
    ops.check_backend(backend, q_rows.device)
    p = int(q_rows.shape[0])
    if not p:
        return np.zeros(0, np.float32)
    q, c = q_rows.to(torch.float32), c_rows.to(torch.float32)
    thr = None
    if threshold is not None:
        thr = torch.as_tensor(threshold, dtype=torch.float32).to(
            q.device).reshape(-1).expand(p)
    out = [ops.dtw_rerank_pairs(q[lo:hi].contiguous(), c[lo:hi].contiguous(),
                                band, None if thr is None
                                else thr[lo:hi].contiguous())
           for lo, hi in _pair_spans(p)]
    return torch.cat(out).cpu().numpy()


def lb_improved_pairs_chunked(q_rows: torch.Tensor, c_rows: torch.Tensor,
                              band: int) -> np.ndarray:
    """Row-aligned LB_Improved (P, m) x (P, m) -> (P,) f32 as a host
    array (``repro/core/rerank.py:189-216``), in :func:`dtw_pairs_chunked`'s
    launches; the bound is lane-independent, so they do not change a
    value."""
    p = int(q_rows.shape[0])
    if not p:
        return np.zeros(0, np.float32)
    q, c = q_rows.to(torch.float32), c_rows.to(torch.float32)
    return torch.cat([lb.lb_improved_pairs(q[lo:hi], c[lo:hi], band)
                      for lo, hi in _pair_spans(p)]).cpu().numpy()


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
           backend: str = "auto", seed_size: Optional[int] = None,
           early_abandon: bool = True, timer: StageTimer = DISABLED):
    """Candidate ids (C,) int64 -> (ids (k,) int64, dists (k,) f32, stats)
    as host arrays, best first; stage 2+3 of Alg. 2 for one query.

    The threshold is the topk-th best seed DTW, always a valid upper
    bound on the final k-th distance, so no pruned or abandoned
    candidate can belong to the answer.  ``backend`` is checked against
    the index's device, which picks the route.
    """
    dev = index.device
    ops.check_backend(backend, dev)
    cands = index.series[cand_ids]
    n_hash = int(cand_ids.shape[0])
    stats = SearchStats(n_in=n_hash, backend=dev.type)
    thr = None
    counters = None

    if use_lb_cascade and band is not None and n_hash > topk:
        with timer.stage("lb"):
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
        with timer.stage("lb_improved"):
            # Lemire's two-pass bound over the cascade survivors only
            lbi = lb.lb_improved(query, cands, band)
            forced_surv = forced[keep]
            pass123_surv = (k1 & k2 & k3)[keep]
            below = lbi < best
            keep2 = below | forced_surv
            counters = torch.cat([stage_counts, torch.stack([
                (~keep2).sum(), (forced_surv & pass123_surv & ~below).sum()])])
            cand_ids, cands = cand_ids[keep2], cands[keep2]
        if early_abandon:
            thr = best
    stats.n_dtw = int(cands.shape[0])

    with timer.stage("dtw"):
        d = dtw_candidates(query, cands, band, threshold=thr)
        k = min(topk, int(cands.shape[0]))
        # stable ascending sort: ties to the lowest candidate slot, as
        # lax.top_k(-d) breaks them
        order = torch.sort(d, stable=True).indices[:k]
        extra = [] if counters is None else [counters]
        if thr is not None:
            extra.append((d >= BIG * 0.5).sum()[None])
        host = [t.cpu() for t in (cand_ids[order], d[order], *extra)]
    if counters is not None:
        (stats.pruned_kim, stats.pruned_keogh, stats.pruned_keogh2,
         stats.forced_kept, stats.pruned_improved, more) = host[2].tolist()
        stats.forced_kept += more
    if thr is not None:
        stats.dtw_abandoned = int(host[-1][0])
    timer.report(stats)
    return host[0].numpy().astype(np.int64), host[1].numpy(), stats


def dtw_pairs(q_rows: torch.Tensor, c_rows: torch.Tensor,
              band: Optional[int],
              threshold: Optional[torch.Tensor] = None,
              cells: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-aligned pair DTW over all P pairs in one dispatch:
    (P, m) x (P, m) -> (P,); ``cells`` (P,) int32, when given, receives
    the DP cells each pair computed (``ops.dtw_rerank_pairs``)."""
    if q_rows.shape[0] == 0:
        return torch.zeros(0, dtype=torch.float32, device=q_rows.device)
    return ops.dtw_rerank_pairs(q_rows.contiguous(), c_rows.contiguous(),
                                band, threshold, cells=cells)


def _dtw_counted(q_rows: torch.Tensor, c_rows: torch.Tensor,
                 band: Optional[int], threshold: Optional[torch.Tensor],
                 count: bool):
    """:func:`dtw_pairs` -> (P,) distances and, with ``count``, the sum
    of the pairs' computed cells (a 0-d tensor on the device), else
    None.  Without ``count`` it passes no ``cells``, so a stand-in for
    ``dtw_pairs`` of the four-argument form still fits."""
    if not count:
        return dtw_pairs(q_rows, c_rows, band, threshold), None
    cells = torch.zeros(q_rows.shape[0], dtype=torch.int32,
                        device=q_rows.device)
    return (dtw_pairs(q_rows, c_rows, band, threshold, cells=cells),
            cells.sum())


def rerank_batch(queries: torch.Tensor, ids: torch.Tensor,
                 valid: torch.Tensor, index: SSHIndex, topk: int,
                 band: Optional[int], *, use_lb_cascade: bool = True,
                 backend: str = "auto", seed_size: Optional[int] = None,
                 early_abandon: bool = True, timer: StageTimer = DISABLED,
                 tie_slots: Optional[torch.Tensor] = None):
    """Batched stage 2+3 over per-query candidate blocks.

    queries (B, m); ids (B, C) int64 candidate ids; valid (B, C) bool, all
    on the index's device.  ``tie_slots``, a 0-d device count of the
    probe's top-C slots filled from each query's threshold count, reaches
    ``stats.topc_tie_slots`` in the block's one copy to the host.  Returns host arrays (out_ids (B, k) int64,
    out_d (B, k) f32, n_final (B,) int64), n_union and the stats; filler
    slots (fewer survivors than topk) carry id -1 / dist BIG.
    ``backend`` is checked against the index's device, which picks the
    route.
    """
    dev = index.device
    ops.check_backend(backend, dev)
    b, c = ids.shape
    n_hash = valid.sum(1)                                      # (B,)
    stats = SearchStats(backend=dev.type)
    k_out = min(topk, c)
    seed_k = min(max(seed_size or 0, topk), c)
    cascade_on = use_lb_cascade and band is not None
    thr_rows = None
    counters = [valid.sum()]
    seed_cells = None

    if cascade_on:
        with timer.stage("lb"):
            seed_ids = ids[:, :seed_k]
            seed_d, seed_cells = _dtw_counted(
                queries.repeat_interleave(seed_k, 0),
                index.series[seed_ids.reshape(-1)], band, None,
                timer.enabled)
            seed_d = seed_d.reshape(b, seed_k)
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
    else:
        ok = valid.clone()

    # flattened survivor pairs, row-major like the reference's np.nonzero
    rows_idx, cols_idx = torch.nonzero(ok, as_tuple=True)
    pair_ids = ids[rows_idx, cols_idx]
    c_rows = index.series[pair_ids]                            # (P, m)
    q_rows = queries[rows_idx]                                 # (P, m)

    if cascade_on:
        with timer.stage("lb_improved"):
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

    with timer.stage("dtw"):
        thr_pairs = (thr_rows[rows_idx]
                     if (cascade_on and early_abandon) else None)
        pair_d, cells = _dtw_counted(q_rows, c_rows, band, thr_pairs,
                                     timer.enabled)            # (P,)
        if thr_pairs is not None:
            counters.append((pair_d >= BIG * 0.5).sum())
        if cells is not None:          # the seed's and the survivors'
            counters.append(cells if seed_cells is None
                            else cells + seed_cells)
        cand_d = torch.full((b, c), BIG, dtype=torch.float32, device=dev)
        cand_d[rows_idx, cols_idx] = pair_d
        # stable ascending sort: ties go to the lowest candidate slot, as
        # lax.top_k(-d) breaks them
        out_d, order = torch.sort(cand_d, dim=1, stable=True)
        out_d, order = out_d[:, :k_out], order[:, :k_out]
        out_ids = torch.where(out_d < BIG * 0.5, ids.gather(1, order), -1)
        n_final = ok.sum(1)
        n_union = torch.unique(pair_ids).numel()
        if tie_slots is not None:
            counters.append(tie_slots)
        host = [t.cpu() for t in (out_ids, out_d, n_final,
                                  torch.stack(counters))]
    out_ids, out_d, n_final, cnt = host
    cnt = cnt.tolist()
    if tie_slots is not None:
        stats.topc_tie_slots = cnt.pop()
    stats.n_in = cnt[0]
    if cascade_on:
        (stats.pruned_kim, stats.pruned_keogh, stats.pruned_keogh2,
         stats.forced_kept, stats.pruned_improved) = cnt[1:6]
        stats.forced_kept += cnt[6]
        if early_abandon:
            stats.dtw_abandoned = cnt[7]
    stats.n_dtw = int(pair_d.shape[0])
    if timer.enabled:
        m = int(queries.shape[1])
        stats.dtw_cells = cnt[-1]
        n_pairs = int(pair_d.shape[0]) + (0 if seed_cells is None
                                          else b * seed_k)
        stats.dtw_band_cells = n_pairs * band_cells(
            m, m - 1 if band is None else min(band, m - 1))
    timer.report(stats)
    return (out_ids.numpy().astype(np.int64), out_d.numpy(),
            n_final.numpy().astype(np.int64), n_union, stats)
