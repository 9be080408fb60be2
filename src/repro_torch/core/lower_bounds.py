"""DTW lower bounds — the branch-and-bound machinery of the UCR suite,
counterpart of ``repro.core.lower_bounds``.

LB_Kim (O(1)), LB_Keogh (O(m)), LB_Keogh2 (O(m), from precomputed
candidate envelopes) and Lemire's two-pass LB_Improved, all on squared
costs so they compare directly with ``core.dtw``.  Every bound is a
batched masked tensor op over all candidates; pruning is by boolean mask.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def envelope(x: torch.Tensor, radius: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Upper/lower envelope within a Sakoe-Chiba band, x (..., m):
    U_i = max(x[i-r : i+r+1]), L_i = min(x[i-r : i+r+1]).

    A stride-1 max pool over 2r+1 taps whose padding is -inf, so every
    value is one of the window's own (max and min are exact)."""
    shape = x.shape
    flat = x.to(torch.float32).reshape(-1, 1, shape[-1])
    k = 2 * radius + 1
    upper = F.max_pool1d(flat, k, stride=1, padding=radius)
    lower = -F.max_pool1d(-flat, k, stride=1, padding=radius)
    return upper.reshape(shape), lower.reshape(shape)


def lb_kim(query: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """LB_Kim (first/last point), squared.  query broadcasts against
    candidates (..., m) -> (...,)."""
    first = candidates[..., 0] - query[..., 0]
    last = candidates[..., -1] - query[..., -1]
    return first * first + last * last


def lb_keogh(upper: torch.Tensor, lower: torch.Tensor,
             candidates: torch.Tensor) -> torch.Tensor:
    """LB_Keogh of candidates against the *query* envelope, squared."""
    above = candidates - upper
    below = lower - candidates
    zero = torch.zeros((), dtype=candidates.dtype, device=candidates.device)
    above = torch.where(candidates > upper, above * above, zero)
    below = torch.where(candidates < lower, below * below, zero)
    return torch.sum(above + below, dim=-1)


def lb_keogh_env(query: torch.Tensor, cand_upper: torch.Tensor,
                 cand_lower: torch.Tensor) -> torch.Tensor:
    """LB_Keogh2 from precomputed *candidate* envelopes, squared."""
    return lb_keogh(cand_upper, cand_lower, query)


def lb_keogh2(query: torch.Tensor, candidates: torch.Tensor,
              radius: int) -> torch.Tensor:
    """LB_Keogh with roles swapped: query against candidate envelopes."""
    upper, lower = envelope(candidates, radius)
    return lb_keogh_env(query, upper, lower)


def lb_improved(query: torch.Tensor, candidates: torch.Tensor, radius: int,
                upper: Optional[torch.Tensor] = None,
                lower: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lemire's two-pass LB_Improved (arXiv 0811.3301), squared.

    Pass 1 is LB_Keogh of the candidate against the query envelope; pass 2
    adds LB_Keogh of the query against the envelope of the candidate
    clipped into the query envelope, H = clip(c, L, U).
    LB_Keogh <= LB_Improved <= DTW.  query broadcasts against candidates.
    """
    if upper is None:
        upper, lower = envelope(query, radius)
    pass1 = lb_keogh(upper, lower, candidates)
    h = torch.minimum(torch.maximum(candidates, lower), upper)
    h_upper, h_lower = envelope(h, radius)
    return pass1 + lb_keogh_env(query, h_upper, h_lower)


def lb_improved_pairs(q_rows: torch.Tensor, c_rows: torch.Tensor,
                      radius: int) -> torch.Tensor:
    """Row-aligned LB_Improved: (P, m) x (P, m) -> (P,) — the flattened
    survivor pairs of the batched re-rank, one query per row."""
    return lb_improved(q_rows, c_rows, radius)


def cascade_staged(query: torch.Tensor, candidates: torch.Tensor,
                   radius: int, best_so_far: torch.Tensor,
                   cand_upper: Optional[torch.Tensor] = None,
                   cand_lower: Optional[torch.Tensor] = None):
    """Per-bound survivor masks, cheapest bound first (LB_Kim -> LB_Keogh
    -> LB_Keogh2).

    Batched over queries: query (B, m), candidates (B, C, m),
    best_so_far (B,), candidate envelopes (B, C, m) when precomputed.
    Returns ``(keep_kim, keep_keogh, keep_keogh2)``, each (B, C) bool.
    """
    u, l = envelope(query, radius)
    q = query[:, None, :]
    lb1 = lb_kim(q, candidates)
    lb2 = lb_keogh(u[:, None, :], l[:, None, :], candidates)
    if cand_upper is None:
        cand_upper, cand_lower = envelope(candidates, radius)
    lb3 = lb_keogh_env(q, cand_upper, cand_lower)
    best = best_so_far[:, None]
    return lb1 < best, lb2 < best, lb3 < best


def cascade(query: torch.Tensor, candidates: torch.Tensor, radius: int,
            best_so_far) -> torch.Tensor:
    """UCR-suite survivor mask of one query against a block: query (m,),
    candidates (C, m) -> (C,) bool.  A candidate survives iff every bound
    (LB_Kim, LB_Keogh, LB_Keogh2) is below ``best_so_far``
    (``repro/core/lower_bounds.py:133-147``)."""
    u, l = envelope(query, radius)
    lb1 = lb_kim(query, candidates)
    lb2 = lb_keogh(u, l, candidates)
    lb3 = lb_keogh2(query, candidates, radius)
    return torch.maximum(torch.maximum(lb1, lb2), lb3) < best_so_far


def cascade_stats(query: torch.Tensor, candidates: torch.Tensor,
                  radius: int, best_so_far) -> dict:
    """Per-bound pruning fractions of one (m,) query over (N, m)
    candidates against ``best_so_far`` (the paper's Table 1;
    ``repro/core/lower_bounds.py:172-189``): the share of candidates
    whose LB_Kim, LB_Keogh, LB_Keogh2, LB_Improved, and the largest of
    the four, reach ``best_so_far``.  Keys ``kim``, ``keogh``,
    ``keogh2``, ``improved``, ``combined``; each a 0-d f32 tensor on the
    candidates' device."""
    u, l = envelope(query, radius)
    lb1 = lb_kim(query, candidates)
    lb2 = lb_keogh(u, l, candidates)
    lb3 = lb_keogh2(query, candidates, radius)
    lb4 = lb_improved(query, candidates, radius, u, l)
    n = candidates.shape[0]

    def frac(mask):
        return mask.sum().to(torch.float32) / n
    combined = torch.maximum(torch.maximum(lb1, lb2), torch.maximum(lb3, lb4))
    return dict(kim=frac(lb1 >= best_so_far), keogh=frac(lb2 >= best_so_far),
                keogh2=frac(lb3 >= best_so_far),
                improved=frac(lb4 >= best_so_far),
                combined=frac(combined >= best_so_far))
