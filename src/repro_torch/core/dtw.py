"""Dynamic Time Warping in PyTorch (counterpart of ``repro.core.dtw``).

Squared-difference DTW (paper §2.1) with an optional Sakoe-Chiba band of
radius ``band`` (|i - j| <= band), on equal-length series.

The plain version here is an anti-diagonal wavefront: cell (i, j) on
diagonal d = i + j depends only on diagonals d-1 and d-2, so each of the
2m-1 steps is one vectorised update over every pair and every band slot.
It is the arithmetic of the CUDA kernel ``csrc/dtw_wavefront.cu`` op for
op — ``diff = q_i - x_j``, ``cost = diff * diff``, ``D = cost + best``,
each rounded once — so the kernel and this function agree bit for bit.
The reference's window DP reassociates the same sums through a
cumsum/cummin identity; the two agree to float32 rounding.

The threshold contract (``repro/core/dtw.py:214``): with ``threshold``
the result is the exact cost where it is <= threshold and ``BIG``
elsewhere (strict ``>``, so ties survive).  A pair is abandoned once the
minimum over its two live anti-diagonals exceeds its threshold — a sound
bound, since every warping path crosses one of any two adjacent
anti-diagonals.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Large-but-finite "infinity" (float32 1e30): survives a few additions of
# itself without overflowing.
BIG = 1e30


def radius(band: Optional[int], m: int) -> int:
    """Sakoe-Chiba radius for length-m series; ``None`` is unconstrained
    (radius m - 1 covers every cell of an equal-length DP)."""
    return m - 1 if band is None else min(int(band), m - 1)


def dtw_pairs_work(queries: torch.Tensor, candidates: torch.Tensor,
                   band: Optional[int],
                   threshold: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-aligned banded DTW plus the work it took.

    (P, m) x (P, m) -> (values (P,) f32, cells (P,) int64), where
    ``cells`` counts the DP cells each pair computed before it finished or
    was abandoned — the count a roofline bound of the kernel needs.
    ``threshold`` is a scalar or (P,).
    """
    q = queries.to(torch.float32)
    x = candidates.to(torch.float32)
    p, m = q.shape
    if x.shape != q.shape:
        raise ValueError(f"row-aligned pairs required, got {tuple(q.shape)} "
                         f"and {tuple(x.shape)}")
    dev = q.device
    r = radius(band, m)
    bw = 2 * r + 2
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    u = torch.arange(bw, device=dev)
    prev1 = torch.full((p, bw), BIG, dtype=torch.float32, device=dev)
    prev2 = prev1.clone()
    big_col = prev1[:, :1].clone()
    thr = None
    if threshold is not None:
        thr = torch.as_tensor(threshold, dtype=torch.float32,
                              device=dev).expand(p)
    alive = torch.ones(p, dtype=torch.bool, device=dev)
    cells = torch.zeros(p, dtype=torch.int64, device=dev)
    for d in range(2 * m - 1):
        i = d // 2 - r + u                  # query index of slot u
        j = d - i                           # candidate index of slot u
        valid = (i >= 0) & (i < m) & (j >= 0) & (j < m) & \
            ((i - j).abs() <= r)
        diff = q[:, i.clamp(0, m - 1)] - x[:, j.clamp(0, m - 1)]
        cost = diff * diff
        shifted_down = torch.cat([big_col, prev1[:, :-1]], 1)  # a[u-1]
        shifted_up = torch.cat([prev1[:, 1:], big_col], 1)     # a[u+1]
        top = prev1 if d % 2 == 0 else shifted_down
        left = shifted_up if d % 2 == 0 else prev1
        best = torch.minimum(torch.minimum(top, left), prev2)
        if d == 0:
            best[:, r] = 0.0                # cell (0, 0) sits at u = r
        cur = torch.where(valid, torch.minimum(cost + best, big), big)
        cells += alive * valid.sum()
        prev2, prev1 = prev1, cur
        if thr is not None:
            bound = torch.minimum(prev1.min(1).values, prev2.min(1).values)
            alive &= ~(bound > thr)
            if d % 8 == 7 and not bool(alive.any()):
                break                       # every pair abandoned
    out = prev1[:, r]
    if thr is not None:
        out = torch.where(~alive | (out > thr), big, out)
    return out, cells


def dtw_banded_pairs(queries: torch.Tensor, candidates: torch.Tensor,
                     band: Optional[int],
                     threshold: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Row-aligned banded squared DTW: (P, m) x (P, m) -> (P,) f32."""
    return dtw_pairs_work(queries, candidates, band, threshold)[0]


def dtw(x: torch.Tensor, y: torch.Tensor,
        band: Optional[int] = None) -> torch.Tensor:
    """Exact (optionally banded) squared-DTW cost of two equal-length
    series, as a 0-d tensor."""
    if x.shape != y.shape or x.dim() != 1:
        raise ValueError("dtw takes two (m,) series of equal length, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    return dtw_banded_pairs(x[None], y[None], band)[0]


def dtw_dp_reference(x, y, band=None):
    """O(m^2) float64 DP, for tests only (the 'obviously correct' DTW)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    m_x, m_y = len(x), len(y)
    D = np.full((m_x, m_y), np.inf)
    slope = m_x / m_y
    for j in range(m_y):
        for i in range(m_x):
            if band is not None:
                width = max(band, abs(m_x - m_y) + band)
                if abs(i - j * slope) > width:
                    continue
            c = (x[i] - y[j]) ** 2
            if i == 0 and j == 0:
                D[i, j] = c
            else:
                best = np.inf
                if i > 0:
                    best = min(best, D[i - 1, j])
                if j > 0:
                    best = min(best, D[i, j - 1])
                if i > 0 and j > 0:
                    best = min(best, D[i - 1, j - 1])
                D[i, j] = c + best
    return D[-1, -1]
