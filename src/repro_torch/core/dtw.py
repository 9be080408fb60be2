"""Dynamic Time Warping in PyTorch (counterpart of ``repro.core.dtw``).

Squared-difference DTW (paper §2.1) with an optional Sakoe-Chiba band of
radius ``band`` (|i - j| <= band).  Series of different lengths m_x and
m_y are aligned with the band measured around the scaled diagonal: cell
(i, j) is in the band when |i - j·m_x/m_y| <= max(band, |m_x - m_y| +
band) (``repro/core/dtw.py:77-115``).

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


def znormalize(x: torch.Tensor, axis: int = -1,
               eps: float = 1e-8) -> torch.Tensor:
    """Z-normalise a time series (UCR-suite convention): (x - mean) /
    (population std + eps) along ``axis``."""
    x = x.to(torch.float32)
    mu = x.mean(dim=axis, keepdim=True)
    sd = x.std(dim=axis, correction=0, keepdim=True)
    return (x - mu) / (sd + eps)


def _rect_band(m_x: int, m_y: int, band: Optional[int],
               dev: torch.device) -> torch.Tensor:
    """(m_x, m_y) bool: the cells of the band around the scaled diagonal,
    tested in float64 as ``dtw_dp_reference`` tests them."""
    if band is None:
        return torch.ones((m_x, m_y), dtype=torch.bool, device=dev)
    width = max(band, abs(m_x - m_y) + band)
    i = torch.arange(m_x, dtype=torch.float64, device=dev)
    j = torch.arange(m_y, dtype=torch.float64, device=dev)
    return (i[:, None] - j[None, :] * (m_x / m_y)).abs() <= width


def _dtw_rect(x: torch.Tensor, ys: torch.Tensor,
             band: Optional[int] = None) -> torch.Tensor:
    """Squared DTW of one (m_x,) series against each row of ys (C, m_y),
    any lengths -> (C,) f32, the band around the scaled diagonal.

    The reference computes this case in jnp, outside any Pallas kernel,
    so there is no kernel here either: a plain anti-diagonal DP over the
    whole (m_x, m_y) grid on the inputs' device, each cell ``(x_i -
    y_j)^2 + min`` of its three neighbours with every operation rounded
    once, as the equal-length wavefront rounds it.  Out-of-band cells
    hold ``BIG``.
    """
    x = x.to(torch.float32)
    ys = ys.to(torch.float32)
    m_x, (c, m_y) = x.shape[0], ys.shape
    dev = x.device
    inband = _rect_band(m_x, m_y, band, dev)
    i = torch.arange(m_x, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    big_col = torch.full((c, 1), BIG, dtype=torch.float32, device=dev)
    prev1 = torch.full((c, m_x), BIG, dtype=torch.float32, device=dev)
    prev2 = prev1.clone()
    for d in range(m_x + m_y - 1):
        j = d - i
        jc = j.clamp(0, m_y - 1)
        valid = (j >= 0) & (j < m_y) & inband[i, jc]
        diff = x[None, :] - ys[:, jc]
        cost = diff * diff
        up = torch.cat([big_col, prev1[:, :-1]], 1)       # (i - 1, j)
        diag = torch.cat([big_col, prev2[:, :-1]], 1)     # (i - 1, j - 1)
        best = torch.minimum(torch.minimum(up, prev1), diag)
        if d == 0:
            best[:, 0] = 0.0                # the path starts at (0, 0)
        cur = torch.where(valid, torch.minimum(cost + best, big), big)
        prev2, prev1 = prev1, cur
    return prev1[:, m_x - 1]


def dtw(x: torch.Tensor, y: torch.Tensor,
        band: Optional[int] = None) -> torch.Tensor:
    """Exact (optionally Sakoe-Chiba banded) squared-DTW cost of an
    (m_x,) and an (m_y,) series, as a 0-d f32 tensor on their device.
    Equal lengths take the plain wavefront (radius ``band``, m - 1 when
    None); different lengths :func:`_dtw_rect`, the band measured around
    the scaled diagonal.  Take ``sqrt`` for the paper's distance
    (:func:`dtw_distance`)."""
    if x.dim() != 1 or y.dim() != 1:
        raise ValueError("dtw takes two 1-D series, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.shape == y.shape:
        return dtw_banded_pairs(x[None], y[None], band)[0]
    return _dtw_rect(x, y[None], band)[0]


def dtw_batch(query: torch.Tensor, candidates: torch.Tensor,
              band: Optional[int] = None) -> torch.Tensor:
    """DTW of one (m_x,) query against a (C, m_y) block -> (C,) f32.
    Equal lengths go through ``ops.dtw_rerank``: the ``dtw_wavefront``
    kernel on a CUDA tensor, its plain version on the CPU (``band=None``
    is radius m - 1); other lengths through :func:`_dtw_rect`."""
    from repro_torch.kernels import ops    # kernels.ref imports this module
    query = query.to(torch.float32)
    candidates = candidates.to(torch.float32)
    if candidates.shape[1] != query.shape[0]:
        return _dtw_rect(query, candidates, band)
    if candidates.shape[0] == 0:
        return torch.zeros(0, dtype=torch.float32, device=candidates.device)
    return ops.dtw_rerank(query.contiguous(), candidates.contiguous(), band)


def dtw_banded(x: torch.Tensor, y: torch.Tensor, band: int,
               threshold=None) -> torch.Tensor:
    """Equal-length banded squared DTW of two (m,) series, radius
    min(band, m - 1), as a 0-d f32 tensor.  With ``threshold`` the
    contract is *exact value if DTW <= threshold, else BIG*
    (``repro/core/dtw.py:159-194``); ``None`` returns the exact value."""
    if x.shape != y.shape or x.dim() != 1:
        raise ValueError("dtw_banded requires two (m,) series of equal "
                         f"length, got {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    return dtw_banded_batch(x, y[None], band, threshold)[0]


def dtw_banded_batch(query: torch.Tensor, candidates: torch.Tensor,
                     band: int, threshold=None) -> torch.Tensor:
    """Banded DTW of one (m,) query against a (C, m) block -> (C,) f32,
    with the threshold contract of :func:`dtw_banded` (``threshold`` a
    scalar or (C,)); the ``dtw_wavefront`` kernel on a CUDA tensor, its
    plain version on the CPU."""
    from repro_torch.kernels import ops    # kernels.ref imports this module
    query = query.to(torch.float32)
    candidates = candidates.to(torch.float32)
    if candidates.dim() != 2 or candidates.shape[1] != query.shape[0]:
        raise ValueError("dtw_banded_batch requires (m,) and (C, m), got "
                         f"{tuple(query.shape)} and "
                         f"{tuple(candidates.shape)}")
    c = candidates.shape[0]
    if c == 0:
        return torch.zeros(0, dtype=torch.float32, device=candidates.device)
    thr = None
    if threshold is not None:               # a scalar or (C,) -> (C,)
        thr = torch.as_tensor(threshold, dtype=torch.float32).to(
            candidates.device).reshape(-1).expand(c).contiguous()
    return ops.dtw_rerank(query.contiguous(), candidates.contiguous(), band,
                          thr)


#: pairs per ``dtw_pairwise`` launch: bounds the two (P, m) row blocks
#: (2^16 pairs of length 512 are 134 MB a block)
PAIRWISE_CHUNK = 1 << 16


def dtw_pairwise(xs: torch.Tensor, ys: torch.Tensor,
                 band: Optional[int] = None) -> torch.Tensor:
    """All-pairs DTW: xs (A, m_x), ys (B, m_y) -> (A, B) f32.  Equal
    lengths send the A·B row pairs through ``ops.dtw_rerank_pairs`` (the
    ``dtw_wavefront_pairs`` kernel on CUDA, its plain version on the
    CPU) in launches of at most :data:`PAIRWISE_CHUNK` pairs, which bound
    the gathered (P, m) blocks; other lengths run :func:`_dtw_rect` a row
    of xs at a time."""
    from repro_torch.kernels import ops    # kernels.ref imports this module
    xs = xs.to(torch.float32)
    ys = ys.to(torch.float32)
    a, b = xs.shape[0], ys.shape[0]
    if xs.shape[1] != ys.shape[1]:
        rows = [_dtw_rect(x, ys, band) for x in xs]
        return torch.stack(rows) if rows else xs.new_zeros((0, b))
    out = torch.empty(a * b, dtype=torch.float32, device=xs.device)
    for lo in range(0, a * b, PAIRWISE_CHUNK):
        k = torch.arange(lo, min(lo + PAIRWISE_CHUNK, a * b),
                         device=xs.device)
        out[lo:lo + k.numel()] = ops.dtw_rerank_pairs(
            xs[k // b].contiguous(), ys[k % b].contiguous(), band)
    return out.reshape(a, b)


def dtw_distance(x: torch.Tensor, y: torch.Tensor,
                 band: Optional[int] = None) -> torch.Tensor:
    """Paper-convention distance: sqrt of the summed squared path cost."""
    return torch.sqrt(dtw(x, y, band))


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
