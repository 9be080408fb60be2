"""Step 2 of SSH — n-gram shingles over the bit-profile (§4.2),
counterpart of ``repro.core.shingle``.

Every length-n substring of a bit string is a shingle, packed into an id
``sum_j bits[i+j] << j``; the weighted set is the dense histogram of ids
over the shingle space F·2^n (filter f's ids are offset by f << n).
Integer arithmetic throughout, so every output is exact.
"""
from __future__ import annotations

from typing import Optional

import torch


def shingle_space(n: int, num_filters: int = 1) -> int:
    return num_filters * (1 << n)


def pack_ngrams(bits: torch.Tensor, n: int) -> torch.Tensor:
    """(..., N_B) uint8 in {0,1} -> ids (..., N_B - n + 1) int32."""
    n_b = bits.shape[-1]
    if n_b < n:
        raise ValueError(f"bit string length {n_b} < shingle length {n}")
    out = n_b - n + 1
    acc = torch.zeros(bits.shape[:-1] + (out,), dtype=torch.int32,
                      device=bits.device)
    for j in range(n):
        acc += bits[..., j:j + out].to(torch.int32) << j
    return acc


def shingle_ids(bits: torch.Tensor, n: int,
                valid_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat shingle ids of a bit-profile batch: (B, N_B, F) -> (B, F·S)
    int64, S = N_B - n + 1.

    With ``valid_rows`` (B,), shingle i of a row counts only when it lies
    inside the row's first ``valid_rows`` bits (i + n <= valid_rows, the
    fused multiprobe mask); masked shingles get the sentinel id F·2^n.
    """
    b, n_b, f = bits.shape
    ids = pack_ngrams(bits.transpose(1, 2), n).to(torch.int64)  # (B, F, S)
    ids += (torch.arange(f, device=bits.device) << n)[None, :, None]
    if valid_rows is not None:
        s = ids.shape[-1]
        keep = torch.arange(s, device=bits.device)[None, :] \
            < (valid_rows.to(bits.device)[:, None] - n + 1)
        ids = torch.where(keep[:, None, :], ids, shingle_space(n, f))
    return ids.reshape(b, -1)


def histogram_from_ids(ids: torch.Tensor, dim: int) -> torch.Tensor:
    """(B, S) ids (sentinel ``dim`` dropped) -> (B, dim) int32 counts."""
    counts = torch.zeros((ids.shape[0], dim + 1), dtype=torch.int32,
                         device=ids.device)
    counts.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.int32))
    return counts[:, :dim]


def shingle_histogram(bits: torch.Tensor, n: int) -> torch.Tensor:
    """Weighted set S_X: bits (N_B, F) uint8 -> counts (F·2^n,) int32."""
    return histogram_from_ids(shingle_ids(bits[None], n),
                              shingle_space(n, bits.shape[1]))[0]


def shingle_histogram_masked(bits: torch.Tensor, n: int,
                             valid_rows: int) -> torch.Tensor:
    """Histogram over only the shingles fully inside the first
    ``valid_rows`` bits of each filter column: (N_B, F) -> (F·2^n,)."""
    ids = shingle_ids(bits[None], n,
                      torch.tensor([valid_rows], device=bits.device))
    return histogram_from_ids(ids, shingle_space(n, bits.shape[1]))[0]


def shingle_histogram_batch(bits: torch.Tensor, n: int) -> torch.Tensor:
    """Weighted sets of a batch: bits (B, N_B, F) -> counts (B, F·2^n)
    int32 (``repro/core/shingle.py:88-107``)."""
    return histogram_from_ids(shingle_ids(bits, n),
                              shingle_space(n, bits.shape[2]))


def weighted_jaccard(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Generalised weighted Jaccard J(a, b) = Σ min / Σ max over the last
    axis, f32, 0 where both are empty (paper eq. 2)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    num = torch.minimum(a, b).sum(-1)
    den = torch.maximum(a, b).sum(-1)
    return torch.where(den > 0, num / den, torch.zeros_like(den))
