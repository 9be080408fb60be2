"""Hierarchical count-sketch over the shingle space (counterpart of
``repro.streaming.count_sketch``).

``rows`` independent (bucket, sign) hash pairs over a ``width``-bin table;
level ``h`` sketches the shingle-id prefix ``id >> (base_bits·h)``, so
heavy hitters are recovered top-down.  Two sketches over disjoint
streams combine by addition.

Hashing is Dietzfelbinger multiply-shift in uint32 arithmetic, as in the
reference: ``(a·x + b) mod 2^32 >> (32 - log2 width)`` for the bucket
and the top bit of an independent multiply-shift for the ±1 sign.
PyTorch's uint32 support is thin, so every uint32 value is held in int64
and each product is reduced mod 2^32 (``core.minhash._mul32``) before the
shift; the ids' arithmetic ``>>`` keeps an invalid -1 at -1 on every
level.  Tables are float32 sums of ±1, exact integers below 2^24, so a
merge is bit-identical to sketching the concatenated stream.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.minhash import _MASK32, _mul32


class CSParams(NamedTuple):
    """Multiply-shift coefficients for ``levels × rows`` hash pairs, each
    (levels, rows) int64 holding a uint32 value; ``bucket_a``/``sign_a``
    are odd."""
    bucket_a: torch.Tensor
    bucket_b: torch.Tensor
    sign_a: torch.Tensor
    sign_b: torch.Tensor

    @property
    def levels(self) -> int:
        return self.bucket_a.shape[0]

    @property
    def rows(self) -> int:
        return self.bucket_a.shape[1]


def num_levels(id_bits: int, width: int, base_bits: int) -> int:
    """Hierarchy depth: enough levels that the coarsest prefix domain
    (``id_bits − base_bits·(levels−1)`` bits) fits the table width."""
    log2w = width.bit_length() - 1
    extra = max(0, id_bits - log2w)
    return 1 + -(-extra // base_bits)          # 1 + ceil(extra / base_bits)


def make_cs_params(generator: torch.Generator, levels: int, rows: int
                   ) -> CSParams:
    """Draw the coefficients uniformly in uint32 on the CPU (the
    reference's distribution, ``count_sketch.py:69-79``)."""
    def u32():
        return torch.randint(0, 1 << 32, (levels, rows), generator=generator,
                             dtype=torch.int64)

    return CSParams(bucket_a=u32() | 1, bucket_b=u32(), sign_a=u32() | 1,
                    sign_b=u32())


def bucket_sign(ids: torch.Tensor, a, b, sa, sb, width: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multiply-shift bucket and ±1 sign of (possibly invalid) ids.

    ``ids`` integer with -1 marking invalid entries; the coefficients
    broadcast against it.  Returns (bucket int32, -1 where invalid; sign
    float32, 0 where invalid), as ``count_sketch.py:82-97``.
    """
    shift = 32 - (width.bit_length() - 1)
    x = ids.to(torch.int64) & _MASK32                 # the uint32 view
    bkt = ((_mul32(x, a) + b) & _MASK32) >> shift
    top = ((_mul32(x, sa) + sb) & _MASK32) >> 31
    sgn = 1.0 - 2.0 * top.to(torch.float32)
    valid = ids >= 0
    return (torch.where(valid, bkt, -1).to(torch.int32),
            torch.where(valid, sgn, 0.0))


def _scatter_tables(bkt: torch.Tensor, sgn: torch.Tensor, width: int
                    ) -> torch.Tensor:
    """(T, S) buckets and signs -> (T, width) tables; -1 goes to a dump
    bin that is sliced off."""
    tgt = torch.where(bkt >= 0, bkt, width).to(torch.int64)
    tables = torch.zeros((bkt.shape[0], width + 1), dtype=torch.float32,
                         device=bkt.device)
    return tables.scatter_add_(1, tgt, sgn)[:, :width]


def update(agg: torch.Tensor, ids: torch.Tensor, params: CSParams,
           base_bits: int) -> torch.Tensor:
    """Fold shingle ids (any shape, -1 invalid) into a hierarchical sketch
    ``agg`` (levels, rows, width) f32; returns the new aggregate
    (``count_sketch.py:100-127``)."""
    levels, rows, width = agg.shape
    flat = ids.reshape(-1).to(torch.int64)
    shifts = base_bits * torch.arange(levels, device=flat.device)
    prefixes = flat[None, :] >> shifts[:, None]                # (lv, S)
    bkt, sgn = bucket_sign(
        prefixes[:, None, :], params.bucket_a[:, :, None],
        params.bucket_b[:, :, None], params.sign_a[:, :, None],
        params.sign_b[:, :, None], width)                      # (lv, R, S)
    contrib = _scatter_tables(bkt.reshape(levels * rows, -1),
                              sgn.reshape(levels * rows, -1), width)
    return agg + contrib.reshape(levels, rows, width)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine sketches of disjoint streams: addition, exact."""
    return a + b


def _median_rows(x: torch.Tensor) -> torch.Tensor:
    """Median over dim 0 as ``jnp.median`` takes it: the midpoint of the
    two middle values, ``(lo + hi) * 0.5``."""
    n = x.shape[0]
    srt = torch.sort(x, dim=0).values
    return (srt[(n - 1) // 2] + srt[n // 2]) * 0.5


def estimate(agg: torch.Tensor, ids: torch.Tensor, params: CSParams,
             base_bits: int, level: int = 0) -> torch.Tensor:
    """Median-of-rows frequency estimate of prefix ids at ``level`` (the
    caller shifts; raw shingle ids at level 0); -1 ids estimate 0
    (``count_sketch.py:139-154``)."""
    width = agg.shape[-1]
    ids = ids.to(agg.device)
    bkt, sgn = bucket_sign(ids[None, :], params.bucket_a[level][:, None],
                           params.bucket_b[level][:, None],
                           params.sign_a[level][:, None],
                           params.sign_b[level][:, None], width)   # (R, S)
    reads = agg[level].gather(1, bkt.clamp(min=0).to(torch.int64))
    est = _median_rows(sgn * reads)
    return torch.where(ids >= 0, est, 0.0)


def find_heavy_hitters(agg: torch.Tensor, params: CSParams, *,
                       base_bits: int, id_bits: int, threshold: float
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Shingle ids whose estimated frequency clears ``threshold``, by
    top-down refinement from the coarsest level; (ids, estimates) sorted
    by estimate descending (``count_sketch.py:157-185``)."""
    levels = int(agg.shape[0])
    top_bits = max(id_bits - base_bits * (levels - 1), 0)
    cand = np.arange(1 << top_bits, dtype=np.int64)
    for level in range(levels - 1, -1, -1):
        if cand.size == 0:
            return (np.empty(0, np.int64), np.empty(0, np.float32))
        ests = estimate(agg, torch.from_numpy(cand), params,
                        base_bits=base_bits, level=level).cpu().numpy()
        keep = ests >= threshold
        cand, ests = cand[keep], ests[keep]
        if level > 0:
            cand = (cand[:, None] * (1 << base_bits)
                    + np.arange(1 << base_bits, dtype=np.int64)).reshape(-1)
    order = np.argsort(-ests, kind="stable")
    return cand[order], ests[order].astype(np.float32)


def l2_estimate(agg: torch.Tensor, level: int = 0) -> float:
    """Median-of-rows ‖f‖₂ estimate at ``level``."""
    return float(_median_rows(torch.sqrt(torch.sum(agg[level] ** 2, -1))))
