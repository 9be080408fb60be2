"""Plain PyTorch versions of the CUDA kernels (counterpart of
``repro.kernels.ref``).

Each ``<name>_ref`` is the oracle its kernel is held against on the card
and the path ``kernels.ops`` takes for a tensor that lies on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import dtw as _dtw
from repro_torch.core.sketch import sketch_projections


def sketch_conv_ref(x: torch.Tensor, filters: torch.Tensor, step: int
                    ) -> torch.Tensor:
    """Sliding-window projections. x (B, m), filters (W, F) -> (B, N_B, F).

    ``x.unfold(-1, W, step) @ filters``: a matrix product, which sums the
    taps in another order than the kernel's tap loop — compare within
    float32 tolerance.
    """
    return sketch_projections(x, filters, step)


def collision_count_batch_ref(query_keys: torch.Tensor,
                              db_keys: torch.Tensor) -> torch.Tensor:
    """queries (B, K), db (N, K) int32 -> (B, N) int32 match counts,
    accumulated key by key as a (B, N) broadcast compare."""
    b, n = query_keys.shape[0], db_keys.shape[0]
    acc = torch.zeros((b, n), dtype=torch.int32, device=db_keys.device)
    db_t = db_keys.t()
    for k in range(db_keys.shape[1]):
        acc += db_t[k][None, :] == query_keys[:, k][:, None]
    return acc


def collision_count_ref(query_keys: torch.Tensor, db_keys: torch.Tensor
                        ) -> torch.Tensor:
    """query (K,), db (N, K) int32 -> (N,) int32 per-row match counts."""
    return (db_keys == query_keys[None, :]).sum(1, dtype=torch.int32)


def dtw_pairs_ref(queries: torch.Tensor, candidates: torch.Tensor,
                  band: Optional[int] = None,
                  threshold: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-aligned banded squared DTW: (P, m) x (P, m) -> (P,).

    The reference routes narrow bands to its O(m·band) window DP and the
    rest to the full DP (``repro/kernels/ref.py:30-73``); both compute the
    same function, which the wavefront of ``core.dtw`` computes at radius
    ``min(band, m - 1)`` (``None`` -> m - 1), with the same threshold
    contract: exact where <= threshold, else BIG.
    """
    return _dtw.dtw_banded_pairs(queries, candidates, band,
                                 threshold=threshold)


def dtw_wavefront_ref(query: torch.Tensor, candidates: torch.Tensor,
                      band: Optional[int] = None,
                      threshold=None) -> torch.Tensor:
    """Banded squared DTW of one query against a block: query (m,),
    candidates (C, m) -> (C,), with the threshold contract of
    :func:`dtw_pairs_ref` (``threshold`` a scalar or (C,)).  The query
    row is broadcast to every pair, so the values are those of the pair
    wavefront, bit for bit."""
    return _dtw.dtw_banded_pairs(query[None, :].expand_as(candidates),
                                 candidates, band, threshold=threshold)


def cs_tables_ref(bucket: torch.Tensor, sign: torch.Tensor, width: int
                  ) -> torch.Tensor:
    """Signed count-sketch tables: bucket (B, R, S) int32 (-1 invalid),
    sign (B, R, S) f32 -> (B, R, width) f32.

    A scatter-add into ``width + 1`` bins whose last bin collects every
    bucket outside [0, width) and is sliced off
    (``repro/kernels/ref.py:106-122``).  Sums of +-1 are exact integers,
    so every order of the adds gives the same bits.
    """
    b, r, s = bucket.shape
    tgt = torch.where((bucket >= 0) & (bucket < width), bucket, width)
    tables = torch.zeros((b * r, width + 1), dtype=torch.float32,
                         device=bucket.device)
    tables.scatter_add_(1, tgt.reshape(b * r, s).to(torch.int64),
                        sign.to(torch.float32).reshape(b * r, s))
    return tables[:, :width].reshape(b, r, width)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Plain softmax attention: q (B, H, S, D), k/v (B, Hk, T, D) with
    H % Hk == 0 -> (B, H, S, D) in q's type.

    The reference's oracle (``repro/kernels/ref.py:126-136``) with the
    KV heads repeated (head h reads KV head h // (H / Hk)), computed in
    float32 throughout and rounded to q's type once, as the kernel does:
    the (B, H, S, T) float32 logits are materialised.  Under ``causal``
    query i sees keys 0..i, as the TPU kernel has it; that is the
    reference's mask when S == T (it aligns the queries to the end of the
    keys when S < T).
    """
    h, s, d = q.shape[1:]
    hk, t = k.shape[1], k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    if h != hk:
        kf = kf.repeat_interleave(h // hk, dim=1)
        vf = vf.repeat_interleave(h // hk, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", qf, kf)
    logits.mul_(d ** -0.5 if scale is None else scale)
    if causal:
        above = torch.ones((s, t), dtype=torch.bool,
                           device=q.device).triu_(1)
        logits.masked_fill_(above, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    del logits
    return torch.einsum("bhst,bhtd->bhsd", probs, vf).to(q.dtype)
