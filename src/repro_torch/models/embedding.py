"""Sparse-embedding substrate (counterpart of ``repro.models.embedding``).

* :func:`embedding_lookup` — hashed ("quotient" trick) row gather: ids
  taken modulo the table's rows (Python's sign rule, as
  ``jnp.remainder``), then ``index_select``;
* :func:`embedding_bag` — multi-hot gather and a sum or mean by bag
  through ``index_add_`` (the reference's ``segment_sum``);
* :func:`positional_embedding`.

The gathers and the scatter-add are PyTorch operations, as the
reference's are XLA's: no kernel of the reference is on this path.
"""
from __future__ import annotations

from typing import Optional

import torch


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor
                     ) -> torch.Tensor:
    """Hashed row gather: table (V, d), ids (...,) any int -> (..., d).
    Ids are read as int32, as the reference casts them, and widened to
    int64 for the index."""
    v = table.shape[0]
    idx = ids.to(torch.int32).to(torch.int64).remainder(v)
    return table.index_select(0, idx.reshape(-1)).reshape(
        *ids.shape, table.shape[1])


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segment_ids: torch.Tensor, num_segments: int,
                  mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EmbeddingBag: gather rows for ``ids`` and reduce by ``segment_ids``.

    ids (L,), segment_ids (L,) bag assignment in [0, num_segments), in any
    order -> (num_segments, d).
    """
    rows = embedding_lookup(table, ids)
    if weights is not None:
        rows = rows * weights[:, None]
    seg = segment_ids.to(torch.int64)
    bags = rows.new_zeros((num_segments, rows.shape[1])).index_add_(
        0, seg, rows)
    if mode == "sum":
        return bags
    if mode == "mean":
        counts = rows.new_zeros((num_segments,)).index_add_(
            0, seg, torch.ones_like(seg, dtype=rows.dtype))
        return bags / torch.clamp(counts, min=1.0)[:, None]
    raise ValueError(f"mode {mode}")


def positional_embedding(table: torch.Tensor, length: int) -> torch.Tensor:
    """table (max_len, d) -> (length, d)."""
    return table[:length]
