"""Signed random projections, the paper's baseline (§5.2; counterpart of
``repro.core.srp``).

The whole series is one long vector hashed by K random hyperplanes
(cosine LSH).  SRP has no alignment mechanism, so it fails on warped
series.  The projection is one ``torch.matmul``: the reference computes
it outside any Pallas kernel too.
"""
from __future__ import annotations

import torch


def make_srp(num_hashes: int, dim: int,
             generator: torch.Generator) -> torch.Tensor:
    """(dim, K) standard normal planes, drawn on the CPU (the
    distribution of ``repro/core/srp.py:19``)."""
    return torch.randn((dim, num_hashes), generator=generator,
                       dtype=torch.float32)


def srp_bits(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """(..., m) -> (..., K) uint8 sign bits (projection >= 0)."""
    return (torch.matmul(x, planes) >= 0).to(torch.uint8)


def hamming_similarity(query_bits: torch.Tensor, db_bits: torch.Tensor
                       ) -> torch.Tensor:
    """Fraction of matching bits: (K,), (N, K) -> (N,) f32."""
    agree = (query_bits[None, :] == db_bits).to(torch.float32)
    # jnp.mean's arithmetic: the sum times the float32 reciprocal of n
    return agree.sum(-1) * torch.tensor(1.0 / agree.shape[-1],
                                        dtype=torch.float32)


def srp_topk(query_bits: torch.Tensor, db_bits: torch.Tensor, topk: int):
    """(ids int64, similarities f32), each (topk,): the rows of the most
    matching bits, ties to the lowest row as ``lax.top_k`` breaks them
    (a stable sort; ``torch.topk`` promises no tie order on CUDA)."""
    sim = hamming_similarity(query_bits, db_bits)
    vals, idx = torch.sort(sim, descending=True, stable=True)
    return idx[:topk], vals[:topk]
