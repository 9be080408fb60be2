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
