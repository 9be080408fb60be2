"""Step 1 of SSH — sliding-window bit-profile (sketch) extraction (§4.1),
counterpart of ``repro.core.sketch``.

A random Gaussian filter bank (W, F) slides over the series with step δ;
each window contributes ``projection >= 0`` — one bit per filter.  Bits
are uint8 in {0, 1}.  On CUDA the projections come from the kernel
``csrc/sketch_conv.cu`` through ``kernels.ops.sketch_bits``; the functions
here are the plain versions.
"""
from __future__ import annotations

from typing import Tuple

import torch


def num_sketch_bits(m: int, window: int, step: int) -> int:
    """N_B = floor((m - W) / δ) + 1 (number of full windows)."""
    if m < window:
        raise ValueError(f"series length {m} < filter window {window}")
    return (m - window) // step + 1


def make_filter(window: int, num_filters: int,
                generator: torch.Generator) -> torch.Tensor:
    """Spherically-symmetric random filter bank r ~ N(0, 1), (W, F), drawn
    on the CPU from ``generator``."""
    return torch.randn((window, num_filters), generator=generator,
                       dtype=torch.float32)


def sketch_projections(x: torch.Tensor, filters: torch.Tensor, step: int
                       ) -> torch.Tensor:
    """Raw sliding-window projections: (..., m) -> (..., N_B, F)."""
    window = filters.shape[0]
    num_sketch_bits(x.shape[-1], window, step)
    return x.to(torch.float32).unfold(-1, window, step) \
        @ filters.to(torch.float32)


def sketch_bits(x: torch.Tensor, filters: torch.Tensor, step: int
                ) -> torch.Tensor:
    """Bit-profile B_X: (..., m) -> (..., N_B, F) uint8 in {0, 1}."""
    return (sketch_projections(x, filters, step) >= 0).to(torch.uint8)


def sketch_shape(m: int, window: int, step: int, num_filters: int
                 ) -> Tuple[int, int]:
    """(N_B, F) of the bit-profile of a length-m series."""
    return num_sketch_bits(m, window, step), num_filters
