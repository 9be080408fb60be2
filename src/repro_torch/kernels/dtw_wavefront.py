"""Wrappers of the CUDA kernels in ``csrc/dtw_wavefront.cu`` — the
re-rank stage's banded DTW on the H100.

``dtw_wavefront_pairs`` (row-aligned pairs, the batched searcher)
replaces the TPU kernel ``repro/kernels/dtw_wavefront.py::
dtw_wavefront_pairs``; ``dtw_wavefront`` (one query against a candidate
block: the sequential re-rank and the UCR scan) replaces
``::dtw_wavefront``.  The source says what bounds them and how the design
answers that; ``kernels.ref.dtw_pairs_ref`` and
``kernels.ref.dtw_wavefront_ref`` are their plain PyTorch versions, equal
to them bit for bit.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import _build

NAME = "dtw_wavefront"    # the library
PAIRS_PER_BLOCK = 4      # WARPS in csrc/dtw_wavefront.cu


def dtw_wavefront_pairs(queries: torch.Tensor, candidates: torch.Tensor,
                        band: int, threshold: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(P, m) x (P, m) f32 on one CUDA device, Sakoe-Chiba radius ``band``
    (m - 1 for unconstrained) -> (P,) f32.

    ``threshold`` (P,) f32 applies the early-abandon contract: the exact
    cost where it is <= threshold, BIG = 1e30 elsewhere.
    """
    if not (queries.is_cuda and candidates.device == queries.device):
        raise ValueError("dtw_wavefront_pairs kernel needs both operands on "
                         f"one CUDA device, got {queries.device} and "
                         f"{candidates.device}")
    if queries.dtype != torch.float32 or candidates.dtype != torch.float32:
        raise TypeError(f"dtw_wavefront_pairs takes float32, got "
                        f"{queries.dtype} and {candidates.dtype}")
    if queries.dim() != 2 or queries.shape != candidates.shape:
        raise ValueError(f"row-aligned (P, m) pairs required, got "
                         f"{tuple(queries.shape)} and "
                         f"{tuple(candidates.shape)}")
    p, m = queries.shape
    r = min(int(band), m - 1)
    if r < 0:
        raise ValueError(f"band must be >= 0, got {band}")
    thr_ptr = None
    if threshold is not None:
        if (threshold.device != queries.device
                or threshold.dtype != torch.float32
                or tuple(threshold.shape) != (p,)):
            raise ValueError("threshold must be a (P,) float32 tensor on the "
                             "operands' device")
        threshold = threshold.contiguous()
        thr_ptr = threshold.data_ptr()
    out = torch.empty((p,), dtype=torch.float32, device=queries.device)
    if p == 0:
        return out
    lib = _build.load(NAME)
    if r > lib.dtw_pairs_max_radius():
        raise ValueError(f"dtw_wavefront_pairs kernel takes a radius <= "
                         f"{lib.dtw_pairs_max_radius()}, got {r}")
    if PAIRS_PER_BLOCK * 2 * m * 4 > 227 * 1024:    # both rows in smem
        raise ValueError(f"dtw_wavefront_pairs kernel: series length {m} "
                         "does not fit in shared memory")
    queries, candidates = queries.contiguous(), candidates.contiguous()
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    rc = lib.dtw_wavefront_pairs_launch(queries.data_ptr(),
                                        candidates.data_ptr(), thr_ptr,
                                        out.data_ptr(), p, m, r, stream)
    _build.check(NAME, lib, rc)
    _build.LAUNCHES["dtw_wavefront_pairs"] += 1
    return out


def dtw_wavefront(query: torch.Tensor, candidates: torch.Tensor, band: int,
                  threshold: Union[None, float, torch.Tensor] = None
                  ) -> torch.Tensor:
    """query (m,) and candidates (C, m) f32 on one CUDA device,
    Sakoe-Chiba radius ``band`` (m - 1 for unconstrained) -> (C,) f32.

    ``threshold`` (a scalar, a one-element tensor or a (C,) f32 tensor)
    applies the early-abandon contract: the exact cost where it is <=
    threshold, BIG = 1e30 elsewhere.
    """
    if not (query.is_cuda and candidates.device == query.device):
        raise ValueError("dtw_wavefront kernel needs both operands on one "
                         f"CUDA device, got {query.device} and "
                         f"{candidates.device}")
    if query.dtype != torch.float32 or candidates.dtype != torch.float32:
        raise TypeError(f"dtw_wavefront takes float32, got {query.dtype} "
                        f"and {candidates.dtype}")
    if (query.dim() != 1 or candidates.dim() != 2
            or candidates.shape[1] != query.shape[0]):
        raise ValueError(f"need (m,) and (C, m), got {tuple(query.shape)} "
                         f"and {tuple(candidates.shape)}")
    c, m = candidates.shape
    r = min(int(band), m - 1)
    if r < 0:
        raise ValueError(f"band must be >= 0, got {band}")
    thr_ptr, thr_stride = None, 0
    if threshold is not None:
        threshold = torch.as_tensor(threshold, dtype=torch.float32,
                                    device=query.device).reshape(-1)
        if threshold.numel() not in (1, c):
            raise ValueError(f"threshold must be a scalar or (C,) = ({c},), "
                             f"got {threshold.numel()} values")
        threshold = threshold.contiguous()
        thr_ptr = threshold.data_ptr()
        thr_stride = 0 if threshold.numel() == 1 else 1
    out = torch.empty((c,), dtype=torch.float32, device=query.device)
    if c == 0:
        return out
    lib = _build.load(NAME)
    if r > lib.dtw_pairs_max_radius():
        raise ValueError(f"dtw_wavefront kernel takes a radius <= "
                         f"{lib.dtw_pairs_max_radius()}, got {r}")
    if m > lib.dtw_one_max_length():
        raise ValueError(f"dtw_wavefront kernel: series length {m} does not "
                         "fit in shared memory")
    query, candidates = query.contiguous(), candidates.contiguous()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    rc = lib.dtw_wavefront_launch(query.data_ptr(), candidates.data_ptr(),
                                  thr_ptr, thr_stride, out.data_ptr(), c, m,
                                  r, stream)
    _build.check(NAME, lib, rc)
    _build.LAUNCHES["dtw_wavefront"] += 1
    return out
