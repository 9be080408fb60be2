"""Wrapper of the CUDA kernel ``csrc/collision_count.cu`` — the probe
stage's batched signature agreement counts on the H100.

It replaces the TPU kernel
``repro/kernels/collision_count.py::collision_count_batch``.  The source's
header says what bounds it and how its design answers that;
``kernels.ref.collision_count_batch_ref`` is its plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "collision_count"


def collision_count_batch(query_keys: torch.Tensor, db_keys: torch.Tensor
                          ) -> torch.Tensor:
    """queries (B, K) int32, db (N, K) int32 on one CUDA device -> (B, N)
    int32 exact match counts."""
    if not (query_keys.is_cuda and db_keys.device == query_keys.device):
        raise ValueError("collision_count_batch kernel needs both operands "
                         f"on one CUDA device, got {query_keys.device} and "
                         f"{db_keys.device}")
    if query_keys.dtype != torch.int32 or db_keys.dtype != torch.int32:
        raise TypeError(f"collision_count_batch takes int32, got "
                        f"{query_keys.dtype} and {db_keys.dtype}")
    if (query_keys.dim() != 2 or db_keys.dim() != 2
            or query_keys.shape[1] != db_keys.shape[1]):
        raise ValueError(f"need (B, K) and (N, K), got "
                         f"{tuple(query_keys.shape)} and "
                         f"{tuple(db_keys.shape)}")
    b, k = query_keys.shape
    n = db_keys.shape[0]
    out = torch.empty((b, n), dtype=torch.int32, device=db_keys.device)
    if b == 0 or n == 0:
        return out
    lib = _build.load(NAME)
    if k > lib.collision_count_max_k():
        raise ValueError(f"collision_count_batch kernel takes K <= "
                         f"{lib.collision_count_max_k()}, got K={k}")
    query_keys, db_keys = query_keys.contiguous(), db_keys.contiguous()
    stream = torch.cuda.current_stream(db_keys.device).cuda_stream
    rc = lib.collision_count_batch_launch(query_keys.data_ptr(),
                                          db_keys.data_ptr(), out.data_ptr(),
                                          b, n, k, stream)
    _build.check(NAME, lib, rc)
    _build.LAUNCHES[NAME] += 1
    return out
