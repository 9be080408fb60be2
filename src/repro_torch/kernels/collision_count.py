"""Wrappers of the CUDA kernels in ``csrc/collision_count.cu`` — the
probe stage's signature agreement counts on the H100.

``collision_count_batch`` replaces the TPU kernel
``repro/kernels/collision_count.py::collision_count_batch`` (the batched
searcher) and ``collision_count`` replaces ``::collision_count`` (the
sequential searcher, one query row at a time).  The source says what
bounds each and how its design answers that;
``kernels.ref.collision_count_batch_ref`` and
``kernels.ref.collision_count_ref`` are their plain PyTorch versions.

Both kernels pad the key axis to :func:`k_pad` slots with the TPU
kernel's sentinels, ``DB_PAD`` on the database side and ``Q_PAD`` on the
query side, inside the kernel (nothing is padded on the host);
``ref.collision_count_padded_ref`` is that rule in plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "collision_count"      # the library
K_MULTIPLE = 8                # the kernels' key slots: K rounded up to this
DB_PAD = -2 ** 31             # database-side sentinel (INT32_MIN)
Q_PAD = 2 ** 31 - 1           # query-side sentinel (INT32_MAX)
ONE_TILE = 256                # single-query kernel: database rows per tile


def one_stage_words(k: int) -> int:
    """int32 words of one stage of the single-query kernel's ring: the
    tile's 256·k, up to 3 words of lead and 3 of tail from widening its
    span to 16-byte boundaries, and the up to 7 slots its last row reads
    past k; rounded up to 128 bytes (``one_stage_words`` in the source)."""
    return (ONE_TILE * k + 16 + 31) // 32 * 32


def k_pad(k: int) -> int:
    """Key slots a kernel runs for signatures of width ``k``: ``k``
    rounded up to a multiple of :data:`K_MULTIPLE` (the compile-time
    width of the instance it launches)."""
    return -(-k // K_MULTIPLE) * K_MULTIPLE


def _check_int32_pair(query_keys, db_keys, fn: str) -> None:
    if not (query_keys.is_cuda and db_keys.device == query_keys.device):
        raise ValueError(f"{fn} kernel needs both operands on one CUDA "
                         f"device, got {query_keys.device} and "
                         f"{db_keys.device}")
    if query_keys.dtype != torch.int32 or db_keys.dtype != torch.int32:
        raise TypeError(f"{fn} takes int32, got {query_keys.dtype} and "
                        f"{db_keys.dtype}")


def collision_count_batch(query_keys: torch.Tensor, db_keys: torch.Tensor
                          ) -> torch.Tensor:
    """queries (B, K) int32, db (N, K) int32 on one CUDA device -> (B, N)
    int32 exact match counts."""
    _check_int32_pair(query_keys, db_keys, "collision_count_batch")
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
    _build.count("collision_count_batch")
    return out


def collision_count(query_keys: torch.Tensor, db_keys: torch.Tensor
                    ) -> torch.Tensor:
    """query (K,) int32, db (N, K) int32 on one CUDA device -> (N,) int32
    exact match counts."""
    _check_int32_pair(query_keys, db_keys, "collision_count")
    if (query_keys.dim() != 1 or db_keys.dim() != 2
            or query_keys.shape[0] != db_keys.shape[1]):
        raise ValueError(f"need (K,) and (N, K), got "
                         f"{tuple(query_keys.shape)} and "
                         f"{tuple(db_keys.shape)}")
    n, k = db_keys.shape
    out = torch.empty((n,), dtype=torch.int32, device=db_keys.device)
    if n == 0:
        return out
    lib = _build.load(NAME)
    if k > lib.collision_count_max_k():
        raise ValueError(f"collision_count kernel takes K <= "
                         f"{lib.collision_count_max_k()}, got K={k}")
    query_keys, db_keys = query_keys.contiguous(), db_keys.contiguous()
    stream = torch.cuda.current_stream(db_keys.device).cuda_stream
    rc = lib.collision_count_launch(query_keys.data_ptr(), db_keys.data_ptr(),
                                    out.data_ptr(), n, k, stream)
    _build.check(NAME, lib, rc)
    _build.count("collision_count")
    return out
