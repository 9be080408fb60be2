"""Wrapper of the CUDA kernels in ``csrc/topc_select.cu`` — the probe's
top-C by count on the H100.

No TPU kernel maps to it: the reference leaves this step to
``lax.top_k``.  The counts it ranks are small integers (agreeing hashes
or tables, at most :data:`MAX_COUNT`), so three passes that read the
counts twice at most replace a sort: a histogram per chunk of each row, a
threshold with each bin's slot base, and a stable scatter of the
selected columns.  The source says what bounds it and how its design
answers that; ``kernels.ref.top_c_select_ref`` is the same three passes
in plain PyTorch.

The chunking is this module's rule (:func:`chunk_rows`): it follows from
the rows and the columns alone, so one query over 20M columns fills the
card as 64 queries over 6M do.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

NAME = "topc_select"          # the library
#: widest count taken (the count kernels' own limit on K)
MAX_COUNT = 64
#: a chunk's length is a multiple of the scatter's tile (256 threads x 4
#: columns x 4 loads), so only a row's last chunk has a ragged tile
CHUNK_MULTIPLE = 4096
#: shortest chunk: below it the per-block histogram work outweighs the
#: chunk's own reads
MIN_CHUNK = 4 * CHUNK_MULTIPLE
#: (row, chunk) blocks a call aims at: about four waves of the scatter
#: (eight blocks of 256 threads on each of 132 SMs)
TARGET_BLOCKS = 4096
#: launches, in order, counted under these names
PASSES = ("topc_histogram", "topc_threshold", "topc_scatter")


def chunk_rows(b: int, n: int) -> int:
    """Columns a chunk of each of ``b`` rows of ``n`` holds: about
    :data:`TARGET_BLOCKS` (row, chunk) blocks in all, a multiple of
    :data:`CHUNK_MULTIPLE`, at least :data:`MIN_CHUNK`."""
    per_row = -(-TARGET_BLOCKS // max(1, b))
    chunk = -(-max(1, n) // per_row)
    return max(MIN_CHUNK, -(-chunk // CHUNK_MULTIPLE) * CHUNK_MULTIPLE)


def check_args(counts: torch.Tensor, top_c: int, max_count: int) -> None:
    """Shape and range checks on the host, no device read: (B, N) int32
    counts, 0 <= top_c <= N, 0 <= max_count <= :data:`MAX_COUNT`."""
    if counts.dim() != 2:
        raise ValueError(f"top_c_select takes (B, N) counts, got "
                         f"{tuple(counts.shape)}")
    if counts.dtype != torch.int32:
        raise TypeError(f"top_c_select takes int32 counts, got "
                        f"{counts.dtype}")
    if not 0 <= max_count <= MAX_COUNT:
        raise ValueError(f"top_c_select takes max_count in [0, "
                         f"{MAX_COUNT}], got {max_count}")
    if not 0 <= top_c <= counts.shape[1]:
        raise ValueError(f"top_c must lie in [0, N={counts.shape[1]}], "
                         f"got {top_c}")


def top_c_select(counts: torch.Tensor, top_c: int,
                 max_count: int = MAX_COUNT
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """counts (B, N) int32 in [0, max_count] on a CUDA device -> ids
    (B, top_c) int64, counts (B, top_c) int32: each row's columns by
    count, highest first, ties to the lowest column.  Three launches on the
    current stream, no synchronisation; a count outside [0, max_count]
    is read as the nearer end (the kernels stay in bounds; the order is
    then undefined)."""
    if not counts.is_cuda:
        raise ValueError(f"top_c_select kernel needs a CUDA tensor, got "
                         f"{counts.device}")
    check_args(counts, top_c, max_count)
    b, n = counts.shape
    dev = counts.device
    ids = torch.empty((b, top_c), dtype=torch.int64, device=dev)
    vals = torch.empty((b, top_c), dtype=torch.int32, device=dev)
    if b == 0 or top_c == 0:
        return ids, vals
    if n >= 2 ** 31 or b > 65535:
        raise ValueError(f"top_c_select kernel takes N < 2^31 and B <= "
                         f"65535, got ({b}, {n})")
    bins = max_count + 1
    chunk = chunk_rows(b, n)
    chunks = -(-n // chunk)
    plane = b * chunks * bins
    scratch = torch.empty((2 * plane + b * bins + b,), dtype=torch.int32,
                          device=dev)
    hist, base = scratch[:plane], scratch[plane:2 * plane]
    above = scratch[2 * plane:2 * plane + b * bins]
    thresh = scratch[2 * plane + b * bins:]
    lib = _build.load(NAME)
    counts = counts.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.topc_select_launch(
        counts.data_ptr(), hist.data_ptr(), base.data_ptr(),
        above.data_ptr(), thresh.data_ptr(), ids.data_ptr(), vals.data_ptr(),
        b, n, chunk, chunks, bins, top_c, stream)
    _build.check(NAME, lib, rc)
    _build.count(*PASSES)
    return ids, vals
