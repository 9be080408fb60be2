"""Wrappers of the CUDA kernels in ``csrc/dtw_wavefront.cu`` — the
re-rank stage's banded DTW on the H100.

``dtw_wavefront_pairs`` (row-aligned pairs, the batched searcher)
replaces the TPU kernel ``repro/kernels/dtw_wavefront.py::
dtw_wavefront_pairs``; ``dtw_wavefront`` (one query against a candidate
block: the sequential re-rank and the UCR scan) replaces
``::dtw_wavefront``.  Each runs one of two schedules, which
:func:`dtw_schedule` picks (never a fallback on failure):

* ``"rows"``: one thread per pair sweeps the rows in band coordinates
  with the row's costs in registers; for many pairs and r <= 63.
  ``kernels.ref.dtw_band_rows_ref`` is its arithmetic in plain torch.
* ``"diagonals"``: one warp per pair walks the anti-diagonals; for few
  pairs, where one pair's latency sets the time, and for any band up to
  r = 1023.

The source says what bounds them and how each schedule answers that;
``kernels.ref.dtw_pairs_ref`` and ``kernels.ref.dtw_wavefront_ref`` are
their plain PyTorch versions, equal to them bit for bit.  Launches count
under the kernel's name and, per schedule, under
``"<kernel>:<schedule>"`` (:func:`schedule_counts`).

``dtw_wavefront_pairs`` also counts work: given a (P,) int32 ``cells``,
each pair writes the band's cells its schedule computed before the pair
ended or was abandoned, by the closed forms :func:`band_cells` (rows)
and :func:`band_cells_diagonals` repeat.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import _build

NAME = "dtw_wavefront"    # the library
SCHEDULES = ("rows", "diagonals")
#: the row schedule's register classes end at 2r + 1 <= 128
ROWS_MAX_RADIUS = 63
#: the crossover of :func:`dtw_schedule`: rows from this many pairs per
#: band cell of a row (2r + 1) over the diagonal slots of a lane
#: (ceil((r + 1) / 32))
ROWS_MIN_PAIRS_PER_CELL = 240
#: candidate rows a tile of the row schedule (TILE in the source); it
#: tests its abandon bound after each tile
ROWS_TILE = 32
#: the diagonal schedule tests its abandon bound every this many
#: anti-diagonals
DIAG_CHECK_EVERY = 32
#: shared memory a block may hold (227 KB)
SMEM_MAX = 232448


def band_cells(m: int, r: int, rows: Optional[int] = None) -> int:
    """Cells (i, j) with |i - j| <= r of an m x m matrix, in its first
    ``rows`` rows (all by default): the row schedule's count for a pair
    whose block swept that many rows (``band_rows`` in the source)."""
    rows = m if rows is None else rows
    t = max(0, min(m - r, rows))         # rows j with j + r + 1 <= m
    u = max(0, rows - r - 1)             # rows j with j > r
    return t * (t - 1) // 2 + t * (r + 1) + (rows - t) * m - u * (u + 1) // 2


def band_cells_diagonals(m: int, r: int, diagonals: int) -> int:
    """Band cells on the anti-diagonals i + j < ``diagonals``: the
    diagonal schedule's count for a pair whose warp stepped that many
    (``band_diagonals`` in the source).  Up to the middle diagonal d
    holds d + 1 cells while d <= r, then r + 1 and r in turn; past it,
    the whole band less the far corner's 2m - 1 - ``diagonals``."""
    far = diagonals > m
    e = 2 * m - 1 - diagonals if far else diagonals
    a = min(e, r + 1)
    n = max(0, e - r - 1)
    near = a * (a + 1) // 2 + n * r + n // 2
    return band_cells(m, r) - near if far else near


def dtw_schedule(n_pairs: int, m: int, r: int) -> str:
    """The written rule: ``"rows"`` or ``"diagonals"`` for ``n_pairs``
    pairs of length ``m`` at radius ``r`` (already clamped to m - 1).

    Until the card is full, the row schedule's time is one thread's chain
    through its m x (2r + 1) cells and the diagonal schedule's one warp's
    2m - 1 diagonals; past that, the rows issue about 8 instructions a
    cell and the diagonals a warp's ceil((r + 1) / 32) slots a lane per
    diagonal.  So the crossover grows with the row's cells over the
    lane's slots, and ``m`` cancels out: rows from
    ``ROWS_MIN_PAIRS_PER_CELL`` x (2r + 1) / ceil((r + 1) / 32) pairs,
    where 2r + 1 fits the row schedule's registers.  The constant is the
    crossover measured on an H100 at m = 512, r = 25 (between 8,192 and
    12,288 pairs: ``python -m repro_torch.bench.dtw_schedules --sweep``,
    PERF.md).
    """
    slots = -(-(r + 1) // 32)
    if (r <= ROWS_MAX_RADIUS
            and n_pairs * slots >= ROWS_MIN_PAIRS_PER_CELL * (2 * r + 1)):
        return "rows"
    return "diagonals"


def schedule_counts() -> Dict[str, int]:
    """Launches per (kernel, schedule) since the last reset."""
    with _build.COUNT_LOCK:
        return {f"{k}:{s}": _build.LAUNCHES[f"{k}:{s}"]
                for k in ("dtw_wavefront_pairs", "dtw_wavefront")
                for s in SCHEDULES}


def _launch(kernel: str, n: int, m: int, r: int, schedule: Optional[str],
            one: bool, call) -> str:
    """Check the shape against the library, pick the schedule, launch
    through ``call(lib, schedule_code)`` and count; returns the schedule."""
    lib = _build.load(NAME)
    if r > lib.dtw_pairs_max_radius():
        raise ValueError(f"{kernel} kernel takes a radius <= "
                         f"{lib.dtw_pairs_max_radius()}, got {r}")
    if schedule is None:
        schedule = dtw_schedule(n, m, r)
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                         f"{schedule!r}")
    if schedule == "rows" and r > lib.dtw_rows_max_radius():
        raise ValueError(f"{kernel}: the rows schedule takes a radius <= "
                         f"{lib.dtw_rows_max_radius()}, got {r}")
    code = SCHEDULES.index(schedule)
    smem = lib.dtw_smem_bytes(code, int(one), m, r)
    if smem > SMEM_MAX:
        raise ValueError(f"{kernel} kernel: series length {m} at radius "
                         f"{r} needs {smem} bytes of shared memory with the "
                         f"{schedule} schedule, more than {SMEM_MAX}")
    _build.check(NAME, lib, call(lib, code))
    _build.count(kernel, f"{kernel}:{schedule}")
    return schedule


def dtw_wavefront_pairs(queries: torch.Tensor, candidates: torch.Tensor,
                        band: int, threshold: Optional[torch.Tensor] = None,
                        schedule: Optional[str] = None,
                        cells: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(P, m) x (P, m) f32 on one CUDA device, Sakoe-Chiba radius ``band``
    (m - 1 for unconstrained) -> (P,) f32.

    ``threshold`` (P,) f32 applies the early-abandon contract: the exact
    cost where it is <= threshold, BIG = 1e30 elsewhere.  ``schedule``
    (``"rows"`` or ``"diagonals"``) overrides :func:`dtw_schedule`.
    ``cells``, a contiguous (P,) int32 tensor on the operands' device,
    receives each pair's computed band cells; without it nothing is
    counted.
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
    cells_ptr = None
    if cells is not None:
        if (cells.device != queries.device or cells.dtype != torch.int32
                or tuple(cells.shape) != (p,) or not cells.is_contiguous()):
            raise ValueError("cells must be a contiguous (P,) int32 tensor "
                             "on the operands' device")
        cells_ptr = cells.data_ptr()
    out = torch.empty((p,), dtype=torch.float32, device=queries.device)
    if p == 0:
        return out
    queries, candidates = queries.contiguous(), candidates.contiguous()
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    _launch("dtw_wavefront_pairs", p, m, r, schedule, False,
            lambda lib, code: lib.dtw_wavefront_pairs_launch(
                queries.data_ptr(), candidates.data_ptr(), thr_ptr,
                out.data_ptr(), cells_ptr, p, m, r, code, DIAG_CHECK_EVERY,
                stream))
    return out


def dtw_wavefront(query: torch.Tensor, candidates: torch.Tensor, band: int,
                  threshold: Union[None, float, torch.Tensor] = None,
                  schedule: Optional[str] = None) -> torch.Tensor:
    """query (m,) and candidates (C, m) f32 on one CUDA device,
    Sakoe-Chiba radius ``band`` (m - 1 for unconstrained) -> (C,) f32.

    ``threshold`` (a scalar, a one-element tensor or a (C,) f32 tensor)
    applies the early-abandon contract: the exact cost where it is <=
    threshold, BIG = 1e30 elsewhere.  ``schedule`` (``"rows"`` or
    ``"diagonals"``) overrides :func:`dtw_schedule`.
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
    query, candidates = query.contiguous(), candidates.contiguous()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    _launch("dtw_wavefront", c, m, r, schedule, True,
            lambda lib, code: lib.dtw_wavefront_launch(
                query.data_ptr(), candidates.data_ptr(), thr_ptr, thr_stride,
                out.data_ptr(), c, m, r, code, DIAG_CHECK_EVERY, stream))
    return out
