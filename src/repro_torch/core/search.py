"""Per-query search result (counterpart of ``repro.core.search``; the
sequential ``ssh_search`` is not ported yet)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.rerank import SearchStats


@dataclasses.dataclass
class SearchResult:
    ids: np.ndarray              # (k,) database ids, best first
    dists: np.ndarray            # (k,) squared DTW costs
    n_candidates: int            # candidates that reached the DTW stage
    n_database: int
    pruned_by_hash_frac: float
    pruned_total_frac: float
    wall_seconds: float
    stats: Optional[SearchStats] = None
