"""SearchConfig — the search-time knobs (counterpart of
``repro.db.config``).

Field names, defaults and checks are the reference's, so a config reads
the same in both packages.  The port serves two of the reference's
searchers, ``"batched"`` (the default) and ``"local"``; the others and
the batcher/fleet/subsequence knobs are outside this package for now
(ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.kernels import ops

#: searchers this package serves (``repro/db/registry.py:104-137``)
SEARCHERS = ("batched", "local")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """``topk`` results per query from ``top_c`` hash candidates; ``band``
    is the Sakoe-Chiba radius (``None`` = unconstrained, no envelope
    bounds); ``use_lb_cascade`` / ``seed_size`` / ``early_abandon`` shape
    the re-rank; ``rank_by_signature`` / ``multiprobe_offsets`` shape the
    probe; ``backend`` keeps the reference's values ("auto" and "pallas":
    CUDA kernels on the card, plain versions on the CPU; "jnp": plain
    versions, CPU only); ``searcher`` routes the facade's queries
    (``"batched"``: ``serving.batched.ssh_search_batch``; ``"local"``:
    one ``core.search.ssh_search`` per query); ``stage_timings`` records
    per-stage seconds."""

    topk: int = 10
    top_c: int = 256
    band: Optional[int] = None
    use_lb_cascade: bool = True
    rank_by_signature: bool = True
    multiprobe_offsets: int = 1
    seed_size: Optional[int] = None
    early_abandon: bool = True
    backend: str = "auto"
    searcher: str = "batched"
    stage_timings: bool = True

    def validate(self) -> "SearchConfig":
        if self.topk < 1:
            raise ValueError(f"topk must be >= 1, got {self.topk}")
        if self.top_c < 1:
            raise ValueError(f"top_c must be >= 1, got {self.top_c}")
        if self.top_c < self.topk:
            raise ValueError(
                f"top_c ({self.top_c}) must be >= topk ({self.topk}); "
                "the hash stage must supply at least topk candidates")
        if self.band is not None and self.band < 1:
            raise ValueError(f"band must be None or >= 1, got {self.band}")
        if self.multiprobe_offsets < 1:
            raise ValueError("multiprobe_offsets must be >= 1, got "
                             f"{self.multiprobe_offsets}")
        if self.seed_size is not None and self.seed_size < self.topk:
            raise ValueError(
                f"seed_size ({self.seed_size}) must be None or >= topk "
                f"({self.topk}): the cascade threshold is the topk-th "
                "best of the seeded set")
        ops.check_backend(self.backend)
        if self.searcher not in SEARCHERS:
            raise ValueError(f"repro_torch serves searchers {SEARCHERS}, "
                             f"got {self.searcher!r}")
        return self

    def replace(self, **changes: Any) -> "SearchConfig":
        return dataclasses.replace(self, **changes).validate()

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
