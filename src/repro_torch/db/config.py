"""SearchConfig and BatchPolicy — the search-time knobs (counterpart of
``repro.db.config``).

Field names, defaults, checks and the dict form are the reference's, so
a config saved by either package loads in the other.  Which searcher
serves a name is the registry's business (``repro_torch.db.registry``):
``validate`` checks only that ``searcher`` is a name, and
``make_searcher`` refuses one the port does not serve.  The knobs of
tiers the port does not have yet (:data:`QUEUED`) are carried through
the dict form as data, and ``validate`` refuses any value of theirs but
the default, so setting one never silently does nothing.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional

from repro_torch.kernels import ops

_HEDGE_POLICIES = ("off", "fixed", "adaptive")

_BATCH_MODES = ("fixed", "adaptive")

#: knob -> the tier that would serve it, queued in ROADMAP.md §1
QUEUED = {
    "replication": "the fleet", "fleet_workers": "the fleet",
    "hedge_policy": "the fleet", "hedge_ms": "the fleet",
    "subseq_window": "subsequence search",
    "subseq_hop": "subsequence search",
    "exclusion_zone": "subsequence search",
}


def _known_fields(cls, d: Dict[str, Any], where: str) -> Dict[str, Any]:
    """``d`` without the keys ``cls`` has no field for (a config written
    by a newer release), warning about them."""
    known = {f.name for f in dataclasses.fields(cls)}
    extra = sorted(set(d) - known)
    if extra:
        warnings.warn(f"{where}: ignoring unknown fields {extra}",
                      RuntimeWarning, stacklevel=3)
    return {k: v for k, v in d.items() if k in known}


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """The dynamic batcher's policy (``repro/db/config.py:34-160``):
    ``mode`` "fixed" closes a batch at ``max_batch`` requests or
    ``max_wait_ms``; "adaptive" waits between ``min_wait_ms`` and
    ``max_wait_ms`` by queue depth and an EWMA (weight ``ewma_alpha``)
    of batch service time scaled by ``gain``.  The ``ServingEngine``
    (``repro_torch.serving.engine``) reads it: :meth:`wait_budget_s` is
    the adaptive control law, :meth:`buckets` the padded batch sizes."""

    mode: str = "fixed"
    max_batch: int = 8
    max_wait_ms: float = 2.0
    min_wait_ms: float = 0.05
    gain: float = 0.5
    ewma_alpha: float = 0.3

    def validate(self) -> "BatchPolicy":
        if self.mode not in _BATCH_MODES:
            raise ValueError(f"batch mode must be one of {_BATCH_MODES}, "
                             f"got {self.mode!r}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if not 0 <= self.min_wait_ms <= self.max_wait_ms:
            raise ValueError(
                f"min_wait_ms ({self.min_wait_ms}) must be within "
                f"[0, max_wait_ms={self.max_wait_ms}]")
        if self.gain <= 0:
            raise ValueError(f"gain must be > 0, got {self.gain}")
        if not 0 < self.ewma_alpha <= 1:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")
        return self

    def replace(self, **changes: Any) -> "BatchPolicy":
        """``dataclasses.replace`` + ``validate`` in one step."""
        return dataclasses.replace(self, **changes).validate()

    def buckets(self) -> List[int]:
        """Padded batch sizes of the dynamic batcher: the powers of two
        below ``max_batch``, then ``max_batch``."""
        out, b = [], 1
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return out

    def wait_budget_s(self, have: int, depth: int,
                      service_ewma_s: Optional[float],
                      engine_idle: bool = True,
                      arrival_gap_s: Optional[float] = None) -> float:
        """Seconds the batcher keeps a ``have``-request batch open with
        ``depth`` queued behind it (``repro/db/config.py:104-153``).

        Fixed mode returns ``max_wait_ms``.  Adaptive mode: 0 when the
        queue covers the batch; ``min_wait_ms`` when the batch opened
        while the engine was busy; ``max_wait_ms`` before the first
        service-time sample; else ``clip(gain * S * (1 - fill), min,
        max)`` with ``fill = (have + depth) / max_batch`` and ``S`` the
        EWMA of batch service seconds, unless the EWMA of arrival gaps
        exceeds that, when waiting would coalesce nothing
        (``min_wait_ms``).  The same operations in the same order as the
        reference, so the same float comes out."""
        if self.mode == "fixed":
            return self.max_wait_ms / 1e3
        if have + depth >= self.max_batch:
            return 0.0
        if not engine_idle:
            return self.min_wait_ms / 1e3
        if service_ewma_s is None:
            return self.max_wait_ms / 1e3
        fill = (have + depth) / self.max_batch
        budget = min(max(self.gain * service_ewma_s * (1.0 - fill),
                         self.min_wait_ms / 1e3),
                     self.max_wait_ms / 1e3)
        if arrival_gap_s is not None and arrival_gap_s > budget:
            return self.min_wait_ms / 1e3
        return budget

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BatchPolicy":
        return cls(**_known_fields(cls, d, "BatchPolicy.from_dict"))


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Every search-time knob (semantics as ``repro/db/config.py:163-287``).

    Probe: ``topk`` results from ``top_c`` hash candidates;
    ``rank_by_signature`` (all K hashes, else the L band keys);
    ``multiprobe_offsets`` (δ-residue shifts of the query, max count);
    ``use_host_buckets`` (the paper's dict tables, ``"local"`` only).
    Re-rank: ``band`` (Sakoe-Chiba radius, ``None`` unconstrained),
    ``use_lb_cascade``, ``seed_size``, ``early_abandon``.  Execution:
    ``backend`` ("auto"/"pallas": the CUDA kernels on the card, plain
    versions on the CPU; "jnp": plain versions, CPU only), ``searcher``
    (a name in ``repro_torch.db.registry``), ``batch_policy`` (the
    ``"engine"`` searcher's batcher).  The fleet
    (``replication``, ``fleet_workers``, ``hedge_policy``, ``hedge_ms``)
    and subsequence (``subseq_window``, ``subseq_hop``,
    ``exclusion_zone``) knobs round-trip through the dict form, but their
    tiers are queued in ROADMAP.md §1: ``validate`` checks them as the
    reference does and then refuses any value but the default.
    ``stage_timings`` records per-stage seconds."""

    topk: int = 10
    top_c: int = 256
    band: Optional[int] = None
    use_lb_cascade: bool = True
    rank_by_signature: bool = True
    multiprobe_offsets: int = 1
    use_host_buckets: bool = False
    seed_size: Optional[int] = None
    early_abandon: bool = True
    backend: str = "auto"
    searcher: str = "batched"
    batch_policy: BatchPolicy = BatchPolicy()
    replication: int = 1
    fleet_workers: Optional[int] = None
    hedge_policy: str = "adaptive"
    hedge_ms: float = 30.0
    stage_timings: bool = True
    subseq_window: Optional[int] = None
    subseq_hop: int = 1
    exclusion_zone: Optional[int] = None

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
        if not isinstance(self.searcher, str) or not self.searcher:
            raise ValueError(f"searcher must be a non-empty string, "
                             f"got {self.searcher!r}")
        if self.use_host_buckets and self.searcher != "local":
            raise ValueError(
                "use_host_buckets is only served by the 'local' searcher "
                f"(got searcher={self.searcher!r}); the batched path "
                "probes the device-side key matrix")
        if not isinstance(self.batch_policy, BatchPolicy):
            raise ValueError(f"batch_policy must be a BatchPolicy, "
                             f"got {type(self.batch_policy).__name__}")
        self.batch_policy.validate()
        if self.replication < 1:
            raise ValueError(
                f"replication must be >= 1, got {self.replication}")
        if self.fleet_workers is not None and self.fleet_workers < 1:
            raise ValueError(f"fleet_workers must be None or >= 1, "
                             f"got {self.fleet_workers}")
        if (self.fleet_workers is not None
                and self.replication > self.fleet_workers):
            raise ValueError(
                f"replication ({self.replication}) > fleet_workers "
                f"({self.fleet_workers}): each shard needs that many "
                "distinct workers")
        if self.hedge_policy not in _HEDGE_POLICIES:
            raise ValueError(f"hedge_policy must be one of "
                             f"{_HEDGE_POLICIES}, got {self.hedge_policy!r}")
        if self.hedge_ms <= 0:
            raise ValueError(f"hedge_ms must be > 0, got {self.hedge_ms}")
        if self.subseq_window is not None and self.subseq_window < 1:
            raise ValueError(f"subseq_window must be None or >= 1, "
                             f"got {self.subseq_window}")
        if self.subseq_hop < 1:
            raise ValueError(f"subseq_hop must be >= 1, "
                             f"got {self.subseq_hop}")
        if self.exclusion_zone is not None and self.exclusion_zone < 0:
            raise ValueError(f"exclusion_zone must be None or >= 0, "
                             f"got {self.exclusion_zone}")
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if f.name in QUEUED and value != f.default:
                raise ValueError(
                    f"{f.name}={value!r} needs {QUEUED[f.name]}, which the "
                    "port does not have yet (queued in ROADMAP.md §1); leave "
                    "it at its default (a saved database's config is "
                    "replaced by TimeSeriesDB.load(..., config=))")
        return self

    def replace(self, **changes: Any) -> "SearchConfig":
        return dataclasses.replace(self, **changes).validate()

    def buckets(self) -> List[int]:
        """Padded batch sizes of the dynamic batcher
        (``batch_policy.buckets()``)."""
        return self.batch_policy.buckets()

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready dict; ``batch_policy`` nests as its own dict."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SearchConfig":
        """Inverse of ``to_dict``, tolerant as the reference's
        (``repro/db/config.py:399-424``): unknown keys are dropped with a
        warning, and the flat ``max_batch``/``max_wait_ms`` keys of older
        saves fold into ``batch_policy``."""
        d = dict(d)
        policy = d.get("batch_policy")
        policy = (BatchPolicy.from_dict(policy) if isinstance(policy, dict)
                  else policy if policy is not None else BatchPolicy())
        flat = {k: d.pop(k) for k in ("max_batch", "max_wait_ms") if k in d}
        flat = {k: v for k, v in flat.items() if v is not None}
        if flat:
            policy = dataclasses.replace(policy, **flat)
        d["batch_policy"] = policy
        return cls(**_known_fields(cls, d, "SearchConfig.from_dict"))
