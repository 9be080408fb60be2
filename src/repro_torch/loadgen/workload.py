"""Workload specification → replayable request trace (counterpart of
``repro.loadgen.workload``; DESIGN.md §12).

A ``WorkloadSpec`` is declarative and frozen: arrival process + rate +
mixtures over query length and top-k.  ``generate_trace`` lowers it to a
``RequestTrace`` — plain numpy arrays fully determined by the spec's
seed, so the *same* trace can be replayed against different engines and
batch policies (the bit-identity tests depend on exactly this).

Query *content* is deliberately indirect: the trace carries pool indices
per request, not series — callers pair a trace with a query pool (any
array of shape ``(pool_size, length)`` per length in the mixture), so a
trace generated once drives synthetic ECG today and a real dataset
tomorrow without re-deriving arrival times.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.loadgen.arrivals import ARRIVAL_PROCESSES, make_arrivals


@dataclasses.dataclass(frozen=True)
class Mixture:
    """Discrete distribution over workload attribute values."""

    values: Tuple[int, ...]
    weights: Tuple[float, ...] = ()

    def validate(self) -> "Mixture":
        if not self.values:
            raise ValueError("Mixture needs at least one value")
        if self.weights and len(self.weights) != len(self.values):
            raise ValueError(
                f"weights ({len(self.weights)}) must match values "
                f"({len(self.values)})")
        if self.weights and (min(self.weights) < 0
                             or sum(self.weights) <= 0):
            raise ValueError("weights must be non-negative with a "
                             "positive sum")
        return self

    def probabilities(self) -> np.ndarray:
        if not self.weights:
            return np.full(len(self.values), 1.0 / len(self.values))
        w = np.asarray(self.weights, dtype=np.float64)
        return w / w.sum()

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        self.validate()
        return rng.choice(np.asarray(self.values), size=n,
                          p=self.probabilities())

    def to_dict(self) -> Dict[str, Any]:
        return {"values": list(self.values), "weights": list(self.weights)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Mixture":
        return cls(tuple(d["values"]), tuple(d.get("weights", ())))


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Everything that determines a synthetic traffic trace."""

    process: str = "poisson"            # ARRIVAL_PROCESSES key
    rate_qps: float = 50.0              # mean offered load
    n_requests: int = 256
    seed: int = 0
    lengths: Mixture = Mixture((128,))  # query length mixture
    topks: Mixture = Mixture((10,))     # per-request top-k mixture
    # process-specific shape knobs (ignored by processes not using them)
    burst_factor: float = 4.0           # mmpp: burst/quiet rate ratio
    dwell_s: float = 0.25               # mmpp: mean state dwell
    period_s: float = 20.0              # diurnal: ramp period
    depth: float = 0.8                  # diurnal: modulation depth

    def validate(self) -> "WorkloadSpec":
        if self.process not in ARRIVAL_PROCESSES:
            raise ValueError(
                f"unknown arrival process {self.process!r}; choose from "
                f"{sorted(ARRIVAL_PROCESSES)}")
        if self.rate_qps <= 0:
            raise ValueError(f"rate_qps must be > 0, got {self.rate_qps}")
        if self.n_requests < 1:
            raise ValueError(
                f"n_requests must be >= 1, got {self.n_requests}")
        self.lengths.validate()
        self.topks.validate()
        if min(self.topks.values) < 1:
            raise ValueError("every topk in the mixture must be >= 1")
        return self

    def replace(self, **changes) -> "WorkloadSpec":
        return dataclasses.replace(self, **changes).validate()

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["lengths"] = self.lengths.to_dict()
        d["topks"] = self.topks.to_dict()
        return d


@dataclasses.dataclass(frozen=True)
class RequestTrace:
    """A lowered workload: one row per request, seeded and replayable.

    ``pool_ids`` index into a caller-supplied query pool *for that
    request's length* — the trace never owns series data.
    """

    spec: WorkloadSpec
    arrivals_s: np.ndarray              # sorted absolute offsets (s)
    lengths: np.ndarray                 # per-request query length
    topks: np.ndarray                   # per-request top-k
    pool_ids: np.ndarray                # per-request index into the pool

    def __len__(self) -> int:
        return int(self.arrivals_s.shape[0])

    @property
    def duration_s(self) -> float:
        return float(self.arrivals_s[-1])


def generate_trace(spec: WorkloadSpec,
                   pool_sizes: Mapping[int, int]) -> RequestTrace:
    """Lower a spec against pool sizes (length → number of candidate
    queries at that length).  Same spec + same pool sizes → identical
    trace, down to the last bit."""
    spec.validate()
    missing = set(spec.lengths.values) - set(pool_sizes)
    if missing:
        raise ValueError(
            f"no query pool for lengths {sorted(missing)}; "
            f"pools cover {sorted(pool_sizes)}")
    kwargs: Dict[str, Any] = {}
    if spec.process == "mmpp":
        kwargs = dict(burst_factor=spec.burst_factor, dwell_s=spec.dwell_s)
    elif spec.process == "diurnal":
        kwargs = dict(period_s=spec.period_s, depth=spec.depth)
    arrivals = make_arrivals(spec.process, spec.rate_qps, spec.n_requests,
                             seed=spec.seed, **kwargs)
    # attribute streams draw from independent child seeds so adding a
    # mixture value never perturbs the arrival times
    rng = np.random.default_rng(np.random.SeedSequence(spec.seed).spawn(1)[0])
    lengths = spec.lengths.sample(rng, spec.n_requests).astype(np.int64)
    topks = spec.topks.sample(rng, spec.n_requests).astype(np.int64)
    uniforms = rng.uniform(size=spec.n_requests)
    sizes = np.asarray([pool_sizes[int(ln)] for ln in lengths])
    pool_ids = np.minimum((uniforms * sizes).astype(np.int64), sizes - 1)
    return RequestTrace(spec=spec, arrivals_s=arrivals, lengths=lengths,
                        topks=topks, pool_ids=pool_ids)
