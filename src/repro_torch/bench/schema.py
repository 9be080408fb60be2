"""Versioned benchmark result schema (counterpart of
``repro.bench.schema``; DESIGN.md §8).

One ``BENCH_<module>.json`` file per benchmark module, in the
reference's format, so a report written by either package validates
and loads in the other:

* :class:`BenchCase` — the frozen workload identity of one measurement
  (dataset, length, database size, batch, ``IndexSpec``/``SearchConfig``
  dicts, resolved kernel backend).  Two runs with equal cases are
  comparable; the baseline diff matches entries by name and assumes the
  case is part of that name's contract.
* :class:`BenchResult` — one measured row: latency (``us_per_query``
  plus p50/p95 when multiple samples exist), the per-stage breakdown in
  microseconds (``stage_us``: encode/probe/lb/dtw), pruning and quality
  (``lb_pruned_frac``, ``precision_at_k``), build time, and a free-form
  ``derived`` dict holding the historical CSV payload.
* :class:`BenchReport` — the file: schema version, module name, git sha,
  scale, host fingerprint, and the result rows.

``validate_report`` is the single gate every emitted file passes:
``dump_report`` validates before writing and ``load_report`` after
reading.  ``STAGE_KEYS`` is also the set of stage keys
``serving.metrics.ServingMetrics`` keeps a running mean of.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.bench.timing import STAGES

SCHEMA_VERSION = 1

SCALES = ("smoke", "small", "full")

#: stage_us may carry the canonical stages plus "fused" (the
#: distributed fan-out cannot split its shard_map program) and
#: "encode_amortized" (subsequence search: the build-side rolling
#: encode seconds divided over the indexed windows — the per-window
#: encode cost each query's probe amortises, constant per query).
STAGE_KEYS = STAGES + ("fused", "encode_amortized")


class SchemaError(ValueError):
    """A BENCH_*.json document violates the schema."""


@dataclasses.dataclass(frozen=True)
class BenchCase:
    """Frozen workload identity of one benchmark measurement."""

    dataset: str                      # "ecg" | "randomwalk" | "synthetic"
    length: int                       # series length m
    n_database: int                   # indexed series N
    batch: int = 1                    # queries per dispatch
    spec: Optional[Dict[str, Any]] = None     # IndexSpec.to_dict()
    config: Optional[Dict[str, Any]] = None   # SearchConfig.to_dict()
    backend: str = "jnp"              # resolved kernel backend

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BenchCase":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class BenchResult:
    """One measured benchmark row."""

    name: str                         # e.g. "table3/ecg/len128"
    us_per_query: float               # headline latency (mean)
    us_p50: Optional[float] = None
    us_p95: Optional[float] = None
    stage_us: Optional[Dict[str, float]] = None
    lb_pruned_frac: Optional[float] = None
    precision_at_k: Optional[float] = None
    build_s: Optional[float] = None
    case: Optional[BenchCase] = None
    derived: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["case"] = self.case.to_dict() if self.case is not None else None
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BenchResult":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if kw.get("case") is not None:
            kw["case"] = BenchCase.from_dict(kw["case"])
        return cls(**kw)


@dataclasses.dataclass
class BenchReport:
    """One BENCH_<name>.json document."""

    name: str                         # benchmark module, e.g. "table3_query_time"
    scale: str
    git_sha: str
    results: List[BenchResult]
    host: Dict[str, Any] = dataclasses.field(default_factory=dict)
    created_unix: float = 0.0
    schema_version: int = SCHEMA_VERSION

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "name": self.name,
            "scale": self.scale,
            "git_sha": self.git_sha,
            "created_unix": self.created_unix,
            "host": self.host,
            "results": [r.to_dict() for r in self.results],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BenchReport":
        return cls(
            name=d["name"], scale=d["scale"], git_sha=d.get("git_sha", ""),
            results=[BenchResult.from_dict(r) for r in d.get("results", [])],
            host=d.get("host", {}),
            created_unix=d.get("created_unix", 0.0),
            schema_version=d.get("schema_version", SCHEMA_VERSION))

    def result(self, name: str) -> Optional[BenchResult]:
        for r in self.results:
            if r.name == name:
                return r
        return None


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _finite_nonneg(x, where: str) -> None:
    if not isinstance(x, (int, float)) or isinstance(x, bool) \
            or not math.isfinite(x) or x < 0:
        raise SchemaError(f"{where}: expected finite number >= 0, got {x!r}")


def validate_report(doc: Dict[str, Any]) -> None:
    """Raise :class:`SchemaError` unless ``doc`` is a valid v1 report."""
    if not isinstance(doc, dict):
        raise SchemaError(f"report must be a JSON object, got {type(doc)}")
    if doc.get("schema_version") != SCHEMA_VERSION:
        raise SchemaError("schema_version must be "
                          f"{SCHEMA_VERSION}, got {doc.get('schema_version')!r}")
    for key in ("name", "scale", "git_sha"):
        if not isinstance(doc.get(key), str) or (key != "git_sha"
                                                 and not doc.get(key)):
            raise SchemaError(f"{key} must be a non-empty string")
    if doc["scale"] not in SCALES:
        raise SchemaError(f"scale must be one of {SCALES}, "
                          f"got {doc['scale']!r}")
    results = doc.get("results")
    if not isinstance(results, list) or not results:
        raise SchemaError("results must be a non-empty list")
    seen = set()
    for i, r in enumerate(results):
        where = f"results[{i}]"
        if not isinstance(r, dict):
            raise SchemaError(f"{where}: expected object")
        name = r.get("name")
        if not isinstance(name, str) or not name:
            raise SchemaError(f"{where}.name must be a non-empty string")
        if name in seen:
            raise SchemaError(f"duplicate result name {name!r}")
        seen.add(name)
        _finite_nonneg(r.get("us_per_query"), f"{where}.us_per_query")
        for opt in ("us_p50", "us_p95", "lb_pruned_frac",
                    "precision_at_k", "build_s"):
            if r.get(opt) is not None:
                _finite_nonneg(r[opt], f"{where}.{opt}")
        stage_us = r.get("stage_us")
        if stage_us is not None:
            if not isinstance(stage_us, dict):
                raise SchemaError(f"{where}.stage_us must be an object")
            unknown = sorted(set(stage_us) - set(STAGE_KEYS))
            if unknown:
                raise SchemaError(f"{where}.stage_us has unknown stages "
                                  f"{unknown}; known: {list(STAGE_KEYS)}")
            for k, v in stage_us.items():
                _finite_nonneg(v, f"{where}.stage_us[{k!r}]")


def has_full_stage_breakdown(doc: Dict[str, Any]) -> bool:
    """True when some result row carries all four canonical stages."""
    return any(set(STAGES) <= set(r.get("stage_us") or ())
               for r in doc.get("results", ()))


# ---------------------------------------------------------------------------
# file IO
# ---------------------------------------------------------------------------

def load_report(path: str | Path) -> BenchReport:
    with open(path) as f:
        doc = json.load(f)
    validate_report(doc)
    return BenchReport.from_dict(doc)


def dump_report(report: BenchReport, path: str | Path) -> Path:
    doc = report.to_dict()
    validate_report(doc)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return path
