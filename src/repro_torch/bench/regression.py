"""Perf-regression detection over BENCH_*.json trajectories (counterpart
of ``repro.bench.regression``).

The comparison is conservative about noise: a timing entry counts as a
regression only when it is slower than the baseline by more than
``rel_threshold`` (a *fraction*: 1.0 means "2x the baseline") AND both
sides are above ``min_us`` (sub-noise-floor timings flap, and their
absolute cost is irrelevant).  Quality metrics (``precision_at_k``) are
compared with an absolute tolerance: they are deterministic for fixed
seeds, but top-k tie-breaks can flip across library versions.

``compare_reports`` returns every finding (regressions, improvements,
entries missing from either side); callers decide severity.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.bench.schema import BenchReport

#: noise allowance for cross-run timing comparison: only
#: multiple-of-baseline slowdowns gate
DEFAULT_REL_THRESHOLD = 1.0
#: timings below this (on either side) are never compared
DEFAULT_MIN_US = 200.0
#: absolute allowed drop in precision_at_k
DEFAULT_PRECISION_TOL = 0.15


@dataclasses.dataclass
class Finding:
    kind: str    # "regression" | "improvement" | "missing" | "new" | "mismatch"
    entry: str   # result name, e.g. "table3/ecg/len128" (or report name)
    metric: str  # "us_per_query" | "precision_at_k" | "scale" | ""
    baseline: float | str = 0.0
    current: float | str = 0.0

    @property
    def is_failure(self) -> bool:
        return self.kind in ("regression", "missing", "mismatch")

    def __str__(self) -> str:
        if self.kind == "missing":
            return f"MISSING   {self.entry} (present in baseline, not in run)"
        if self.kind == "new":
            return f"NEW       {self.entry} (no baseline entry)"
        if self.kind == "mismatch":
            return (f"MISMATCH  {self.entry} {self.metric}: baseline "
                    f"{self.baseline!r} vs current {self.current!r} — "
                    "not comparable")
        ratio = self.current / self.baseline if self.baseline else float("inf")
        return (f"{self.kind.upper():<9} {self.entry} {self.metric}: "
                f"baseline {self.baseline:.1f} -> current {self.current:.1f} "
                f"({ratio:.2f}x)")


def compare_reports(current: BenchReport, baseline: BenchReport, *,
                    rel_threshold: float = DEFAULT_REL_THRESHOLD,
                    min_us: float = DEFAULT_MIN_US,
                    precision_tol: float = DEFAULT_PRECISION_TOL
                    ) -> List[Finding]:
    """All findings from diffing ``current`` against ``baseline``.

    A scale mismatch makes timings incomparable by construction, so it
    short-circuits into a single failing ``mismatch`` finding.
    """
    if current.scale != baseline.scale:
        return [Finding("mismatch", current.name, "scale",
                        baseline.scale, current.scale)]
    findings: List[Finding] = []
    cur_names = {r.name for r in current.results}
    for base in baseline.results:
        cur = current.result(base.name)
        if cur is None:
            findings.append(Finding("missing", base.name, ""))
            continue
        b_us, c_us = base.us_per_query, cur.us_per_query
        if min(b_us, c_us) >= min_us:
            if c_us > b_us * (1.0 + rel_threshold):
                findings.append(Finding("regression", base.name,
                                        "us_per_query", b_us, c_us))
            elif b_us > c_us * (1.0 + rel_threshold):
                findings.append(Finding("improvement", base.name,
                                        "us_per_query", b_us, c_us))
        if base.precision_at_k is not None \
                and cur.precision_at_k is not None:
            if cur.precision_at_k < base.precision_at_k - precision_tol:
                findings.append(Finding(
                    "regression", base.name, "precision_at_k",
                    base.precision_at_k, cur.precision_at_k))
    for name in sorted(cur_names - {r.name for r in baseline.results}):
        findings.append(Finding("new", name, ""))
    return findings


def failures(findings: List[Finding]) -> List[Finding]:
    return [f for f in findings if f.is_failure]
