"""``BenchRunner`` collects ``BenchResult``s and writes one
``BENCH_<module>.json`` a benchmark module (counterpart of
``repro.bench.runner``), and :func:`compare_dirs` diffs a directory of
such reports against a baseline directory.

The reports follow the reference's schema (``bench.schema``), so either
package's tools read the other's.  :func:`host_fingerprint` records
what a timing depends on here: torch and CUDA versions and, where there
is a card, its name and power limit as ``nvidia-smi`` reports them.
"""
from __future__ import annotations

import platform
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from repro_torch.bench import regression as reg
from repro_torch.bench.schema import (BenchReport, BenchResult, dump_report,
                                      load_report)


def git_sha(repo_dir: Optional[str] = None) -> str:
    """Current commit sha ("" outside a git checkout or without git)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo_dir,
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the cards, one line
    each, or "" where there is no ``nvidia-smi`` or it fails."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return ""
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


def host_fingerprint() -> Dict[str, str]:
    host = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "device_count": str(torch.cuda.device_count()),
    }
    if torch.cuda.is_available():
        host["device"] = torch.cuda.get_device_name(0)
        host["nvidia_smi"] = gpu_name_and_power_limit()
    return host


class BenchRunner:
    """Accumulates results per benchmark module; writes one report each.

    ``write_json=False`` keeps the reports in memory only (``reports``).
    """

    def __init__(self, scale: str, out_dir: str | Path = ".",
                 write_json: bool = True, sha: Optional[str] = None):
        self.scale = scale
        self.out_dir = Path(out_dir)
        self.write_json = write_json
        self.sha = git_sha() if sha is None else sha
        self.host = host_fingerprint()
        self.reports: Dict[str, BenchReport] = {}
        self._module: Optional[str] = None
        self._results: List[BenchResult] = []

    def start_module(self, name: str) -> None:
        if self._module is not None:
            raise RuntimeError(f"module {self._module!r} still open")
        self._module = name
        self._results = []

    def record(self, result: BenchResult) -> None:
        if self._module is None:
            raise RuntimeError("record() outside start_module/finish_module")
        self._results.append(result)

    def finish_module(self) -> Optional[Path]:
        """Validate and (optionally) write the open module's report; the
        written path, or None when nothing was recorded or JSON output is
        off."""
        name, results = self._module, self._results
        self._module, self._results = None, []
        if not results:
            return None
        report = BenchReport(
            name=name, scale=self.scale, git_sha=self.sha,
            results=results, host=self.host, created_unix=time.time())
        self.reports[name] = report
        if not self.write_json:
            return None
        return dump_report(report, self.out_dir / f"BENCH_{name}.json")


def compare_dirs(current_dir: str | Path, baseline_dir: str | Path, *,
                 modules: Optional[List[str]] = None,
                 rel_threshold: float = reg.DEFAULT_REL_THRESHOLD,
                 min_us: float = reg.DEFAULT_MIN_US,
                 precision_tol: float = reg.DEFAULT_PRECISION_TOL):
    """Diff baseline ``BENCH_*.json`` files against their counterparts in
    ``current_dir``.

    ``modules`` restricts the diff to ``BENCH_<module>.json`` names;
    ``None`` diffs every baseline file.  Returns ``(findings,
    missing_reports)``, where ``missing_reports`` names baseline files
    with no counterpart in ``current_dir``.  Current reports without a
    baseline are ignored.
    """
    current_dir, baseline_dir = Path(current_dir), Path(baseline_dir)
    if modules is None:
        names = sorted(p.name for p in baseline_dir.glob("BENCH_*.json"))
    else:
        names = [f"BENCH_{m}.json" for m in modules
                 if (baseline_dir / f"BENCH_{m}.json").exists()]
    findings, missing = [], []
    for name in names:
        cur_path = current_dir / name
        if not cur_path.exists():
            missing.append(name)
            continue
        findings.extend(reg.compare_reports(
            load_report(cur_path), load_report(baseline_dir / name),
            rel_threshold=rel_threshold, min_us=min_us,
            precision_tol=precision_tol))
    return findings, missing
