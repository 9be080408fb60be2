"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Each lives in a file of its own, so a later change adds a cell, a
configuration or a metric by adding files and entries, never by editing
one:

* ``portbench/configs/<config>.json``: the deployment (encoder, series
  length, database rows, search knobs), as it is run;
* ``portbench/workloads/<traffic>.json``: the traffic mix, the driver
  that reads it (``"driver"``) and the limits of the correctness check;
* ``portbench/drivers/<driver>.py``: a general traffic driver
  (``run(harness) -> Outcome``);
* ``portbench/metrics/<metric>.py``: the reader of one per-layer metric
  (``read(obs) -> float | None``).

:func:`validate` checks the file against the benchmark's name and unit
rules and that every named file exists.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

#: the directory that holds ``BENCHMARK.json`` and ``portbench/``
ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "portbench"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]

    @property
    def length(self) -> int:
        return int(self.config["length"])

    @property
    def n_rows(self) -> int:
        return int(self.config["n_subsequences"])

    @property
    def band(self) -> int:
        """The Sakoe-Chiba radius: 5 % of the length, at least 4 (the
        UCR suite's convention, as the configuration states it)."""
        return max(4, self.length // 20)

    @property
    def offsets(self) -> int:
        return int(self.config["multiprobe_offsets"])


def load(root: Path = ROOT) -> Dict[str, Any]:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def config_path(root: Path, bench: Dict[str, Any], name: str) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return Path(root) / c["file"]
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def workload_path(root: Path, traffic: str) -> Path:
    return Path(root) / PACKAGE / "workloads" / f"{traffic}.json"


def driver_path(root: Path, driver: str) -> Path:
    return Path(root) / PACKAGE / "drivers" / f"{driver}.py"


def metric_path(root: Path, metric: str) -> Path:
    return Path(root) / PACKAGE / "metrics" / f"{metric}.py"


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    cells = metric.get("workloads")
    return cells is None or cell in cells


def cell(name: str, root: Path = ROOT,
         bench: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` with its configuration and traffic files read,
    and the metrics it reports."""
    bench = bench if bench is not None else load(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    # a per-layer metric without a list of cells goes wherever the
    # end-to-end metric it moves is reported
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=_read_json(config_path(root, bench, entry["config"])),
                traffic=_read_json(workload_path(root, entry["traffic"])),
                end_to_end=e2e, per_layer=layer)


def load_module(path: Path, label: str):
    """Import one file by path (drivers and metric readers carry names
    with dots and dashes, which no import statement takes)."""
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}_{label}", str(path))
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _one_line(text: Any, limit: int = 200) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def validate(root: Path = ROOT, bench: Optional[Dict[str, Any]] = None
             ) -> List[str]:
    """Every fault of ``BENCHMARK.json`` and of the files it names, as
    sentences; an empty list is a valid benchmark."""
    root = Path(root)
    bench = bench if bench is not None else load(root)
    bad: List[str] = []
    if tuple(sorted(bench)) != tuple(sorted(TOP_KEYS)):
        bad.append(f"top-level keys {sorted(bench)} are not {sorted(TOP_KEYS)}")
    cmd = bench.get("command", [])
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32
            and all(_one_line(w) for w in cmd)):
        bad.append("command is not a list of 1 to 32 one-line words")
    for p in bench.get("paths", []):
        if not re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) or p.startswith(
                "/") or ".." in p.split("/"):
            bad.append(f"path {p!r} breaks the path rule")
    rs = bench.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        bad.append(f"run_seconds {rs!r} is not a whole number from 1 to 51")
    names: Dict[str, str] = {}

    def check_name(kind: str, name: Any) -> None:
        if not isinstance(name, str) or not NAME_RE.match(name):
            bad.append(f"{kind} name {name!r} breaks the name rule")
        elif kind in ("metric", "cell", "config"):
            key = f"{kind}:{name}"
            if key in names:
                bad.append(f"{kind} name {name!r} is used twice")
            names[key] = name

    configs = {c.get("name"): c for c in bench.get("configs", [])}
    for c in bench.get("configs", []):
        check_name("config", c.get("name"))
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            bad.append(f"config {c.get('name')!r} has keys {sorted(c)}")
        for k in c.get("reduced", []):
            check_name("reduced key", k)
        if not _one_line(c.get("source")) or not _one_line(c.get("why")):
            bad.append(f"config {c.get('name')!r}: source or why is not one "
                       "line of 1 to 200 characters")
        if not (root / c.get("file", "")).is_file():
            bad.append(f"config file {c.get('file')!r} is missing")
    cells = {w.get("name") for w in bench.get("workloads", [])}
    pairs = set()
    for w in bench.get("workloads", []):
        check_name("cell", w.get("name"))
        check_name("traffic", w.get("traffic"))
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            bad.append(f"workload {w.get('name')!r} has keys {sorted(w)}")
        if w.get("config") not in configs:
            bad.append(f"workload {w.get('name')!r} names an unknown config")
        if w.get("chips") not in (1, 4):
            bad.append(f"workload {w.get('name')!r}: chips is not 1 or 4")
        if not _one_line(w.get("why")):
            bad.append(f"workload {w.get('name')!r}: why is not one line")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            bad.append(f"configuration and traffic {pair} appear twice")
        pairs.add(pair)
        tpath = workload_path(root, str(w.get("traffic")))
        if not tpath.is_file():
            bad.append(f"traffic file {tpath.relative_to(root)} is missing")
            continue
        driver = _read_json(tpath).get("driver")
        if not driver_path(root, str(driver)).is_file():
            bad.append(f"driver {driver!r} of {w.get('name')!r} is missing")
    e2e = {m.get("name"): m for m in bench.get("end_to_end", [])}
    if "setup_s" not in e2e:
        bad.append("no setup_s among the end-to-end metrics")
    for kind, metrics in (("end_to_end", bench.get("end_to_end", [])),
                          ("per_layer", bench.get("per_layer", []))):
        for m in metrics:
            check_name("metric", m.get("name"))
            unit = m.get("unit")
            if not isinstance(unit, str) or not UNIT_RE.match(unit):
                bad.append(f"metric {m.get('name')!r}: unit {unit!r} breaks "
                           "the unit rule")
            if m.get("better") not in ("lower", "higher"):
                bad.append(f"metric {m.get('name')!r}: better is not "
                           "lower or higher")
            for c in m.get("workloads", []):
                if c not in cells:
                    bad.append(f"metric {m.get('name')!r} lists an unknown "
                               f"cell {c!r}")
            if kind == "end_to_end":
                keys = {"name", "unit", "better", "bound", "source"}
                if m.get("source") not in SOURCES_E2E:
                    bad.append(f"metric {m.get('name')!r}: source "
                               f"{m.get('source')!r} is not host_clock or "
                               "device_trace")
                b = m.get("bound")
                if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
                    bad.append(f"metric {m.get('name')!r}: bound {b!r} is "
                               "outside 0.01 to 0.25")
            else:
                keys = {"name", "unit", "better", "source", "layer", "moves"}
                if m.get("source") not in SOURCES:
                    bad.append(f"metric {m.get('name')!r}: unknown source")
                if m.get("moves") not in e2e:
                    bad.append(f"metric {m.get('name')!r} moves an unknown "
                               "end-to-end metric")
                if not _one_line(m.get("layer")):
                    bad.append(f"metric {m.get('name')!r}: layer is not one "
                               "line")
                if not metric_path(root, str(m.get("name"))).is_file():
                    bad.append(f"reader of {m.get('name')!r} is missing")
            extra = set(m) - keys - {"workloads"}
            missing = keys - set(m)
            if extra or missing:
                bad.append(f"metric {m.get('name')!r}: keys {sorted(m)}")
    return bad


def readers(root: Path = ROOT) -> Dict[str, Path]:
    """Every per-layer metric reader on disk, by metric name."""
    return {p.stem: p for p in
            sorted((Path(root) / PACKAGE / "metrics").glob("*.py"))
            if not p.name.startswith("_")}
