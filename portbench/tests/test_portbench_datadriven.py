"""A configuration, a traffic mix and a per-layer metric are added by
adding files and entries: the harness lists, validates and runs them
with no file edited.  Every name and unit keeps to the allowed
characters."""
import hashlib
import json
import time
from pathlib import Path

import pytest

from conftest import ROOT, make_tiny
from portbench import spec

pytestmark = pytest.mark.torch_port


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_the_benchmark_is_valid():
    assert spec.validate(ROOT) == []


def test_names_and_units_keep_to_the_rules():
    bench = spec.load(ROOT)
    names = [c["name"] for c in bench["configs"]]
    names += [w[k] for w in bench["workloads"] for k in ("name", "config",
                                                          "traffic")]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(spec.NAME_RE.match(n) for n in names), names
    units = [m["unit"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(spec.UNIT_RE.match(u) for u in units), units
    for bad in ("has space", "a,b", "a/b", "µs", "", "x" * 65):
        assert not spec.NAME_RE.match(bad)
    for bad in ("queries per s", "µs", "", "x" * 17):
        assert not spec.UNIT_RE.match(bad)
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_per_layer_metric_has_its_reader():
    have = spec.readers(ROOT)
    for m in spec.load(ROOT)["per_layer"]:
        assert m["name"] in have


def test_a_new_cell_config_and_metric_need_no_edit(tmp_path):
    root = make_tiny(tmp_path)
    before = _digests(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "tiny-ecg.json").read_text())
    cfg.update(name="tiny-ecg-b", n_subsequences=3000)
    (pb / "configs" / "tiny-ecg-b.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "workloads" / "tiny-bulk.json").read_text())
    traffic["block"] = 4
    (pb / "workloads" / "tiny-bulk-b.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "blocks_in_window.py").write_text(
        '"""Blocks served in the window."""\n\n\n'
        "def read(obs):\n    return float(len(obs.block_stats()))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="tiny-ecg-b", source="test b",
                                 file="portbench/configs/tiny-ecg-b.json",
                                 reduced=["n_subsequences"], why="test"))
    bench["workloads"].append(dict(name="tiny-new", config="tiny-ecg-b",
                                   traffic="tiny-bulk-b", chips=1,
                                   why="a cell added by files alone"))
    bench["per_layer"].append(dict(
        name="blocks_in_window", unit="blocks", better="higher",
        source="program_counter", layer="serving/batched probe",
        moves="qps", workloads=["tiny-new"]))
    next(m for m in bench["end_to_end"] if m["name"] == "qps")[
        "workloads"].append("tiny-new")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.validate(root) == []
    cell = spec.cell("tiny-new", root)
    assert cell.n_rows == 3000 and cell.traffic["block"] == 4
    assert [m["name"] for m in cell.end_to_end] == ["qps", "setup_s"]
    assert "blocks_in_window" in [m["name"] for m in cell.per_layer]
    assert "blocks_in_window" in spec.readers(root)
    from portbench.run import run_cell
    line = run_cell("tiny-new", 11, 0.5, True, device="cpu", root=root,
                    t_start=time.perf_counter())
    assert line["correct"] is True
    assert line["metrics"]["blocks_in_window"]["value"] >= 1
    line = run_cell("tiny-new", 11, 0.5, False, device="cpu", root=root,
                    t_start=time.perf_counter())
    assert set(line["metrics"]) == {"qps", "setup_s"}
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_validation_names_the_faults(tmp_path):
    root = make_tiny(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="bad cell", config="nope",
                                   traffic="missing", chips=2, why="x"))
    bench["per_layer"].append(dict(name="no_reader", unit="ms",
                                   better="lower", source="host_clock",
                                   layer="x", moves="qps"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    bad = " | ".join(spec.validate(root))
    for fault in ("'bad cell' breaks the name rule", "unknown config",
                  "chips is not 1 or 4", "traffic file", "reader of "
                  "'no_reader' is missing"):
        assert fault in bad, bad
