"""The port's bench runner, regression diff and validator against the JAX
package's, on the committed ``benchmarks/baselines/smoke`` reports.

Both packages read the same BENCH_*.json schema, so each test runs the
reference and the port on the same files and holds their findings,
missing reports and exit codes equal.  The "current" directories are the
baselines with seeded edits: an entry 3x slower, one 3x faster, one
gone, one new, a precision drop, a scale mismatch and a missing file.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from repro.bench import regression as jregression
from repro.bench import runner as jrunner
from repro.bench import schema as jschema
from repro.bench import validate as jvalidate
from repro_torch.bench import regression, runner, schema, validate

pytestmark = pytest.mark.torch_port

BASELINES = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "baselines" / "smoke"
FILES = sorted(p.name for p in BASELINES.glob("BENCH_*.json"))


def _as_tuple(f):
    return (f.kind, f.entry, f.metric, f.baseline, f.current,
            f.is_failure, str(f))


def _edited(tmp_path, seed):
    """A copy of the baselines with seeded edits; returns its directory."""
    rng = np.random.default_rng(seed)
    cur = tmp_path / "current"
    shutil.copytree(BASELINES, cur)
    names = list(FILES)
    rng.shuffle(names)
    (cur / names[0]).unlink()                         # a missing report
    doc = json.loads((cur / names[1]).read_text())
    doc["scale"] = "full" if doc["scale"] != "full" else "small"
    (cur / names[1]).write_text(json.dumps(doc))      # a scale mismatch
    for name in names[2:]:
        doc = json.loads((cur / name).read_text())
        res = doc["results"]
        for r in res:
            kind = rng.integers(0, 6)
            if kind == 0:
                r["us_per_query"] *= 3.0
            elif kind == 1:
                r["us_per_query"] /= 3.0
            elif kind == 2 and r.get("precision_at_k") is not None:
                r["precision_at_k"] = max(0.0, r["precision_at_k"] - 0.3)
        if len(res) > 1 and rng.integers(0, 2):
            res.pop(int(rng.integers(0, len(res))))
        res.append(dict(res[0], name=f"{res[0]['name']}/new"))
        (cur / name).write_text(json.dumps(doc))
    return cur


def test_baselines_load_alike():
    assert FILES
    for name in FILES:
        a = schema.load_report(BASELINES / name)
        b = jschema.load_report(BASELINES / name)
        assert a.to_dict() == b.to_dict()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compare_dirs_gives_the_reference_findings(tmp_path, seed):
    cur = _edited(tmp_path, seed)
    got, missing = runner.compare_dirs(cur, BASELINES)
    want, jmissing = jrunner.compare_dirs(cur, BASELINES)
    assert missing == jmissing and len(missing) == 1
    assert [_as_tuple(f) for f in got] == [_as_tuple(f) for f in want]
    kinds = {f.kind for f in got}
    assert {"regression", "missing", "new", "mismatch"} <= kinds
    assert ([_as_tuple(f) for f in regression.failures(got)]
            == [_as_tuple(f) for f in jregression.failures(want)])
    only = [n[len("BENCH_"):-len(".json")] for n in FILES[:4]]
    got, missing = runner.compare_dirs(cur, BASELINES, modules=only,
                                       rel_threshold=0.5, min_us=10.0,
                                       precision_tol=0.05)
    want, jmissing = jrunner.compare_dirs(cur, BASELINES, modules=only,
                                          rel_threshold=0.5, min_us=10.0,
                                          precision_tol=0.05)
    assert missing == jmissing
    assert [_as_tuple(f) for f in got] == [_as_tuple(f) for f in want]


def test_compare_reports_on_each_baseline_against_itself():
    for name in FILES:
        a = schema.load_report(BASELINES / name)
        b = jschema.load_report(BASELINES / name)
        assert regression.compare_reports(a, a) == []
        assert jregression.compare_reports(b, b) == []


def test_validate_main_exit_codes(tmp_path, capsys):
    files = [str(BASELINES / n) for n in FILES]
    for argv in (files, files + ["--no-require-stages"]):
        assert validate.main(argv) == jvalidate.main(argv)
    bad = tmp_path / "BENCH_bad.json"
    bad.write_text(json.dumps({"schema_version": 1, "name": "x"}))
    broken = tmp_path / "BENCH_broken.json"
    broken.write_text("{not json")
    doc = json.loads((BASELINES / FILES[0]).read_text())
    for r in doc["results"]:
        r.pop("stage_us", None)
    stageless = tmp_path / "BENCH_stageless.json"
    stageless.write_text(json.dumps(doc))
    for paths in ([str(bad)], [str(broken)], [str(stageless)],
                  [str(stageless), "--no-require-stages"],
                  [str(tmp_path / "BENCH_absent.json")]):
        want = jvalidate.main(paths)
        assert validate.main(paths) == want
    assert validate.main([str(stageless), "--no-require-stages"]) == 0
    assert validate.main([str(bad)]) == 1


def test_runner_report_passes_the_reference_validator(tmp_path):
    run = runner.BenchRunner("smoke", tmp_path, sha="abc123")
    assert run.host["torch"] and "cuda" in run.host
    run.start_module("table3_query_time")
    run.record(schema.BenchResult(
        name="table3/ecg/len128", case=schema.BenchCase(
            dataset="ecg", length=128, n_database=1000, backend="auto"),
        us_per_query=1234.5,
        stage_us={"encode": 1.0, "probe": 2.0, "lb": 3.0,
                  "lb_improved": 0.5, "dtw": 4.0}))
    with pytest.raises(RuntimeError):
        run.start_module("another")
    path = run.finish_module()
    doc = json.loads(path.read_text())
    jschema.validate_report(doc)
    assert jschema.has_full_stage_breakdown(doc)
    assert jvalidate.main([str(path)]) == 0
    with pytest.raises(RuntimeError):
        run.record(schema.BenchResult(name="x", us_per_query=1.0))
    quiet = runner.BenchRunner("smoke", tmp_path / "none", write_json=False,
                               sha="")
    quiet.start_module("m")
    quiet.record(schema.BenchResult(name="x", us_per_query=1.0))
    assert quiet.finish_module() is None and "m" in quiet.reports
    assert not (tmp_path / "none").exists()
