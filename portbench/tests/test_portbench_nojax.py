"""No run loads JAX or the JAX package, and nothing of the benchmark
reads the JAX-era benchmark folder."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT, make_tiny

pytestmark = pytest.mark.torch_port

_PROBE = r"""
import json, sys, time
sys.modules["jax"] = None        # an import of jax now raises
sys.path[:0] = [ROOT, ROOT + "/src"]
from pathlib import Path
import portbench.run as run
from portbench import harness, spec, calibrate, sweep
for path in spec.readers(Path(TINY)).values():
    spec.load_module(path, path.stem)
for kind in ("bulk", "serve"):
    spec.load_module(spec.driver_path(Path(TINY), kind), kind)
line = run.run_cell("tiny-bulk", 3, 0.5, False, device="cpu",
                    root=Path(TINY), t_start=time.perf_counter())
print(json.dumps({"found": harness.forbidden_modules(),
                  "correct": line["correct"],
                  "tops": sorted({m.split(".")[0] for m, v in sys.modules.items()
                          if v is not None})}))
"""


def test_no_module_of_jax_or_the_jax_package_is_loaded(tmp_path):
    tiny = make_tiny(tmp_path)
    code = _PROBE.replace("ROOT", repr(str(ROOT))).replace(
        "TINY", repr(str(tiny)))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path)
    assert done.returncode == 0, done.stderr[-3000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got["found"] == []
    assert got["correct"] is True
    tops = set(got["tops"])
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxfake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.db", sys)
    assert harness.forbidden_modules() == ["repro.db"]


def test_nothing_reads_the_jax_era_benchmark_folder():
    old = "bench" + "marks"
    for path in (ROOT / "portbench").rglob("*.py"):
        text = path.read_text()
        for pattern in (f"{old}/", f'"{old}"', f"'{old}'", f"import {old}",
                        f"from {old}"):
            assert pattern not in text, (path, pattern)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert not any(old in w for w in bench["command"])
