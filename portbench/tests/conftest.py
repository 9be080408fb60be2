"""Fixtures of the benchmark's tests: the paths, the card, and a tiny
copy of the benchmark whose cells run on the CPU in seconds.

    python -m pytest portbench/tests -q

The tests need no card; the one that does skips without it (decided in
the ``cuda`` fixture).
"""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the program's kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def make_tiny(root: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` under ``root``
    with tiny cells: ``tiny-bulk`` and ``tiny-serve`` on ssh-ecg's
    encoder, ``tiny-rw-bulk`` on ssh-randomwalk's, at 256 points, a few
    thousand rows, top-C 64, blocks of 8."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    for src, dst, n in (("ssh-ecg", "tiny-ecg", 4096),
                        ("ssh-randomwalk", "tiny-rw", 2048)):
        c = json.loads((pb / "configs" / f"{src}.json").read_text())
        c.update(length=256, n_subsequences=n, top_c=64)
        (pb / "configs" / f"{dst}.json").write_text(json.dumps(c))
        bench["configs"].append(dict(
            name=dst, source=f"test copy of {src}", reduced=[], why="test",
            file=f"portbench/configs/{dst}.json"))
    for src, dst in (("ecg-bulk-m512", "tiny-bulk"),
                     ("ecg-serve-m512", "tiny-serve")):
        t = json.loads((pb / "workloads" / f"{src}.json").read_text())
        t["pool"]["pool_qps"] = 40
        t["sample"] = 12
        if t["driver"] == "bulk":
            t.update(block=8, warmup_blocks=1)
        else:
            t.update(rate_qps=20, warmup_seconds=0.3)
            t["policy"]["max_batch"] = 8
        (pb / "workloads" / f"{dst}.json").write_text(json.dumps(t))
    bench["workloads"] += [
        dict(name="tiny-bulk", config="tiny-ecg", traffic="tiny-bulk",
             chips=1, why="test"),
        dict(name="tiny-rw-bulk", config="tiny-rw", traffic="tiny-bulk",
             chips=1, why="test"),
        dict(name="tiny-serve", config="tiny-ecg", traffic="tiny-serve",
             chips=1, why="test")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            bulk = any("bulk" in w for w in m["workloads"])
            m["workloads"] += (["tiny-bulk", "tiny-rw-bulk"] if bulk
                               else ["tiny-serve"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("portbench_tiny"))
