"""The port's examples (``examples/torch_*.py``) run to their end on the
CPU at a cut size, and refuse to run without CUDA unless ``--device
cpu`` is passed, as every entry point of the port."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
CUT = {
    "torch_index_and_search": ["--points", "4000", "--length", "64",
                               "--smoke", "--queries", "2"],
    "torch_distributed_search": ["--points", "4000", "--length", "64",
                                 "--shards", "4"],
    "torch_train_recsys_ssh": ["--steps", "2", "--users", "256"],
}


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(CUT))
def test_example_runs_on_the_cpu(name, capsys):
    assert _example(name).main(CUT[name] + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(CUT))
def test_example_needs_cuda_unless_cpu_is_asked(name, monkeypatch):
    mod = _example(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(CUT[name])


def test_index_and_search_builds_then_loads(tmp_path, capsys):
    """The first run builds, saves and holds the loaded database to the
    built one; the second loads it, and answers the same."""
    mod = _example("torch_index_and_search")
    argv = CUT["torch_index_and_search"] + ["--device", "cpu", "--db-dir",
                                            str(tmp_path)]
    first = mod.run(mod.parse_args(argv))
    assert first["loaded_equal"] is True
    assert "built + saved" in capsys.readouterr().out
    second = mod.run(mod.parse_args(argv))
    assert second["loaded_equal"] is None
    assert "loaded database from" in capsys.readouterr().out
    for a, b in zip(first["queries"], second["queries"]):
        assert a["query"] == b["query"] and a["precision"] == b["precision"]
        assert a["ucr_exact"] and a["dtw_evals"] == b["dtw_evals"]


def test_distributed_search_agrees_with_the_facade():
    mod = _example("torch_distributed_search")
    res = mod.run(mod.parse_args(CUT["torch_distributed_search"]
                                 + ["--device", "cpu"]))
    assert mod.agree(res)
    ids, dists = res["fanout"]
    assert ids[0] == res["row"] and dists[0] == 0.0
    assert np.all(np.diff(dists) >= 0)
    # a disagreement is caught
    res["facade"] = (res["facade"][0][::-1], res["facade"][1])
    assert not mod.agree(res)


def test_train_recsys_ssh_learns_and_self_matches():
    mod = _example("torch_train_recsys_ssh")
    res = mod.run(mod.parse_args(["--steps", "3", "--users", "128",
                                  "--device", "cpu"]))
    assert len(res["losses"]) == 3 and np.all(np.isfinite(res["losses"]))
    assert int(res["ids"][0]) == res["user"] == 7
