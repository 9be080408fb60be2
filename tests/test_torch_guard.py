"""The port stands alone: no JAX, nothing of ``repro``, CUDA by default.

* importing every module of ``repro_torch`` in a fresh interpreter where
  ``import jax`` fails must work;
* no ``import`` under ``src/repro_torch/`` or in ``chip_smoke.py`` names
  ``jax`` or the ``repro`` package (AST scan);
* an entry point called without ``device="cpu"`` on a host without CUDA
  raises instead of carrying on on the CPU.
"""
import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.ssh_ecg import SMOKE
from repro_torch.db import SearchConfig, TimeSeriesDB
from repro_torch.encoders import SSHEncoder
from repro_torch.kernels import ops

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
QUICKSTART = ROOT / "examples" / "torch_quickstart.py"

_IMPORT_ALL = """
import sys
sys.modules["jax"] = None
import importlib, pkgutil
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
assert not [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
for name in ("repro_torch.streaming.count_sketch",
             "repro_torch.streaming.encoder", "repro_torch.streaming.ingest",
             "repro_torch.encoders.registry", "repro_torch.kernels.count_sketch",
             "repro_torch.core.search", "repro_torch.kernels.flash_attention",
             "repro_torch.models.layers", "repro_torch.models.transformer",
             "repro_torch.configs.granite_3_2b", "repro_torch.launch.serve",
             "repro_torch.checkpoint.checkpointer", "repro_torch.db.registry",
             "repro_torch.db.persistence", "repro_torch.encoders.srp",
             "repro_torch.encoders.sigcache", "repro_torch.core.srp",
             "repro_torch.configs.registry",
             "repro_torch.configs.ssh_randomwalk",
             "repro_torch.launch.build_index", "repro_torch.serving.engine",
             "repro_torch.serving.metrics", "repro_torch.bench.schema",
             "repro_torch.loadgen.arrivals", "repro_torch.loadgen.workload",
             "repro_torch.loadgen.harness", "repro_torch.subseq",
             "repro_torch.subseq.rolling", "repro_torch.subseq.index",
             "repro_torch.subseq.persistence", "repro_torch.distributed",
             "repro_torch.distributed.dist_index",
             "repro_torch.distributed.fault_tolerance", "repro_torch.fleet",
             "repro_torch.fleet.injector", "repro_torch.fleet.placement",
             "repro_torch.fleet.worker", "repro_torch.fleet.transfer",
             "repro_torch.fleet.searcher", "repro_torch.models.moe",
             "repro_torch.configs.granite_3_8b",
             "repro_torch.configs.phi3_mini_3_8b",
             "repro_torch.configs.dbrx_132b",
             "repro_torch.configs.deepseek_v2_lite_16b",
             "repro_torch.configs.base", "repro_torch.train",
             "repro_torch.train.optimizer",
             "repro_torch.train.grad_compress",
             "repro_torch.launch.steps", "repro_torch.launch.train",
             "repro_torch.launch.mesh", "repro_torch.launch.analytic",
             "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
             "repro_torch.launch.hlo_analysis",
             "repro_torch.launch.hlo_graph",
             "repro_torch.distributed.sharding",
             "repro_torch.distributed.constraints",
             "repro_torch.bench.runner", "repro_torch.bench.regression",
             "repro_torch.bench.validate"):
    assert name in names, name
print(len(names), "modules")
"""


def test_import_without_jax_in_a_subprocess():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "modules" in out.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "attention_yardstick.py",
                                          QUICKSTART]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): root for f in files
           for root in _imported_roots(f) if root in ("jax", "repro")}
    assert not bad, bad


def test_no_library_attention_or_compile_in_the_port():
    """The port's attention is its own kernel: no PyTorch fused attention
    (``scaled_dot_product_attention`` is only chip_smoke.py's yardstick)
    and no ``torch.compile`` anywhere under src/repro_torch."""
    banned = {"scaled_dot_product_attention", "compile",
              "flash_attention_forward", "_scaled_dot_product_attention"}
    found = {}
    for f in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            name = (node.attr if isinstance(node, ast.Attribute) else
                    node.id if isinstance(node, ast.Name) else None)
            if name in banned:
                found.setdefault(str(f.relative_to(ROOT)), set()).add(name)
    assert not found, found


def test_lm_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs.granite_3_2b import SMOKE as LM_SMOKE
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = transformer.init_params(LM_SMOKE, device="cpu")
    arrays = {k: (v.float().numpy() if k != "layers" else
                  {n: t.float().numpy() for n, t in v.items()})
              for k, v in params.items()}
    for call in (lambda: transformer.init_params(LM_SMOKE),
                 lambda: transformer.init_cache(LM_SMOKE, 1, 4),
                 lambda: serve.serve_lm(LM_SMOKE, gen_len=1),
                 lambda: serve.main(["--arch", "granite-3-2b", "--smoke"]),
                 lambda: convert.lm_params_from_arrays(arrays, LM_SMOKE)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    res = serve.serve_lm(LM_SMOKE, params, batch=1, prompt_len=3, gen_len=1,
                         device="cpu")
    assert res.generated.device == torch.device("cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    series = np.zeros((4, 64), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TimeSeriesDB.build(series, SMOKE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SSHEncoder(SMOKE).materialize()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.encoder_state_from_arrays(
            SSHEncoder(SMOKE).materialize("cpu").arrays())
    with pytest.raises(RuntimeError):
        ops.resolve_device("cuda")
    assert ops.resolve_device("cpu") == torch.device("cpu")


def test_new_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.core import search
    from repro_torch.encoders import IndexSpec, make_encoder
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    series = np.random.default_rng(1).normal(size=(40, 64)).astype(
        np.float32)
    spec_cs = IndexSpec(encoder="ssh-cs", params=dict(
        window=16, step=2, ngram=6, num_hashes=8, num_tables=4, width=128))
    for call in (lambda: make_encoder(spec_cs),
                 lambda: TimeSeriesDB.build(series, spec_cs),
                 lambda: search.ucr_search(series[0], series, band=4),
                 lambda: search.brute_force_topk(series[0], series, 3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    db = TimeSeriesDB.build(series, spec_cs, SearchConfig(
        searcher="local", top_c=16, band=4), device="cpu")
    db.add_stream(series[:5])
    db.flush()
    assert db.device == torch.device("cpu") and len(db) == 45
    assert search.ucr_search(series[0], torch.from_numpy(series),
                             band=4).ids[0] == 0


def test_jnp_backend_only_on_cpu():
    db = TimeSeriesDB.build(np.random.default_rng(0).normal(
        size=(30, 64)).astype(np.float32), SMOKE,
        SearchConfig(backend="jnp", top_c=16, band=4), device="cpu")
    assert db.device == torch.device("cpu")
    with pytest.raises(ValueError, match="device='cpu'"):
        ops.check_backend("jnp", torch.device("cuda"))


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _quickstart():
    spec = importlib.util.spec_from_file_location("torch_quickstart",
                                                  QUICKSTART)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_persistence_entry_points_need_cuda_unless_cpu_is_asked(
        monkeypatch, tmp_path):
    from repro_torch.launch import build_index
    quickstart = _quickstart()
    series = np.random.default_rng(2).normal(size=(40, 64)).astype(
        np.float32)
    TimeSeriesDB.build(series, SMOKE, SearchConfig(top_c=16, band=4),
                       device="cpu").save(tmp_path / "db")
    argv = ["--points", "200", "--length", "64", "--out",
            str(tmp_path / "built")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TimeSeriesDB.load(tmp_path / "db"),
                 lambda: build_index.main(argv),
                 lambda: quickstart.main([])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert len(TimeSeriesDB.load(tmp_path / "db", device="cpu")) == 40
    assert not (tmp_path / "built").exists()
    assert quickstart.main(["--device", "cpu"]) == 0


def test_saved_jnp_backend_is_refused_on_cuda(monkeypatch, tmp_path):
    """A database saved with backend='jnp' (the plain versions, CPU only)
    loaded onto CUDA raises, naming both ways out, before any array is
    read; the config= override is the first of them."""
    series = np.random.default_rng(3).normal(size=(30, 64)).astype(
        np.float32)
    TimeSeriesDB.build(series, SMOKE, SearchConfig(
        backend="jnp", top_c=16, band=4), device="cpu").save(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="config=.*device='cpu'"):
        TimeSeriesDB.load(tmp_path, device="cuda")
    with pytest.raises(ValueError, match="config=.*device='cpu'"):
        TimeSeriesDB.load(tmp_path)
    monkeypatch.undo()
    db = TimeSeriesDB.load(tmp_path, device="cpu")
    assert db.config.backend == "jnp"


def test_engine_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch,
                                                           capsys):
    """The ``"engine"`` searcher and the launcher's engine mode raise
    without CUDA unless ``device="cpu"`` is passed, as every entry point,
    the fleet's options among them; with ``--device cpu`` each fleet
    option serves (``--replication 2`` through the fleet)."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    series = np.random.default_rng(5).normal(size=(40, 64)).astype(
        np.float32)
    cfg = SearchConfig(searcher="engine", top_c=16, band=4)
    for call in (lambda: TimeSeriesDB.build(series, SMOKE, cfg),
                 lambda: serve.main(["--arch", "ssh-ecg", "--requests",
                                     "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    db = TimeSeriesDB.build(series, SMOKE, cfg, device="cpu")
    with db:
        assert db.search(series[3]).ids[0] == 3
        assert db.engine._state == "running"
    assert db.device == torch.device("cpu")
    for opt in (["--replication", "2"], ["--fleet-workers", "4"],
                ["--hedge-ms", "10"]):
        args = ["--arch", "ssh-ecg", "--requests", "1", "--batch-size",
                "1", *opt]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(args)
        assert serve.main([*args, "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "engine: req=1" in out
        assert ("fleet: hedged=" in out) == (opt[0] == "--replication")


def test_stream_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch,
                                                           tmp_path):
    """``build_stream``, ``SubsequenceIndex.build`` and the load of a
    saved stream database raise without CUDA unless ``device="cpu"`` is
    passed."""
    from repro_torch.subseq import SubsequenceIndex
    stream = np.random.default_rng(6).normal(size=600).astype(np.float32)
    cfg = SearchConfig(searcher="local", top_c=16, band=4,
                       subseq_window=64, subseq_hop=2)
    TimeSeriesDB.build_stream(stream, SMOKE, cfg, device="cpu").save(
        tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TimeSeriesDB.build_stream(stream, SMOKE, cfg),
                 lambda: SubsequenceIndex.build(stream, SMOKE, length=64),
                 lambda: SubsequenceIndex.load(tmp_path),
                 lambda: TimeSeriesDB.load(tmp_path)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    sub = SubsequenceIndex.build(stream, SMOKE, length=64, hop=2,
                                 device="cpu")
    assert sub.device == sub.stream.device == torch.device("cpu")
    db = TimeSeriesDB.load(tmp_path, device="cpu")
    assert len(db) == sub.num_windows and db.length == 64
