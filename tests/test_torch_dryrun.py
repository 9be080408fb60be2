"""The dry run, the roofline table and the profiler counterparts of the
HLO tools, against the JAX package where it has a counterpart.

* ``hlo_analysis.shape_bytes`` equals the reference's on HLO shapes and
  counts torch dtypes; ``roofline_terms`` is the reference's formula with
  the H100's constants (the reference's patched to them here);
* ``hlo_graph.executed_costs`` counts the matrix FLOPs of a hand-countable
  CPU program exactly from ``torch.profiler`` (``with_flops=True``), the
  check the reference's docstring claims for its HLO parser;
* the op census and the collective counts classify device records by
  name (NCCL kernels as collectives);
* ``dryrun.shardings_for`` equals the reference's in-shardings (params,
  the optimizer state, the decode cache, the batch) on an
  ``AbstractMesh`` for a cell of every kind, and the per-device argument
  bytes of ``granite-3-2b__decode_32k__single`` equal the reference's
  dry-run report's 2,049,274,400 (XLA's ``memory_analysis()``);
* the report's keys, the ``local`` mesh's fit against one card, and the
  roofline table's formatting (``fmt_s`` as the reference's).
"""
import json
import math
import os
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.launch import hlo_analysis as jhlo
from repro.launch import roofline as jroofline
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun, hlo_analysis, hlo_graph, roofline
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "reports" / "dryrun" / \
    "granite-3-2b__decode_32k__single.json"


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module.  Importing it appends a 512-device
    flag to XLA_FLAGS for processes that start jax after it; this one's
    backend is up first and the variable is put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


@pytest.mark.parametrize("dtype,dims", [
    ("bf16", "16,512,128"), ("f32", ""), ("s32", "7"), ("pred", "3,3"),
    ("f8e4m3fn", "2,2"), ("c128", "4"), ("weird", "5,5")])
def test_shape_bytes_match_reference(dtype, dims):
    assert hlo_analysis.shape_bytes(dtype, dims) == jhlo.shape_bytes(dtype,
                                                                     dims)


def test_shape_bytes_of_torch_dtypes():
    assert hlo_analysis.shape_bytes(torch.bfloat16, (16, 512, 128)) == \
        jhlo.shape_bytes("bf16", "16,512,128")
    assert hlo_analysis.shape_bytes(torch.float32, ()) == 4
    assert hlo_analysis.shape_bytes(torch.int64, [3, 2]) == 48


def test_roofline_terms_are_the_reference_formula_at_h100_peaks(
        monkeypatch):
    monkeypatch.setattr(jhlo, "PEAK_FLOPS_BF16", hlo_analysis.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jhlo, "HBM_BW", hlo_analysis.HBM_BW)
    monkeypatch.setattr(jhlo, "ICI_BW", hlo_analysis.ICI_BW)
    assert hlo_analysis.PEAK_FLOPS_BF16 == 989e12
    assert hlo_analysis.HBM_BW == 3.35e12
    rng = np.random.default_rng(0)
    for _ in range(50):
        f, b, c = (float(x) for x in 10 ** rng.uniform(6, 16, 3))
        n = int(rng.choice([1, 4, 256, 512]))
        assert hlo_analysis.roofline_terms(f, b, c, n) == \
            jhlo.roofline_terms(f, b, c, n)


def test_executed_costs_count_matrix_flops_exactly():
    """2 x result elements x contracted extent for every product,
    nothing for the elementwise operations around them."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32)
    a, b, w = t(8, 16), t(16, 32), t(24, 16)
    c, d, e = t(4, 8, 16), t(4, 16, 5), t(4, 8, 5)
    bias = t(24)
    with profile(activities=[ProfilerActivity.CPU], with_flops=True) as prof:
        x = a @ b                                   # mm: 2*8*32*16
        y = torch.nn.functional.linear(a, w, bias)  # addmm: 2*8*24*16
        z = torch.bmm(c, d)                         # bmm: 2*4*8*5*16
        u = torch.baddbmm(e, c, d)                  # baddbmm: the same
        v = torch.einsum("bij,bjk->bik", c, d)      # bmm again
        for _ in range(3):                          # a loop runs 3 times
            x = x * 2.0 + 1.0
            x = x[:, :16] @ b                       # mm: 2*8*32*16
    want = (2 * 8 * 32 * 16 * 4 + 2 * 8 * 24 * 16 + 3 * 2 * 4 * 8 * 5 * 16)
    cost = hlo_graph.executed_costs(prof.key_averages())
    assert cost.dot_flops == want
    assert cost.total_coll_bytes == 0
    assert all(v == 0 for v in cost.coll_counts.values())
    del y, z, u, v


class _Ev(SimpleNamespace):
    pass


def _cuda_events(names_counts):
    return [_Ev(key=k, count=n, device_type=torch.autograd.DeviceType.CUDA,
                self_device_time_total=10.0) for k, n in names_counts]


def test_op_census_and_collectives_classify_device_records():
    evs = _cuda_events([
        ("void simt::flash_attention_simt_kernel<float, 64, 64, true>", 3),
        ("void tc::flash_attention_tc_kernel<64, 64>(CUtensorMap)", 2),
        ("sketch_conv_kernel<80>", 4), ("collision_count_kernel", 5),
        ("collision_count_batch_kernel", 6), ("dtw_rows_kernel<8, 0, 1>", 7),
        ("dtw_diag_kernel<4, 0, 1>", 1), ("cs_tables_kernel", 8),
        ("sm90_xmma_gemm_bf16bf16_bf16f32", 9), ("Memcpy DtoD", 2),
        ("Memset (Device)", 1), ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 2),
        ("ncclDevKernel_AllGather_RING_LL", 1), ("elementwise_kernel", 11)])
    evs.append(_Ev(key="cudaLaunchKernel", count=40,
                   device_type=torch.autograd.DeviceType.CPU,
                   self_device_time_total=0.0))
    census = hlo_analysis.op_census(evs)
    assert census == {"flash_attention_simt": 3, "flash_attention": 2,
                      "sketch_conv": 4, "collision_count": 5,
                      "collision_count_batch": 6, "dtw": 8, "cs_tables": 8,
                      "gemm": 9, "memcpy": 2, "memset": 1, "nccl": 3,
                      "other": 11}
    assert hlo_analysis.kernel_records(evs)["dtw"] == 8
    coll = hlo_analysis.collective_stats(evs)
    assert coll["all-reduce"]["count"] == 2
    assert coll["all-gather"]["count"] == 1
    assert set(coll) == set(jhlo.collective_stats([]))
    from repro_torch.bench import device_time
    before = {"dtw_wavefront": 1, "flash_attention": 0}
    after = {"dtw_wavefront": 5, "dtw_wavefront_pairs": 6,
             "flash_attention": 2, "flash_attention_simt": 4}
    lead = _cuda_events([("void at::cuda::(anonymous namespace)::"
                          "spin_kernel(long)", 120)])
    n = len(device_time.CENSUS)
    entry = device_time.census_window("t", evs + lead, before, after,
                                      lead=128)
    assert device_time.CENSUS[-1] is entry and entry["window"] == n + 1
    assert entry["launched"]["dtw"] == 10 and entry["kept"]["dtw"] == 8
    # records without a launch in the window count as negative gaps
    assert entry["gap"] == {"dtw": 2, "flash_attention_simt": 1,
                            "sketch_conv": -4, "collision_count": -5,
                            "collision_count_batch": -6, "cs_tables": -8}
    assert entry["lead_lost"] == 8
    assert entry["device_records"] == sum(census.values())
    assert device_time.without_lead(evs + lead) == evs


def _jspec_tree(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, s in leaves:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(
            p, "name", p)))) for p in path)
        out[key] = tuple(s.spec)
    return out


def _spec_tree(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_tree(v, path + (str(k),)))
        return out
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and hasattr(tree, "_fields")):
        items = (zip(tree._fields, tree) if hasattr(tree, "_fields")
                 else enumerate(tree))
        out = {}
        for k, v in items:
            out.update(_spec_tree(v, path + (str(k),)))
        return out
    return {"/".join(path): tuple(tree)}


@pytest.mark.parametrize("name,shape", [
    ("granite-3-2b", "decode_32k"), ("granite-3-2b", "train_4k"),
    ("deepseek-v2-lite-16b", "long_500k"), ("dbrx-132b", "prefill_32k"),
    ("dlrm-rm2", "train_batch"), ("nequip", "molecule"),
    ("ssh-ecg", "query_128"), ("ssh-ecg", "build_2048")])
@pytest.mark.parametrize("multi", [False, True])
def test_shardings_for_match_the_reference(jdryrun, name, shape, multi):
    from repro.configs import get_arch as jget_arch
    from repro.launch import steps as jsteps
    jm = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi
          else AbstractMesh((16, 16), ("data", "model")))
    pm = make_production_mesh(multi_pod=multi)
    jarch, arch = jget_arch(name), get_arch(name)
    kind, jstate = jsteps.abstract_state(jarch, shape)
    want = jdryrun.shardings_for(jarch, shape, kind, jstate, jm)[0]
    _, state = steps.abstract_state(arch, shape)
    got = dryrun.shardings_for(arch, shape, kind, state, pm)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _spec_tree(g) == _jspec_tree(w)


def test_granite_decode_argument_bytes_equal_the_committed_report():
    """``granite-3-2b__decode_32k__single``: the reference's dry run gets
    2,049,274,400 argument bytes a device from XLA's
    ``memory_analysis()`` of the compiled cell (its report, which
    ``tests/test_system.py`` writes to ``reports/dryrun/`` each run, is
    read too where it is there).  The port reckons the state's bytes a
    device under the rules: the same number, with no difference to
    pin."""
    rep = dryrun.run_cell("granite-3-2b", "decode_32k", "single",
                          report_dir=None, verbose=False)
    assert rep["memory"]["argument_bytes"] == 2_049_274_400
    assert (rep["kind"], rep["n_chips"]) == ("decode", 256)
    if COMMITTED.exists():
        committed = json.loads(COMMITTED.read_text())
        assert rep["memory"]["argument_bytes"] == \
            committed["memory"]["argument_bytes"]
        for key in ("arch", "shape", "mesh", "kind", "n_chips"):
            assert rep[key] == committed[key]


def test_report_keys_and_the_local_fit(tmp_path):
    rep = dryrun.run_cell("granite-3-2b", "train_4k", "local", tmp_path,
                          verbose=False)
    assert set(rep) >= {"arch", "shape", "mesh", "kind", "n_chips",
                        "compile_seconds", "model_flops", "memory",
                        "roofline"}
    assert set(rep["memory"]) >= {"argument_bytes", "optimizer_bytes",
                                  "device_bytes", "fits_device"}
    assert set(rep["roofline"]) == set(jhlo.roofline_terms(1, 1, 1, 1))
    assert rep["n_chips"] == 1
    # 2.53 B parameters in bf16, float32 m, v and master: 17.7 GB, and
    # the batch of 256 x 4,096 tokens
    n_params = 2_634_201_088
    assert rep["memory"]["optimizer_bytes"] == 12 * n_params + 4
    assert rep["memory"]["fits_device"]
    written = json.loads((tmp_path / "granite-3-2b__train_4k__local.json")
                         .read_text())
    assert written == json.loads(json.dumps(rep))
    big = dryrun.run_cell("dbrx-132b", "train_4k", "local", None,
                          verbose=False)
    assert not big["memory"]["fits_device"]
    assert big["memory"]["argument_bytes"] > 1.8e12


def test_dryrun_cli_and_roofline_table(tmp_path, capsys):
    rdir = tmp_path / "reports"
    assert dryrun.main(["--arch", "ssh-ecg", "--mesh", "all",
                        "--report-dir", str(rdir)]) == 0
    assert len(list(rdir.glob("*.json"))) == 9
    measured = tmp_path / "measured.json"
    measured.write_text(json.dumps([dict(
        arch="ssh-ecg", shape="query_2048", model_flops=1.6254e9,
        seconds=0.003, n_chips=1)]))
    out = tmp_path / "roofline.md"
    assert roofline.main(["--report-dir", str(rdir), "--measured",
                          str(measured), "--out", str(out)]) == 0
    md = out.read_text()
    assert md.count("### Roofline") == 3
    rows = [l for l in md.splitlines() if l.startswith("| ssh-ecg")]
    assert len(rows) == 9 and all(l.count("|") == 12 for l in rows)
    assert "measured" in [l for l in rows if "query_2048" in l
                          and "3.0ms" in l][0]
    frac = roofline.measured_frac(1.6254e9, 0.003)
    assert math.isclose(frac, 1.6254e9 / 0.003 / 989e12)
    for x in (2.5, 1.0, 0.999, 0.0123, 1e-3, 9.99e-4, 3e-6, 0.0):
        assert roofline.fmt_s(x) == jroofline.fmt_s(x)
