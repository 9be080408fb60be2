"""The roofline of ``collision_count_batch``, counted from shapes."""
import json

import pytest

from conftest import ROOT
from portbench import spec

H100 = json.loads((ROOT / "portbench" / "peaks.json").read_text())["H100"]


def _reader():
    name = "collision_count_batch_roofline"
    return spec.load_module(spec.metric_path(ROOT, name), name)


def test_int32_rate_from_its_basis():
    assert H100["int32_ops_per_s"] == pytest.approx(132 * 64 * 1.98e9,
                                                    rel=1e-4)


def test_bound_of_the_ecg_cell_is_its_compares():
    """192 query rows (64 queries x 3 offsets) against 6,291,456 rows of
    40 hashes: 48.3e9 compares (2.887 ms at the int32 rate) against
    5.84e9 bytes (1.743 ms at 3.35 TB/s)."""
    rows, n, k = 64 * 3, 6_291_456, 40
    ops = rows * n * k
    nbytes = 4 * (n * k + rows * k + rows * n)
    assert ops == 48_318_382_080
    assert nbytes == 5_838_501_888
    got = _reader().bound_s(rows, n, k, H100)
    assert got == pytest.approx(ops / H100["int32_ops_per_s"])
    assert got == pytest.approx(2.8886e-3, rel=1e-3)


def test_bound_switches_to_bytes_for_few_hashes():
    rows, n, k = 64, 1 << 20, 1
    nbytes = 4 * (n * k + rows * k + rows * n)
    got = _reader().bound_s(rows, n, k, H100)
    assert got == pytest.approx(nbytes / H100["hbm_bytes_per_s"])


class _Obs:
    def __init__(self, cell, seconds, launches, device="cpu"):
        from types import SimpleNamespace
        self.cell = cell
        self.trace = SimpleNamespace(kernel=lambda *f: (seconds, launches))
        self.harness = SimpleNamespace(device=device)


def test_reader_reads_nothing_without_a_card_or_records():
    cell = spec.cell("ecg-bulk-m512")
    assert _reader().read(_Obs(cell, 0.0, 0)) is None
    assert _reader().read(_Obs(cell, 0.01, 2)) is None   # CPU: no peaks


def test_trace_reads_a_kernel_by_fragments():
    from portbench.trace import TraceObs
    obs = TraceObs(window_s=1.0, busy_s=0.5,
                   device_ops={"void dtw_rows_kernel<1>(...)": 0.2,
                               "void dtw_diag_kernel<4>(...)": 0.1,
                               "memcpy": 0.2},
                   op_counts={"void dtw_rows_kernel<1>(...)": 4,
                              "void dtw_diag_kernel<4>(...)": 2,
                              "memcpy": 9},
                   gaps={}, batches=2)
    assert obs.kernel("dtw_rows_kernel", "dtw_diag_kernel") == \
        pytest.approx((0.3, 6))
    reader = spec.load_module(
        spec.metric_path(ROOT, "kernel.dtw_wavefront_pairs.ms"), "dtw")

    class O:
        trace = obs
    assert reader.read(O()) == pytest.approx(150.0)
