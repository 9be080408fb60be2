"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA GPU; without one each test skips (decided inside
the ``cuda`` fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: collision counts exact; pair DTW bit-identical (the kernel
repeats the plain version's rounding op for op); sketch projections
within the float32 bound of reordering a W-term sum,
2·W·2^-24·Σ|x·f|.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.ssh_ecg import SMOKE
from repro_torch.data.timeseries import make_benchmark_db
from repro_torch.db import SearchConfig, TimeSeriesDB
from repro_torch.kernels import _build, ops, ref

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("f,step,m", [(1, 3, 200), (3, 1, 130), (2, 5, 301)])
def test_sketch_conv_kernel_matches_plain(cuda, f, step, m):
    rng = np.random.default_rng(f * 10 + step)
    x = torch.tensor(rng.normal(size=(37, m)), dtype=torch.float32,
                     device=cuda)
    filt = torch.tensor(rng.normal(size=(24, f)), dtype=torch.float32,
                        device=cuda)
    got = ops.sketch_conv(x, filt, step)
    torch.cuda.synchronize()
    want = ref.sketch_conv_ref(x, filt, step)
    bound = 2 * 24 * 2.0 ** -24 * ref.sketch_conv_ref(x.abs(), filt.abs(),
                                                      step)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("k", [20, 40, 64])
def test_collision_count_kernel_exact(cuda, k):
    rng = np.random.default_rng(k)
    db = torch.tensor(rng.integers(0, 4, size=(1000, k)), dtype=torch.int32,
                      device=cuda)
    q = torch.tensor(rng.integers(0, 4, size=(45, k)), dtype=torch.int32,
                     device=cuda)
    got = ops.collision_count_batch(q, db)
    assert torch.equal(got, ref.collision_count_batch_ref(q, db))


@pytest.mark.parametrize("band", [6, 25, None])
@pytest.mark.parametrize("with_thr", [False, True])
def test_dtw_kernel_bit_identical(cuda, band, with_thr):
    rng = np.random.default_rng(0 if band is None else band)
    p, m = 301, 96
    q = torch.tensor(rng.normal(size=(p, m)).cumsum(1), dtype=torch.float32,
                     device=cuda)
    c = torch.tensor(rng.normal(size=(p, m)).cumsum(1), dtype=torch.float32,
                     device=cuda)
    thr = None
    if with_thr:
        exact = ref.dtw_pairs_ref(q, c, band)
        thr = exact * torch.tensor(rng.uniform(0.5, 1.5, p),
                                   dtype=torch.float32, device=cuda)
    got = ops.dtw_rerank_pairs(q, c, band, thr)
    assert torch.equal(got, ref.dtw_pairs_ref(q, c, band, thr))


def test_kernel_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((4, 64), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        ops.sketch_conv(x, torch.zeros((8, 1), dtype=torch.float64,
                                       device=cuda), 2)
    with pytest.raises(ValueError):
        ops.collision_count_batch(
            torch.zeros((2, 70), dtype=torch.int32, device=cuda),
            torch.zeros((5, 70), dtype=torch.int32, device=cuda))


def test_batched_search_cuda_matches_cpu(cuda):
    series = make_benchmark_db("ecg", 600, 128, seed=11)
    cfg = SearchConfig(topk=10, top_c=64, band=6, multiprobe_offsets=3)
    ops.reset_launch_counts()
    gpu = TimeSeriesDB.build(series, SMOKE, cfg)
    cpu = TimeSeriesDB.build(series, SMOKE, cfg, device="cpu")
    assert torch.equal(gpu.index.signatures.cpu(), cpu.index.signatures)
    qs = series[[0, 17, 301, 599]]
    for a, b in zip(gpu.search_batch(qs), cpu.search_batch(qs)):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
    assert min(ops.launch_counts().values()) >= 1
    assert set(ops.launch_counts()) == set(_build.SIGNATURES)
