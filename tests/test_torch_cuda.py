"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA GPU; without one each test skips (decided inside
the ``cuda`` fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: collision counts exact; DTW bit-identical (the kernels
repeat the plain version's rounding op for op); count-sketch tables
bit-identical (sums of +-1 are exact in float32 in any order); sketch
projections within the float32 bound of reordering a W-term sum,
2·W·2^-24·Σ|x·f|, of the plain version and bit-identical to the exact
emulation of the kernel's fused multiply-add chain
(``ref.sketch_conv_fma_ref``); flash attention within one unit in the
last place of the output type plus float32 reordering
(``flash_attention.error_bound``: both compute in float32 and round
once); the tensor-core kernel, which
rounds the softmax weights to bf16 before P·V, per element: against the
plain version with (2^-13 + 2^-8) · sum_j w_j |v_j|, and against the
emulation of its own rounding (``ref.flash_attention_tc_ref``) with
2^-13 · sum_j w_j |v_j| plus the emulation's ``spread``.
Both flash kernels run every case: through the model's call (the rule
picks the kernel; the test asserts which count moved) and through the
CUDA-core kernel's own entry point.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.ssh_ecg import SMOKE
from repro_torch.data.timeseries import make_benchmark_db
from repro_torch.db import SearchConfig, TimeSeriesDB
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import dtw_wavefront as kd

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


def _sketch_bits_equal(got, x, filt, step):
    want = ref.sketch_conv_fma_ref(x, filt, step)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        int((got != want).sum())


@pytest.mark.parametrize("w,f,step,m", [
    (80, 1, 3, 512), (24, 1, 3, 128), (24, 3, 3, 301), (80, 2, 3, 530),
    (8, 1, 1, 200), (128, 3, 5, 999), (17, 1, 2, 257), (80, 1, 4, 512),
    (24, 1, 3, 24), (5, 1, 7, 6)])
def test_sketch_conv_kernel_bit_identical_to_fma_ref(cuda, w, f, step, m):
    """Both written (W, step) pairs and the run-time walk, F > 1, N_B
    past one 160-window tile, m not a multiple of 4 (scalar segment
    loads), a single window; one launch counted per call."""
    rng = np.random.default_rng(w * 100 + f * 10 + step)
    x = torch.tensor(rng.normal(size=(37, m)).cumsum(1), dtype=torch.float32,
                     device=cuda)
    filt = torch.tensor(rng.normal(size=(w, f)), dtype=torch.float32,
                        device=cuda)
    ops.reset_launch_counts()
    got = ops.sketch_conv(x, filt, step)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sketch_conv"] == 1
    _sketch_bits_equal(got, x, filt, step)


def test_sketch_conv_kernel_path_shapes_and_views(cuda):
    """ssh-ecg's build chunk (4096 x 512) and query batch (192 x 512) with
    the encoder's own filter; a row block whose base is 4 bytes off a
    16-byte boundary; the library's shared-memory size equals the
    wrapper's."""
    from repro_torch.configs import ssh_ecg
    from repro_torch.data.timeseries import (extract_subsequences,
                                             synthetic_ecg)
    from repro_torch.encoders import SSHEncoder
    from repro_torch.kernels import sketch_conv as sk
    filt = SSHEncoder(ssh_ecg.CONFIG).materialize(cuda)._require_state()[
        "filters"]
    x = torch.as_tensor(extract_subsequences(
        synthetic_ecg(4096 * 64 + 512, seed=1), 512, stride=64,
        max_count=4096, znorm=True), device=cuda)
    for rows in (x, x[:192]):
        _sketch_bits_equal(ops.sketch_conv(rows, filt, 3), rows, filt, 3)
    flat = x.reshape(-1)[1:1 + 300 * 512].view(300, 512)
    assert flat.data_ptr() % 16
    _sketch_bits_equal(ops.sketch_conv(flat, filt, 3), flat, filt, 3)
    lib = _build.load("sketch_conv")
    for w, f, step in ((80, 1, 3), (24, 3, 1), (7, 2, 5)):
        assert lib.sketch_conv_smem_bytes(w, f, step) == sk.smem_bytes(
            w, f, step)


@pytest.mark.parametrize("w", [80, 24])
@pytest.mark.parametrize("step", [1, 2, 3])
def test_sketch_conv_single_long_row_bit_identical(cuda, w, step):
    """The rolling encode's shape (``subseq.rolling``): one (1, n) row of
    a stream at stride gcd(hop, δ).  n % 4 != 0 (scalar segment loads),
    a suffix view starting 20 bytes into the stream (off every 16-byte
    boundary, as ``extend_stream`` rolls it) and a 16-byte aligned slice
    with n % 4 == 0 (vector loads); ``ops.sketch_bits_stream`` gives the
    emulation's signs."""
    rng = np.random.default_rng(w + step)
    base = torch.tensor(rng.normal(size=200_007).cumsum() * 0.05,
                        dtype=torch.float32, device=cuda)
    filt = torch.tensor(rng.normal(size=(w, 1)), dtype=torch.float32,
                        device=cuda)
    views = (base, base[5:], base[4:100_004])
    assert [v.data_ptr() % 16 for v in views][1:] == [4, 0]
    for x in views:
        got = ops.sketch_conv(x[None], filt, step)
        _sketch_bits_equal(got, x[None], filt, step)
        bits = ops.sketch_bits_stream(x, filt, step)
        assert torch.equal(bits, (ref.sketch_conv_fma_ref(
            x[None], filt, step)[0] >= 0).to(torch.uint8))


@pytest.mark.parametrize("params,length", [
    (dict(), 512),
    (dict(window=24, step=3, ngram=8, num_hashes=20, num_tables=20), 128)])
@pytest.mark.parametrize("hop", [1, 4, 6])
def test_rolling_signatures_cuda_match_per_window_encode(cuda, params,
                                                         length, hop):
    """The rolling encode on the card (stride-gcd sketch of one row, then
    the windows' CWS) equals ``encode_batch`` of the materialised windows
    on the card, which sketches them at the encoder's stride."""
    from repro_torch.configs import ssh_ecg
    from repro_torch.data.timeseries import synthetic_ecg
    from repro_torch.encoders import make_encoder
    from repro_torch.subseq import rolling_signatures
    enc = make_encoder(ssh_ecg.CONFIG.with_params(**params), cuda)
    stream = torch.as_tensor(synthetic_ecg(20_003, seed=hop), device=cuda)
    ops.reset_launch_counts()
    got = rolling_signatures(stream, enc, length, hop, chunk=1000)
    assert ops.launch_counts()["sketch_conv"] == 1
    want = enc.encode_chunked(stream.unfold(0, length, hop))
    assert torch.equal(got, want), int((got != want).any(1).sum())


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


@pytest.mark.parametrize("k,n", [(20, 1000), (40, 4097), (64, 300)])
def test_single_query_collision_count_kernel_exact(cuda, k, n):
    rng = np.random.default_rng(k + n)
    db = torch.tensor(rng.integers(0, 3, size=(n, k)), dtype=torch.int32,
                      device=cuda)
    q = torch.tensor(rng.integers(0, 3, size=k), dtype=torch.int32,
                     device=cuda)
    got = ops.collision_count(q, db)
    assert torch.equal(got, ref.collision_count_ref(q, db))
    # a row of a larger block, as hash_probe hands it over
    assert torch.equal(ops.collision_count(db[7], db[5:]),
                       ref.collision_count_ref(db[7], db[5:]))


_I32 = np.iinfo(np.int32)
# keys with both sentinels of the kernels' padding in real slots
_EXTREME = np.array([_I32.min, _I32.max, -1, 0, 1, 2], dtype=np.int32)


def _keys(rng, shape, cuda):
    """int32 keys, half of the columns drawn from _EXTREME and half from
    {0, 1, 2}, so that counts spread and both sentinels appear."""
    k = shape[-1]
    x = rng.integers(0, 3, size=shape).astype(np.int32)
    cols = rng.permutation(k)[:max(1, k // 2)]
    x[..., cols] = rng.choice(_EXTREME, size=x[..., cols].shape)
    return torch.tensor(x, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("k", [1, 8, 20, 33, 40, 64])
@pytest.mark.parametrize("bo", [1, 7, 192, 193])
@pytest.mark.parametrize("n", [100, 1300])
def test_collision_count_batch_ragged_exact(cuda, k, bo, n):
    """Ragged N (under one 256-row tile, and not a multiple of it),
    ragged B·O (193 rows at K = 64 take two 48 KB staging passes), K
    not a multiple of 8, both sentinels as real keys; queries share
    the database's column draws, so that every count occurs."""
    rng = np.random.default_rng(k * 1000 + bo + n)
    db = _keys(rng, (n, k), cuda)
    q = db[torch.tensor(rng.integers(0, n, bo), device=cuda)].clone()
    flip = torch.tensor(rng.random((bo, k)) < 0.5, device=cuda)
    q[flip] = _keys(rng, (bo, k), cuda)[flip]
    got = ops.collision_count_batch(q, db)
    assert torch.equal(got, ref.collision_count_batch_ref(q, db))
    assert torch.equal(got, ref.collision_count_padded_ref(q, db))


def test_collision_count_batch_serving_rows_and_views(cuda):
    """The serving shape's 192 x 40 query rows against a few thousand
    database rows, and both operands as views with misaligned bases
    (db[5:] at K = 33)."""
    rng = np.random.default_rng(17)
    db = _keys(rng, (5000, 40), cuda)
    q = db[torch.tensor(rng.integers(0, 5000, 192), device=cuda)]
    assert torch.equal(ops.collision_count_batch(q, db),
                       ref.collision_count_batch_ref(q, db))
    db33 = _keys(rng, (3005, 33), cuda)[5:]
    q33 = _keys(rng, (10, 33), cuda)[3:]
    assert torch.equal(ops.collision_count_batch(q33, db33),
                       ref.collision_count_batch_ref(q33, db33))


@pytest.mark.parametrize("k", [1, 8, 20, 33, 40, 64])
@pytest.mark.parametrize("n", [100, 257, 4097])
@pytest.mark.parametrize("lead", [0, 1, 2, 3])
def test_collision_count_single_ragged_exact(cuda, k, n, lead):
    """Ragged N, K not a multiple of 8 or 4 (the word-by-word path),
    both sentinels as real keys, and the database's base ``lead`` words
    past a 16-byte boundary (a view db[lead:] of a 16-byte-aligned
    block at K = 4j; any lead at odd K)."""
    rng = np.random.default_rng(k * 100 + n + lead)
    full = _keys(rng, (n + lead, k), cuda)
    db = full[lead:]
    q = db[int(rng.integers(0, n))].clone()
    if k >= 3:
        q[:k // 3] = _keys(rng, (k // 3,), cuda)
    got = ops.collision_count(q, db)
    assert torch.equal(got, ref.collision_count_ref(q, db))


@pytest.mark.parametrize("k,lead", [(40, 0), (33, 5), (34, 1), (64, 0)])
def test_collision_count_single_many_tiles(cuda, k, lead):
    """More tiles than the ring holds on every SM (the stages refill
    several times), at the serving width and at misaligned views."""
    rng = np.random.default_rng(k + lead)
    n = 300_000
    db = _keys(rng, (n + lead, k), cuda)[lead:]
    q = db[12345].clone()
    got = ops.collision_count(q, db)
    assert torch.equal(got, ref.collision_count_ref(q, db))
    assert int(got[12345]) == k


@pytest.mark.parametrize("band", [6, 25, None])
@pytest.mark.parametrize("thr_kind", ["none", "scalar", "per_candidate"])
def test_single_query_dtw_kernel_bit_identical(cuda, band, thr_kind):
    rng = np.random.default_rng(1 if band is None else band)
    c, m = 203, 96
    q = torch.tensor(rng.normal(size=m).cumsum(), dtype=torch.float32,
                     device=cuda)
    x = torch.tensor(rng.normal(size=(c, m)).cumsum(1), dtype=torch.float32,
                     device=cuda)
    exact = ref.dtw_wavefront_ref(q, x, band)
    thr = None
    if thr_kind == "scalar":
        thr = exact.median()
    elif thr_kind == "per_candidate":
        thr = exact * torch.tensor(rng.uniform(0.5, 1.5, c),
                                   dtype=torch.float32, device=cuda)
    got = ops.dtw_rerank(q, x, band, thr)
    assert torch.equal(got, ref.dtw_wavefront_ref(q, x, band, thr))
    # the pair kernel on the broadcast query gives the same bits
    assert torch.equal(ops.dtw_rerank(q, x, band),
                       ops.dtw_rerank_pairs(q.expand(c, m).contiguous(), x,
                                            band))


def _walk_rows(rng, n, m, cuda):
    w = rng.normal(size=(n, m)).cumsum(1)
    if m > 1:
        w = (w - w.mean(1, keepdims=True)) / w.std(1, keepdims=True)
    return torch.tensor(w, dtype=torch.float32, device=cuda)


def _dtw_thresholds(exact, rng):
    """none, scalar, per pair (half of them below the cost, mixed within
    every warp), exactly the cost (kept: strict >) and below every row."""
    n = exact.shape[0]
    mixed = exact * torch.tensor(rng.choice([0.5, 0.9, 1.1, 2.0], n),
                                 dtype=torch.float32, device=exact.device)
    return {"none": None, "scalar": exact.median(), "per_pair": mixed,
            "exact": exact.clone(),
            "below_rows": torch.full_like(exact, -1.0)}


def _check_dtw_schedules(cuda, q, x, band, schedules, thresholds=True):
    """Both entry points through the rule (None) and each schedule in
    ``schedules``, bit for bit against the plain versions, with the
    launch counts per kernel and per schedule asserted."""
    n, m = x.shape
    qs = q[None].expand(n, m).contiguous()
    exact = ref.dtw_pairs_ref(qs, x, band)
    thrs = (_dtw_thresholds(exact, np.random.default_rng(n + m))
            if thresholds else {"none": None})
    r = m - 1 if band is None else min(band, m - 1)
    for kind, thr in thrs.items():
        thr_p = None if thr is None else thr.reshape(-1).expand(n) \
            .contiguous()
        want = ref.dtw_pairs_ref(qs, x, band, thr_p)
        assert torch.equal(ref.dtw_wavefront_ref(q, x, band, thr), want)
        if kind == "exact":
            assert torch.equal(want, exact)
        if kind == "below_rows":
            assert bool((want == 1e30).all())
        for sched in (None, *schedules):
            took = sched or kd.dtw_schedule(n, m, r)
            ops.reset_launch_counts()
            got_p = kd.dtw_wavefront_pairs(qs, x, r, thr_p, schedule=sched)
            got_1 = kd.dtw_wavefront(q, x, r, thr, schedule=sched)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["dtw_wavefront_pairs"] == 1
            assert _build.LAUNCHES["dtw_wavefront"] == 1
            assert kd.schedule_counts() == {
                f"{k}:{s}": int(s == took)
                for k in ("dtw_wavefront_pairs", "dtw_wavefront")
                for s in kd.SCHEDULES}
            assert torch.equal(got_p, want), (sched, kind)
            assert torch.equal(got_1, want), (sched, kind)


@pytest.mark.parametrize("m", [1, 2, 3, 40, 96])
@pytest.mark.parametrize("band", [0, 1, 2, 6, "m-1", None])
def test_dtw_schedules_bit_identical_grid(cuda, m, band):
    band = m - 1 if band == "m-1" else band
    rng = np.random.default_rng(m * 7 + (band if band is not None else 5))
    x = _walk_rows(rng, 70, m, cuda)             # 3 warps, the last ragged
    q = _walk_rows(rng, 1, m, cuda)[0]
    r = m - 1 if band is None else min(band, m - 1)
    schedules = (("rows", "diagonals") if r <= 63 else ("diagonals",))
    _check_dtw_schedules(cuda, q, x, band, schedules)


@pytest.mark.parametrize("m,band,n", [(512, 25, 1000), (1024, 1023, 20),
                                      (1024, 63, 300)])
def test_dtw_schedules_wide_shapes(cuda, m, band, n):
    rng = np.random.default_rng(m + band)
    x = _walk_rows(rng, n, m, cuda)
    q = _walk_rows(rng, 1, m, cuda)[0]
    schedules = ("rows", "diagonals") if band <= 63 else ("diagonals",)
    _check_dtw_schedules(cuda, q, x, band, schedules)


def test_dtw_schedules_longest_series(cuda):
    lib = _build.load("dtw_wavefront")
    m, r_max = lib.dtw_max_length(), lib.dtw_pairs_max_radius()
    assert m >= 3418 and r_max == 1023   # the limits before
    rng = np.random.default_rng(3)
    x = _walk_rows(rng, 3, m, cuda)
    q = _walk_rows(rng, 1, m, cuda)[0]
    _check_dtw_schedules(cuda, q, x, r_max, ("diagonals",),
                         thresholds=False)
    _check_dtw_schedules(cuda, q, x, 25, ("rows", "diagonals"),
                         thresholds=False)
    with pytest.raises(ValueError, match="shared memory"):
        kd.dtw_wavefront(q.repeat(2), x.repeat(1, 2), 25,
                         schedule="diagonals")


def test_dtw_schedule_crossover(cuda):
    """C from 1 across the rule's crossover at r = 25: each count takes
    the schedule the rule names, bit-identical either way."""
    m, r = 128, 25
    cross = kd.ROWS_MIN_PAIRS_PER_CELL * (2 * r + 1)
    rng = np.random.default_rng(9)
    x = _walk_rows(rng, cross + 1, m, cuda)
    q = _walk_rows(rng, 1, m, cuda)[0]
    for n in (1, 31, 33, cross - 1, cross, cross + 1):
        assert kd.dtw_schedule(n, m, r) == ("rows" if n >= cross
                                            else "diagonals")
        _check_dtw_schedules(cuda, q, x[:n].contiguous(), r, ())


def test_dtw_wrappers_refuse_bad_schedules(cuda):
    x = torch.zeros((4, 200), device=cuda)
    with pytest.raises(ValueError, match="rows schedule"):
        kd.dtw_wavefront_pairs(x, x, 64, schedule="rows")
    with pytest.raises(ValueError, match="schedule must be"):
        kd.dtw_wavefront(x[0], x, 5, schedule="columns")
    with pytest.raises(ValueError, match="radius"):
        kd.dtw_wavefront_pairs(torch.zeros((2, 1100), device=cuda),
                               torch.zeros((2, 1100), device=cuda), 1024)


@pytest.mark.parametrize("width,s", [(128, 300), (4096, 131)])
def test_cs_tables_kernel_bit_identical(cuda, width, s):
    rng = np.random.default_rng(width)
    bkt = rng.integers(-1, width, size=(9, 4, s)).astype(np.int32)
    sgn = np.where(bkt < 0, 0.0, rng.choice([-1.0, 1.0], bkt.shape))
    bucket = torch.tensor(bkt, device=cuda)
    sign = torch.tensor(sgn, dtype=torch.float32, device=cuda)
    got = ops.cs_tables(bucket, sign, width)
    assert torch.equal(got, ref.cs_tables_ref(bucket, sign, width))


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
    counts = ops.launch_counts()
    assert set(counts) == set(_build.KERNELS)
    assert min(counts[k] for k in ("sketch_conv", "collision_count_batch",
                                   "dtw_wavefront_pairs")) >= 1


def test_sequential_search_and_ucr_cuda_match_cpu(cuda):
    from repro_torch.core import search
    series = make_benchmark_db("ecg", 600, 128, seed=12)
    cfg = SearchConfig(topk=10, top_c=64, band=6, multiprobe_offsets=3,
                       searcher="local")
    gpu = TimeSeriesDB.build(series, SMOKE, cfg)
    cpu = TimeSeriesDB.build(series, SMOKE, cfg, device="cpu")
    ops.reset_launch_counts()
    qs = series[[2, 99, 450]]
    for a, b in zip(gpu.search_batch(qs), cpu.search_batch(qs)):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
    counts = ops.launch_counts()
    assert counts["collision_count"] == 3 * len(qs)       # one per row
    assert counts["dtw_wavefront"] >= 2 * len(qs)         # seed, survivors
    ucr = search.ucr_search(qs[1], gpu.index.series, topk=10, band=6)
    gold, _ = search.brute_force_topk(qs[1], series, 10, 6, device="cpu")
    np.testing.assert_array_equal(ucr.ids, gold)


def test_sshcs_encode_and_ingest_cuda_match_cpu(cuda):
    from repro_torch.encoders import IndexSpec
    spec = IndexSpec(encoder="ssh-cs", params=dict(
        window=24, step=3, ngram=8, num_hashes=40, num_tables=20, width=1024))
    series = make_benchmark_db("ecg", 500, 128, seed=13)
    cfg = SearchConfig(topk=10, top_c=64, band=6, searcher="local")
    ops.reset_launch_counts()
    dbs = [TimeSeriesDB.build(series[:300], spec, cfg, device=d)
           for d in ("cuda", "cpu")]
    assert ops.launch_counts()["cs_tables"] >= 1
    gpu, cpu = dbs
    assert torch.equal(gpu.index.signatures.cpu(), cpu.index.signatures)
    for db in dbs:
        db.add_stream(series[400:500], seq=1)
        db.add_stream(series[300:400], seq=0)
        db.flush()
    assert torch.equal(gpu.index.signatures.cpu(), cpu.index.signatures)
    assert torch.equal(gpu.index.encoder.aggregate_sketch().cpu(),
                       cpu.index.encoder.aggregate_sketch())
    for a, b in zip(gpu.search_batch(series[[5, 350, 480]]),
                    cpu.search_batch(series[[5, 350, 480]])):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)


def _flash_inputs(cuda, b, h, hk, s, t, d, dtype, seed, dv=None):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=sh), dtype=torch.float32,
                         device=cuda).to(dtype)
            for sh in ((b, h, s, d), (b, hk, t, d), (b, hk, t, dv or d))]


#: the two ways into the kernels: ``flash_attention`` is the model's call
#: (bf16 to the tensor-core kernel by the rule, float32 to the CUDA-core
#: one), ``flash_attention_simt`` the CUDA-core kernel whatever the inputs
ROUTES = ["flash_attention", "flash_attention_simt"]


def _entry(route):
    from repro_torch.kernels import flash_attention as fa
    return ops.flash_attention if route == "flash_attention" \
        else fa.flash_attention_simt


def _check_flash(q, k, v, causal, route="flash_attention", kernel=None,
                 scale=None, q_offset=0, kv_valid=None):
    """Kernel against its plain version: one unit in the last place of
    the output type plus float32 reordering (``error_bound``); exactly
    one launch, counted under ``kernel`` (by default the one the route
    should pick).  The tensor-core kernel is held per element, to the
    plain version with its bf16 weights allowed for, and to the
    emulation of its own rounding (``ref.flash_attention_tc_ref``)
    within the tight bound.  ``q_offset`` and ``kv_valid`` go to the
    kernel and to both oracles alike; a row that sees no key must come
    out exactly 0."""
    from repro_torch.kernels.flash_attention import (error_bound,
                                                     takes_tensor_cores)
    if kernel is None:
        kernel = ("flash_attention" if route == "flash_attention"
                  and takes_tensor_cores(q, k, v, scale)
                  else "flash_attention_simt")
    ops.reset_launch_counts()
    got = _entry(route)(q, k, v, causal=causal, scale=scale,
                        q_offset=q_offset, kv_valid=kv_valid)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts[kernel] == 1
    assert counts["flash_attention"] + counts["flash_attention_simt"] == 1
    want = ref.flash_attention_ref(q, k, v, causal, scale, q_offset,
                                   kv_valid)
    assert got.shape == want.shape and got.dtype == q.dtype
    hidden = ref.attention_hidden(q.shape[2], k.shape[2], causal, q_offset,
                                  kv_valid, device=q.device,
                                  batch=q.shape[0])
    if hidden is not None:
        empty = hidden.all(-1).expand(q.shape[0], q.shape[1], -1)
        assert not bool(got[empty].any())
    err = (got.float() - want.float()).abs()
    if kernel == "flash_attention_simt":
        bound = error_bound(got, want, v)
        assert bool((err <= bound).all()), float(err.max())
        return got
    emu = ref.flash_attention_tc_ref(q, k, v, causal, scale, q_offset,
                                     kv_valid)
    bound = error_bound(got, want, v, emu.abs_out)
    assert bool((err <= bound).all()), float((err / bound).max())
    err = (got.float() - emu.out.float()).abs()
    bound = error_bound(got, emu.out, v, emu.abs_out, emu.spread)
    assert bool((err <= bound).all()), float((err / bound).max())
    return got


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("d", [16, 64, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_head_dims(cuda, d, dtype, route):
    _check_flash(*_flash_inputs(cuda, 2, 4, 2, 150, 150, d, dtype, d),
                 causal=True, route=route)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("s,t,causal", [
    (130, 130, True), (37, 200, True), (200, 37, True), (1, 1, True),
    (64, 128, False), (77, 131, False), (5, 300, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_ragged_and_masks(cuda, s, t, causal, dtype, route):
    """Ragged S and T, S < T and S > T under causal (query i sees keys
    0..i), and no mask."""
    _check_flash(*_flash_inputs(cuda, 1, 3, 3, s, t, 64, dtype, s + t),
                 causal=causal, route=route)


# (S, T, causal, q_offset, kv_valid): T - S (the model's alignment),
# offsets a multiple of 16 (the CUDA-core kernel's sub-block skips) and
# not, S > T with rows before the first key, key bounds with a 0 and a T
OFFSET_CASES = [
    (100, 230, True, 130, [0, 57, 230]),
    (100, 228, True, 128, [228, 0, 100]),
    (130, 130, True, 0, [0, 130, 64]),
    (150, 90, True, -60, None),
    (150, 86, True, -64, [86, 1, 40]),
    (70, 190, True, 16, [0, 190, 17]),
    (70, 190, False, 0, [0, 190, 129]),
    (1, 300, True, 299, [0, 300, 150]),
    (200, 600, True, 400, [600, 333, 0]),
]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("s,t,causal,off,kv", OFFSET_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv", [(64, 64), (192, 128)])
def test_flash_kernel_offset_and_key_bound(cuda, s, t, causal, off, kv,
                                           dtype, d, dv, route):
    """Both kernels with a query offset and a per-batch key bound against
    the plain version (and the tensor-core kernel against its emulation),
    rows that see no key exactly 0; GQA at (64, 64), MLA's (192, 128)."""
    hk = 2 if d == 64 else 4
    q, k, v = _flash_inputs(cuda, 3, 4, hk, s, t, d, dtype, s + t + off,
                            dv=dv)
    kvt = None if kv is None else torch.tensor(kv, dtype=torch.int32,
                                               device=cuda)
    _check_flash(q, k, v, causal=causal, route=route, scale=d ** -0.5,
                 q_offset=off, kv_valid=kvt)


def test_flash_kernel_offset_zero_is_the_old_path(cuda):
    """q_offset 0 and a key bound of T give the same bits as neither."""
    q, k, v = _flash_inputs(cuda, 2, 8, 2, 300, 300, 64, torch.bfloat16, 3)
    full = torch.full((2,), 300, dtype=torch.int32, device=cuda)
    for route in ROUTES:
        assert torch.equal(_entry(route)(q, k, v),
                           _entry(route)(q, k, v, q_offset=0,
                                         kv_valid=full))


def test_chunked_attention_offset_cuda_matches_cpu(cuda):
    """The model's call at S < T with a key bound, on the card and on the
    CPU (float32, the CUDA-core kernel against the plain version)."""
    from repro_torch.models import layers
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((2, 40, 4, 32), (2, 90, 2, 32), (2, 90, 2, 32)))
    kv = np.array([0, 77], np.int32)
    got = layers.chunked_attention(
        *(torch.tensor(x, device=cuda) for x in (q, k, v)), causal=True,
        kv_valid=torch.tensor(kv, device=cuda)).cpu()
    want = layers.chunked_attention(
        *(torch.tensor(x) for x in (q, k, v)), causal=True,
        kv_valid=torch.tensor(kv))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not bool(got[0].any())


def test_ssh_steps_cuda_match_cpu(cuda):
    """``launch.steps``' ssh build and query steps at the full ssh-ecg
    config, small: signatures and ids equal on the card and the CPU, the
    kernels launched."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps
    arch = get_arch("ssh-ecg")
    p_cpu = steps.init_fn(arch, "build_2048", device="cpu")()
    p_gpu = steps.init_fn(arch, "build_2048", device=cuda)()
    assert torch.equal(p_cpu["filters"], p_gpu["filters"].cpu())
    db = make_benchmark_db("ecg", 3000, 256, seed=4)
    build = steps.make_step(arch, "build_2048", "build")
    ops.reset_launch_counts()
    sig_gpu = build(p_gpu, {"series": torch.tensor(db, device=cuda)})
    assert ops.launch_counts()["sketch_conv"] == 1
    sig_cpu = build(p_cpu, {"series": torch.tensor(db)})
    assert torch.equal(sig_gpu.cpu(), sig_cpu)
    query = steps._make_ssh_query(arch.config, top_c=256, band=12, topk=10)
    for i in (5, 1234):
        ops.reset_launch_counts()
        gi, gd = query(p_gpu, {"query": torch.tensor(db[i], device=cuda),
                               "db_sigs": sig_gpu,
                               "db_series": torch.tensor(db, device=cuda)})
        counts = ops.launch_counts()
        assert counts["collision_count"] == 1 and counts["dtw_wavefront"] == 1
        ci, cd = query(p_cpu, {"query": torch.tensor(db[i]),
                               "db_sigs": sig_cpu,
                               "db_series": torch.tensor(db)})
        assert torch.equal(gi.cpu(), ci) and int(ci[0]) == i
        torch.testing.assert_close(gd.cpu(), cd, rtol=1e-6, atol=0)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("g", [1, 4, 8])
def test_flash_kernel_gqa(cuda, g, route):
    q, k, v = _flash_inputs(cuda, 2, 8, 8 // g, 100, 100, 64,
                            torch.bfloat16, g)
    got = _check_flash(q, k, v, causal=True, route=route)
    rep = _entry(route)(q, k.repeat_interleave(g, 1),
                        v.repeat_interleave(g, 1))
    assert torch.equal(got, rep)          # the head map, not a copy


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_strided_views(cuda, dtype, route):
    """(B, S, H, D) tensors as transpose(1, 2) views, a head slice, and
    the output laid out as (B, S, H, D)."""
    rng = np.random.default_rng(9)
    x = [torch.tensor(rng.normal(size=sh), dtype=torch.float32,
                      device=cuda).to(dtype)
         for sh in ((2, 90, 8, 64), (2, 90, 2, 64), (2, 90, 2, 64))]
    q, k, v = (t.transpose(1, 2) for t in x)
    got = _check_flash(q, k, v, causal=True, route=route)
    assert got.transpose(1, 2).is_contiguous()
    part = _check_flash(q[:, 2:6], k[:, :1], v[:, :1], causal=True,
                        route=route)
    assert torch.equal(part, _entry(route)(
        q[:, 2:6].contiguous(), k[:, :1].contiguous(),
        v[:, :1].contiguous()))


@pytest.mark.parametrize("route", ROUTES)
def test_flash_kernel_long_gqa_4096(cuda, route):
    """The model's head layout (H 32, Hk 8, D 64) at S = T = 4096: 32 query
    tiles of the tensor-core kernel, 64 key tiles on the diagonal one."""
    _check_flash(*_flash_inputs(cuda, 1, 32, 8, 4096, 4096, 64,
                                torch.bfloat16, 40), causal=True,
                 route=route)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("scale", [0.05, 0.0, -0.3])
def test_flash_kernel_scales(cuda, scale, route):
    """A scale that is not positive takes the CUDA-core kernel by the
    rule (the tensor-core kernel folds the scale into the exponent after
    the row max), and the count says so; 0 gives uniform weights over the
    unmasked keys."""
    _check_flash(*_flash_inputs(cuda, 1, 4, 2, 300, 300, 64, torch.bfloat16,
                                21), causal=True, route=route, scale=scale)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("d,dv", [(192, 128), (96, 96), (128, 128),
                                  (136, 64), (64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_qk_and_v_head_dims(cuda, d, dv, dtype, route):
    """The models' head dims: MLA's Q/K 192 and V 128 (the (192, 128)
    instance), phi3's 96 (tiles of 128 columns), granite-3-8b's and
    dbrx's 128; and unequal dims either way, in each tile.  Ragged S and
    T, causal and not, GQA group 2."""
    for causal in (True, False):
        _check_flash(*_flash_inputs(cuda, 2, 4, 2, 150, 150, d, dtype,
                                    d + dv, dv), causal=causal, route=route)
    q, k, v = _flash_inputs(cuda, 1, 4, 4, 70, 190, d, dtype, 7, dv)
    _check_flash(q, k, v, causal=False, route=route, scale=0.07)


def test_flash_kernel_mla_prefill_layout(cuda):
    """The MLA prefill's own layout: q and k concatenated from their nope
    and rope parts ((B, S, H, 192), the rope key broadcast to every head),
    v (B, S, H, 128), all as transpose(1, 2) views, scale (128 + 64)^-0.5:
    the tensor-core kernel by the rule, within its bounds."""
    from repro_torch.kernels.flash_attention import takes_tensor_cores
    rng = np.random.default_rng(19)
    b, s, h = 2, 300, 4

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda).bfloat16()
    q = torch.cat([t(b, s, h, 128), t(b, s, h, 64)], dim=-1)
    k = torch.cat([t(b, s, h, 128), t(b, s, 1, 64).expand(b, s, h, 64)],
                  dim=-1)
    v = t(b, s, h, 128)
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    assert takes_tensor_cores(q, k, v, 192 ** -0.5)
    got = _check_flash(q, k, v, causal=True, scale=192 ** -0.5)
    assert got.shape == (b, h, s, 128)
    assert got.transpose(1, 2).is_contiguous()


def test_flash_kernel_misaligned_bf16_takes_cuda_cores(cuda):
    """A bf16 view whose base is 2 bytes off a 16-byte boundary cannot be
    described to TMA: the rule sends it to the CUDA-core kernel, and the
    count says so."""
    from repro_torch.kernels.flash_attention import takes_tensor_cores
    rng = np.random.default_rng(12)
    flat = torch.tensor(rng.normal(size=3 * 2 * 70 * 64 + 1),
                        dtype=torch.float32, device=cuda).bfloat16()
    q, k, v = flat[1:].view(3, 2, 70, 64).unbind(0)
    q, k, v = q[None], k[None], v[None]
    assert q.data_ptr() % 16 and not takes_tensor_cores(q, k, v)
    _check_flash(q, k, v, causal=True, route="flash_attention",
                 kernel="flash_attention_simt")
    assert takes_tensor_cores(q.clone(), k.clone(), v.clone())


@pytest.mark.parametrize("d", [20, 32, 33, 36, 72])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_simt_head_dim_templates(cuda, d, dtype):
    """The CUDA-core kernel at head dims that are not multiples of 8 or
    16 (33: plain loads even in float32) in each of its 32-, 64- and
    96-column tiles, causal and not."""
    for causal in (True, False):
        _check_flash(*_flash_inputs(cuda, 1, 4, 2, 130, 150, d, dtype, d),
                     causal=causal, route="flash_attention_simt")


def test_flash_simt_serve_gate_shape_and_views(cuda):
    """The float32 serve gate's layer: q (8, 32, 128, 64) with 8 KV heads,
    causal, as transposed (B, S, H, D) views (the cp.async ring); the same
    values through a float32 view whose base is 4 bytes off a 16-byte
    boundary (plain loads) agree with it bit for bit."""
    rng = np.random.default_rng(31)
    x = [torch.tensor(rng.normal(size=sh), dtype=torch.float32, device=cuda)
         for sh in ((8, 128, 32, 64), (8, 128, 8, 64), (8, 128, 8, 64))]
    q, k, v = (t.transpose(1, 2) for t in x)
    got = _check_flash(q, k, v, causal=True)
    flat = torch.empty(q.numel() + 1, device=cuda)
    qm = flat[1:].view(8, 128, 32, 64).transpose(1, 2)
    qm.copy_(q)
    assert qm.data_ptr() % 16
    assert torch.equal(_check_flash(qm, k, v, causal=True), got)
    from repro_torch.kernels import flash_attention as fa
    lib = _build.load("flash_attention")
    assert fa.MAX_HEAD_DIM == lib.flash_attention_max_head_dim() == 192
    assert fa.MAX_V_HEAD_DIM == lib.flash_attention_max_v_head_dim() == 128
    assert lib.flash_attention_tc_smem_bytes(192, 128) <= 232448
    assert lib.flash_attention_tc_smem_bytes(200, 128) == 0


@pytest.mark.parametrize("route", ROUTES)
def test_flash_wrapper_refuses_bad_inputs(cuda, route):
    call = _entry(route)
    q, k, v = _flash_inputs(cuda, 1, 2, 2, 16, 16, 200, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="D <= 192"):
        call(q, k, v)
    q, k, v = _flash_inputs(cuda, 1, 2, 2, 16, 16, 64, torch.bfloat16, 0,
                            dv=136)
    with pytest.raises(ValueError, match="Dv <= 128"):
        call(q, k, v)
    q, k, v = _flash_inputs(cuda, 1, 2, 2, 16, 16, 32, torch.float32, 0)
    with pytest.raises(ValueError, match="Hk, T, Dv"):
        call(q, k, v[:, :, :8])
    q, k, v = _flash_inputs(cuda, 1, 2, 2, 16, 16, 32, torch.float32, 0)
    with pytest.raises(ValueError, match="one CUDA device"):
        call(q, k.cpu(), v)
    with pytest.raises(TypeError):
        call(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        call(q, k.bfloat16(), v)
    for dt in (torch.float32, torch.bfloat16):
        strided = torch.zeros((1, 2, 16, 64), device=cuda, dtype=dt)[..., ::2]
        with pytest.raises(ValueError, match="contiguous"):
            call(strided, k.to(dt), v.to(dt))
    with pytest.raises(ValueError, match="multiple of Hk"):
        call(q, k[:, :1].expand(1, 3, 16, 32), v[:, :1].expand(1, 3, 16, 32))


def test_lm_prefill_and_decode_cuda_match_cpu(cuda):
    """The SMOKE model in float32 on the card and on the CPU: prefill and
    decode logits within float32 reordering; 2 launches of the CUDA-core
    kernel (one a layer) per prefill, none per decode step."""
    import dataclasses
    from repro_torch.configs.granite_3_2b import SMOKE as LM_SMOKE
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = dataclasses.replace(LM_SMOKE, dtype="float32")
    params = transformer.init_params(cfg, device="cpu")
    gpu = {k: (v.to(cuda) if k != "layers" else
               {n: t.to(cuda) for n, t in v.items()})
           for k, v in params.items()}
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (3, 70))
    ops.reset_launch_counts()
    on_gpu = serve.serve_lm(cfg, gpu, prompts, gen_len=4, device=cuda)
    counts = ops.launch_counts()         # float32: the CUDA-core kernel
    assert counts["flash_attention_simt"] == cfg.n_layers
    assert counts["flash_attention"] == 0
    on_cpu = serve.serve_lm(cfg, params, prompts, gen_len=4, device="cpu")
    for a, b in ((on_gpu.prefill_logits, on_cpu.prefill_logits),
                 (on_gpu.prompt_logits, on_cpu.prompt_logits)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
    serve.check_prefill_against_decode(on_gpu, 1e-5)
    with pytest.raises(ValueError, match="generator"):
        transformer.init_params(cfg, torch.Generator(), cuda)


@pytest.mark.parametrize("arch", ["dbrx_132b", "deepseek_v2_lite_16b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mla_serve_cuda_match_cpu(cuda, arch, dtype):
    """The MoE (dbrx) and MoE + MLA (deepseek) SMOKE models on the card
    and on the CPU, at a capacity that drops nothing and with prompts
    that fill whole groups of 64 (no ragged tail through expert 0): the
    same routing within float32 reordering, so prefill and decode logits
    agree; one flash launch a layer per prefill (the tensor-core kernel
    in bf16, MLA's 24/16 dims included; the CUDA-core one in float32)."""
    import dataclasses
    import importlib
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    smoke = importlib.import_module(f"repro_torch.configs.{arch}").SMOKE
    cfg = dataclasses.replace(smoke, dtype=dtype,
                              capacity_factor=float(smoke.n_experts))
    params = transformer.init_params(cfg, device="cpu")
    gpu = {k: (v.to(cuda) if k != "layers" else
               {n: t.to(cuda) for n, t in v.items()})
           for k, v in params.items()}
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (3, 64))
    ops.reset_launch_counts()
    on_gpu = serve.serve_lm(cfg, gpu, prompts, gen_len=4, device=cuda)
    counts = ops.launch_counts()
    kernel = "flash_attention_simt" if dtype == "float32" \
        else "flash_attention"
    assert counts[kernel] == cfg.n_layers
    assert sum(counts[k] for k in ("flash_attention",
                                   "flash_attention_simt")) == cfg.n_layers
    if dtype == "float32":
        on_cpu = serve.serve_lm(cfg, params, prompts, gen_len=4,
                                device="cpu")
        for a, b in ((on_gpu.prefill_logits, on_cpu.prefill_logits),
                     (on_gpu.prompt_logits, on_cpu.prompt_logits)):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
        serve.check_prefill_against_decode(on_gpu, 1e-5)


@pytest.mark.parametrize("encoder", ["ssh", "srp", "ssh-multires"])
def test_save_load_round_trip_on_the_card(cuda, tmp_path, encoder):
    """An index built on the card, saved and loaded back onto it, answers
    with bit-identical ids and distances, and holds the same arrays; the
    host-bucket probe of the loaded index finds the database rows."""
    from repro_torch.encoders import IndexSpec
    series = make_benchmark_db("ecg", 3000, 128, seed=5)
    spec = (SMOKE if encoder == "ssh" else IndexSpec(
        encoder=encoder, params={} if encoder == "srp" else dict(
            window=24, step=3, ngrams=(6, 8))))
    cfg = SearchConfig(topk=10, top_c=64, band=6, multiprobe_offsets=3)
    db = TimeSeriesDB.build(series, spec, cfg)
    want = db.search_batch(series[:32])
    db.save(tmp_path)
    loaded = TimeSeriesDB.load(tmp_path)
    assert loaded.device.type == "cuda"
    for name in ("signatures", "keys", "series", "env_upper", "env_lower"):
        assert torch.equal(getattr(loaded.index, name),
                           getattr(db.index, name)), name
    ops.reset_launch_counts()
    got = loaded.search_batch(series[:32])
    assert ops.launch_counts()["collision_count_batch"] == 1
    for g, w in zip(got, want):
        assert np.array_equal(g.ids, w.ids)
        assert np.array_equal(g.dists, w.dists)
    hb = loaded.with_config(cfg.replace(searcher="local",
                                        use_host_buckets=True))
    assert [int(r.ids[0]) for r in hb.search_batch(series[:4])] == \
        [0, 1, 2, 3]


def test_engine_on_the_card_matches_the_block_and_the_cpu(cuda):
    """The engine's batcher thread serves a CUDA index: queued host rows
    and CUDA-tensor queries answer as ``ssh_search_batch`` on the block
    and as the CPU engine (these raw windows need not find themselves at
    top_c 64); the three SSH kernels launch from the worker thread; an
    insert through the running engine is found at rank 1."""
    from repro_torch.db import BatchPolicy
    from repro_torch.serving import ServingEngine, ssh_search_batch
    series = make_benchmark_db("ecg", 2000, 128, seed=13)
    cfg = SearchConfig(topk=10, top_c=64, band=6, multiprobe_offsets=3,
                       searcher="engine", batch_policy=BatchPolicy(
                           max_batch=4, max_wait_ms=20.0))
    gpu = TimeSeriesDB.build(series, SMOKE, cfg)
    cpu = TimeSeriesDB.build(series, SMOKE, cfg, device="cpu")
    qids = [0, 5, 77, 301, 999, 1500, 1999]
    block = ssh_search_batch(series[qids], gpu.index, config=cfg)
    gpu.index.sig_cache = None           # so that the engine's batches encode
    engine = gpu.engine
    assert isinstance(engine, ServingEngine)
    futs = [engine.submit(series[q]) for q in qids[:4]]
    futs += [engine.submit(torch.as_tensor(series[q], device=cuda))
             for q in qids[4:]]
    ops.reset_launch_counts()
    with gpu:
        engine.start()
        got = [f.result(timeout=300) for f in futs]
        counts = ops.launch_counts()
        hist = engine.metrics.batch_histogram()
        novel = make_benchmark_db("ecg", 1, 128, seed=99)[0]
        gpu.add(novel)
        found = gpu.search(novel)
    assert min(counts[k] for k in ("sketch_conv", "collision_count_batch",
                                   "dtw_wavefront_pairs")) >= 1
    assert hist == {4: 1, 3: 1}
    with cpu:
        want = cpu.search_batch(series[qids])
    for i, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g.ids, np.ndarray)
        np.testing.assert_array_equal(g.ids, block.per_query(i).ids)
        np.testing.assert_array_equal(g.dists, block.per_query(i).dists)
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.dists, w.dists)
    assert found.ids[0] == len(series) and found.n_database == len(series) + 1


def test_engine_facade_on_the_card_adaptive(cuda):
    """The facade's engine on the card under the adaptive policy: every
    row finds itself and futures resolve to host arrays."""
    from repro_torch.db import BatchPolicy
    series = make_benchmark_db("ecg", 500, 128, seed=14)
    cfg = SearchConfig(topk=5, top_c=32, band=6, searcher="engine",
                       batch_policy=BatchPolicy(mode="adaptive",
                                                max_batch=8))
    db = TimeSeriesDB.build(series, SMOKE, cfg, device=cuda)
    with db:
        res = [db.submit(series[i]).result(timeout=300) for i in range(6)]
        engine = db.engine
    assert [int(r.ids[0]) for r in res] == list(range(6))
    assert all(isinstance(r.dists, np.ndarray) for r in res)
    assert engine._state == "stopped" and engine.service_ewma_s > 0
    assert engine.metrics.snapshot()["requests_total"] == 6


def test_spun_events_read_the_profilers_device_time(cuda):
    """``spun_ms`` (events, the stream held by a spin while the host
    dispatches) reads a kernel's device time as the profiler does: a
    small sketch call, whose host work outlasts its kernel, is read as
    the kernel's time and not as the dispatch's."""
    from repro_torch.bench.device_time import device_ms, spun_ms
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(512, 512)), dtype=torch.float32,
                     device=cuda)
    filt = torch.tensor(rng.normal(size=(80, 1)), dtype=torch.float32,
                        device=cuda)
    prof = device_ms(lambda: ops.sketch_conv(x, filt, 3), calls=20)
    ev = spun_ms(lambda: ops.sketch_conv(x, filt, 3), calls=20)
    assert prof["source"] == "profiler"
    assert 0.5 * prof["ms"] < ev < 2.0 * prof["ms"] + 0.02


def test_device_ms_reads_events_when_the_profiler_keeps_nothing(
        cuda, monkeypatch):
    """Every profiled window empty: ``device_ms`` reads the call by
    events after ``WINDOWS`` windows and says so, instead of raising."""
    import types

    import torch.profiler as tp
    from repro_torch.bench import device_time

    class Empty:
        def __init__(self, **_):
            self.profiler = types.SimpleNamespace(
                kineto_results=types.SimpleNamespace(events=lambda: []))

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

        def key_averages(self):
            return []

    monkeypatch.setattr(tp, "profile", Empty)
    a = torch.randn(1024, 1024, device=cuda)
    got = device_time.device_ms(lambda: a @ a, calls=5)
    assert got["source"] == "events" and got["windows"] == \
        device_time.WINDOWS
    assert got["ms"] > 0 and got["launches"] is None


def test_spun_ms_refuses_a_call_that_synchronises(cuda):
    """A call that waits for the card outlasts every spin, so its device
    time cannot be read by events: ``spun_ms`` raises."""
    from repro_torch.bench.device_time import spun_ms
    a = torch.randn(256, 256, device=cuda)
    with pytest.raises(RuntimeError, match="synchronises"):
        spun_ms(lambda: float((a @ a).sum()), calls=2, doublings=2)


def test_device_ms_reads_the_kernel_after_the_lead_in(cuda):
    """A window opens with the lead-in's spin kernels and reads only the
    call's: a sketch call's device time is its one kernel's, recorded
    once a call, and the census holds the records against the launch
    counter."""
    from repro_torch.bench import device_time
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(512, 512)), dtype=torch.float32,
                     device=cuda)
    filt = torch.tensor(rng.normal(size=(80, 1)), dtype=torch.float32,
                        device=cuda)
    got = device_time.device_ms(lambda: ops.sketch_conv(x, filt, 3),
                                calls=20, label="sketch")
    assert got["launches"] == 1 and got["complete"]
    assert list(got["kernels"]) and all(
        "sketch_conv_kernel" in k for k in got["kernels"])
    assert 0.0 < got["ms"] < 1.0
    entry = device_time.CENSUS[-1]
    assert entry["label"] == "sketch" and not entry["gap"]
    assert entry["launched"]["sketch_conv"] == 20


def test_fleet_query_on_the_card_launches_the_kernels_and_matches_cpu(
        cuda):
    """A fleet (R = 2, W = 4) over a CUDA index encodes through
    ``sketch_conv`` and probes every shard through ``collision_count`` and
    ``dtw_wavefront`` from the pool's threads, and answers as the same
    fleet over a CPU copy, and as four row shards on the card; one
    killed worker changes nothing."""
    from repro_torch.fleet import FleetSearcher
    from repro_torch.serving import DistributedSearcher
    series = make_benchmark_db("ecg", 2000, 128, seed=15)
    cfg = SearchConfig(topk=5, top_c=64, band=6, replication=2,
                       fleet_workers=4)
    gpu = TimeSeriesDB.build(series, SMOKE, cfg)
    cpu = TimeSeriesDB.build(series, SMOKE, cfg, device="cpu")
    qids = [0, 5, 77, 1999]
    fleet = FleetSearcher(gpu.index, cfg)
    try:
        assert all(r.device.type == "cuda"
                   for w in fleet.workers.values()
                   for r in w._shards.values())
        ops.reset_launch_counts()
        got = fleet.search_batch(series[qids])
        counts = ops.launch_counts()
        fleet.injector.kill("w0")
        again = fleet.search_batch(series[qids])
    finally:
        fleet.close()
    assert counts["sketch_conv"] >= len(qids)
    assert counts["collision_count"] >= 4 * len(qids)
    assert counts["dtw_wavefront"] >= 4 * len(qids)
    fleet_cpu = FleetSearcher(cpu.index, cfg)
    try:
        want = fleet_cpu.search_batch(series[qids])
    finally:
        fleet_cpu.close()
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(again.ids, got.ids)
    np.testing.assert_array_equal(again.dists, got.dists)
    dist = DistributedSearcher(gpu.index, cfg.replace(replication=1),
                               [cuda] * 4).search_batch(series[qids])
    np.testing.assert_array_equal(dist.ids, got.ids)
    np.testing.assert_array_equal(dist.dists, got.dists)


def test_launch_counts_stay_exact_under_threads(cuda):
    """Eight threads launching ``collision_count`` at once: the count is
    every launch, no increment lost."""
    import sys
    import threading
    q = torch.randint(0, 50, (40,), dtype=torch.int32, device=cuda)
    db = torch.randint(0, 50, (4096, 40), dtype=torch.int32, device=cuda)
    calls, threads = 200, 8
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ops.reset_launch_counts()
        workers = [threading.Thread(target=lambda: [
            ops.collision_count(q, db) for _ in range(calls)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    torch.cuda.synchronize()
    assert ops.launch_counts()["collision_count"] == calls * threads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hk,d,dv", [(4, 2, 64, 64), (4, 4, 192, 128)])
def test_flash_function_gradients_on_the_card(cuda, dtype, h, hk, d, dv):
    """``ops.FlashAttention`` on the card (the kernel's forward, launched
    once; the chunked plain backward) against the same Function on a CPU
    copy: float32 within 1e-5 of the max gradient, bf16 within 2^-6 of it
    (the tensor-core forward rounds P to bf16, which enters the backward
    through rowsum(dO o O); chip_smoke.py's train_grad holds it per
    element)."""
    rng = np.random.default_rng(d + h)
    shapes = ((2, h, 150, d), (2, hk, 150, d), (2, hk, 150, dv),
              (2, h, 150, dv))
    q, k, v, do = (torch.tensor(rng.normal(size=s), dtype=torch.float32)
                   .to(dtype) for s in shapes)
    leaves = [x.to(cuda).requires_grad_(True) for x in (q, k, v)]
    ops.reset_launch_counts()
    o = ops.flash_attention(*leaves, causal=True)
    o.backward(do.to(cuda))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] + counts["flash_attention_simt"] == 1
    cpu = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ops.flash_attention(*cpu, causal=True).backward(do)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    for got, want in zip(leaves, cpu):
        err = (got.grad.float().cpu() - want.grad.float()).abs().max()
        assert float(err) <= tol * float(want.grad.float().abs().max())


def test_train_step_on_the_card_matches_cpu(cuda):
    """Two float32 training steps of the SMOKE granite through
    ``launch.steps`` on the card and on the CPU from the same weights:
    losses within 1e-5, parameters within 2 x sum lr_t (Adam's step)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    arch = get_arch("granite-3-2b")
    arch = dataclasses.replace(arch, smoke_config=dataclasses.replace(
        arch.smoke_config, dtype="float32"))
    runs = {}
    for dev in ("cpu", cuda):
        params = steps.init_fn(arch, "train_4k", smoke=True, device="cpu")(
            torch.Generator().manual_seed(3))
        params = T.unflatten({k: v.to(dev) for k, v in
                              T.flatten(params).items()})
        opt = steps.make_optimizer("lm")
        state = opt.init(params)
        step = steps.make_step(arch, "train_4k", "train", smoke=True)
        toks = torch.tensor(np.random.default_rng(0).integers(
            0, 256, (2, 2, 64)), device=dev)
        losses = []
        for _ in range(2):
            params, state, m = step(params, state, {"tokens": toks[0],
                                                    "labels": toks[1]})
            losses.append(float(m["loss"]))
        runs[str(dev)] = (losses, {k: v.detach().cpu() for k, v in
                                   T.flatten(params).items()})
    (cpu_l, cpu_p), (gpu_l, gpu_p) = runs["cpu"], runs[str(cuda)]
    np.testing.assert_allclose(gpu_l, cpu_l, rtol=1e-5)
    atol = 2 * sum(steps.make_optimizer("lm").schedule(i) for i in (1, 2))
    for k in cpu_p:
        assert float((gpu_p[k] - cpu_p[k]).abs().max()) <= atol * 1.01, k


def test_paper_api_goes_through_the_kernels(cuda):
    """``build_signatures``, the ``SSHParams`` facade shim and the probe
    functions on the card: signatures and keys equal to the spec= build
    (the same kernels), counts and top-C equal to the plain versions on
    the CPU, each kernel launched."""
    import warnings

    from repro_torch.core import index as cidx
    params = cidx.SSHParams(window=24, step=3, ngram=8, num_hashes=20,
                            num_tables=10)
    series = make_benchmark_db("ecg", 600, 128, seed=5)
    ops.reset_launch_counts()
    fns = cidx.SSHFunctions.create(params)
    sigs = cidx.build_signatures(series, fns)
    assert ops.launch_counts()["sketch_conv"] == 3      # 256-row chunks
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        db = TimeSeriesDB.build(series, params, SearchConfig(band=6))
    assert torch.equal(sigs, db.index.signatures)
    keys = cidx.band_keys(sigs, params)
    assert torch.equal(keys, db.index.keys)
    assert db.params == params
    q = sigs[[1, 50, 333]]
    before = ops.launch_counts()
    ids, vals = cidx.probe_topc_batch(q, sigs, 40)
    one_ids, one_vals = cidx.probe_topc(q[0], sigs, 40)
    after = ops.launch_counts()
    assert after["collision_count_batch"] - before[
        "collision_count_batch"] == 1
    assert after["collision_count"] - before["collision_count"] == 1
    want = ref.collision_count_batch_ref(q.cpu(), sigs.cpu())
    wids, wvals = cidx.top_c_by_count(want, 40)
    assert torch.equal(ids.cpu(), wids) and torch.equal(vals.cpu(), wvals)
    assert torch.equal(one_ids, ids[0]) and torch.equal(one_vals, vals[0])


def _composite_topk(counts, top_c):
    """The oracle of the top-C select: ``torch.topk`` of the unique key
    count·2^32 + (N-1-column), ties to the lowest column."""
    n = counts.shape[1]
    rev = n - 1 - torch.arange(n, device=counts.device)
    key = (counts.to(torch.int64) << 32) | rev
    top = torch.topk(key, top_c, dim=1, sorted=True).values
    return n - 1 - (top & 0xFFFFFFFF), (top >> 32).to(torch.int32)


def _topc_counts(kind, b, n, max_count, seed, device):
    """All 0, all ``max_count`` (every column a tie), uniform, or a few
    high columns over a mass tied at one count."""
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "zero":
        return torch.zeros((b, n), dtype=torch.int32, device=device)
    if kind == "max":
        return torch.full((b, n), max_count, dtype=torch.int32,
                          device=device)
    if kind == "uniform":
        return torch.randint(0, max_count + 1, (b, n), generator=g,
                             dtype=torch.int32, device=device)
    x = torch.full((b, n), max_count // 2, dtype=torch.int32, device=device)
    x[torch.rand((b, n), generator=g, device=device) < 0.002] = max_count
    x[torch.rand((b, n), generator=g, device=device) < 0.3] = max_count // 4
    return x


TOPC_BIG = 2 ** 20 + 7
TOPC_NC = sorted({(n, c) for c in (1, 512)
                  for n in (1, c - 1, c, c + 1, TOPC_BIG) if n >= 1}
                 | {(n, n) for n in (1, 511, 512, 513, TOPC_BIG)})


@pytest.mark.parametrize("max_count", [20, 40, 64])
@pytest.mark.parametrize("n, c", TOPC_NC)
@pytest.mark.parametrize("b", [1, 3, 64])
def test_topc_select_kernel_equals_composite_topk(cuda, b, n, c,
                                                  max_count):
    """The three kernels give the composite-key ``torch.topk``'s ids and
    counts bit for bit, on every kind of counts; each pass launches once
    a call; C > N raises on the host."""
    for i, kind in enumerate(("zero", "max", "uniform", "mass")):
        counts = _topc_counts(kind, b, n, max_count, n + 7 * i + b, cuda)
        if c > n:
            with pytest.raises(ValueError):
                ops.top_c_select(counts, c, max_count)
            continue
        ops.reset_launch_counts()
        ids, vals = ops.top_c_select(counts, c, max_count)
        launched = ops.launch_counts()
        torch.cuda.synchronize()
        assert all(launched[p] == 1 for p in
                   ("topc_histogram", "topc_threshold", "topc_scatter"))
        want_ids, want_vals = _composite_topk(counts, c)
        assert torch.equal(ids, want_ids), kind
        assert torch.equal(vals, want_vals), kind


def test_topc_select_kernel_multiprobe_block_and_limits(cuda):
    """The (B, O, N) -> max counts of a multiprobe block, rows that start
    off a 16-byte boundary, a side stream; max_count above 64 raises and
    the library's limit is the wrapper's; nothing synchronises."""
    from repro_torch.kernels import topc_select as tc
    spec = SMOKE.with_params(num_hashes=40, num_tables=20)
    series = make_benchmark_db("ecg", 3000, 128, seed=21)
    db = TimeSeriesDB.build(series, spec, SearchConfig(band=6), device=cuda)
    qs = torch.as_tensor(series[::47][:64], dtype=torch.float32, device=cuda)
    sigs = db.index.query_signatures_batch_multiprobe(qs, 3)
    counts = ops.collision_count_batch(sigs.reshape(-1, 40),
                                       db.index.signatures
                                       ).reshape(64, 3, -1).amax(1)
    for c in (1, 64, 512, int(counts.shape[1])):
        got = ops.top_c_select(counts, c, 40)
        want = _composite_topk(counts, c)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        plain = ref.top_c_select_ref(counts, c, 40)
        assert all(torch.equal(a, p) for a, p in zip(got, plain))
    x = _topc_counts("mass", 5, 70_001, 40, 3, cuda)
    shifted = torch.empty(5 * 70_001 + 1, dtype=torch.int32,
                          device=cuda)[1:].view(5, 70_001)
    shifted.copy_(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    calls = []
    real = torch.cuda.synchronize
    with torch.cuda.stream(side):
        try:
            torch.cuda.synchronize = lambda *a, **k: calls.append(a)
            got = ops.top_c_select(shifted, 700, 40)
        finally:
            torch.cuda.synchronize = real
    torch.cuda.synchronize()
    assert calls == []
    want = _composite_topk(x, 700)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        ops.top_c_select(counts, 8, 65)
    assert _build.load(tc.NAME).topc_select_max_count() == tc.MAX_COUNT


@pytest.mark.parametrize("band", [None, 6])
def test_dtw_family_on_the_card(cuda, band):
    """``dtw_batch`` / ``dtw_banded_batch`` through ``dtw_wavefront`` and
    ``dtw_pairwise`` through ``dtw_wavefront_pairs``, bit-identical to
    the plain versions on the CPU; rectangular ``dtw`` (plain torch on
    the card) within 1e-6 of the float64 DP."""
    from repro_torch.core import dtw as core_dtw
    rng = np.random.default_rng(7)
    xs = torch.tensor(rng.normal(size=(6, 96)).cumsum(1),
                      dtype=torch.float32)
    ys = torch.tensor(rng.normal(size=(40, 96)).cumsum(1),
                      dtype=torch.float32)
    before = ops.launch_counts()
    pw = core_dtw.dtw_pairwise(xs.to(cuda), ys.to(cuda), band)
    b1 = core_dtw.dtw_batch(xs[0].to(cuda), ys.to(cuda), band)
    after = ops.launch_counts()
    assert after["dtw_wavefront_pairs"] > before["dtw_wavefront_pairs"]
    assert after["dtw_wavefront"] > before["dtw_wavefront"]
    assert torch.equal(pw.cpu(), core_dtw.dtw_pairwise(xs, ys, band))
    assert torch.equal(b1.cpu(), pw[0].cpu())
    if band is not None:
        thr = torch.sort(pw[0]).values[9]
        got = core_dtw.dtw_banded_batch(xs[0].to(cuda), ys.to(cuda), band,
                                        thr)
        want = core_dtw.dtw_banded_batch(xs[0], ys, band, thr.cpu())
        assert torch.equal(got.cpu(), want)
        assert int((got < core_dtw.BIG).sum()) == 10
    for m_x, m_y in ((96, 80), (70, 96)):
        x, y = xs[1, :m_x], ys[2, :m_y]
        got = float(core_dtw.dtw(x.to(cuda), y.to(cuda), band))
        want = core_dtw.dtw_dp_reference(x.numpy(), y.numpy(), band)
        assert abs(got - want) <= 1e-6 * want


def test_cascade_stats_and_srp_search_on_the_card(cuda):
    """``cascade_stats`` within 2/N of the CPU's fractions, and the SRP
    baseline's ids equal to the CPU's (its DTW through
    ``dtw_wavefront``)."""
    from repro_torch.core import lower_bounds as lb
    from repro_torch.core import search, srp
    series = torch.from_numpy(make_benchmark_db("ecg", 2000, 128, seed=6))
    q = series[17] + 0.05
    best = torch.sort(ref.dtw_wavefront_ref(q, series, 8)).values[9]
    got = lb.cascade_stats(q.to(cuda), series.to(cuda), 8, best.to(cuda))
    want = lb.cascade_stats(q, series, 8, best)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 2 / 2000, k
    planes = srp.make_srp(32, 128, torch.Generator().manual_seed(1))
    bits = srp.srp_bits(series, planes)
    before = ops.launch_counts()["dtw_wavefront"]
    g = search.srp_search(q.to(cuda), series.to(cuda), planes.to(cuda),
                          bits.to(cuda), topk=10)
    assert ops.launch_counts()["dtw_wavefront"] == before + 1
    w = search.srp_search(q, series, planes, bits, topk=10, device="cpu")
    np.testing.assert_array_equal(g.ids, w.ids)
    np.testing.assert_array_equal(g.dists, w.dists)


# -- the DTW cell count and the sync-free stage timer ------------------------

def _pairs(rng, n, m, cuda):
    return _walk_rows(rng, n, m, cuda), _walk_rows(rng, n, m, cuda)


@pytest.mark.parametrize("schedule", ["rows", "diagonals"])
@pytest.mark.parametrize("m,band,n", [(1, 0, 5), (40, 6, 70), (96, 40, 33),
                                      (512, 25, 300), (130, 63, 40)])
def test_dtw_cells_count_the_band_without_a_threshold(cuda, schedule, m,
                                                      band, n):
    """With no threshold every pair computes its whole band, under both
    schedules, and the values are those without the counter."""
    rng = np.random.default_rng(m + band)
    q, c = _pairs(rng, n, m, cuda)
    cells = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    got = kd.dtw_wavefront_pairs(q, c, band, schedule=schedule, cells=cells)
    plain = kd.dtw_wavefront_pairs(q, c, band, schedule=schedule)
    assert torch.equal(got, plain)
    assert torch.equal(got, ref.dtw_pairs_ref(q, c, band))
    r = min(band, m - 1)
    assert cells.tolist() == [kd.band_cells(m, r)] * n


@pytest.mark.parametrize("schedule", ["rows", "diagonals"])
@pytest.mark.parametrize("m,band", [(200, 6), (512, 25), (256, 63)])
def test_dtw_cells_fall_where_pairs_are_abandoned(cuda, schedule, m, band):
    """Pairs under their threshold count the whole band; pairs abandoned
    count fewer, at the closed form of the rows or diagonals their
    schedule stepped; the values are those without the counter."""
    from repro_torch.core.dtw import BIG
    rng = np.random.default_rng(m * 3 + band)
    n = 96                                   # three row-schedule blocks
    q, c = _pairs(rng, n, m, cuda)
    exact = ref.dtw_pairs_ref(q, c, band)
    full = kd.band_cells(m, band)
    # every pair over (at zero: every cost is positive) or under its bound
    for thr, abandoned in ((torch.zeros_like(exact), True),
                           (exact * 1.5, False), (exact, False)):
        cells = torch.zeros(n, dtype=torch.int32, device=cuda)
        got = kd.dtw_wavefront_pairs(q, c, band, thr.contiguous(),
                                     schedule=schedule, cells=cells)
        assert torch.equal(got, kd.dtw_wavefront_pairs(
            q, c, band, thr.contiguous(), schedule=schedule))
        assert torch.equal(got, ref.dtw_pairs_ref(q, c, band, thr))
        counts = cells.tolist()
        if not abandoned:
            assert counts == [full] * n
            continue
        assert bool((got == BIG).all())
        assert all(0 < k < full for k in counts), counts
        if schedule == "rows":               # one tile, then every pair
            assert counts == [kd.band_cells(m, band, kd.ROWS_TILE)] * n
        else:                                # the first check's diagonals
            d = kd.DIAG_CHECK_EVERY + (band & 1)
            assert counts == [kd.band_cells_diagonals(m, band, d)] * n


def test_batched_search_timer_never_synchronises(cuda, monkeypatch):
    """``ssh_search_batch`` with stage timings on: no
    ``torch.cuda.synchronize`` at all, every span on the stream's clock,
    and the cell count no more than the band's."""
    series = make_benchmark_db("ecg", 600, 128, seed=15)
    cfg = SearchConfig(topk=10, top_c=64, band=6, multiprobe_offsets=3)
    db = TimeSeriesDB.build(series, SMOKE, cfg, device=cuda)
    qs = series[[1, 40, 333, 599]]
    db.search_batch(qs)                           # warm
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    from repro_torch.serving.batched import ssh_search_batch
    res = ssh_search_batch(qs, db.index, cfg)
    assert calls == []
    st = res.stats
    assert set(st.stage_seconds) == {"encode", "probe", "lb",
                                     "lb_improved", "dtw"}
    for name in ("probe.topc", "encode.sigcache", "dtw"):
        assert st.span_seconds[name]["device"] >= 0.0, name
        assert st.span_seconds[name]["host"] >= 0.0, name
    assert st.span_seconds["probe.topc"]["device"] <= \
        st.span_seconds["probe"]["device"]
    assert 0 < st.dtw_cells <= st.dtw_band_cells
    cpu = TimeSeriesDB.build(series, SMOKE, cfg, device="cpu")
    want = ssh_search_batch(qs, cpu.index, cfg)
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_array_equal(res.dists, want.dists)
    assert want.stats.dtw_band_cells == st.dtw_band_cells
    assert 0 < st.topc_tie_slots == want.stats.topc_tie_slots
