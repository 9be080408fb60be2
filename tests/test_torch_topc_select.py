"""The probe's top-C select on the CPU: the plain three-pass version
(``kernels.ref.top_c_select_ref``: a histogram per chunk, a threshold,
a stable scatter) against the composite-key ``torch.topk`` that it
replaced, kept here as the oracle; the chunk rule; the callers' key
widths; the tie-slot counter.

Everything is exact: ids and counts are integers, compared
with ``torch.equal``.  The card's kernels are held to the same oracle in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.ssh_ecg import SMOKE
from repro_torch.core import search
from repro_torch.data.timeseries import make_benchmark_db
from repro_torch.db import SearchConfig, TimeSeriesDB
from repro_torch.distributed import dist_index
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import topc_select as tc
from repro_torch.serving import batched

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

BIG_N = 2 ** 14 + 7          # several chunks of SMALL_CHUNK at CPU size
SMALL_CHUNK = 4096


def composite_topk(counts: torch.Tensor, top_c: int):
    """The select this one replaced: ``torch.topk`` of the unique key
    count·2^32 + (N-1-column), so ties go to the lowest column."""
    n = counts.shape[1]
    rev = n - 1 - torch.arange(n, device=counts.device)
    key = (counts.to(torch.int64) << 32) | rev
    top = torch.topk(key, top_c, dim=1, sorted=True).values
    return n - 1 - (top & 0xFFFFFFFF), (top >> 32).to(torch.int32)


def tie_slots(vals: torch.Tensor) -> torch.Tensor:
    """Slots each row filled from its threshold, the smallest count it
    kept."""
    return (vals == vals[:, -1:]).sum(1, dtype=torch.int32)


def make_counts(kind: str, b: int, n: int, max_count: int, seed: int
                ) -> torch.Tensor:
    """All 0; all ``max_count`` (every column a tie); uniform; or a few
    high columns over a mass tied at one count, with a lower band."""
    g = torch.Generator().manual_seed(seed)
    if kind == "zero":
        return torch.zeros((b, n), dtype=torch.int32)
    if kind == "max":
        return torch.full((b, n), max_count, dtype=torch.int32)
    if kind == "uniform":
        return torch.randint(0, max_count + 1, (b, n), generator=g,
                             dtype=torch.int32)
    x = torch.full((b, n), max_count // 2, dtype=torch.int32)
    x[torch.rand((b, n), generator=g) < 0.002] = max_count
    x[torch.rand((b, n), generator=g) < 0.3] = max_count // 4
    return x


#: (N, C): C of 1 and 512 at N = 1, C - 1, C, C + 1 and a row of several
#: chunks; C = N at the same N
NC = sorted({(n, c) for c in (1, 512) for n in (1, c - 1, c, c + 1, BIG_N)
             if n >= 1} | {(n, n) for n in (1, 511, 512, 513, BIG_N)})


@pytest.mark.parametrize("max_count", [20, 40, 64])
@pytest.mark.parametrize("n, c", NC)
@pytest.mark.parametrize("b", [1, 3, 64])
def test_ref_equals_composite_topk(b, n, c, max_count):
    """The three passes give the oracle's ids and counts bit for bit, on
    every kind of counts, at the kernel's chunk and at several chunks a
    row; C > N raises, as ``torch.topk`` does."""
    for i, kind in enumerate(("zero", "max", "uniform", "mass")):
        counts = make_counts(kind, b, n, max_count, seed=n + 7 * i + b)
        if c > n:
            with pytest.raises(ValueError):
                ref.top_c_select_ref(counts, c, max_count)
            with pytest.raises(RuntimeError):
                composite_topk(counts, c)
            continue
        want_ids, want_vals = composite_topk(counts, c)
        for chunk in (None, SMALL_CHUNK):
            ids, vals = ref.top_c_select_ref(counts, c, max_count, chunk)
            assert ids.dtype == torch.int64 and vals.dtype == torch.int32
            assert torch.equal(ids, want_ids), (kind, chunk)
            assert torch.equal(vals, want_vals), (kind, chunk)


def test_ref_on_a_multiprobe_block():
    """The (B, O, N) -> max counts of a real multiprobe block over a
    synthetic ECG index (K = 40)."""
    spec = SMOKE.with_params(num_hashes=40, num_tables=20)
    series = make_benchmark_db("ecg", 3000, 128, seed=21)
    db = TimeSeriesDB.build(series, spec, SearchConfig(band=6),
                            device="cpu")
    idx = db.index
    qs = torch.as_tensor(series[::50][:60], dtype=torch.float32)
    sigs = idx.query_signatures_batch_multiprobe(qs, 3)        # (B, 3, K)
    counts = ref.collision_count_batch_ref(
        sigs.reshape(-1, sigs.shape[-1]), idx.signatures
    ).reshape(len(qs), 3, -1).amax(1)
    for c in (1, 64, 512, int(counts.shape[1])):
        want_ids, want_vals = composite_topk(counts, c)
        for chunk in (None, 512):
            ids, vals = ref.top_c_select_ref(counts, c, 40, chunk)
            assert torch.equal(ids, want_ids) and torch.equal(vals,
                                                              want_vals)


def test_ops_route_and_limits():
    """A CPU tensor takes the plain version and launches nothing; the
    limits raise on the host: max_count 65, a negative max_count, C > N,
    a non-int32 or 1-D tensor."""
    counts = make_counts("uniform", 4, 1000, 40, seed=3)
    ops.reset_launch_counts()
    got = ops.top_c_select(counts, 100, 40)
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    want = ref.top_c_select_ref(counts, 100, 40)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert ops.MAX_COUNT == tc.MAX_COUNT == 64
    for bad in (dict(max_count=65), dict(max_count=-1),
                dict(top_c=1001)):
        kw = {**dict(top_c=10, max_count=40), **bad}
        with pytest.raises(ValueError):
            ops.top_c_select(counts, **kw)
    with pytest.raises(TypeError):
        ops.top_c_select(counts.long(), 10, 40)
    with pytest.raises(ValueError):
        ops.top_c_select(counts[0], 10, 40)
    ids, vals = ops.top_c_select(counts, 0, 40)
    assert ids.shape == (4, 0) and vals.shape == (4, 0)


@pytest.mark.parametrize("b, n", [(64, 6_291_456), (64, 1_572_864),
                                  (1, 20_971_520), (53, 6_291_456),
                                  (1, 1), (3, 4097), (64, 600)])
def test_chunk_rule(b, n):
    """A chunk is a multiple of the scatter's tile and at least
    ``MIN_CHUNK``; at the paper's scales (64 queries over 6.3M or 1.6M
    rows, one over 20,971,520) a call has at least a resident wave of
    blocks, 8 a SM on 132 SMs, and no more than ``TARGET_BLOCKS`` plus a
    row's worth."""
    chunk = tc.chunk_rows(b, n)
    assert chunk % tc.CHUNK_MULTIPLE == 0 and chunk >= tc.MIN_CHUNK
    blocks = b * -(-n // chunk)
    assert blocks <= tc.TARGET_BLOCKS + b
    if n >= 1_000_000:
        assert blocks >= 132 * 8


# ---------------------------------------------------------------------------
# callers: the key width as max_count; the tie-slot counter

@pytest.fixture(scope="module")
def db():
    """K = 40 hashes in L = 20 tables, so the two widths differ."""
    spec = SMOKE.with_params(num_hashes=40, num_tables=20)
    series = make_benchmark_db("ecg", 800, 128, seed=23)
    return TimeSeriesDB.build(series, spec, SearchConfig(band=6, top_c=64),
                              device="cpu"), series


def _spy(monkeypatch, module, name):
    seen = []
    orig = getattr(module, name)

    def spy(counts, top_c, max_count=ops.MAX_COUNT):
        seen.append(max_count)
        return orig(counts, top_c, max_count)
    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("by_signature, width", [(True, 40), (False, 20)])
@pytest.mark.parametrize("offsets", [1, 3])
def test_batch_probe_passes_its_key_width(db, monkeypatch, by_signature,
                                          width, offsets):
    """``batch_probe`` calls ``top_c_by_count(counts, top_c)``, the
    two-argument form that the benchmark's candidate fault
    (``portbench/tests/test_portbench_faults.py``) wraps, so its key
    width reaches the select as the default ``ops.MAX_COUNT``, whose bins
    hold every count of either width; what the stand-in returns is what
    the probe returns."""
    db, series = db
    seen = _spy(monkeypatch, batched.ops, "top_c_select")
    calls = []
    orig = batched.top_c_by_count

    def two_args(counts, c):
        calls.append(c)
        ids, vals = orig(counts, c)
        return ids.flip(1), vals.flip(1)
    monkeypatch.setattr(batched, "top_c_by_count", two_args)
    qs = torch.as_tensor(series[[1, 50, 700]], dtype=torch.float32)
    ids, vals = batched.batch_probe(qs, db.index, 64,
                                    rank_by_signature=by_signature,
                                    multiprobe_offsets=offsets)
    assert calls == [64] and seen == [ops.MAX_COUNT] and width <= seen[0]
    assert torch.all(vals[:, :-1] <= vals[:, 1:])      # the stand-in's


@pytest.mark.parametrize("by_signature, width", [(True, 40), (False, 20)])
def test_sequential_probe_passes_its_key_width(db, monkeypatch,
                                               by_signature, width):
    db, series = db
    seen = _spy(monkeypatch, search, "top_c_by_count")
    q = torch.as_tensor(series[5], dtype=torch.float32)
    search.hash_probe(q, db.index, 64, rank_by_signature=by_signature,
                      multiprobe_offsets=2)
    assert seen == [width]


def test_dist_index_passes_its_key_width(db, monkeypatch):
    db, series = db
    seen = _spy(monkeypatch, dist_index, "top_c_by_count")
    idx = db.index
    q = torch.as_tensor(series[9], dtype=torch.float32)
    sig = idx.query_signatures_batch(q[None])[0]
    dist_index.local_query(sig, q, idx.series, idx.signatures, local_c=32,
                           topk=5, band=6, abandon=True, seed_always=True)
    assert seen == [int(sig.shape[-1])] == [40]


@pytest.mark.parametrize("offsets", [1, 3])
def test_tie_slots_counter_equals_the_oracle(db, offsets):
    """``SearchStats.topc_tie_slots`` of a block is the oracle's count of
    slots filled from each query's threshold count, summed."""
    db, series = db
    idx = db.index
    rows = [0, 17, 301, 599, 600, 777]
    qs = torch.as_tensor(series[rows], dtype=torch.float32)
    cfg = SearchConfig(topk=5, top_c=64, band=6, multiprobe_offsets=offsets)
    res = batched.ssh_search_batch(qs, idx, cfg)
    sigs = (idx.query_signatures_batch_multiprobe(qs, offsets)
            if offsets > 1 else idx.query_signatures_batch(qs)[:, None])
    counts = ref.collision_count_batch_ref(
        sigs.reshape(-1, sigs.shape[-1]), idx.signatures
    ).reshape(len(rows), offsets, -1).amax(1)
    _, want_vals = composite_topk(counts, 64)
    want = int(tie_slots(want_vals).sum())
    assert res.stats.topc_tie_slots == want
    assert len(rows) <= want <= len(rows) * 64
    assert np.all(res.n_candidates >= 0)
