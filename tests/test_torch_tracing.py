"""The search's spans and counters on the CPU: ``bench.timing.StageTimer``
(profiler ranges, host and stream seconds, never a synchronise), the
pair DTW's cell count and its closed forms, the batcher's phases and
ranges, and the benchmark's readers of them on a tiny cell.

The stream side of the timer is driven here by stand-in CUDA events on
a clock of the test's own; ``tests/test_torch_cuda.py`` runs it on the
card.
"""
import contextlib
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch.bench import timing
from repro_torch.configs.ssh_ecg import SMOKE
from repro_torch.core import rerank as rr
from repro_torch.data.timeseries import make_benchmark_db
from repro_torch.db import BatchPolicy, SearchConfig, TimeSeriesDB
from repro_torch.kernels import ops, ref
from repro_torch.kernels import dtw_wavefront as kd
from repro_torch.serving import ServingEngine
from repro_torch.serving.batched import ssh_search_batch

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
KNOBS = dict(topk=5, top_c=48, band=6, multiprobe_offsets=3)
SPANS = ("encode", "probe", "lb", "lb_improved", "dtw", "probe.topc",
         "encode.sigcache")
ENGINE = ("engine.wait", "engine.collect", "engine.serve",
          "engine.resolve")
TIMEOUT = 120


@pytest.fixture(scope="module")
def series():
    return make_benchmark_db("ecg", 500, 128, seed=21)


@pytest.fixture(scope="module")
def db(series):
    return TimeSeriesDB.build(series, SMOKE, SearchConfig(**KNOBS),
                              device="cpu")


def _queries(series, n=6, seed=1):
    rng = np.random.default_rng(seed)
    qs = series[rng.choice(len(series), n, replace=False)].copy()
    return qs + rng.normal(0, 0.05, qs.shape).astype(np.float32)


def _ranges(prof, prefix):
    return {e.name for e in prof.events() if e.name.startswith(prefix)}


# ---------------------------------------------------------------------------
# the timer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("on", [True, False])
def test_batched_search_spans_on_the_profiler(db, series, on):
    """Each stage and both nested spans are profiler ranges ``ssh.<name>``
    with timings on, and no range exists with them off."""
    cfg = SearchConfig(stage_timings=on, **KNOBS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = ssh_search_batch(_queries(series), db.index, cfg)
    got = _ranges(prof, timing.PREFIX)
    if on:
        assert got == {timing.PREFIX + s for s in SPANS}
        assert set(res.stats.stage_seconds) == set(timing.STAGES)
        assert set(res.stats.span_seconds) == set(SPANS)
        for name, v in res.stats.span_seconds.items():
            assert v["device"] is None and v["host"] >= 0.0, name
        # on the CPU a stage's seconds are its host seconds
        for s in timing.STAGES:
            assert res.stats.stage_seconds[s] == \
                res.stats.span_seconds[s]["host"]
        spans = res.stats.span_seconds
        assert spans["probe.topc"]["host"] <= spans["probe"]["host"]
        assert spans["encode.sigcache"]["host"] <= spans["encode"]["host"]
    else:
        assert got == set()
        assert res.stats.stage_seconds is None
        assert res.stats.span_seconds is None
        assert res.stats.dtw_cells == res.stats.dtw_band_cells == 0


def test_stage_keys_kept_on_every_searcher(db, series):
    """``stage_seconds`` keeps the stages' key set on the batched and the
    local searcher; nested spans stay out of it."""
    qs = _queries(series, 3)
    batched = ssh_search_batch(qs, db.index, SearchConfig(**KNOBS))
    assert set(batched.stats.stage_seconds) == set(timing.STAGES)
    local = db.with_config(SearchConfig(searcher="local", **KNOBS))
    one = local.search(qs[0])
    assert set(one.stats.stage_seconds) == set(timing.STAGES)
    assert "probe.topc" not in one.stats.span_seconds


def test_disabled_timer_opens_no_range_event_or_clock(db, series,
                                                      monkeypatch):
    """With timings off the timer reads no clock, creates no event and
    opens no range, and no cell count is asked of the DTW."""
    def refuse(*a, **k):
        raise AssertionError("called with stage timings off")

    class NoClock:
        perf_counter = staticmethod(refuse)
    monkeypatch.setattr(timing, "time", NoClock)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    seen = []
    orig = ops.dtw_rerank_pairs

    def spy(q, c, band, thr=None, cells=None):
        seen.append(cells)
        return orig(q, c, band, thr, cells=cells)
    monkeypatch.setattr(ops, "dtw_rerank_pairs", spy)
    res = ssh_search_batch(_queries(series), db.index,
                           SearchConfig(stage_timings=False, **KNOBS))
    assert seen and all(c is None for c in seen)
    assert res.stats.dtw_cells == res.stats.dtw_band_cells == 0


class _Clock:
    """A stream's clock for stand-in events: each record reads it."""

    def __init__(self):
        self.t_ms = 0.0
        self.recorded = []
        self.waits = []


def _fake_cuda(monkeypatch, clock):
    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t = None

        def record(self, stream=None):
            self.t = clock.t_ms
            clock.recorded.append(self)

        def synchronize(self):
            clock.waits.append(self)

        def elapsed_time(self, end):
            return end.t - self.t

    def refuse(*a, **k):
        raise AssertionError("the timer synchronised")
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def test_stream_seconds_from_events_waiting_on_the_last(monkeypatch):
    """On a CUDA device a stage reads its events' elapsed time, summed
    over its entries; nested spans are named by their parent; reading
    waits on the last event alone and never synchronises the device."""
    clock = _Clock()
    _fake_cuda(monkeypatch, clock)
    timer = timing.StageTimer(prefill=timing.STAGES,
                              device=torch.device("cuda"))
    with timer.stage("encode") as sync:
        assert sync(7) == 7
        clock.t_ms += 2.0
        with timer.stage("sigcache"):
            clock.t_ms += 0.5
    with timer.stage("probe"):
        clock.t_ms += 4.0
        with timer.stage("topc"):
            clock.t_ms += 3.0
    with timer.stage("encode"):
        clock.t_ms += 1.0
    spans = timer.spans
    assert clock.waits == [clock.recorded[-1]]
    assert set(spans) == {"encode", "encode.sigcache", "probe",
                          "probe.topc"}
    assert spans["encode"]["device"] == pytest.approx(3.5e-3)
    assert spans["encode.sigcache"]["device"] == pytest.approx(0.5e-3)
    assert spans["probe"]["device"] == pytest.approx(7e-3)
    assert spans["probe.topc"]["device"] == pytest.approx(3e-3)
    assert timer.timings == pytest.approx(
        {"encode": 3.5e-3, "probe": 7e-3, "lb": 0.0, "lb_improved": 0.0,
         "dtw": 0.0})
    assert list(timer.timings) == list(timing.STAGES)
    assert len(clock.waits) == 1          # read once, then kept


def test_batched_search_never_synchronises_with_fake_events(
        db, series, monkeypatch):
    """The whole batched search under a timer whose device is CUDA (the
    events stand-ins): one wait on the last event, no synchronise."""
    clock = _Clock()
    _fake_cuda(monkeypatch, clock)
    timer = timing.StageTimer(prefill=timing.STAGES,
                              device=torch.device("cuda"))
    from repro_torch.serving import batched
    q = torch.as_tensor(_queries(series))
    ids, vals = batched.batch_probe(q, db.index, 48, timer=timer,
                                    multiprobe_offsets=3)
    valid = vals > 0
    rr.rerank_batch(q, ids, valid, db.index, 5, 6, timer=timer)
    assert set(timer.spans) == set(SPANS)
    assert clock.waits == [clock.recorded[-1]]


# ---------------------------------------------------------------------------
# the DTW cell count
# ---------------------------------------------------------------------------

def _brute(m, r, rows=None, diagonals=None):
    i, j = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    keep = np.abs(i - j) <= r
    if rows is not None:
        keep &= j < rows
    if diagonals is not None:
        keep &= i + j < diagonals
    return int(keep.sum())


@pytest.mark.parametrize("m,r", [(1, 0), (2, 1), (7, 0), (7, 3), (7, 6),
                                 (33, 5), (64, 31), (128, 6), (97, 40),
                                 (512, 25)])
def test_band_cells_closed_forms_count_the_band(m, r):
    """The closed forms the kernels store at exit equal a brute-force
    count: the whole band, its first rows (the row schedule) and its
    first anti-diagonals (the diagonal schedule)."""
    assert kd.band_cells(m, r) == _brute(m, r) == m * (2 * r + 1) - \
        r * (r + 1)
    for rows in sorted({0, 1, r, r + 1, m // 2, m - r, m - 1, m}):
        if 0 <= rows <= m:
            assert kd.band_cells(m, r, rows) == _brute(m, r, rows=rows)
    for d in sorted({0, 1, r, r + 1, r + 2, m - 1, m, m + 1, m + r,
                     2 * m - 2, 2 * m - 1}):
        if 0 <= d <= 2 * m - 1:
            assert kd.band_cells_diagonals(m, r, d) == \
                _brute(m, r, diagonals=d)


@pytest.mark.parametrize("band", [0, 5, None])
def test_plain_dtw_counts_the_full_band(band):
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.normal(size=(9, 40)), dtype=torch.float32)
    c = torch.tensor(rng.normal(size=(9, 40)), dtype=torch.float32)
    cells = torch.zeros(9, dtype=torch.int32)
    got = ops.dtw_rerank_pairs(q, c, band, cells=cells)
    assert torch.equal(got, ref.dtw_pairs_ref(q, c, band))
    r = 39 if band is None else band
    assert cells.tolist() == [kd.band_cells(40, r)] * 9


def test_batched_search_counts_cells_on_the_cpu(db, series):
    """On the CPU every pair computes its whole band: ``dtw_cells ==
    dtw_band_cells``, the seed pairs and the survivors together."""
    res = ssh_search_batch(_queries(series), db.index, SearchConfig(**KNOBS))
    st = res.stats
    seeds = 6 * KNOBS["topk"]                  # seed_size None: topk a row
    assert st.dtw_band_cells == (seeds + st.n_dtw) * kd.band_cells(128, 6)
    assert st.dtw_cells == st.dtw_band_cells > 0


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

def _engine(db, on, max_batch=4):
    cfg = SearchConfig(stage_timings=on, **KNOBS, batch_policy=BatchPolicy(
        mode="fixed", max_batch=max_batch, max_wait_ms=5.0))
    return ServingEngine(db.index, cfg)


def test_queued_and_collect_split_each_queue_wait(db, series, monkeypatch):
    """For every request the queued and collect seconds add up to its
    queue-wait sample; the batch's service is recorded once."""
    engine = _engine(db, False)
    calls = []
    orig = engine.metrics.on_batch

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)
    monkeypatch.setattr(engine.metrics, "on_batch", spy)
    qs = _queries(series, 10)
    with engine:
        futs = [engine.submit(q) for q in qs[:6]]
        [f.result(timeout=TIMEOUT) for f in futs]
        time.sleep(0.02)
        futs = [engine.submit(q) for q in qs[6:]]
        [f.result(timeout=TIMEOUT) for f in futs]
    n = 0
    for args, kw in calls:
        waits = args[2]
        assert len(kw["queued_s"]) == len(kw["collect_s"]) == len(waits)
        for w, a, b in zip(waits, kw["queued_s"], kw["collect_s"]):
            assert a >= 0.0 and b >= 0.0
            assert a + b == pytest.approx(w, rel=0, abs=1e-9)
            n += 1
        assert kw["service_s"] > 0.0
    assert n == 10
    snap = engine.metrics.snapshot()
    m = engine.metrics
    assert m.queued.n == m.collect.n == 10 and m.service.n == len(calls)
    assert snap["queued_ms_mean"] + snap["collect_ms_mean"] == \
        pytest.approx(1e3 * np.mean([w for a, _ in calls for w in a[2]]))
    assert snap["service_ms_mean"] > 0.0


def test_adaptive_ewma_reads_the_wall_time(db):
    """The policy's service estimate is the batch's wall time, with stage
    timings on as off: stage seconds never feed it."""
    engine = _engine(db, True)
    engine._observe_service(0.125)
    assert engine.service_ewma_s == 0.125
    alpha = engine.config.batch_policy.ewma_alpha
    engine._observe_service(0.5)
    assert engine.service_ewma_s == pytest.approx(
        alpha * 0.5 + (1 - alpha) * 0.125)


@pytest.mark.parametrize("on", [True, False])
def test_batcher_ranges_under_an_all_threads_profiler(db, series, on):
    """A profiler that profiles every thread sees the batcher's ranges
    (and the search's, on the batcher thread) with timings on, and none
    of either with them off."""
    engine = _engine(db, on)
    qs = _queries(series, 8)
    with engine:
        engine.submit(qs[0]).result(timeout=TIMEOUT)
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            for lo in (1, 5):
                futs = [engine.submit(q) for q in qs[lo:lo + 3]]
                [f.result(timeout=TIMEOUT) for f in futs]
                time.sleep(0.05)
    got = _ranges(prof, "engine.")
    ssh = _ranges(prof, timing.PREFIX)
    if on:
        assert got == set(ENGINE)
        assert {timing.PREFIX + s for s in ("encode", "probe", "dtw")} <= ssh
    else:
        assert got == set() and ssh == set()


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

def _portbench_conftest():
    spec = importlib.util.spec_from_file_location(
        "portbench_tests_conftest", ROOT / "portbench" / "tests" /
        "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


NEW_READERS = ("probe.topc_ms", "encode.sigcache_ms",
               "rerank.dtw_cell_frac", "kernel.dtw_wavefront_pairs.gcell_s")


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return _portbench_conftest().make_tiny(
        tmp_path_factory.mktemp("tiny_tracing"))


@pytest.mark.parametrize("cell", ["tiny-bulk", "tiny-rw-bulk"])
def test_new_readers_on_the_tiny_cpu_cell(tiny_root, cell):
    """A traced tiny bulk cell on the CPU reports the span and counter
    readers, each within its stage; the device-trace reader reads
    nothing without a card's trace."""
    from portbench.run import run_cell
    line = run_cell(cell, 2 ** 31 + 77, 0.8, True, device="cpu",
                    root=tiny_root, t_start=time.perf_counter())
    got = line["metrics"]
    assert line["correct"], line["checks"]
    assert 0.0 < got["probe.topc_ms"]["value"] < got["probe_ms"]["value"]
    assert 0.0 < got["encode.sigcache_ms"]["value"] <= \
        got["encode_ms"]["value"]
    assert got["rerank.dtw_cell_frac"]["value"] == 1.0
    assert "kernel.dtw_wavefront_pairs.gcell_s" not in got
    assert 0.0 < got["probe.topc_tie_frac"]["value"] <= 1.0


def test_gcell_reader_arithmetic(tiny_root):
    """Mean counted cells a block over the kernels' device seconds a
    block; nothing without cells or kernel records."""
    from portbench import spec
    from portbench.trace import TraceObs
    from repro_torch.core.rerank import SearchStats
    reader = spec.load_module(
        spec.metric_path(tiny_root, NEW_READERS[3]), "gcell")

    class Obs:
        def __init__(self, trace, stats):
            self.trace, self._stats = trace, stats

        def block_stats(self):
            return self._stats
    trace = TraceObs(window_s=1.0, busy_s=0.5,
                     device_ops={"void dtw_rows_kernel<24>": 0.004,
                                 "other": 1.0},
                     op_counts={"void dtw_rows_kernel<24>": 4, "other": 1},
                     gaps={}, batches=2)
    stats = [SearchStats(dtw_cells=3_000_000, dtw_band_cells=4_000_000),
             SearchStats(dtw_cells=5_000_000, dtw_band_cells=6_000_000)]
    assert reader.read(Obs(trace, stats)) == pytest.approx(
        1e-9 * 4e6 / 0.002)
    assert reader.read(Obs(trace, [SearchStats()])) is None
    assert reader.read(Obs(None, stats)) is None
    for name in NEW_READERS[:3]:
        mod = spec.load_module(spec.metric_path(tiny_root, name), name)
        assert mod.read(Obs(None, [SearchStats()])) is None


def test_tie_frac_reader_arithmetic(tiny_root):
    """Tie slots over blocks x B x C, C cut to the rows; nothing from a
    program whose stats lack the counter."""
    import types

    from portbench import spec
    from repro_torch.core.rerank import SearchStats
    name = "probe.topc_tie_frac"
    reader = spec.load_module(spec.metric_path(tiny_root, name), name)
    cell = spec.cell("tiny-bulk", tiny_root)

    class Obs:
        def __init__(self, stats):
            self.cell, self._stats = cell, stats

        def block_stats(self):
            return self._stats
    slots = int(cell.traffic["block"]) * min(int(cell.config["top_c"]),
                                             cell.n_rows)
    got = reader.read(Obs([SearchStats(topc_tie_slots=30),
                           SearchStats(topc_tie_slots=90)]))
    assert got == pytest.approx(120 / (2 * slots))
    older = types.SimpleNamespace(n_in=5, n_dtw=3)
    assert reader.read(Obs([older, None])) is None
    assert reader.read(Obs([])) is None


def test_ranges_are_no_user_annotations(db, series):
    """The spans are function-scope ranges: a user annotation would also
    stand on the device's timeline, from its first kernel to its last,
    and read as busy there."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ssh_search_batch(_queries(series), db.index, SearchConfig(**KNOBS))
    ours = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(timing.PREFIX)]
    assert len(ours) >= len(SPANS)
    assert not any(e.is_user_annotation() for e in ours)


@pytest.mark.parametrize("order", ["profiler starts inside",
                                   "profiler stops inside"])
def test_a_range_cut_by_the_profiler_closes_quietly(order):
    """A batcher may be inside a range when profiling starts or stops;
    the range closes without error either way."""
    prof = profile(activities=[ProfilerActivity.CPU])
    if order == "profiler stops inside":
        prof.__enter__()
    with timing.profiler_range("engine.wait"):
        if order == "profiler starts inside":
            prof.__enter__()
        else:
            prof.__exit__(None, None, None)
    with timing.profiler_range("engine.collect"):
        pass
    if order == "profiler starts inside":
        prof.__exit__(None, None, None)
        assert "engine.collect" in {e.name for e in prof.events()}


def test_the_fast_range_api_profiler_range_relies_on():
    """``profiler_range`` rests on torch's private ``_RecordFunctionFast``
    and on the error it raises when a profiler started inside the range:
    this fails when the installed torch changes either."""
    fast = torch._C._profiler._RecordFunctionFast
    rng = fast("engine.wait")
    rng.__enter__()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="no guard is set"):
            rng.__exit__(None, None, None)


@pytest.mark.parametrize("phase", ["wait", "collect", "serve", "resolve"])
def test_a_failing_range_fails_the_batch_not_the_batcher(
        db, series, monkeypatch, phase):
    """A batcher range that raises on closing fails that batch's open
    requests and leaves the worker serving the next ones."""
    from repro_torch.serving import engine as engine_mod
    fail = [True]

    @contextlib.contextmanager
    def flaky(name):
        yield
        if name == f"engine.{phase}" and fail[0]:
            fail[0] = False
            raise RuntimeError("range failed to close")
    monkeypatch.setattr(engine_mod, "profiler_range", flaky)
    engine = _engine(db, True)
    qs = _queries(series, 2)
    with engine:
        time.sleep(0.05)                   # the worker waits, idle
        first = engine.submit(qs[0])
        if phase == "wait":
            first.result(timeout=TIMEOUT)  # the failing wait held no batch
        elif phase == "resolve":
            assert first.result(timeout=TIMEOUT) is not None  # answered
        else:
            with pytest.raises(RuntimeError, match="failed to close"):
                first.result(timeout=TIMEOUT)
        assert not fail[0]
        assert engine.submit(qs[1]).result(timeout=TIMEOUT) is not None
