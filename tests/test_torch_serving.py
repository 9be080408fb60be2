"""The port's serving tier against the JAX package, on the CPU: the
``ServingEngine`` (answers, batching, inserts, shutdown), the
``BatchPolicy`` control law, ``ServingMetrics`` and the ``"engine"``
searcher behind the facade.

The JAX package builds the index (``backend="jnp"``) over ~1k
synthetic-ECG series of length 128; ``repro_torch.convert`` carries its
state across.  Ids, counters, batch histograms, policy floats and
metric snapshots must be equal; distances are held to the float64 DP
(the port at rtol 1e-6, the reference at 1e-4: ROADMAP.md §3).  Threaded
tests wait with ``result(timeout=...)`` and stop their engine in a
``with`` block; none depends on how fast this host runs.
"""
import itertools
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SSHIndex as JaxIndex
from repro.core import SSHParams
from repro.core.dtw import dtw_dp_reference
from repro.data.timeseries import extract_subsequences, synthetic_ecg
from repro.db import BatchPolicy as JaxBatchPolicy
from repro.db import SearchConfig as JaxSearchConfig
from repro.serving import ServingEngine as JaxEngine
from repro.serving import ServingMetrics as JaxMetrics
from repro.serving import metrics as jax_metrics
from repro_torch import convert
from repro_torch.db import BatchPolicy, SearchConfig, TimeSeriesDB
from repro_torch.encoders import IndexSpec
from repro_torch.serving import ServingEngine, ServingMetrics, engine as em
from repro_torch.serving import metrics as metrics_mod

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

PARAMS = SSHParams(window=24, step=3, ngram=8, num_hashes=40, num_tables=20)
QIDS = [3, 100, 250, 444, 512, 700, 801, 999]
KNOBS = dict(topk=10, top_c=128, band=8)
TIMEOUT = 120


@pytest.fixture(scope="module")
def db():
    stream = synthetic_ecg(4200, seed=5)
    return extract_subsequences(stream, 128, stride=4, znorm=True)


@pytest.fixture(scope="module")
def jax_index(db):
    return JaxIndex.build(jnp.asarray(db), spec=PARAMS.to_spec(),
                          backend="jnp")


def _carry(jax_index):
    """A fresh port index on the reference index's state."""
    ji = jax_index
    return convert.index_from_arrays(
        IndexSpec.from_dict(ji.enc.spec.to_dict()), ji.enc.arrays(),
        np.asarray(ji.signatures), np.asarray(ji.keys),
        np.asarray(ji.series), build_backend=ji.build_backend,
        device="cpu")


@pytest.fixture(scope="module")
def index(jax_index):
    return _carry(jax_index)


def _cfg(max_batch=4, max_wait_ms=2.0, mode="fixed", **kw):
    return SearchConfig(**{**KNOBS, **kw}, batch_policy=BatchPolicy(
        mode=mode, max_batch=max_batch, max_wait_ms=max_wait_ms))


def _jax_cfg(max_batch=4, max_wait_ms=2.0, mode="fixed", **kw):
    return JaxSearchConfig(backend="jnp", **{**KNOBS, **kw},
                           batch_policy=JaxBatchPolicy(
                               mode=mode, max_batch=max_batch,
                               max_wait_ms=max_wait_ms))


def _novel():
    x = np.sin(np.linspace(0, 17, 128)) ** 3
    return ((x - x.mean()) / x.std()).astype(np.float32)


# ---------------------------------------------------------------------------
# answers and batching against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(multiprobe_offsets=3),
                                dict(rank_by_signature=False),
                                dict(use_lb_cascade=False)])
def test_engine_search_batch_matches_jax(db, jax_index, index, kw):
    want = JaxEngine(jax_index, _jax_cfg(8, **kw)).search_batch(
        jnp.asarray(db[QIDS]))
    engine = ServingEngine(index, _cfg(8, **kw))
    got = engine.search_batch(db[QIDS])
    for qid, g, w in zip(QIDS, got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        assert g.ids[0] == qid
        assert g.n_candidates == w.n_candidates
        assert isinstance(g.ids, np.ndarray) and g.stats is None
        exact = [dtw_dp_reference(db[qid], db[i], KNOBS["band"])
                 for i in g.ids]
        np.testing.assert_allclose(g.dists, exact, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(w.dists), exact, rtol=1e-4)
    snap = engine.metrics.snapshot()
    assert snap["requests_total"] == len(QIDS) and snap["batches_total"] == 1
    assert snap["lb_pruned_frac_mean"] >= 0 and snap["index_bytes"] > 0


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_queue_filled_before_start_batches_as_jax(db, jax_index, index,
                                                  mode):
    """Seven requests queued before the worker starts: both engines form
    a full batch of 4 and a batch of 3 (padded to 4, the filler trimmed),
    with the same counters and answers."""
    qids = QIDS[:7]
    jeng = JaxEngine(jax_index, _jax_cfg(4, 20.0, mode, topk=5, top_c=64))
    jfuts = [jeng.submit(jnp.asarray(db[q])) for q in qids]
    with jeng:
        want = [f.result(timeout=TIMEOUT) for f in jfuts]
    engine = ServingEngine(index, _cfg(4, 20.0, mode, topk=5, top_c=64))
    futs = [engine.submit(db[q]) for q in qids]
    assert engine.queue_depth == len(qids)
    with engine:
        got = [f.result(timeout=TIMEOUT) for f in futs]
    assert engine.metrics.batch_histogram() == \
        jeng.metrics.batch_histogram() == {4: 1, 3: 1}
    snap, jsnap = engine.metrics.snapshot(), jeng.metrics.snapshot()
    for key in ("requests_total", "batches_total", "batch_size_mean",
                "batch_occupancy_mean", "queue_depth_max"):
        assert snap[key] == jsnap[key], key
    for qid, g, w in zip(qids, got, want):
        assert g.ids[0] == qid
        np.testing.assert_array_equal(g.ids, w.ids)
    assert engine.service_ewma_s > 0 and engine.arrival_gap_ewma_s >= 0


def test_collect_under_each_policy(db, index):
    """``_collect`` on a queue filled before any worker runs: a full
    queue closes the batch at ``max_batch`` (adaptive budget 0: step load
    runs at full occupancy), and a busy adaptive engine closes a short
    batch at ``min_wait``, far inside the fixed 10 s deadline; the stop
    sentinel stays queued."""
    def engine_with(mode, n, stop_at=None):
        eng = ServingEngine(index, _cfg(4, 10_000.0, mode))
        for i in range(n):
            eng._pending.append(em._Request(db[i], None, 0.0))
            if i == stop_at:
                eng._pending.append(eng._STOP)
        return eng

    eng = engine_with("adaptive", 9)
    first = eng._pending.popleft()
    assert [r.query is not None for r in eng._collect(first, False)] == \
        [True] * 4
    assert len(eng._pending) == 5
    eng = engine_with("adaptive", 2)
    first = eng._pending.popleft()
    t0 = time.perf_counter()
    assert len(eng._collect(first, opened_idle=False)) == 2
    assert time.perf_counter() - t0 < 5.0
    eng = engine_with("fixed", 5, stop_at=1)
    first = eng._pending.popleft()
    assert len(eng._collect(first)) == 2
    assert eng._pending[0] is eng._STOP and eng.queue_depth == 3


def test_pad_batch_repeats_the_first_query(db, index):
    eng = ServingEngine(index, _cfg(8))
    rows = [db[i] for i in (5, 6, 7)]
    block = eng._pad_batch(rows)
    assert block.shape == (4, 128) and block.dtype == np.float32
    np.testing.assert_array_equal(block[3], db[5])
    assert eng._pad_batch([db[1]]).shape == (1, 128)
    assert eng._pad_batch([db[i] for i in range(5)]).shape == (8, 128)


# ---------------------------------------------------------------------------
# engine behaviour
# ---------------------------------------------------------------------------

def test_engine_insert_visible_to_later_queries(jax_index):
    index = _carry(jax_index)
    engine = ServingEngine(index, _cfg(4, topk=3, top_c=64))
    n0 = int(index.signatures.shape[0])
    novel = _novel()
    with engine:
        engine.insert(novel)
        res = engine.search(novel, timeout=TIMEOUT)
    assert int(index.signatures.shape[0]) == n0 + 1
    assert res.ids[0] == n0 and res.n_database == n0 + 1
    assert res.dists[0] == pytest.approx(0.0, abs=1e-4)
    assert engine.metrics.snapshot()["inserts_total"] == 1


def test_engine_concurrent_submitters(db, index):
    engine = ServingEngine(index, _cfg(4, 5.0, topk=3, top_c=64))
    out = {}

    def client(qid):
        out[qid] = engine.search(db[qid], timeout=TIMEOUT)

    with engine:
        threads = [threading.Thread(target=client, args=(q,)) for q in QIDS]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
    assert {q: out[q].ids[0] for q in QIDS} == {q: q for q in QIDS}
    assert engine.metrics.snapshot()["requests_total"] == len(QIDS)


def test_engine_survives_failing_insert(db, jax_index):
    engine = ServingEngine(_carry(jax_index), _cfg(2, topk=3, top_c=64))

    class Boom(RuntimeError):
        pass

    real_insert = engine.searcher.insert
    engine.searcher.insert = lambda s: (_ for _ in ()).throw(Boom("nope"))
    with engine:
        engine.insert(db[0])
        with pytest.raises(Boom):
            engine.search(db[QIDS[0]], timeout=TIMEOUT)
        engine.searcher.insert = real_insert
        res = engine.search(db[QIDS[1]], timeout=TIMEOUT)
    assert res.ids[0] == QIDS[1]


def test_batch_exception_reaches_every_future(db, index):
    """A failing batch resolves each of its futures with the exception;
    the worker goes on to the next batch."""
    engine = ServingEngine(index, _cfg(4, 20.0, topk=3, top_c=64))
    real = engine.searcher.search_batch
    engine.searcher.search_batch = lambda q: (_ for _ in ()).throw(
        ValueError("card lost"))
    futs = [engine.submit(db[q]) for q in QIDS[:3]]
    with engine:
        for f in futs:
            with pytest.raises(ValueError, match="card lost"):
                f.result(timeout=TIMEOUT)
        engine.searcher.search_batch = real
        assert engine.search(db[QIDS[3]], timeout=TIMEOUT).ids[0] == QIDS[3]


def test_submit_after_stop_and_straggler_drain(db, index):
    cfg = _cfg(4, topk=3, top_c=64)
    engine = ServingEngine(index, cfg)
    engine.start()
    engine.stop()
    fut = engine.submit(db[QIDS[0]])             # served on this thread
    assert fut.done() and fut.result().ids[0] == QIDS[0]
    engine2 = ServingEngine(index, cfg)
    futs = [engine2.submit(db[q]) for q in QIDS[:3]]
    engine2.start()
    engine2.stop()
    assert all(f.done() for f in futs)
    assert [f.result(timeout=TIMEOUT).ids[0] for f in futs] == QIDS[:3]
    assert engine2.search(db[QIDS[4]]).ids[0] == QIDS[4]


def test_engine_filler_rows_trimmed(db, index):
    """Fewer survivors than topk give short results, and a padded batch
    returns one result a real request."""
    engine = ServingEngine(index, _cfg(8, topk=10, top_c=16))
    res = engine.search_batch(db[QIDS[:3]])
    assert len(res) == 3
    for r in res:
        assert np.all(r.ids >= 0) and len(r.ids) == len(r.dists) <= 10
    futs = [engine.submit(db[q]) for q in QIDS[:3]]
    with engine:
        got = [f.result(timeout=TIMEOUT) for f in futs]
    assert engine.metrics.batch_histogram() == {3: 2}
    for g, r in zip(got, res):
        np.testing.assert_array_equal(g.ids, r.ids)
        np.testing.assert_array_equal(g.dists, r.dists)


def test_engine_config_is_retired_and_fleet_calls_raise(index):
    with pytest.raises(TypeError, match="SearchConfig"):
        em.EngineConfig(max_batch=4)
    engine = ServingEngine(index, _cfg())
    with pytest.raises(AttributeError, match="drain"):
        engine.drain("w0")
    with pytest.raises(AttributeError, match="resize"):
        engine.resize(2)
    from repro_torch.fleet import FleetSearcher
    fleet = ServingEngine(index, _cfg(replication=2)).searcher
    try:
        assert isinstance(fleet, FleetSearcher) and fleet.replication == 2
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# the policy and the metrics, number for number
# ---------------------------------------------------------------------------

POLICIES = [dict(mode="fixed"),
            dict(mode="adaptive"),
            dict(mode="adaptive", max_batch=16, max_wait_ms=8.0,
                 min_wait_ms=0.2, gain=0.8, ewma_alpha=0.5)]


@pytest.mark.parametrize("pol", POLICIES)
def test_wait_budget_equals_reference(pol):
    port, ref = BatchPolicy(**pol).validate(), JaxBatchPolicy(**pol)
    grid = itertools.product(range(1, port.max_batch + 1), range(0, 18, 3),
                             (None, 1e-4, 3.3e-3, 0.05, 2.0),
                             (True, False), (None, 1e-6, 7e-4, 0.02))
    n = 0
    for have, depth, s, idle, gap in grid:
        got = port.wait_budget_s(have, depth, s, engine_idle=idle,
                                 arrival_gap_s=gap)
        want = ref.wait_budget_s(have, depth, s, engine_idle=idle,
                                 arrival_gap_s=gap)
        assert type(got) is type(want) and got == want, \
            (have, depth, s, idle, gap)
        n += 1
    assert n > 500
    if port.mode == "adaptive":                  # the claims it encodes
        assert port.wait_budget_s(1, port.max_batch, 0.01) == 0.0
        light = port.wait_budget_s(1, 0, 0.001)
        assert port.min_wait_ms / 1e3 <= light < port.max_wait_ms / 1e3
        assert port.wait_budget_s(1, 0, 0.5, engine_idle=False) == \
            port.min_wait_ms / 1e3


def test_buckets_and_replace_equal_reference():
    for mb in range(1, 40):
        assert BatchPolicy(max_batch=mb).buckets() == \
            JaxBatchPolicy(max_batch=mb).buckets()
        assert SearchConfig(batch_policy=BatchPolicy(max_batch=mb)) \
            .buckets() == JaxSearchConfig(batch_policy=JaxBatchPolicy(
                max_batch=mb)).buckets()
    assert BatchPolicy().replace(mode="adaptive").to_dict() == \
        JaxBatchPolicy().replace(mode="adaptive").to_dict()
    for bad in (dict(max_batch=0), dict(mode="eager"), dict(gain=0.0)):
        with pytest.raises(ValueError):
            BatchPolicy().replace(**bad)
        with pytest.raises(ValueError):
            JaxBatchPolicy().replace(**bad)
    cfg = SearchConfig(searcher="engine", batch_policy=BatchPolicy(
        mode="adaptive", max_batch=16)).validate()
    assert cfg.buckets() == [1, 2, 4, 8, 16]
    assert cfg.validate() is cfg


def _feed(m, clock):
    clock[0] = 100.0
    m.on_start()
    for i, depth in enumerate((1, 3, 2, 6, 4)):
        clock[0] += 0.25
        m.on_enqueue(depth)
    m.on_batch(4, [0.010, 0.020, 0.030, 0.045], [0.001] * 4,
               [0.9] * 4, [0.95, 0.96, 0.97, 0.98], depth_after=2,
               lb_pruned_frac=[0.5], dtw_abandoned_frac=[0.25],
               stage_seconds={"encode": 0.002, "probe": 0.004, "lb": 0.001,
                              "lb_improved": 0.003, "dtw": 0.0015,
                              "not_a_stage": 9.0},
               sig_cache_hits=2, batch_wait_s=0.002, batch_occupancy=0.5)
    clock[0] += 0.5
    m.on_batch(2, [0.05, 0.07], [0.002, 0.003], [0.8, 0.85], [0.9, 0.91],
               depth_after=0, stage_seconds={"encode": 0.001},
               batch_wait_s=0.004, batch_occupancy=0.25)
    clock[0] += 0.25
    m.on_batch(8, [0.2] * 8, [0.1] * 8, [0.7] * 8, [0.8] * 8,
               depth_after=5)
    m.on_insert(3)
    m.on_rebalance(2)
    m.set_index_bytes(123456)
    clock[0] = 104.0


def test_metrics_snapshot_equals_reference(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    assert metrics_mod.time is time and jax_metrics.time is time
    port, ref = ServingMetrics(), JaxMetrics()
    _feed(port, clock)
    _feed(ref, clock)
    got, want = port.snapshot(), ref.snapshot()
    # the port's batcher phases, last in its snapshot; ``_feed`` records
    # none, as the reference has none
    phases = {k: got.pop(k) for k in ("queued_ms_mean", "collect_ms_mean",
                                      "service_ms_mean")}
    assert phases == dict.fromkeys(phases, 0.0)
    assert list(got) == list(want)
    assert got == want
    assert port.format() == ref.format()
    assert port.batch_histogram() == ref.batch_histogram() == \
        {4: 1, 2: 1, 8: 1}
    assert got["throughput_qps"] == 14 / 4.0
    assert metrics_mod.STAGE_KEYS == jax_metrics.STAGE_KEYS


def test_trackers_equal_reference():
    rng = np.random.default_rng(4)
    xs = rng.exponential(0.01, size=300)
    port, ref = metrics_mod.LatencyTracker(128), \
        jax_metrics.LatencyTracker(128)
    for x in xs:
        port.record(x)
        ref.record(x)
    assert len(port) == len(ref) == 128
    for p in (0, 1, 50, 95, 99, 99.9, 100):
        assert port.percentile(p) == ref.percentile(p)
    assert metrics_mod.LatencyTracker().percentile(50) == 0.0
    tp = metrics_mod.ThroughputTracker(window_seconds=2.0)
    tr = jax_metrics.ThroughputTracker(window_seconds=2.0)
    for t in (tp, tr):
        t.restart_clock(now=10.0)
        for k, now in enumerate((10.1, 10.5, 11.0, 12.4, 13.0)):
            t.record(k + 1, now=now)
    for now in (13.0, 14.0, 20.0):
        assert tp.rate(now=now) == tr.rate(now=now)
    rm, rr = metrics_mod.RunningMean(), jax_metrics.RunningMean()
    for x in xs[:17]:
        rm.record(x)
        rr.record(x)
    assert (rm.n, rm.mean) == (rr.n, rr.mean)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

def test_facade_engine_searcher(db, jax_index, tmp_path):
    index = _carry(jax_index)
    n0 = int(index.signatures.shape[0])
    tsdb = TimeSeriesDB(index, _cfg(4, searcher="engine", topk=5, top_c=64))
    with tsdb:
        assert tsdb.search(db[QIDS[0]]).ids[0] == QIDS[0]
        assert [r.ids[0] for r in tsdb.search_batch(db[QIDS[:3]])] == \
            QIDS[:3]
        futs = [tsdb.submit(db[q]) for q in QIDS[3:]]
        assert [f.result(timeout=TIMEOUT).ids[0] for f in futs] == QIDS[3:]
        assert isinstance(tsdb.engine, ServingEngine)
        assert tsdb.engine._state == "running"
        tsdb.add(_novel())                         # queued for the worker
        tsdb.save(tmp_path / "db")                 # holds the series
        tsdb.add_stream(db[:2] + np.float32(0.5))
        tsdb.flush()
        assert len(tsdb) == n0 + 3
        snap = tsdb.engine.metrics.snapshot()
    assert tsdb._searcher is None
    assert snap["requests_total"] == 1 + len(QIDS)     # search, 3, 5
    assert snap["inserts_total"] == 1
    loaded = TimeSeriesDB.load(tmp_path / "db", device="cpu")
    assert len(loaded) == n0 + 1 and loaded.config.searcher == "engine"
    with loaded:
        res = loaded.search(_novel())
    assert res.ids[0] == n0 and res.n_database == n0 + 1
    with pytest.raises(AttributeError, match="searcher='engine'"):
        TimeSeriesDB(index, SearchConfig(**KNOBS)).engine
    with pytest.raises(AttributeError, match="searcher='engine'"):
        TimeSeriesDB(index, SearchConfig(searcher="local", **KNOBS)).engine


def test_serve_launcher_engine_mode_on_the_cpu(capsys):
    """``launch.serve --arch ssh-ecg`` serves through the engine by
    default: every request finds itself and the metrics line prints."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", "ssh-ecg", "--requests", "6",
                       "--batch-size", "4", "--wait-ms", "20",
                       "--batch-mode", "adaptive", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    reqs = [line for line in out if line.startswith("req ")]
    assert len(reqs) == 6
    for line in reqs:
        qid, top1 = line.split(":")[0].split()[1], \
            line.split("top1=")[1].split()[0]
        assert qid == top1, line
    assert any(line.startswith("engine: req=6 ") for line in out)


def test_bench_schema_round_trips_with_the_reference(tmp_path):
    """A report dumped by either package's schema loads in the other."""
    from repro.bench import schema as jax_schema
    from repro_torch.bench import schema
    assert schema.STAGE_KEYS == jax_schema.STAGE_KEYS
    case = schema.BenchCase(dataset="ecg", length=512, n_database=1 << 20,
                            batch=8, config=SearchConfig().to_dict(),
                            backend="cuda")
    rows = [schema.BenchResult(
        name="engine/fixed/0.5", us_per_query=15114.0, us_p50=15114.0,
        us_p95=21525.0, stage_us={"encode": 2610.8, "probe": 798.2,
                                  "lb": 1641.3, "lb_improved": 1516.1,
                                  "dtw": 887.7}, case=case,
        derived={"offered_qps": 472.9})]
    report = schema.BenchReport(name="engine", scale="small", git_sha="",
                                results=rows)
    path = schema.dump_report(report, tmp_path / "BENCH_engine.json")
    loaded = jax_schema.load_report(path)
    assert loaded.to_dict() == report.to_dict()
    assert schema.has_full_stage_breakdown(report.to_dict())
    back = schema.load_report(jax_schema.dump_report(
        loaded, tmp_path / "again.json"))
    assert back.to_dict() == report.to_dict()
    assert back.result("engine/fixed/0.5").case == case


@pytest.mark.parametrize("bad", [
    dict(schema_version=2), dict(scale="huge"), dict(results=[]),
    dict(results=[{"name": "a", "us_per_query": -1.0}]),
    dict(results=[{"name": "a", "us_per_query": 1.0,
                   "stage_us": {"warp": 1.0}}]),
    dict(results=[{"name": "a", "us_per_query": 1.0},
                  {"name": "a", "us_per_query": 2.0}])])
def test_bench_schema_errors_match_reference(bad):
    from repro.bench import schema as jax_schema
    from repro_torch.bench import schema
    doc = {"schema_version": 1, "name": "x", "scale": "smoke",
           "git_sha": "", "results": [{"name": "a", "us_per_query": 1.0}],
           **bad}
    with pytest.raises(schema.SchemaError) as got:
        schema.validate_report(doc)
    with pytest.raises(jax_schema.SchemaError) as want:
        jax_schema.validate_report(doc)
    assert str(got.value) == str(want.value)
