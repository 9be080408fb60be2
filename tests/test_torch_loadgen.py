"""The port's load generator against the JAX package, on the CPU: the
arrival processes and the lowered traces bit for bit, the validation
errors message for message, and the open-loop harness through the
port's engine (fixed and adaptive batching answer one trace alike).

Replays run at low rates and judge answers and bookkeeping only: no
assertion depends on how fast this host serves.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.loadgen import arrivals as jax_arrivals
from repro.loadgen import harness as jax_harness
from repro.loadgen import workload as jax_workload
from repro_torch.core.index import SSHIndex
from repro_torch.data.timeseries import extract_subsequences, synthetic_ecg
from repro_torch.db import BatchPolicy, SearchConfig
from repro_torch.encoders import IndexSpec
from repro_torch.loadgen import (ARRIVAL_PROCESSES, LoadResult, Mixture,
                                 WorkloadSpec, diurnal_arrivals,
                                 generate_trace, make_arrivals,
                                 mmpp_arrivals, poisson_arrivals, run_trace,
                                 sweep)
from repro_torch.loadgen import arrivals, harness, workload
from repro_torch.serving import ServingEngine, ssh_search_batch

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

SPEC = IndexSpec(encoder="ssh", params=dict(
    window=24, step=3, ngram=8, num_hashes=40, num_tables=20))
TIMEOUT = 120


@pytest.fixture(scope="module")
def db():
    stream = synthetic_ecg(2500, seed=5)
    return extract_subsequences(stream, 128, stride=4, znorm=True)


@pytest.fixture(scope="module")
def index(db):
    return SSHIndex.build(db, SPEC, device="cpu")


def _engine(index, mode, max_batch=8, max_wait_ms=4.0):
    pol = BatchPolicy(mode=mode, max_batch=max_batch, max_wait_ms=max_wait_ms)
    return ServingEngine(index, SearchConfig(topk=5, top_c=64, band=8,
                                             batch_policy=pol))


def _raises_alike(port_call, ref_call):
    """Both calls raise ValueError with the same message."""
    with pytest.raises(ValueError) as got:
        port_call()
    with pytest.raises(ValueError) as want:
        ref_call()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# arrivals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("process", ["poisson", "mmpp", "diurnal"])
@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_arrivals_equal_reference(process, seed):
    got = make_arrivals(process, 80.0, 1500, seed=seed)
    want = jax_arrivals.make_arrivals(process, 80.0, 1500, seed=seed)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got) >= 0)
    assert 60.0 < 1500 / got[-1] < 110.0


def test_arrival_shape_knobs_equal_reference():
    np.testing.assert_array_equal(
        mmpp_arrivals(40.0, 700, seed=3, burst_factor=8.0, dwell_s=0.1),
        jax_arrivals.mmpp_arrivals(40.0, 700, seed=3, burst_factor=8.0,
                                   dwell_s=0.1))
    np.testing.assert_array_equal(
        diurnal_arrivals(40.0, 700, seed=3, period_s=5.0, depth=0.3),
        jax_arrivals.diurnal_arrivals(40.0, 700, seed=3, period_s=5.0,
                                      depth=0.3))
    np.testing.assert_array_equal(poisson_arrivals(1e4, 1, seed=9),
                                  jax_arrivals.poisson_arrivals(1e4, 1,
                                                                seed=9))
    assert sorted(ARRIVAL_PROCESSES) == sorted(jax_arrivals.ARRIVAL_PROCESSES)
    gaps_p = np.diff(poisson_arrivals(100.0, 4000, seed=3))
    gaps_m = np.diff(mmpp_arrivals(100.0, 4000, seed=3, burst_factor=8.0))
    assert np.std(gaps_m) / np.mean(gaps_m) > np.std(gaps_p) / np.mean(gaps_p)


@pytest.mark.parametrize("call", [
    ("poisson_arrivals", (0.0, 10), {}),
    ("poisson_arrivals", (5.0, 0), {}),
    ("mmpp_arrivals", (5.0, 10), dict(burst_factor=0.5)),
    ("diurnal_arrivals", (5.0, 10), dict(depth=1.0)),
    ("make_arrivals", ("tidal", 50.0, 10), {}),
])
def test_arrival_errors_match_reference(call):
    name, args, kw = call
    _raises_alike(lambda: getattr(arrivals, name)(*args, **kw),
                  lambda: getattr(jax_arrivals, name)(*args, **kw))


# ---------------------------------------------------------------------------
# workload -> trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_kw", [
    dict(process="poisson", rate_qps=50.0, n_requests=300, seed=1),
    dict(process="mmpp", rate_qps=50.0, n_requests=500, seed=3,
         topks=((5, 10), (0.5, 0.5))),
    dict(process="diurnal", rate_qps=20.0, n_requests=200, seed=11,
         lengths=((128, 256), (0.25, 0.75)), topks=((1, 3, 10), ()),
         period_s=4.0, depth=0.5),
])
def test_generate_trace_equals_reference(spec_kw):
    def mk(mod):
        kw = dict(spec_kw)
        for k in ("lengths", "topks"):
            if k in kw:
                kw[k] = mod.Mixture(*kw[k])
        return mod.WorkloadSpec(**kw)

    pools = {128: 321, 256: 77}
    got = generate_trace(mk(workload), pools)
    want = jax_workload.generate_trace(mk(jax_workload), pools)
    for f in ("arrivals_s", "lengths", "topks", "pool_ids"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(got) == spec_kw["n_requests"]
    assert got.duration_s == want.duration_s
    assert got.spec.to_dict() == want.spec.to_dict()
    assert got.pool_ids.min() >= 0
    assert np.all(got.pool_ids < np.where(got.lengths == 128, 321, 77))


@pytest.mark.parametrize("bad", [
    dict(process="tidal"), dict(rate_qps=0), dict(n_requests=0),
    dict(lengths=((128,), (0.5, 0.5))), dict(topks=((0,), ())),
    dict(lengths=((), ())), dict(topks=((5,), (-1.0,))),
])
def test_workload_errors_match_reference(bad):
    def mk(mod):
        kw = {k: (mod.Mixture(*v) if k in ("lengths", "topks") else v)
              for k, v in bad.items()}
        return mod.WorkloadSpec(**kw)

    _raises_alike(lambda: mk(workload).validate(),
                  lambda: mk(jax_workload).validate())


def test_missing_pools_and_mixture_forms_match_reference():
    _raises_alike(
        lambda: generate_trace(WorkloadSpec(lengths=Mixture((64,))),
                               {128: 10}),
        lambda: jax_workload.generate_trace(
            jax_workload.WorkloadSpec(lengths=jax_workload.Mixture((64,))),
            {128: 10}))
    m = Mixture((5, 10, 20), (1.0, 2.0, 1.0))
    jm = jax_workload.Mixture((5, 10, 20), (1.0, 2.0, 1.0))
    assert m.to_dict() == jm.to_dict()
    assert Mixture.from_dict(m.to_dict()) == m
    np.testing.assert_array_equal(m.probabilities(), jm.probabilities())
    np.testing.assert_array_equal(
        m.sample(np.random.default_rng(2), 50),
        jm.sample(np.random.default_rng(2), 50))
    spec = WorkloadSpec(process="mmpp", burst_factor=6.0)
    assert spec.replace(rate_qps=3.0).to_dict() == \
        jax_workload.WorkloadSpec(process="mmpp", burst_factor=6.0) \
        .replace(rate_qps=3.0).to_dict()


# ---------------------------------------------------------------------------
# the harness through the port's engine
# ---------------------------------------------------------------------------

def _warm(engine, db):
    for s in engine.config.buckets():
        engine.searcher.search_batch(db[:s])


def test_fixed_and_adaptive_answer_one_trace_alike(db, index):
    """One trace through a fixed and an adaptive engine: bit-identical
    per-request ids and distances, equal to ``ssh_search_batch`` on the
    requested rows as one block, each prefix of the engine's top-5."""
    spec = WorkloadSpec(rate_qps=100.0, n_requests=24, seed=11,
                        topks=Mixture((3, 5), (0.5, 0.5)))
    trace = generate_trace(spec, {128: len(db)})
    results = {}
    for mode in ("fixed", "adaptive"):
        engine = _engine(index, mode)
        with engine:
            _warm(engine, db)
            results[mode] = run_trace(engine, trace, {128: db},
                                      timeout_s=TIMEOUT)
    fixed, adaptive = results["fixed"], results["adaptive"]
    assert fixed.same_answers(adaptive)
    block = ssh_search_batch(db[trace.pool_ids], index,
                             config=_engine(index, "fixed").config)
    for k, (ids, dists) in enumerate(zip(fixed.ids, fixed.dists)):
        topk = int(trace.topks[k])
        assert len(ids) == topk
        np.testing.assert_array_equal(ids, block.ids[k][:topk])
        np.testing.assert_array_equal(dists, block.dists[k][:topk])
        assert ids[0] == trace.pool_ids[k]
    for res in results.values():
        assert res.n_requests == 24 and res.offered_qps == 100.0
        assert res.latency_p99_ms >= res.latency_p95_ms >= \
            res.latency_p50_ms > 0
        assert sum(k * v for k, v in res.batch_histogram.items()) == 24
        assert res.achieved_qps > 0 and res.wall_s > 0
        assert set(res.stage_us) == {"encode", "probe", "lb",
                                     "lb_improved", "dtw"}
    row = fixed.to_row()
    assert "ids" not in row and set(row["batch_histogram"]) == \
        {str(k) for k in fixed.batch_histogram}


def test_run_trace_refuses_missing_pools(index):
    trace = generate_trace(WorkloadSpec(n_requests=3, lengths=Mixture(
        (128, 64))), {128: 5, 64: 5})
    engine = _engine(index, "fixed")
    with pytest.raises(ValueError, match="pools for lengths"):
        run_trace(engine, trace, {128: np.zeros((5, 128), np.float32)})


def test_load_result_bookkeeping_matches_reference():
    kw = dict(offered_qps=10.0, achieved_qps=9.5, n_requests=2, wall_s=0.2,
              latency_p50_ms=1.0, latency_p95_ms=2.0, latency_p99_ms=3.0,
              queue_depth_p50=0.0, queue_depth_p95=1.0, queue_depth_max=2.0,
              batch_size_mean=1.5, batch_wait_ms_mean=0.5,
              batch_occupancy_mean=0.2, batch_histogram={2: 1, 1: 1},
              stage_us={"encode": 3.0},
              ids=[np.array([1, 2]), np.array([3])],
              dists=[np.array([0.0, 1.0], np.float32),
                     np.array([2.0], np.float32)])
    port, ref = LoadResult(**kw), jax_harness.LoadResult(**kw)
    assert port.to_row() == ref.to_row()
    other = dataclasses.replace(port, dists=[kw["dists"][0],
                                             np.array([2.5], np.float32)])
    assert port.same_answers(port) and not port.same_answers(other)
    assert not port.same_answers(dataclasses.replace(port, ids=kw["ids"][:1]))
    assert harness.SUSTAINED_FRAC == jax_harness.SUSTAINED_FRAC
    for xs in ([], [3.0], [5.0, 1.0, 2.0, 9.0, 4.0]):
        for p in (0, 50, 95, 99, 100):
            assert harness._percentile(xs, p) == jax_harness._percentile(xs,
                                                                        p)


def test_sweep_applies_the_sustainable_rule(db, index):
    """``sweep`` replays each load on a fresh engine; its
    ``max_sustainable_qps`` is the largest offered load meeting both the
    SLO and ``SUSTAINED_FRAC``, whatever the host's speed."""
    made = []

    def factory():
        made.append(_engine(index, "fixed"))
        return made[-1]

    spec = WorkloadSpec(n_requests=6, seed=4)
    for slo in (1e9, 0.0):
        results, best = sweep(factory, spec, [20.0, 40.0], {128: db},
                              slo_p99_ms=slo, timeout_s=TIMEOUT)
        assert [r.offered_qps for r in results] == [20.0, 40.0]
        ok = [r.offered_qps for r in results
              if r.latency_p99_ms <= slo
              and r.achieved_qps >= harness.SUSTAINED_FRAC * r.offered_qps]
        assert best == max(ok, default=0.0)
        assert all(r.n_requests == 6 for r in results)
    assert slo == 0.0 and best == 0.0
    assert len(made) == 4 and all(e._state == "stopped" for e in made)
