"""The port's fleet tier against the JAX package, on the CPU: placement
(the reference's invariants, its plans slot for slot where they stay
balanced, and the rebalance after ``fail()``), ``ShardPlan`` and
``StragglerPolicy``, the fault injector, shard transfer across the two
packages, and ``FleetSearcher`` — answers against the reference's fleet,
chaos, failover, hedging, live drain and resize, the engine's fleet
route, its metrics and the registry.

The reference's fleet fixture: ~500 z-normalised synthetic-ECG windows
of 128, K 40, L 20; topk 5, top_c 64, band 8, R = 2, W = 4.  The JAX
package builds the index (``backend="jnp"``) and
``repro_torch.convert`` carries it across.  Ids must be equal; distances
are held to the float64 DP (the port at rtol 1e-6, the reference at
1e-4: ROADMAP.md §3).  Whatever the fleet survives, its ids and
distances stay bit-identical to its healthy run.  Threaded waits have
timeouts.
"""
import math
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
from repro.db import SearchConfig as JaxSearchConfig
from repro.distributed import fault_tolerance as jax_ft
from repro.fleet import FaultInjector as JaxInjector
from repro.fleet import FleetSearcher as JaxFleet
from repro.fleet import ResponseDropped as JaxDropped
from repro.fleet import ReplicatedShardPlan as JaxPlan
from repro.fleet import WorkerKilled as JaxKilled
from repro.fleet import fetch_shard as jax_fetch
from repro.fleet import publish_shard as jax_publish
from repro_torch import convert
from repro_torch.db import BatchPolicy, SearchConfig
from repro_torch.db.registry import make_searcher
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.encoders import IndexSpec
from repro_torch.fleet import (FaultInjector, FleetSearcher,
                               ReplicatedShardPlan, ResponseDropped,
                               WorkerKilled, fetch_shard, publish_shard)
from repro_torch.kernels import ops
from repro_torch.serving import ServingEngine

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

PARAMS = SSHParams(window=24, step=3, ngram=8, num_hashes=40, num_tables=20)
KNOBS = dict(topk=5, top_c=64, band=8)
QIDS = [3, 100, 250, 444]
TIMEOUT = 120


@pytest.fixture(scope="module")
def db():
    stream = synthetic_ecg(2200, seed=5)
    return extract_subsequences(stream, 128, stride=4, znorm=True)


@pytest.fixture(scope="module")
def jax_index(db):
    return JaxIndex.build(jnp.asarray(db), spec=PARAMS.to_spec(),
                          backend="jnp")


@pytest.fixture(scope="module")
def index(jax_index):
    ji = jax_index
    return convert.index_from_arrays(
        IndexSpec.from_dict(ji.enc.spec.to_dict()), ji.enc.arrays(),
        np.asarray(ji.signatures), np.asarray(ji.keys),
        np.asarray(ji.series), build_backend=ji.build_backend,
        device="cpu")


def _cfg(**kw):
    return SearchConfig(**{**KNOBS, "replication": 2, "fleet_workers": 4,
                           **kw}).validate()


def make_fleet(index, **kw):
    return FleetSearcher(index, _cfg(**kw))


def _run(fleet, queries):
    res = fleet.search_batch(queries)
    return res.ids, res.dists, res.stats


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _assert_invariants(plan):
    for s in range(plan.n_shards):
        ws = plan.replicas(s)
        assert len(ws) == plan.replication          # exactly R replicas
        assert len(set(ws)) == len(ws)              # never co-located
        assert all(w in plan.workers for w in ws)   # all live
    loads = list(plan.loads().values())
    assert max(loads) - min(loads) <= 1             # balanced within 1


def _names(w):
    return [f"w{i}" for i in range(w)]


def test_placement_equals_reference_where_it_stays_balanced():
    """Every plan with 1-24 shards, 2-6 workers, R < W and each dead
    worker: the deal and ``resize`` equal the reference's slot for slot;
    after ``fail`` the port's plan equals the reference's wherever the
    reference's stays balanced, and is balanced everywhere."""
    rebalanced = 0
    for n in range(1, 25):
        for w in range(2, 7):
            for r in range(1, w):
                for dead in _names(w):
                    ref = JaxPlan(n, _names(w), replication=r)
                    got = ReplicatedShardPlan(n, _names(w), replication=r)
                    assert got.assignment == ref.assignment
                    ref_moved, moved = ref.fail(dead), got.fail(dead)
                    _assert_invariants(got)
                    loads = list(ref.loads().values())
                    if max(loads) - min(loads) <= 1:
                        assert got.assignment == ref.assignment
                        assert moved == ref_moved
                    else:
                        rebalanced += 1
                        assert moved[:len(ref_moved)] == ref_moved
                    twin = JaxPlan(n, list(got.workers), replication=r,
                                   assignment={s: list(ws) for s, ws in
                                               got.assignment.items()})
                    grown = got.workers + ["x0", "x1"]
                    assert got.resize(grown) == twin.resize(grown)
                    assert got.assignment == twin.assignment
    assert rebalanced > 0


@pytest.mark.parametrize("n_shards,n_workers,repl,dead,ref_loads", [
    (15, 6, 3, "w1", [8, 8, 10, 10, 9]),
    (3, 6, 3, "w3", [3, 2, 2, 1, 1])])
def test_fail_rebalances_the_reference_failing_examples(
        n_shards, n_workers, repl, dead, ref_loads):
    """The reference leaves these plans unbalanced after ``fail``; the
    port's ``fail`` runs the balance pass that ``resize`` runs."""
    ref = JaxPlan(n_shards, _names(n_workers), replication=repl)
    ref.fail(dead)
    assert list(ref.loads().values()) == ref_loads
    plan = ReplicatedShardPlan(n_shards, _names(n_workers),
                               replication=repl)
    before = {s: set(plan.replicas(s)) for s in range(n_shards)}
    moved = plan.fail(dead)
    _assert_invariants(plan)
    assert sorted(plan.assignment) == list(range(n_shards))
    assert sum(plan.loads().values()) == n_shards * repl
    for s, new in moved:
        assert new != dead
    for s in range(n_shards):              # every replica lost is re-placed
        assert len(before[s] - {dead} - set(plan.replicas(s))) <= \
            sum(1 for t, _ in moved if t == s)


def test_placement_invariants_property():
    """Random fail / grow / shrink trajectories keep the invariants
    (hypothesis), the reference's failing examples among the draws."""
    from hypothesis import example, given, settings
    from hypothesis import strategies as st

    @settings(max_examples=80, deadline=None)
    @given(st.integers(1, 24), st.integers(1, 8), st.integers(1, 4),
           st.randoms(use_true_random=False))
    @example(15, 6, 3, None)
    @example(3, 6, 3, None)
    def prop(n_shards, n_workers, repl, rng):
        repl = min(repl, n_workers)
        plan = ReplicatedShardPlan(n_shards, _names(n_workers),
                                   replication=repl)
        _assert_invariants(plan)
        if rng is None:                    # the explicit examples
            for dead in list(plan.workers):
                again = ReplicatedShardPlan(n_shards, _names(n_workers),
                                            replication=repl)
                again.fail(dead)
                _assert_invariants(again)
            return
        for _ in range(3):
            op = rng.choice(["fail", "grow", "shrink"])
            if op == "fail" and len(plan.workers) > repl:
                plan.fail(rng.choice(plan.workers))
            elif op == "grow":
                plan.resize(plan.workers + [f"x{rng.randrange(10**6)}"])
            elif op == "shrink" and len(plan.workers) > repl:
                plan.resize(plan.workers[:-1])
            _assert_invariants(plan)
            assert sorted(plan.assignment) == list(range(n_shards))

    prop()


def test_placement_refusals_and_minimal_moves():
    for bad in (3, 0):
        for cls in (ReplicatedShardPlan, JaxPlan):
            with pytest.raises(ValueError, match="replication"):
                cls(4, ["w0", "w1"], replication=bad)
    plan = ReplicatedShardPlan(10, ["w0", "w1", "w2"], replication=2)
    before = {s: set(plan.replicas(s)) for s in range(10)}
    plan.fail("w1")
    _assert_invariants(plan)
    for s in range(10):
        assert before[s] - {"w1"} <= set(plan.replicas(s))
    snap = {s: list(plan.replicas(s)) for s in range(10)}
    with pytest.raises(RuntimeError, match="replication"):
        plan.fail(plan.workers[0])           # 1 worker < R = 2: refused
    assert {s: list(plan.replicas(s)) for s in range(10)} == snap
    plan = ReplicatedShardPlan(12, ["w0", "w1", "w2"], replication=2)
    before = {s: set(plan.replicas(s)) for s in range(12)}
    moved = plan.resize(["w0", "w1", "w2", "w3"])
    _assert_invariants(plan)
    assert 0 < len(moved) <= math.ceil(12 * 2 / 4)
    touched = {s for s, _ in moved}
    for s in range(12):
        if s not in touched:
            assert set(plan.replicas(s)) == before[s]


# ---------------------------------------------------------------------------
# ShardPlan, StragglerPolicy, the injector
# ---------------------------------------------------------------------------

def test_shard_plan_and_straggler_policy_match_reference():
    for n, workers in ((10, ["a", "b", "c"]), (7, ["w3", "w1", "w0", "w2"])):
        ours, ref = ft.ShardPlan(n, list(workers)), \
            jax_ft.ShardPlan(n, list(workers))
        assert ours.assignment == ref.assignment
        assert ours.fail(workers[1]) == ref.fail(workers[1])
        assert ours.assignment == ref.assignment
        grown = ours.workers + ["z"]
        assert ours.resize(grown) == ref.resize(grown)
        assert ours.assignment == ref.assignment
        assert ours.shards_of("z") == ref.shards_of("z")
    ours, ref = ft.StragglerPolicy(), jax_ft.StragglerPolicy()
    rng = np.random.default_rng(0)
    for step in range(40):
        for w in ("w0", "w1", "w2", "w3"):
            t = float(rng.uniform(0.01, 0.02)) * (4 if w == "w2" and
                                                  step > 10 else 1)
            ours.observe(w, t)
            ref.observe(w, t)
            if step % 3:
                ours.step(w)
                ref.step(w)
            else:
                assert ours.check(w) == ref.check(w)
        assert ours.ewma == ref.ewma and ours.strikes == ref.strikes
        assert ours.median() == ref.median()
        assert ours.stragglers() == ref.stragglers()
    assert ours.stragglers() == ["w2"]


def test_injector_kill_delay_drop_as_reference():
    for inj, killed, dropped in ((FaultInjector(), WorkerKilled,
                                  ResponseDropped),
                                 (JaxInjector(), JaxKilled, JaxDropped)):
        inj.before_call("w0")                    # default: no-op
        inj.kill("w0")
        with pytest.raises(killed, match="down"):
            inj.before_call("w0")
        inj.revive("w0")
        inj.before_call("w0")
        inj.drop_every("w1", 3)
        outcomes = []
        for _ in range(9):
            try:
                inj.before_call("w1")
                outcomes.append("ok")
            except dropped:
                outcomes.append("drop")
        assert outcomes == ["ok", "ok", "drop"] * 3
        with pytest.raises(ValueError):
            inj.drop_every("w1", 0)
        inj.delay("w2", 30.0)
        t0 = time.perf_counter()
        inj.before_call("w2")                    # sleeps 30 ms
        assert time.perf_counter() - t0 >= 0.03
        inj.clear()
        inj.before_call("w1")


# ---------------------------------------------------------------------------
# transfer across the two packages
# ---------------------------------------------------------------------------

def test_shard_transfer_across_packages(index, tmp_path):
    series = index.series[40:80]
    sigs = index.signatures[40:80]
    jax_publish(tmp_path / "ref", 2, np.asarray(series), np.asarray(sigs),
                40, version=3)
    got = fetch_shard(tmp_path / "ref", 2, device="cpu")
    assert got.row_start == 40 and got.n_rows == 40
    assert torch.equal(got.series, series)
    assert torch.equal(got.signatures, sigs)
    assert got.signatures.dtype == torch.int32
    assert got.nbytes() == 40 * (128 * 4 + 40 * 4)
    publish_shard(tmp_path / "port", 5, series, sigs, 40, version=0)
    publish_shard(tmp_path / "port", 5, series + 1, sigs, 40, version=1)
    back = jax_fetch(tmp_path / "port", 5)
    assert back.row_start == 40
    np.testing.assert_array_equal(np.asarray(back.series),
                                  series.numpy() + 1)
    np.testing.assert_array_equal(np.asarray(back.signatures), sigs.numpy())
    old = fetch_shard(tmp_path / "port", 5, version=0, device="cpu")
    assert torch.equal(old.series, series)
    with pytest.raises(FileNotFoundError, match="no published artifact"):
        fetch_shard(tmp_path / "port", 9, device="cpu")


# ---------------------------------------------------------------------------
# the fleet's answers
# ---------------------------------------------------------------------------

def _exact(db, qid, ids):
    return [dtw_dp_reference(db[qid], db[i], KNOBS["band"]) for i in ids]


def test_fleet_matches_reference_fleet(db, jax_index, index):
    ref = JaxFleet(jax_index, JaxSearchConfig(
        **KNOBS, replication=2, fleet_workers=4, backend="jnp").validate())
    try:
        want = ref.search_batch(jnp.asarray(db[QIDS]))
    finally:
        ref.close()
    fleet = make_fleet(index)
    try:
        assert fleet.n_shards == ref.n_shards == 4
        assert fleet.plan.assignment == ref.plan.assignment
        ids, dists, stats = _run(fleet, db[QIDS])
        np.testing.assert_array_equal(ids, np.asarray(want.ids))
        assert ids.dtype == np.int64 and dists.dtype == np.float32
        for row, qid in enumerate(QIDS):
            assert ids[row, 0] == qid
            exact = _exact(db, qid, ids[row])
            np.testing.assert_allclose(dists[row], exact, rtol=1e-6)
            np.testing.assert_allclose(np.asarray(want.dists[row]), exact,
                                       rtol=1e-4)
        assert stats.failovers == 0
        assert stats.backend == "cpu"
        assert set(stats.stage_seconds) == {"fused"}
        assert sum(fleet.nbytes().values()) == 2 * (
            index.series.numel() * 4 + index.signatures.numel() * 4)
    finally:
        fleet.close()


def test_fleet_chaos_bit_identical(db, index):
    """Queries under kill / delay / drop injection, re-rolled per wave,
    answer with the healthy run's ids and distances, bit for bit."""
    rng = np.random.default_rng(7)
    queries = db[rng.integers(0, db.shape[0], 12)]
    fleet = make_fleet(index, hedge_ms=5.0)
    try:
        healthy_ids, healthy_d, _ = _run(fleet, queries)
        workers = list(fleet.workers)
        total = []
        for lo in range(0, 12, 4):
            fleet.injector.clear()
            # at most R - 1 = 1 worker down at once, plus a delay and
            # dropped responses on others
            fleet.injector.kill(rng.choice(workers))
            fleet.injector.delay(rng.choice(workers), 20.0)
            fleet.injector.drop_every(rng.choice(workers), 2)
            ids, d, stats = _run(fleet, queries[lo:lo + 4])
            np.testing.assert_array_equal(ids, healthy_ids[lo:lo + 4])
            np.testing.assert_array_equal(d, healthy_d[lo:lo + 4])
            total.append(stats)
        assert sum(s.failovers for s in total) > 0
        assert any(s.degraded for s in total)
        assert fleet.failovers_total > 0
    finally:
        fleet.injector.clear()
        fleet.close()


def test_fleet_failover_exhaustion_raises(db, index):
    """Every replica of a shard down is loud, not silently wrong."""
    fleet = make_fleet(index, fleet_workers=2)
    try:
        for w in list(fleet.workers):
            fleet.injector.kill(w)
        with pytest.raises(RuntimeError, match="replicas"):
            fleet.search_batch(db[[3]])
    finally:
        fleet.injector.clear()
        fleet.close()


def test_kernel_error_is_not_a_failover(db, index, monkeypatch):
    """An error of the probe itself (not a ``WorkerFault`` or a missing
    replica) ends the query with that error instead of failing over."""
    fleet = make_fleet(index)

    def broken(*args, **kw):
        raise RuntimeError("collision_count kernel launch failed")
    try:
        monkeypatch.setattr(ops, "collision_count", broken)
        with pytest.raises(RuntimeError, match="launch failed"):
            fleet.search_batch(db[[3]])
        assert fleet.failovers_total == 0
    finally:
        fleet.close()


def test_fleet_hedging_recovers_stragglers(db, index):
    queries = db[QIDS[:2]]
    fleet = make_fleet(index, hedge_policy="fixed", hedge_ms=10.0)
    try:
        healthy_ids, healthy_d, _ = _run(fleet, queries)
        fleet.injector.delay(next(iter(fleet.workers)), 200.0)
        ids, d, stats = _run(fleet, queries)
        np.testing.assert_array_equal(ids, healthy_ids)
        np.testing.assert_array_equal(d, healthy_d)
        assert stats.hedged > 0 and stats.degraded
    finally:
        fleet.injector.clear()
        fleet.close()


def test_fleet_live_resize_and_drain(db, index):
    queries = db[QIDS[:3]]
    fleet = make_fleet(index)
    try:
        healthy_ids, healthy_d, _ = _run(fleet, queries)
        assert fleet.resize(6) > 0                   # scale out
        for name, worker in fleet.workers.items():   # custody = the plan
            assert worker.shard_ids() == fleet.plan.shards_of(name)
        ids, d, _ = _run(fleet, queries)
        np.testing.assert_array_equal(ids, healthy_ids)
        np.testing.assert_array_equal(d, healthy_d)
        moved = fleet.drain(sorted(fleet.workers)[0])
        assert moved > 0 and fleet.rebalanced_shards_total > 0
        for name, worker in fleet.workers.items():
            assert worker.shard_ids() == fleet.plan.shards_of(name)
        ids, d, _ = _run(fleet, queries)
        np.testing.assert_array_equal(ids, healthy_ids)
        np.testing.assert_array_equal(d, healthy_d)
        assert fleet.resize(3) > 0
        ids, d, _ = _run(fleet, queries)
        np.testing.assert_array_equal(ids, healthy_ids)
        np.testing.assert_array_equal(d, healthy_d)
        with pytest.raises(RuntimeError, match="drain"):
            while True:                              # below R: refused
                fleet.drain(sorted(fleet.workers)[0])
    finally:
        fleet.close()
    assert not any(w.shard_ids() for w in fleet.workers.values())


def test_fleet_refusals(index):
    cases = [(dict(band=None), "requires a band radius"),
             (dict(rank_by_signature=False), "rank_by_signature=True"),
             (dict(multiprobe_offsets=3), "multiprobe_offsets=1")]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            make_fleet(index, **kw)
    with pytest.raises(ValueError, match="replication 3 > fleet of 2"):
        FleetSearcher(index, _cfg(replication=3, fleet_workers=None),
                      n_workers=2)
    fleet = make_fleet(index)
    try:
        with pytest.raises(NotImplementedError, match="apply_artifacts"):
            fleet.insert(index.series[:1])
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# the engine's fleet route, its metrics, the registry
# ---------------------------------------------------------------------------

def test_engine_drain_loses_no_queries(db, index):
    cfg = _cfg(batch_policy=BatchPolicy(max_batch=4, max_wait_ms=1.0))
    engine = ServingEngine(index, cfg)               # routes to the fleet
    assert isinstance(engine.searcher, FleetSearcher)
    qids = [int(i) for i in np.random.default_rng(3).integers(
        0, db.shape[0], 8)]
    try:
        with engine:
            engine.search(db[qids[0]])
            futs = [engine.submit(db[i]) for i in qids]
            drained = threading.Thread(target=lambda: engine.drain(
                sorted(engine.searcher.workers)[0]))
            drained.start()                          # retire mid-stream
            results = [f.result(timeout=TIMEOUT) for f in futs]
            drained.join(timeout=TIMEOUT)
            assert not drained.is_alive()
    finally:
        engine.searcher.close()
    assert len(results) == len(qids)
    for i, res in zip(qids, results):
        assert int(res.ids[0]) == i
    snap = engine.metrics.snapshot()
    assert snap["requests_total"] >= len(qids)
    assert snap["rebalanced_shards_total"] > 0


def test_engine_metrics_surface_fleet_counters(db, index):
    engine = ServingEngine(index, _cfg())
    try:
        engine.search_batch(db[QIDS[:2]])            # healthy: zeros
        assert engine.metrics.snapshot()["failovers_total"] == 0
        engine.searcher.injector.kill("w0")
        engine.search_batch(db[QIDS[:2]])
        snap = engine.metrics.snapshot()
        assert snap["failovers_total"] > 0 and snap["degraded_total"] > 0
        assert snap["failovers_total"] == engine.searcher.failovers_total
    finally:
        engine.searcher.injector.clear()
        engine.searcher.close()


def test_registry_routes_distributed_to_fleet_when_replicated(db, index):
    s = make_searcher(index, _cfg(searcher="distributed"))
    try:
        assert isinstance(s._inner, FleetSearcher) and s.mesh is None
        assert s.search(db[3]).ids[0] == 3
    finally:
        s.close()


def test_registry_fleet_searcher_contract(db, index):
    s = make_searcher(index, _cfg(searcher="fleet"))
    try:
        assert s.fleet is s._inner
        out = s.search_batch(db[[3, 100]])
        assert len(out) == 2 and out[0].ids[0] == 3
        s.injector.kill("w0")                        # the chaos hook
        out2 = s.search_batch(db[[3, 100]])
        for a, b in zip(out, out2):
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.dists, b.dists)
        with pytest.raises(NotImplementedError):
            s.insert(db[:1])
        s.injector.clear()
        assert s.fail_worker("w0") > 0 and "w0" not in s.fleet.workers
        assert s.resize(4) > 0 and s.drain("w1") > 0
        np.testing.assert_array_equal(s.search(db[3]).ids, out[0].ids)
    finally:
        s.close()
