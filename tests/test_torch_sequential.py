"""The port's sequential search, UCR baseline and brute force against
the JAX package on the same state, on the CPU.

The JAX package builds the database (``backend="jnp"``; its Pallas DTW
kernel does not run on this JAX), ``repro_torch.convert`` carries the
encoder state and index arrays across, and both answer the same queries.
Ids, ``n_candidates`` and every ``SearchStats`` counter must be equal,
distances within rtol 1e-5 (the port's wavefront and the reference's
window DP round the same sums in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.ssh_ecg import SMOKE as JAX_SMOKE
from repro.core import search as jsearch
from repro.core.dtw import dtw_dp_reference
from repro.data.timeseries import make_benchmark_db, warp_series
from repro.db import SearchConfig as JaxSearchConfig
from repro.db import TimeSeriesDB as JaxDB
from repro.encoders import IndexSpec as JaxIndexSpec
from repro_torch import convert
from repro_torch.configs.ssh_ecg import SMOKE
from repro_torch.core import search
from repro_torch.db import SearchConfig, TimeSeriesDB
from repro_torch.encoders import IndexSpec
from repro_torch.kernels import _build, ops
from repro_torch.serving.batched import ssh_search_batch

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

QIDS = [3, 150, 420, 777, 901, 999]
COUNTERS = ("n_in", "pruned_kim", "pruned_keogh", "pruned_keogh2",
            "pruned_improved", "forced_kept", "n_dtw", "dtw_abandoned")
BASE = dict(topk=10, top_c=64, band=6)


def _queries(series, qids):
    qs = series[qids].copy()
    for i in range(len(qids) // 2, len(qids)):
        qs[i] = warp_series(series[qids[i]], shift=2, stretch=1.02,
                            seed=qids[i], noise=0.01)
    return qs


def _convert(jdb):
    ji = jdb.index
    spec = IndexSpec.from_dict(ji.enc.spec.to_dict())
    env = {}
    if ji.env_upper is not None:
        env = dict(env_upper=np.asarray(ji.env_upper),
                   env_lower=np.asarray(ji.env_lower),
                   env_radius=ji.env_radius)
    return convert.index_from_arrays(
        spec, ji.enc.arrays(), np.asarray(ji.signatures),
        np.asarray(ji.keys), np.asarray(ji.series),
        build_backend=ji.build_backend, device="cpu", **env)


@pytest.fixture(scope="module")
def series():
    return make_benchmark_db("ecg", 1000, 128, seed=4)


@pytest.fixture(scope="module")
def queries(series):
    return _queries(series, QIDS)


@pytest.fixture(scope="module")
def jax_db(series):
    return JaxDB.build(jnp.asarray(series), spec=JAX_SMOKE.to_spec(),
                       config=JaxSearchConfig(backend="jnp", **BASE))


@pytest.fixture(scope="module")
def index(jax_db):
    return _convert(jax_db)


def _assert_same(got, want, dist_rtol=1e-5):
    np.testing.assert_array_equal(got.ids, want.ids)
    if dist_rtol is not None:
        np.testing.assert_allclose(got.dists, want.dists, rtol=dist_rtol,
                                   atol=1e-6)
    assert got.n_candidates == want.n_candidates
    assert got.pruned_by_hash_frac == pytest.approx(want.pruned_by_hash_frac)
    for name in COUNTERS:
        assert getattr(got.stats, name) == getattr(want.stats, name), name


@pytest.mark.parametrize("knobs", [
    {},
    dict(multiprobe_offsets=3),
    dict(rank_by_signature=False),
    dict(seed_size=20, early_abandon=False),
], ids=["default", "multiprobe3", "band_keys", "seed20_no_abandon"])
def test_ssh_search_matches_jax(jax_db, index, queries, knobs):
    jcfg = JaxSearchConfig(backend="jnp", searcher="local",
                           **{**BASE, **knobs})
    cfg = SearchConfig(backend="jnp", searcher="local", **{**BASE, **knobs})
    for q in queries:
        want = jsearch.ssh_search(jnp.asarray(q), jax_db.index, config=jcfg)
        got = search.ssh_search(q, index, cfg)
        _assert_same(got, want)
        assert got.stats.backend == "cpu"
        assert set(got.stats.stage_seconds) == {"encode", "probe", "lb",
                                                "lb_improved", "dtw"}


def test_ssh_search_unbanded_matches_jax():
    """``band=None`` at m = 24 (no envelope bound is sound without a
    band, so the cascade is off and every candidate takes DTW).

    Ids and counters equal the reference's.  Distances are held to the
    float64 DP: the port's within rtol 1e-6; the reference's full-column
    DP (a float32 cumsum/cummin identity, ROADMAP §3) is off by up to
    4.0e-5 relative on query 299 of this database, so its distances are
    held to the float64 DP at rtol 1e-4 instead of to the port's."""
    params = dict(window=8, step=1, ngram=4, num_filters=1, num_hashes=20,
                  num_tables=20)
    short = make_benchmark_db("ecg", 300, 24, seed=6)
    jdb = JaxDB.build(jnp.asarray(short),
                      spec=JaxIndexSpec(encoder="ssh", params=params),
                      config=JaxSearchConfig(backend="jnp", topk=5,
                                             top_c=40))
    index = _convert(jdb)
    jcfg = JaxSearchConfig(backend="jnp", searcher="local", topk=5,
                           top_c=40, multiprobe_offsets=2)
    cfg = SearchConfig(backend="jnp", searcher="local", topk=5, top_c=40,
                       multiprobe_offsets=2)
    for q in _queries(short, [0, 77, 150, 299]):
        want = jsearch.ssh_search(jnp.asarray(q), jdb.index, config=jcfg)
        got = search.ssh_search(q, index, cfg)
        _assert_same(got, want, dist_rtol=None)
        exact = [dtw_dp_reference(q, short[i], None) for i in got.ids]
        np.testing.assert_allclose(got.dists, exact, rtol=1e-6)
        np.testing.assert_allclose(want.dists, exact, rtol=1e-4)
        assert got.stats.n_dtw == got.stats.n_in


@pytest.mark.parametrize("knobs", [dict(multiprobe_offsets=3),
                                   dict(seed_size=20)])
def test_local_equals_batched(index, queries, knobs):
    """The reference's contract (``tests/test_rerank.py:89``): the
    sequential searcher answers each query as the batched one does."""
    cfg = SearchConfig(**{**BASE, **knobs})
    batch = ssh_search_batch(queries, index, cfg)
    for i, q in enumerate(queries):
        one = search.ssh_search(q, index, cfg.replace(searcher="local"))
        row = batch.per_query(i)
        np.testing.assert_array_equal(one.ids, row.ids)
        np.testing.assert_array_equal(one.dists, row.dists)
        assert one.n_candidates == row.n_candidates


def test_facade_routes_by_searcher(index, queries):
    ops.reset_launch_counts()
    local = TimeSeriesDB(index, SearchConfig(searcher="local", **BASE))
    batched = TimeSeriesDB(index, SearchConfig(**BASE))
    for q, a, b in zip(queries, local.search_batch(queries),
                       batched.search_batch(queries)):
        np.testing.assert_array_equal(a.ids, b.ids)
        assert a.stats is not None and b.stats is None
        np.testing.assert_array_equal(local.search(q).ids, a.ids)
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


@pytest.mark.parametrize("band", [6, None])
def test_ucr_search_matches_jax_and_brute_force(series, band):
    """Exact answers both ways.  Unbanded at m = 24, for the reason of
    ``test_ssh_search_unbanded_matches_jax`` (distances then held to the
    float64 DP)."""
    db = series if band is not None else make_benchmark_db("ecg", 300, 24,
                                                           seed=6)
    for q in _queries(db, [10, 250]):
        want = jsearch.ucr_search(jnp.asarray(q), jnp.asarray(db),
                                  topk=10, band=band, backend="jnp")
        got = search.ucr_search(q, db, topk=10, band=band, device="cpu")
        np.testing.assert_array_equal(got.ids, want.ids)
        assert got.n_candidates == want.n_candidates
        if band is None:
            exact = [dtw_dp_reference(q, db[i], None) for i in got.ids]
            np.testing.assert_allclose(got.dists, exact, rtol=1e-6)
            np.testing.assert_allclose(want.dists, exact, rtol=1e-4)
        else:
            np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5,
                                       atol=1e-6)
        gold_ids, gold_d = search.brute_force_topk(q, db, 10, band,
                                                   device="cpu")
        np.testing.assert_array_equal(got.ids, gold_ids)
        np.testing.assert_array_equal(got.dists, gold_d)
        jids, _ = jsearch.brute_force_topk(jnp.asarray(q), jnp.asarray(db),
                                           10, band=band)
        np.testing.assert_array_equal(gold_ids, jids)


def test_precision_and_ndcg_match_jax():
    rng = np.random.default_rng(9)
    for _ in range(20):
        gold = rng.permutation(30)[:10]
        pred = np.concatenate([gold[rng.permutation(10)[:6]],
                               rng.integers(30, 40, 4)])
        for k in (1, 5, 10):
            assert search.precision_at_k(pred, gold, k) == \
                jsearch.precision_at_k(pred, gold, k)
            assert search.ndcg_at_k(pred, gold, k) == \
                jsearch.ndcg_at_k(pred, gold, k)


def test_ssh_recall_against_ucr(index, queries, series):
    """The paper's quality metrics on this database: SSH's top-10
    against the exact UCR answer (logged; the database rows find
    themselves)."""
    cfg = SearchConfig(searcher="local", multiprobe_offsets=3, **BASE)
    precs = []
    for i, q in enumerate(queries):
        ssh = search.ssh_search(q, index, cfg)
        ucr = search.ucr_search(q, series, topk=10, band=6, device="cpu")
        precs.append(search.precision_at_k(ssh.ids, ucr.ids, 10))
        if i < len(queries) // 2:
            assert ssh.ids[0] == ucr.ids[0] == QIDS[i]
    print(f"precision@10 of local SSH against UCR: {precs}")
    assert 0.0 <= float(np.mean(precs)) <= 1.0
