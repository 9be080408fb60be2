"""The port's batched search against the JAX package on the same state,
on the CPU.

The JAX package builds the database (``backend="jnp"``: its Pallas sketch
and DTW kernels do not run on this JAX); ``repro_torch.convert`` carries
its encoder state and index arrays across; both packages answer
``search_batch`` for the same 8 queries.  Ids and every ``SearchStats``
counter must be equal, distances within rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.ssh_ecg import SMOKE as JAX_SMOKE
from repro.data.timeseries import make_benchmark_db, warp_series
from repro.db import SearchConfig as JaxSearchConfig
from repro.db import TimeSeriesDB as JaxDB
from repro.serving.batched import ssh_search_batch as jax_search_batch
from repro_torch import convert
from repro_torch.configs.ssh_ecg import SMOKE
from repro_torch.db import SearchConfig, TimeSeriesDB
from repro_torch.kernels import _build, ops
from repro_torch.serving.batched import ssh_search_batch

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

QIDS = [3, 50, 120, 200, 260, 333, 370, 399]
COUNTERS = ("n_in", "pruned_kim", "pruned_keogh", "pruned_keogh2",
            "pruned_improved", "forced_kept", "n_dtw", "dtw_abandoned")
KNOBS = dict(topk=10, top_c=64, band=6, multiprobe_offsets=3)


@pytest.fixture(scope="module")
def series():
    return make_benchmark_db("ecg", 400, 128, seed=3)


@pytest.fixture(scope="module")
def queries(series):
    qs = series[QIDS].copy()
    for i in range(4, 8):
        qs[i] = warp_series(series[QIDS[i]], shift=2, stretch=1.02,
                            seed=QIDS[i], noise=0.01)
    return qs


@pytest.fixture(scope="module")
def jax_db(series):
    return JaxDB.build(jnp.asarray(series), spec=JAX_SMOKE.to_spec(),
                       config=JaxSearchConfig(backend="jnp", **KNOBS))


@pytest.fixture(scope="module")
def index(jax_db):
    ji = jax_db.index
    return convert.index_from_arrays(
        SMOKE, ji.enc.arrays(), np.asarray(ji.signatures),
        np.asarray(ji.keys), np.asarray(ji.series),
        env_upper=np.asarray(ji.env_upper),
        env_lower=np.asarray(ji.env_lower), env_radius=ji.env_radius,
        build_backend=ji.build_backend, device="cpu")


@pytest.mark.parametrize("knobs", [
    {},
    dict(multiprobe_offsets=1, rank_by_signature=False),
    dict(seed_size=20, early_abandon=False),
])
def test_search_batch_matches_jax(jax_db, index, queries, knobs):
    jcfg = JaxSearchConfig(backend="jnp", **{**KNOBS, **knobs})
    want = jax_search_batch(jnp.asarray(queries), jax_db.index, config=jcfg)
    got = ssh_search_batch(queries, index,
                           SearchConfig(backend="jnp", **{**KNOBS, **knobs}))
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.n_candidates, want.n_candidates)
    assert got.n_union == want.n_union
    for name in COUNTERS:
        assert getattr(got.stats, name) == getattr(want.stats, name), name
    assert got.stats.backend == "cpu"
    assert set(got.stats.stage_seconds) == {"encode", "probe", "lb",
                                            "lb_improved", "dtw"}


def test_facade_matches_jax_facade(jax_db, index, queries):
    want = jax_db.search_batch(jnp.asarray(queries))
    db = TimeSeriesDB(index, SearchConfig(**KNOBS))
    ops.reset_launch_counts()
    got = db.search_batch(queries)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_allclose(g.dists, w.dists, rtol=1e-5, atol=1e-6)
        assert g.n_candidates == w.n_candidates
        assert g.stats is None and w.stats is None     # batch counters
    one = db.search(queries[5])
    np.testing.assert_array_equal(one.ids, got[5].ids)
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


@pytest.mark.parametrize("searcher", ["batched", "local"])
def test_facade_stats_match_jax_facade(jax_db, index, queries, searcher):
    """Per-query ``stats``: None on the batched searcher, as the
    reference leaves them; this query's counters on the local one."""
    jdb = jax_db.with_config(jax_db.config.replace(searcher=searcher))
    db = TimeSeriesDB(index, SearchConfig(searcher=searcher, **KNOBS))
    want = jdb.search_batch(jnp.asarray(queries))
    got = db.search_batch(queries)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        assert g.n_candidates == w.n_candidates
        if searcher == "batched":
            assert g.stats is None and w.stats is None
            continue
        for name in COUNTERS:
            assert getattr(g.stats, name) == getattr(w.stats, name), name
        assert g.stats.n_dtw == g.n_candidates
        assert g.stats.sig_cache_hit == 0
        assert g.stats.index_bytes == index.nbytes()
        assert set(g.stats.stage_seconds) == set(w.stats.stage_seconds)


def test_own_encode_agrees_with_jax_signatures(jax_db, index, series,
                                               queries):
    ji = jax_db.index
    sigs = index.encoder.encode_chunked(torch.from_numpy(series), batch=128)
    rate = float(np.mean(sigs.numpy() == np.asarray(ji.signatures)))
    mp = index.encoder.encode_batch_multiprobe(torch.from_numpy(queries), 3)
    jmp = ji.enc.encode_batch_multiprobe(jnp.asarray(queries), 3,
                                         backend="jnp")
    mp_rate = float(np.mean(mp.numpy() == np.asarray(jmp)))
    print(f"signature agreement with jax: database {rate:.6f}, "
          f"multiprobe queries {mp_rate:.6f}")
    assert rate >= 0.999 and mp_rate >= 0.999
    same = (sigs.numpy() == np.asarray(ji.signatures)).all(1)
    keys = index.encoder.band_keys(sigs).numpy().view(np.uint32)
    np.testing.assert_array_equal(keys[same], np.asarray(ji.keys)[same])


def test_port_builds_and_serves_on_its_own_state(series):
    db = TimeSeriesDB.build(series, SMOKE, SearchConfig(**KNOBS),
                            device="cpu")
    assert db.index.build_backend == "cpu"
    assert db.index.env_radius == 6
    res = db.search_batch(series[QIDS])
    assert [int(r.ids[0]) for r in res] == QIDS
    assert all(float(r.dists[0]) == 0.0 for r in res)
