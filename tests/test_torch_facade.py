"""The rest of the facade against the JAX package, on the CPU: the
config's dict form, the searcher registry, the host hash tables, the
signature LRU, b-bit packing, the ``"srp"`` and ``"ssh-multires"``
encoders on carried state, and the index-build launcher's restart.

Integers (candidate lists, signatures, band keys, packed words, ids,
cache-hit counts) must be equal.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.ssh_ecg import SMOKE as JAX_SMOKE
from repro.core import minhash as jminhash
from repro.core import search as jsearch
from repro.core.index import HostBuckets as JaxHostBuckets
from repro.data.timeseries import make_benchmark_db, warp_series
from repro.db import BatchPolicy as JaxBatchPolicy
from repro.db import SearchConfig as JaxSearchConfig
from repro.db import TimeSeriesDB as JaxDB
from repro.db import available_searchers as jax_searchers
from repro.encoders import IndexSpec as JaxIndexSpec
from repro.serving.batched import ssh_search_batch as jax_search_batch
from repro_torch import convert
from repro_torch.configs.ssh_ecg import SMOKE
from repro_torch.core import minhash, search
from repro_torch.core.index import HostBuckets
from repro_torch.db import (BatchPolicy, SearchConfig, TimeSeriesDB,
                            available_searchers, make_searcher, registry)
from repro_torch.db import config as config_mod
from repro_torch.encoders import IndexSpec, available_encoders, sigcache
from repro_torch.launch import build_index
from repro_torch.serving.batched import ssh_search_batch

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

QIDS = [3, 150, 333, 480]
KNOBS = dict(topk=10, top_c=64, band=6, multiprobe_offsets=3)


@pytest.fixture(scope="module")
def series():
    return make_benchmark_db("ecg", 600, 128, seed=3)


@pytest.fixture(scope="module")
def queries(series):
    qs = series[QIDS].copy()
    for i in (2, 3):
        qs[i] = warp_series(series[QIDS[i]], shift=2, stretch=1.02,
                            seed=QIDS[i], noise=0.01)
    return qs


def _carried(jdb, spec):
    """The port's index on the reference database's state."""
    ji = jdb.index
    return convert.index_from_arrays(
        spec, ji.enc.arrays(), np.asarray(ji.signatures),
        np.asarray(ji.keys), np.asarray(ji.series),
        env_upper=np.asarray(ji.env_upper),
        env_lower=np.asarray(ji.env_lower), env_radius=ji.env_radius,
        device="cpu")


@pytest.fixture(scope="module")
def pair(series):
    """(reference database with host buckets, the port's index on its
    state with host buckets)."""
    jdb = JaxDB.build(jnp.asarray(series), spec=JAX_SMOKE.to_spec(),
                      config=JaxSearchConfig(backend="jnp", searcher="local",
                                             use_host_buckets=True,
                                             **KNOBS))
    index = _carried(jdb, SMOKE)
    index.build_host_buckets()
    return jdb, index


def test_search_config_dict_form_matches_the_reference():
    assert SearchConfig().to_dict() == JaxSearchConfig().to_dict()
    cfg = SearchConfig(topk=5, top_c=40, band=9, searcher="local",
                       use_host_buckets=True, replication=2,
                       fleet_workers=3, hedge_policy="fixed",
                       subseq_window=64, exclusion_zone=0,
                       batch_policy=BatchPolicy(mode="adaptive",
                                                max_batch=16))
    d = json.loads(json.dumps(cfg.to_dict()))
    assert JaxSearchConfig.from_dict(d).to_dict() == d
    assert SearchConfig.from_dict(d) == cfg
    jd = json.loads(json.dumps(JaxSearchConfig(
        band=4, batch_policy=JaxBatchPolicy(max_wait_ms=5.0)).to_dict()))
    assert SearchConfig.from_dict(jd).to_dict() == jd
    flat = SearchConfig.from_dict({"topk": 3, "max_batch": 32,
                                   "max_wait_ms": 7.5})
    assert flat.batch_policy == BatchPolicy(max_batch=32, max_wait_ms=7.5)
    assert flat == SearchConfig(topk=3, batch_policy=BatchPolicy(
        max_batch=32, max_wait_ms=7.5))
    with pytest.warns(RuntimeWarning, match="unknown fields"):
        SearchConfig.from_dict({"topk": 3, "from_the_future": 1})
    for bad in (dict(use_host_buckets=True),          # batched searcher
                dict(replication=3, fleet_workers=2),
                dict(hedge_policy="sometimes"), dict(subseq_hop=0),
                dict(batch_policy=BatchPolicy(max_batch=0))):
        with pytest.raises(ValueError):
            SearchConfig(**bad).validate()
        with pytest.raises(ValueError):
            JaxSearchConfig(**bad).validate()


@pytest.mark.parametrize("knob", [
    dict(hedge_policy="off"), dict(replication=2),
    dict(fleet_workers=3), dict(hedge_policy="fixed"), dict(hedge_ms=10.0),
    dict(subseq_window=64), dict(subseq_hop=2), dict(exclusion_zone=0)])
def test_queued_knobs_round_trip_but_are_refused(knob):
    """A knob whose tier the port lacks keeps its value through the dict
    form (a saved config loads) but is refused when the config is used,
    where the reference serves it."""
    (name,) = knob
    assert name in config_mod.QUEUED
    cfg = SearchConfig(**knob)
    assert SearchConfig.from_dict(json.loads(json.dumps(
        cfg.to_dict()))) == cfg
    with pytest.raises(ValueError, match="queued in ROADMAP"):
        cfg.validate()
    JaxSearchConfig.from_dict(cfg.to_dict()).validate()


def test_searcher_registry(pair, queries):
    _, index = pair
    assert available_searchers() == ["batched", "engine", "local"]
    assert set(available_searchers()) < set(jax_searchers())
    for name in ("distributed", "fleet"):
        with pytest.raises(ValueError, match="queued in ROADMAP"):
            make_searcher(index, SearchConfig(searcher=name))
    with pytest.raises(ValueError, match="unknown searcher"):
        TimeSeriesDB(index, SearchConfig(searcher="nope")).search(queries[0])

    @registry.register_searcher("counting")
    class Counting(registry.LocalSearcher):
        calls = 0

        def search(self, query):
            Counting.calls += 1
            return super().search(query)

    try:
        db = TimeSeriesDB(index, SearchConfig(searcher="counting", **KNOBS))
        res = db.search(queries[1])
        fut = db.submit(queries[1])
        assert fut.done() and Counting.calls == 2
        np.testing.assert_array_equal(fut.result().ids, res.ids)
        with db:
            db.reconfigure(searcher="batched")
        assert db._searcher is None and db.config.searcher == "batched"
        np.testing.assert_array_equal(db.search(queries[1]).ids, res.ids)
    finally:
        registry._FACTORIES.pop("counting")


def test_host_bucket_lists_match_the_reference_with_ties():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 4, (300, 5)).astype(np.uint32)   # many ties
    more = rng.integers(0, 4, (50, 5)).astype(np.uint32)
    jhb, hb = JaxHostBuckets(5), HostBuckets(5)
    for base, block in ((0, keys[:120]), (120, keys[120:])):
        jhb.insert(block, base_id=base)
        hb.insert(torch.from_numpy(block.view(np.int32)), base_id=base)
    probes = rng.integers(0, 5, (12, 5)).astype(np.uint32)  # some miss
    for q in probes:
        np.testing.assert_array_equal(hb.probe(q), jhb.probe(q))
    jhb.insert(more, base_id=300)
    hb.insert(more, base_id=300)
    for q in probes:
        np.testing.assert_array_equal(hb.probe(q), jhb.probe(q))


def test_host_bucket_runs_of_single_row_inserts_match_the_reference():
    """Inserts wait for the next probe and merge in one pass: a run of
    one-row inserts, probed part way, gives the reference's lists."""
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 3, (90, 4)).astype(np.uint32)
    jhb, hb = JaxHostBuckets(4), HostBuckets(4)
    jhb.insert(keys[:30])
    hb.insert(keys[:30])
    probes = rng.integers(0, 3, (8, 4)).astype(np.uint32)
    for row in range(30, 90):
        jhb.insert(keys[row:row + 1], base_id=row)
        hb.insert(torch.from_numpy(keys[row:row + 1].view(np.int32)),
                  base_id=row)
        if row in (31, 60, 89):
            for q in probes:
                np.testing.assert_array_equal(hb.probe(q), jhb.probe(q))


def test_host_bucket_probe_and_search_match_the_reference(pair, series,
                                                          queries):
    jdb, index = pair
    ji = jdb.index
    n = len(series)
    for q in queries:
        want = jsearch.hash_probe(jnp.asarray(q), ji, n,
                                  use_host_buckets=True, backend="jnp")
        got = search.hash_probe(torch.from_numpy(q), index, n,
                                use_host_buckets=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cfg = SearchConfig(searcher="local", use_host_buckets=True, **KNOBS)
    db = TimeSeriesDB(index, cfg)
    for g, w in zip(db.search_batch(queries),
                    jdb.search_batch(jnp.asarray(queries))):
        np.testing.assert_array_equal(g.ids, w.ids)
        assert g.n_candidates == w.n_candidates


def test_host_buckets_stay_aligned_after_insert(series, queries):
    jdb = JaxDB.build(jnp.asarray(series[:500]), spec=JAX_SMOKE.to_spec(),
                      config=JaxSearchConfig(backend="jnp", searcher="local",
                                             use_host_buckets=True,
                                             **KNOBS))
    index = _carried(jdb, SMOKE)
    index.build_host_buckets()
    jdb.add(jnp.asarray(series[500:]))
    index.insert(series[500:])
    np.testing.assert_array_equal(index.signatures.numpy(),
                                  np.asarray(jdb.index.signatures))
    for q in queries:
        want = jdb.index.host_buckets.probe(np.asarray(
            jdb.index.query_keys(jnp.asarray(q))))
        got = index.host_buckets.probe(index.query_keys(
            torch.from_numpy(q)))
        np.testing.assert_array_equal(got, want)


def test_signature_cache_hits_match_the_reference(pair, queries):
    jdb, index = pair
    index.sig_cache = None
    jdb.index.sig_cache = None
    jcfg = JaxSearchConfig(backend="jnp", **KNOBS)
    cfg = SearchConfig(**KNOBS)
    runs = [(ssh_search_batch(queries, index, cfg),
             jax_search_batch(jnp.asarray(queries), jdb.index, config=jcfg))
            for _ in range(2)]
    assert [g.stats.sig_cache_hit for g, _ in runs] == \
        [w.stats.sig_cache_hit for _, w in runs] == [0, len(queries)]
    np.testing.assert_array_equal(runs[0][0].ids, runs[1][0].ids)
    np.testing.assert_array_equal(runs[0][0].dists, runs[1][0].dists)
    np.testing.assert_array_equal(runs[1][0].ids, runs[1][1].ids)
    # the local searcher: its keys are the multiprobe block's, so a hit
    jl = dataclasses.replace(jcfg, searcher="local")
    for q in queries[:2]:
        got = search.ssh_search(q, index, cfg.replace(searcher="local"))
        want = jsearch.ssh_search(jnp.asarray(q), jdb.index, config=jl)
        assert got.stats.sig_cache_hit == want.stats.sig_cache_hit == 1
        np.testing.assert_array_equal(got.ids, want.ids)
    assert index.sig_cache.hits == jdb.index.sig_cache.hits


def test_signature_cache_keys_rows_by_their_bytes(pair, queries):
    """A (m,) query and the same row of a block share one key, whichever
    form the caller passed; values stay tensors of the index's device."""
    _, index = pair
    block = torch.from_numpy(queries)
    assert sigcache.row_bytes(queries) == sigcache.row_bytes(block)
    assert sigcache.row_bytes(queries[1]) == [sigcache.row_bytes(
        queries)[1]]
    assert sigcache.row_bytes(queries.astype(np.float64)) == \
        sigcache.row_bytes(queries)
    index.sig_cache = None
    res = ssh_search_batch(queries, index, SearchConfig(**KNOBS))
    assert res.stats.sig_cache_hit == 0
    sig, hit = index.query_signatures_multiprobe_cached(
        block[1], KNOBS["multiprobe_offsets"])
    assert hit and isinstance(sig, torch.Tensor)
    assert sig.device == index.device
    torch.testing.assert_close(sig, index.query_signatures_multiprobe(
        block[1], KNOBS["multiprobe_offsets"]), rtol=0, atol=0)


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_pack_signatures_match_the_reference(bits):
    rng = np.random.default_rng(bits)
    sigs = rng.integers(-2 ** 31, 2 ** 31, (40, 32), dtype=np.int64).astype(
        np.int32)
    sigs[1] = sigs[0]
    sigs[2, ::2] = sigs[0, ::2]
    got = minhash.pack_signatures(torch.from_numpy(sigs), bits)
    want = np.asarray(jminhash.pack_signatures(jnp.asarray(sigs), bits))
    np.testing.assert_array_equal(got.numpy(), want)
    cnt = minhash.packed_collisions(got[0], got, bits)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(
        jminhash.packed_collisions(jnp.asarray(want[0]), jnp.asarray(want),
                                   bits)))
    assert int(cnt[1]) == 32 and int(cnt[2]) >= 16
    with pytest.raises(ValueError, match="divide 32"):
        minhash.pack_signatures(torch.from_numpy(sigs), 3)


@pytest.mark.parametrize("name,params", [
    ("srp", {}),
    ("ssh-multires", dict(window=24, step=3, ngrams=(6, 8),
                          num_hashes=20, num_tables=20)),
])
def test_new_encoders_match_the_reference_on_carried_state(
        series, queries, name, params):
    assert name in available_encoders()
    jdb = JaxDB.build(jnp.asarray(series),
                      spec=JaxIndexSpec(encoder=name, params=params),
                      config=JaxSearchConfig(backend="jnp", **KNOBS))
    spec = IndexSpec(encoder=name, params=params)
    index = _carried(jdb, spec)
    enc = index.encoder
    np.testing.assert_array_equal(
        enc.encode_chunked(torch.from_numpy(series), batch=256).numpy(),
        np.asarray(jdb.index.signatures))
    np.testing.assert_array_equal(
        enc.band_keys(index.signatures).numpy().view(np.uint32),
        np.asarray(jdb.index.keys))
    db = TimeSeriesDB(index, SearchConfig(**KNOBS))
    assert db.config.multiprobe_offsets == jdb.config.multiprobe_offsets \
        == (3 if enc.supports_multiprobe else 1)
    for g, w in zip(db.search_batch(queries),
                    jdb.search_batch(jnp.asarray(queries))):
        np.testing.assert_array_equal(g.ids, w.ids)
    assert [int(r.ids[0]) for r in db.search_batch(series[QIDS])] == QIDS
    if name == "ssh-multires":
        assert enc.dim == (1 << 6) + (1 << 8) == jdb.index.enc.shingler.dim
        np.testing.assert_array_equal(
            enc.encode_batch_multiprobe(torch.from_numpy(queries), 3)
            .numpy(), np.asarray(jdb.index.enc.encode_batch_multiprobe(
                jnp.asarray(queries), 3, backend="jnp")))
    else:
        with pytest.raises(ValueError, match="shift-alignment"):
            enc.encode_batch_multiprobe(torch.from_numpy(queries), 3)
        assert tuple(enc.arrays()["planes"].shape) == (128, 64)


def test_build_index_resumes_to_the_same_database(tmp_path, monkeypatch,
                                                  capsys):
    argv = ["--points", "1400", "--length", "128", "--batch", "256",
            "--device", "cpu", "--out"]
    whole = build_index.build(build_index.parse_args(
        argv + [str(tmp_path / "whole")]))

    made = build_index.make_encoder

    def dying(*a, **kw):
        enc = made(*a, **kw)
        encode, calls = enc.encode_batch, []

        def encode_batch(xs):
            calls.append(1)
            if len(calls) > 2:
                raise RuntimeError("build killed")
            return encode(xs)
        enc.encode_batch = encode_batch
        return enc

    out = tmp_path / "resumed"
    monkeypatch.setattr(build_index, "make_encoder", dying)
    with pytest.raises(RuntimeError, match="build killed"):
        build_index.build(build_index.parse_args(argv + [str(out)]))
    assert (tmp_path / "resumed.build_ckpt").is_dir()
    monkeypatch.setattr(build_index, "make_encoder", made)
    capsys.readouterr()
    build_index.main(argv + [str(out)])
    assert "resuming at series 512/1273" in capsys.readouterr().out
    assert not (tmp_path / "resumed.build_ckpt").exists()
    got = TimeSeriesDB.load(out, device="cpu")
    for name in ("signatures", "keys", "series", "env_upper", "env_lower"):
        assert torch.equal(getattr(got.index, name),
                           getattr(whole.index, name)), name
    assert got.config == whole.config
    assert len(JaxDB.load(out)) == len(whole) == 1273
