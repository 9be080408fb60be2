"""The port's row-sharded fan-out (``repro_torch.distributed``) against
the JAX package, on the CPU.

One shard: the port's ``DistributedSearcher`` (``make_encoder_query_fn``
over the mesh ``[cpu]``) against the reference's ``DistributedSearcher``
on its one-device CPU mesh.  Four shards (the mesh ``[cpu] * 4``, one
device repeated) against the reference's ``FleetSearcher(replication=1,
fleet_workers=4)``, which cuts the same row ranges, probes the same
``local_c`` and merges alike; and against the port's replicated fleet,
bit for bit.  Then ``build_sharded``, the refusals (the reference's
messages), ``make_query_fn``, and ``apply_artifacts`` / ``resize`` against
a rebuild.  Fixture and tolerances as ``tests/test_torch_fleet.py``: ids
equal, distances to the float64 DP (the port at rtol 1e-6, the reference
at 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SSHIndex as JaxIndex
from repro.core import SSHParams
from repro.core.dtw import dtw_dp_reference
from repro.data.timeseries import extract_subsequences, synthetic_ecg
from repro.db import SearchConfig as JaxSearchConfig
from repro.fleet import FleetSearcher as JaxFleet
from repro.serving import DistributedSearcher as JaxDist
from repro_torch import convert
from repro_torch.db import SearchConfig, TimeSeriesDB
from repro_torch.distributed import dist_index
from repro_torch.encoders import IndexSpec
from repro_torch.fleet import FleetSearcher
from repro_torch.serving import DistributedSearcher
from repro_torch.streaming import StreamIngestor

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

PARAMS = SSHParams(window=24, step=3, ngram=8, num_hashes=40, num_tables=20)
KNOBS = dict(topk=5, top_c=64, band=8)
QIDS = [3, 100, 250, 444]
CPU = torch.device("cpu")
ROWS = 516                           # divides meshes of 1, 2, 3 and 4


@pytest.fixture(scope="module")
def db():
    stream = synthetic_ecg(2200, seed=5)
    return extract_subsequences(stream, 128, stride=4, znorm=True)[:ROWS]


@pytest.fixture(scope="module")
def jax_index(db):
    return JaxIndex.build(jnp.asarray(db), spec=PARAMS.to_spec(),
                          backend="jnp")


def _carry(ji):
    return convert.index_from_arrays(
        IndexSpec.from_dict(ji.enc.spec.to_dict()), ji.enc.arrays(),
        np.asarray(ji.signatures), np.asarray(ji.keys),
        np.asarray(ji.series), build_backend=ji.build_backend,
        device="cpu")


@pytest.fixture(scope="module")
def index(jax_index):
    return _carry(jax_index)


def _cfg(**kw):
    return SearchConfig(**{**KNOBS, **kw}).validate()


def _check_against(db, got, want_ids, want_dists):
    np.testing.assert_array_equal(got.ids, np.asarray(want_ids))
    for row, qid in enumerate(QIDS):
        assert got.ids[row, 0] == qid
        exact = [dtw_dp_reference(db[qid], db[i], KNOBS["band"])
                 for i in got.ids[row]]
        np.testing.assert_allclose(got.dists[row], exact, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(want_dists[row]), exact,
                                   rtol=1e-4)


def test_one_shard_matches_reference_distributed(db, jax_index, index):
    mesh = jax.make_mesh((1,), ("data",))
    want = JaxDist(jax_index, JaxSearchConfig(**KNOBS, backend="jnp"),
                   mesh).search_batch(jnp.asarray(db[QIDS]))
    got = DistributedSearcher(index, _cfg(), [CPU]).search_batch(db[QIDS])
    _check_against(db, got, want.ids, want.dists)
    assert got.stats.backend == "cpu"
    assert set(got.stats.stage_seconds) == {"fused"}
    assert got.n_candidates.tolist() == [KNOBS["top_c"]] * len(QIDS)
    # the facade's default mesh on a CPU index is the CPU: the same answers
    tsdb = TimeSeriesDB(index, _cfg(searcher="distributed"))
    assert tsdb.searcher.mesh == [CPU] == dist_index.default_mesh(CPU)
    res = tsdb.search_batch(db[QIDS])
    for row, r in enumerate(res):
        np.testing.assert_array_equal(r.ids, got.ids[row])
        np.testing.assert_array_equal(r.dists, got.dists[row])
    np.testing.assert_array_equal(tsdb.search(db[QIDS[1]]).ids, got.ids[1])


def test_four_shards_match_reference_fleet_and_port_fleet(db, jax_index,
                                                          index):
    """Four row shards on one device equal the reference fleet at R = 1,
    W = 4 (same partition, local_c and merge), and the port's replicated
    fleet bit for bit — the premise of the card's fleet gate."""
    ref = JaxFleet(jax_index, JaxSearchConfig(
        **KNOBS, replication=1, fleet_workers=4, backend="jnp").validate())
    try:
        want = ref.search_batch(jnp.asarray(db[QIDS]))
    finally:
        ref.close()
    tsdb = TimeSeriesDB(index, _cfg(searcher="distributed"),
                        mesh=[CPU] * 4)
    assert tsdb.with_config(_cfg(searcher="distributed")).mesh == [CPU] * 4
    inner = tsdb.searcher._inner
    assert [s.shape[0] for s in inner._series] == [ROWS // 4] * 4
    assert inner._series[1].data_ptr() == index.series[ROWS // 4].data_ptr()
    got = inner.search_batch(db[QIDS])
    _check_against(db, got, want.ids, want.dists)
    fleet = FleetSearcher(index, _cfg(replication=2, fleet_workers=4))
    try:
        assert fleet._partition() == [(lo, hi) for _, lo, hi in
                                      dist_index.index_shardings(
                                          [CPU] * 4, ROWS)]
        res = fleet.search_batch(db[QIDS])
    finally:
        fleet.close()
    np.testing.assert_array_equal(res.ids, got.ids)
    np.testing.assert_array_equal(res.dists, got.dists)


def test_build_sharded_gives_the_index_signatures(index):
    for n in (1, 3, 4):
        shards = dist_index.build_sharded(index.series, index.encoder,
                                          [CPU] * n)
        assert len(shards) == n
        assert torch.equal(torch.cat(shards), index.signatures)


def test_refusals_use_the_reference_messages(jax_index, index):
    mesh = jax.make_mesh((1,), ("data",))
    for kw, msg in ((dict(band=None), "requires a band radius"),
                    (dict(rank_by_signature=False),
                     "rank_by_signature=True and multiprobe_offsets=1"),
                    (dict(multiprobe_offsets=3),
                     "rank_by_signature=True and multiprobe_offsets=1")):
        with pytest.raises(ValueError, match=msg):
            JaxDist(jax_index, JaxSearchConfig(**{**KNOBS, **kw}), mesh)
        with pytest.raises(ValueError, match=msg):
            DistributedSearcher(index, SearchConfig(**{**KNOBS, **kw}),
                                [CPU])
    msg = r"index rows \(516\) must divide the mesh \(5 devices\)"
    with pytest.raises(ValueError, match=msg):
        DistributedSearcher(index, _cfg(), [CPU] * 5)
    dist = DistributedSearcher(index, _cfg(), [CPU] * 2)
    for searcher in (dist, JaxDist(jax_index, JaxSearchConfig(**KNOBS),
                                   mesh)):
        with pytest.raises(NotImplementedError, match="reshard"):
            searcher.insert(index.series[:1])
    with pytest.raises(ValueError, match="config.band is None"):
        dist_index.make_query_fn(index.encoder.spec, [CPU], length=128,
                                 config=SearchConfig(**{**KNOBS,
                                                        "band": None}))
    with pytest.raises(ValueError, match="at least one device"):
        dist_index.as_mesh([])
    with pytest.raises(ValueError, match="cuda or cpu"):
        dist_index.as_mesh([torch.device("meta")])


def test_make_query_fn_equals_the_encoder_form(db, index):
    mesh = [CPU] * 2
    shards = dist_index.index_shardings(mesh, ROWS)
    series = dist_index.place_rows(index.series, shards)
    sigs = dist_index.place_rows(index.signatures, shards)
    state = index.encoder._require_state()
    cws = {k.split("/", 1)[1]: v for k, v in state.items()
           if k.startswith("cws/")}
    legacy = dist_index.make_query_fn(index.encoder.spec, mesh, length=128,
                                      config=_cfg())
    canon = dist_index.make_encoder_query_fn(index.encoder, mesh,
                                             config=_cfg())
    for qid in QIDS[:2]:
        q = torch.from_numpy(db[qid])
        a = legacy(series, sigs, state["filters"], cws, q)
        b = canon(series, sigs, q)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert int(a[0][0]) == qid


def test_apply_artifacts_and_resize_equal_a_rebuild(db, jax_index):
    """Folding four streamed rows into the sharded index (and into a
    fleet), then moving the index to another mesh, answers as searchers
    built afresh on the grown index do."""
    index = _carry(jax_index)
    extra = extract_subsequences(synthetic_ecg(600, seed=9), 128,
                                 stride=100, znorm=True)[:4]
    ing = StreamIngestor(index.encoder)
    ing.append(extra)
    arts = ing.artifacts()
    dist = DistributedSearcher(index, _cfg(), [CPU] * 4)
    fleet_index = _carry(jax_index)
    fleet = FleetSearcher(fleet_index, _cfg(replication=2, fleet_workers=4))
    try:
        dist.apply_artifacts(arts)
        fleet.apply_artifacts(arts)
        grown = np.concatenate([db, extra])
        sigs = index.encoder.encode_batch(torch.from_numpy(grown))
        rebuilt = convert.index_from_arrays(
            index.encoder.spec, index.encoder.arrays(), sigs.numpy(),
            index.encoder.band_keys(sigs).numpy(), grown, device="cpu")
        queries = np.concatenate([db[QIDS[:2]], extra[:2]])
        got = dist.search_batch(queries)
        assert got.ids[2, 0] == ROWS and got.ids[3, 0] == ROWS + 1
        for searcher, mesh in ((dist, [CPU] * 4), (dist, [CPU] * 2)):
            if mesh != searcher.mesh:
                searcher.resize(mesh)
            assert searcher.mesh == mesh
            want = DistributedSearcher(rebuilt, _cfg(), mesh).search_batch(
                queries)
            got = searcher.search_batch(queries)
            np.testing.assert_array_equal(got.ids, want.ids)
            np.testing.assert_array_equal(got.dists, want.dists)
        fleet_got = fleet.search_batch(queries)
        fresh = FleetSearcher(rebuilt, _cfg(replication=2, fleet_workers=4))
        try:
            fleet_want = fresh.search_batch(queries)
        finally:
            fresh.close()
        np.testing.assert_array_equal(fleet_got.ids, fleet_want.ids)
        np.testing.assert_array_equal(fleet_got.dists, fleet_want.dists)
    finally:
        fleet.close()
