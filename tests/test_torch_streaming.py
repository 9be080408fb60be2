"""The port's count-sketch streaming slice against the JAX package, on
the CPU: the count-sketch core on the same hash coefficients, the
``"ssh-cs"`` encoder on the same converted state, and shard-parallel
ingest folded into a database.

Count-sketch tables, estimates and aggregates are sums of +-1 (exact
integers in float32), so they must be equal bit for bit; signatures and
top-k ids equal; distances within rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dtw import dtw_dp_reference
from repro.data.timeseries import extract_subsequences, synthetic_ecg
from repro.db import SearchConfig as JaxSearchConfig
from repro.db import TimeSeriesDB as JaxDB
from repro.encoders import IndexSpec as JaxIndexSpec
from repro.streaming import StreamIngestor as JaxIngestor
from repro.streaming import count_sketch as jcs
from repro_torch import convert
from repro_torch.core import search
from repro_torch.db import SearchConfig, TimeSeriesDB
from repro_torch.encoders import IndexSpec, make_encoder
from repro_torch.kernels import _build, ops
from repro_torch.streaming import StreamIngestor
from repro_torch.streaming import count_sketch as cs

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

SMOKE = dict(window=24, step=3, ngram=8, num_hashes=40, num_tables=20)
PARAMS_CS = dict(**SMOKE, rows=4, width=1024, base_bits=4)
SPEC_CS = IndexSpec(encoder="ssh-cs", params=PARAMS_CS)
JSPEC_CS = JaxIndexSpec(encoder="ssh-cs", params=PARAMS_CS)
KNOBS = dict(topk=10, top_c=512, band=6, multiprobe_offsets=3)
JCFG = JaxSearchConfig(searcher="local", backend="jnp", **KNOBS)
CFG = SearchConfig(searcher="local", **KNOBS)


@pytest.fixture(scope="module")
def series():
    stream = synthetic_ecg(4000, seed=5)
    return extract_subsequences(stream, 128, stride=4, znorm=True)  # 969


@pytest.fixture(scope="module")
def queries():
    """Windows at offsets off the database's stride-4 grid."""
    stream = synthetic_ecg(4000, seed=5)
    out = []
    for off in (13, 201, 555, 901, 1337, 1601, 2222, 3001):
        q = np.asarray(stream[off:off + 128], np.float32)
        out.append(((q - q.mean()) / (q.std() + 1e-8)).astype(np.float32))
    return np.stack(out)


def _port_index(jdb):
    ji = jdb.index
    return convert.index_from_arrays(
        SPEC_CS, ji.enc.arrays(), np.asarray(ji.signatures),
        np.asarray(ji.keys), np.asarray(ji.series),
        env_upper=np.asarray(ji.env_upper),
        env_lower=np.asarray(ji.env_lower), env_radius=ji.env_radius,
        build_backend=ji.build_backend, device="cpu")


@pytest.fixture(scope="module")
def jax_db(series):
    return JaxDB.build(jnp.asarray(series), spec=JSPEC_CS, config=JCFG)


@pytest.fixture(scope="module")
def port_db(jax_db):
    return TimeSeriesDB(_port_index(jax_db), CFG)


# -- the count-sketch core on the same coefficients ---------------------------

_JPARAMS = jcs.make_cs_params(jax.random.PRNGKey(42), levels=3, rows=3)
_PARAMS = cs.CSParams(*(torch.from_numpy(np.asarray(a).astype(np.int64))
                        for a in _JPARAMS))
_WIDTH, _BASE_BITS = 128, 4


def _stream(seed, n=700):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full(200, 137), np.full(90, 9),
                          rng.integers(0, 2 ** 12, n - 300),
                          np.full(10, -1)]).astype(np.int32)
    return rng.permutation(ids)


def test_bucket_sign_matches_jax():
    ids = np.concatenate([np.arange(-1, 5000, 7), [2 ** 31 - 1]]).astype(
        np.int32)
    for level in range(3):
        for row in range(3):
            coef = [int(np.asarray(a)[level, row]) for a in _JPARAMS]
            jb, js = jcs.bucket_sign(jnp.asarray(ids),
                                     *(jnp.uint32(c) for c in coef), _WIDTH)
            tb, ts = cs.bucket_sign(torch.from_numpy(ids),
                                    *(torch.tensor(c) for c in coef), _WIDTH)
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_update_merge_estimate_match_jax():
    a, b = _stream(1), _stream(2)
    jagg = jnp.zeros((3, 3, _WIDTH), jnp.float32)
    tagg = torch.zeros((3, 3, _WIDTH))
    ja = jcs.update(jagg, jnp.asarray(a), _JPARAMS, base_bits=_BASE_BITS)
    jb = jcs.update(jagg, jnp.asarray(b), _JPARAMS, base_bits=_BASE_BITS)
    ta = cs.update(tagg, torch.from_numpy(a), _PARAMS, _BASE_BITS)
    tb = cs.update(tagg, torch.from_numpy(b), _PARAMS, _BASE_BITS)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    merged = cs.merge(ta, tb)
    np.testing.assert_array_equal(merged.numpy(),
                                  np.asarray(jcs.merge(ja, jb)))
    # the merge is the sketch of the concatenated stream, bit for bit
    both = cs.update(tagg, torch.from_numpy(np.concatenate([a, b])),
                     _PARAMS, _BASE_BITS)
    assert torch.equal(merged, both)
    probe = np.array([137, 9, 4000, -1, 5], np.int32)
    for level in range(3):
        pre = np.where(probe >= 0, probe >> (_BASE_BITS * level), -1)
        got = cs.estimate(merged, torch.from_numpy(pre), _PARAMS,
                          _BASE_BITS, level).numpy()
        want = np.asarray(jcs.estimate(jnp.asarray(np.asarray(merged)),
                                       jnp.asarray(pre), _JPARAMS,
                                       base_bits=_BASE_BITS, level=level))
        np.testing.assert_array_equal(got, want)
    assert cs.l2_estimate(merged) == pytest.approx(
        jcs.l2_estimate(jnp.asarray(np.asarray(merged))), rel=1e-6)


def test_find_heavy_hitters_matches_jax():
    agg = cs.update(torch.zeros((3, 3, _WIDTH)),
                    torch.from_numpy(_stream(3)), _PARAMS, _BASE_BITS)
    for thr in (50.0, 100.0):
        ids, ests = cs.find_heavy_hitters(agg, _PARAMS, base_bits=_BASE_BITS,
                                          id_bits=12, threshold=thr)
        jids, jests = jcs.find_heavy_hitters(
            jnp.asarray(agg.numpy()), _JPARAMS, base_bits=_BASE_BITS,
            id_bits=12, threshold=thr)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(ests, jests)
        assert 137 in ids.tolist() and (thr > 90 or 9 in ids.tolist())
    assert cs.num_levels(15, 4096, 4) == jcs.num_levels(15, 4096, 4) == 2


# -- the "ssh-cs" encoder -----------------------------------------------------

def test_sshcs_signatures_and_sketch_match_jax(jax_db, port_db, series,
                                               queries):
    jenc, enc = jax_db.index.enc, port_db.index.encoder
    got = enc.encode_chunked(torch.from_numpy(series), batch=256).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_db.index.signatures))
    mp = enc.encode_batch_multiprobe(torch.from_numpy(queries), 3).numpy()
    jmp = jenc.encode_batch_multiprobe(jnp.asarray(queries), 3,
                                       backend="jnp")
    np.testing.assert_array_equal(mp, np.asarray(jmp))
    keys = enc.band_keys(torch.from_numpy(got)).numpy().view(np.uint32)
    np.testing.assert_array_equal(keys, np.asarray(jax_db.index.keys))
    np.testing.assert_array_equal(
        enc.sketch_batch(torch.from_numpy(series[:40]), batch=16).numpy(),
        np.asarray(jenc.sketch_batch(jnp.asarray(series[:40]),
                                     backend="jnp")))


def test_sshcs_port_builds_the_same_state_shapes():
    enc = make_encoder(SPEC_CS, "cpu")
    jenc_shapes = {k: tuple(v.shape) for k, v in JaxDB.build(
        jnp.zeros((2, 128)), spec=JSPEC_CS).index.enc.arrays().items()}
    assert {k: tuple(v.shape) for k, v in enc.arrays().items()} == \
        jenc_shapes
    # int64 values on the device, the reference's uint32 on the host
    assert enc._require_state()["cs/bucket_a"].dtype == torch.int64
    assert enc.arrays()["cs/bucket_a"].dtype == np.uint32
    assert bool((enc.shingler.params.bucket_a % 2 == 1).all())
    assert float(enc.aggregate_sketch().abs().sum()) == 0.0
    with pytest.raises(ValueError, match="power of two"):
        IndexSpec(encoder="ssh-cs", params=dict(width=1000)).validate()


def test_sshcs_topk_matches_jax(jax_db, port_db, queries):
    """Port ``"ssh-cs"`` answers as JAX ``"ssh-cs"`` does: ids and DTW
    counts equal.  Distances are held to the float64 DP: the port's
    within rtol 1e-6; the reference's window DP (a float32 cumsum/cummin
    identity, ROADMAP §3) is off by up to 6.1e-5 relative on these
    queries, so its distances are held to the float64 DP at rtol 1e-4.
    The reference's bar of precision@10 >= 0.9 against exact ``"ssh"``
    (which it misses, ROADMAP §3) is reported here, not asserted."""
    ssh = JaxDB.build(jax_db.index.series, spec=JaxIndexSpec(
        encoder="ssh", params=SMOKE), config=JCFG)
    precs = []
    for q in queries:
        want = jax_db.search(jnp.asarray(q))
        got = port_db.search(q)
        np.testing.assert_array_equal(got.ids, want.ids)
        dp = [dtw_dp_reference(q, port_db.index.series[i].numpy(), 6)
              for i in got.ids]
        np.testing.assert_allclose(got.dists, dp, rtol=1e-6)
        np.testing.assert_allclose(want.dists, dp, rtol=1e-4)
        assert got.stats.n_dtw == want.stats.n_dtw
        exact = set(np.asarray(ssh.search(jnp.asarray(q)).ids).tolist())
        precs.append(len(exact & set(got.ids.tolist())) / 10)
    print(f"ssh-cs precision@10 against exact ssh: {precs}, mean "
          f"{np.mean(precs):.3f}")


# -- shard-parallel ingest ----------------------------------------------------

def test_two_shard_fold_matches_single_shard_and_jax(series, queries):
    base, stream = series[:64], series[64:128]
    blocks = [stream[i:i + 16] for i in range(0, 64, 16)]
    jdb = JaxDB.build(jnp.asarray(base), spec=JSPEC_CS, config=JCFG)
    sh0 = JaxIngestor(jdb.index.enc, shard="edge0", backend="jnp")
    sh1 = JaxIngestor(jdb.index.enc, shard="edge1", backend="jnp")
    for i, blk in ((0, blocks[0]), (1, blocks[1])):
        sh0.append(jnp.asarray(blk), seq=i)
    for i, blk in ((2, blocks[2]), (3, blocks[3])):
        sh1.append(jnp.asarray(blk), seq=i)
    jdb.apply_stream(sh0.merge(sh1))

    one = TimeSeriesDB(_port_index(JaxDB.build(
        jnp.asarray(base), spec=JSPEC_CS, config=JCFG)), CFG)
    for i, blk in enumerate(blocks):
        one.add_stream(blk, seq=i)
    one.flush()

    two = TimeSeriesDB(_port_index(JaxDB.build(
        jnp.asarray(base), spec=JSPEC_CS, config=JCFG)), CFG)
    enc = two.index.encoder
    p0, p1 = StreamIngestor(enc, shard="edge0"), StreamIngestor(
        enc, shard="edge1")
    p1.append(blocks[3], seq=3)               # shard 1 arrives first,
    p0.append(blocks[1], seq=1)               # each out of order
    p1.append(blocks[2], seq=2)
    p0.append(blocks[0], seq=0)
    merged = p1.merge(p0)
    np.testing.assert_array_equal(merged.sketch.numpy(),
                                  (p0.sketch + p1.sketch).numpy())
    two.apply_stream(merged)

    assert len(one) == len(two) == len(jdb) == 128
    jagg = np.asarray(jdb.index.enc.aggregate_sketch())
    for db in (one, two):
        idx = db.index
        np.testing.assert_array_equal(idx.series.numpy(),
                                      np.asarray(jdb.index.series))
        np.testing.assert_array_equal(idx.signatures.numpy(),
                                      np.asarray(jdb.index.signatures))
        np.testing.assert_array_equal(idx.keys.numpy().view(np.uint32),
                                      np.asarray(jdb.index.keys))
        np.testing.assert_array_equal(idx.env_upper.numpy(),
                                      np.asarray(jdb.index.env_upper))
        np.testing.assert_array_equal(
            idx.encoder.aggregate_sketch().numpy(), jagg)
    for q in queries[:4]:
        want = jdb.search(jnp.asarray(q))
        a, b = one.search(q), two.search(q)
        np.testing.assert_array_equal(a.ids, want.ids)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)


def test_out_of_order_appends_fold_in_seq_order(port_db, series):
    enc = port_db.index.encoder
    a = StreamIngestor(enc)
    a.append(series[:4], seq=1)
    a.append(series[4:8], seq=0)
    b = StreamIngestor(enc)
    b.append(series[4:8], seq=0)
    b.append(series[:4], seq=1)
    fa, fb = a.artifacts(), b.artifacts()
    for x, y in ((fa.series, fb.series), (fa.signatures, fb.signatures),
                 (fa.keys, fb.keys), (fa.sketch, fb.sketch)):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(fa.series[:4].numpy(), series[4:8])
    auto = StreamIngestor(enc)
    auto.append(series[0])                    # seq 0, then 1
    auto.append(series[1])
    assert auto.artifacts().num_series == 2


def test_ingest_refusals(port_db, series):
    enc = port_db.index.encoder
    ssh = make_encoder(IndexSpec(encoder="ssh", params=SMOKE), "cpu")
    ing = StreamIngestor(enc)
    with pytest.raises(ValueError, match="different specs"):
        ing.merge(StreamIngestor(ssh))
    with pytest.raises(ValueError, match="no appended series"):
        ing.artifacts()
    with pytest.raises(ValueError, match="'ssh-cs'"):
        StreamIngestor(ssh).heavy_hitters(1.0)
    sigs = enc.encode_batch(torch.from_numpy(series[:2]))
    with pytest.raises(ValueError, match="series-less"):
        ing.append_encoded(sigs, enc.band_keys(sigs))
    with pytest.raises(ValueError, match="do not match"):
        ing.append_encoded(sigs[:, :5], enc.band_keys(sigs),
                           series=series[:2])
    plain = StreamIngestor(ssh)
    plain.append(series[:3])
    assert plain.sketch is None and plain.artifacts().sketch is None
    with pytest.raises(ValueError, match="cannot fold"):
        port_db.apply_stream(plain)


def test_append_encoded_and_add_match_append(port_db, series):
    enc = port_db.index.encoder
    a, b = StreamIngestor(enc), StreamIngestor(enc)
    a.append(series[:5], seq=0)
    sigs = enc.encode_batch(torch.from_numpy(series[:5]))
    b.append_encoded(sigs.numpy(), enc.band_keys(sigs).numpy().view(
        np.uint32), series=series[:5], seq=0)
    fa, fb = a.artifacts(), b.artifacts()
    assert torch.equal(fa.signatures, fb.signatures)
    assert torch.equal(fa.keys, fb.keys)
    assert torch.equal(fa.sketch, fb.sketch)
    hot, ests = a.heavy_hitters(3.0)
    assert list(ests) == sorted(ests, reverse=True)
    db = TimeSeriesDB(_port_index(JaxDB.build(
        jnp.asarray(series[:20]), spec=JSPEC_CS, config=JCFG)), CFG)
    db.add(series[20])
    db.add(series[21:30])
    assert len(db) == 30
    np.testing.assert_array_equal(
        db.index.signatures[20:].numpy(),
        enc.encode_batch(torch.from_numpy(series[20:30])).numpy())
    assert db.search(series[25]).ids[0] == 25


def test_sshcs_builds_and_ingests_on_its_own_state(series):
    ops.reset_launch_counts()
    db = TimeSeriesDB.build(series[:300], SPEC_CS, CFG, device="cpu")
    db.add_stream(series[300:400], seq=1)
    db.add_stream(series[400:500], seq=0)
    db.flush()
    db.flush()                                # nothing pending: no-op
    assert len(db) == 500
    np.testing.assert_array_equal(db.index.series[300:400].numpy(),
                                  series[400:500])
    agg = db.index.encoder.aggregate_sketch()
    want = db.index.encoder.sketch_batch(torch.from_numpy(series[300:500]))
    assert torch.equal(agg, want)
    # rows 300-399 hold seq 0 (series 400-499), rows 400-499 seq 1
    for r, row in ((410, 310), (350, 450)):
        res = db.search(series[r])
        assert int(res.ids[0]) == row and float(res.dists[0]) == 0.0
    batched = TimeSeriesDB(db.index, CFG.replace(searcher="batched"))
    assert int(batched.search(series[350]).ids[0]) == 450
    hot, _ = db.index.encoder.find_heavy_hitters(50.0)
    assert hot.size > 0
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    res = search.ucr_search(series[5], db.index.series, topk=3, band=6)
    assert int(res.ids[0]) == 5
