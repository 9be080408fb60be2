"""Subsequence search of the port (``repro_torch.subseq`` and the facade's
stream verbs) against the JAX package's ``repro.subseq``, on the CPU.

The fixture is the reference's (``tests/test_subseq.py``): one
synthetic-ECG stream of 3000 points, the SMOKE sketch with two filters,
windows of L = 128 at hop 4; the reference's encoder state is carried
across with ``convert.encoder_from_arrays`` and the JAX side runs its
plain versions (``backend="jnp"``).  Integers (sign bits, shingle ids,
histograms, signatures, band keys, window ids, offsets) must be equal.
Distances are held to the float64 DP (``core.dtw.dtw_dp_reference``) at
rtol 1e-6 for the port and 1e-4 for the reference (ROADMAP §3).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.timeseries import warp_series
from repro.db import SearchConfig as JaxSearchConfig
from repro.db import TimeSeriesDB as JaxDB
from repro.encoders import IndexSpec as JaxIndexSpec
from repro.encoders import make_encoder as jax_make_encoder
from repro.kernels import ops as jops
from repro.subseq import SubsequenceIndex as JaxSub
from repro.subseq import global_shingle_ids as jax_global_ids
from repro.subseq import rolling_signatures as jax_rolling_signatures
from repro.subseq import rolling_sketch_bits as jax_rolling_bits
from repro_torch import convert
from repro_torch.core import shingle
from repro_torch.core.dtw import dtw_dp_reference
from repro_torch.core.index import SSHIndex
from repro_torch.data.timeseries import extract_subsequences, synthetic_ecg
from repro_torch.db import SearchConfig, TimeSeriesDB
from repro_torch.encoders import IndexSpec, make_encoder
from repro_torch.kernels import ops
from repro_torch.subseq import (SubsequenceIndex, delta_histograms,
                                global_shingle_ids, is_subseq_dir,
                                num_windows, rolling_signatures,
                                rolling_sketch_bits)
from repro_torch.subseq import persistence as sub_persistence

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

SMOKE = dict(window=24, step=3, ngram=8, num_filters=2,
             num_hashes=40, num_tables=20)
SPEC = IndexSpec(encoder="ssh", params=SMOKE)
JAX_SPEC = JaxIndexSpec(encoder="ssh", params=SMOKE)
L, HOP = 128, 4
KNOBS = dict(topk=5, top_c=128, band=8, searcher="local",
             subseq_window=L, subseq_hop=HOP)
CFG = SearchConfig(**KNOBS)
JAX_CFG = JaxSearchConfig(backend="jnp", **KNOBS)
#: query starts: three planted exact windows (one between window
#: starts), then a warped copy of the stream at 2000
QUERY_STARTS = (1200, 800, 405, 2000)


def _windows(stream, length, hop):
    nw = num_windows(len(stream), length, hop)
    return np.stack([stream[j * hop:j * hop + length] for j in range(nw)])


@pytest.fixture(scope="module")
def stream():
    return np.asarray(synthetic_ecg(3000, seed=3), np.float32)


@pytest.fixture(scope="module")
def jax_enc():
    return jax_make_encoder(JAX_SPEC, length=L)


@pytest.fixture(scope="module")
def enc(jax_enc):
    """The port's encoder on the reference's random state."""
    return convert.encoder_from_arrays(SPEC, jax_enc.arrays(), "cpu")


@pytest.fixture(scope="module")
def jax_sub(stream, jax_enc):
    return JaxSub.build(stream, JAX_SPEC, length=L, hop=HOP, backend="jnp")


def _carried_sub(jsub):
    """The port's index on the reference index's state, through the
    rolling encode of the carried encoder."""
    enc = convert.encoder_from_arrays(SPEC, jsub.inner.enc.arrays(), "cpu")
    stream = torch.from_numpy(np.asarray(jsub.stream))
    sigs = rolling_signatures(stream, enc, jsub.length, jsub.hop)
    inner = SSHIndex(encoder=enc, signatures=sigs, keys=enc.band_keys(sigs),
                     series=None, build_backend="cpu")
    return SubsequenceIndex(inner=inner, stream=stream, length=jsub.length,
                            hop=jsub.hop)


@pytest.fixture(scope="module")
def sub(jax_sub):
    return _carried_sub(jax_sub)


def _query(stream, start):
    q = stream[start:start + L].copy()
    if start == QUERY_STARTS[-1]:
        q = warp_series(q, shift=2, stretch=1.02, seed=start, noise=0.01)
    return q.astype(np.float32)


# ---------------------------------------------------------------------------
# bits and ids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2, 3])
def test_sketch_bits_stream_matches_reference(stream, enc, jax_enc, stride):
    filters = enc._require_state()["filters"]
    got = ops.sketch_bits_stream(torch.from_numpy(stream), filters, stride)
    want = jops.sketch_bits_stream(jnp.asarray(stream),
                                   jnp.asarray(jax_enc.arrays()["filters"]),
                                   stride, use_pallas=False)
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == ((len(stream) - 24) // stride + 1, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hop", [1, 3, 4, 5, 6])
def test_rolling_sketch_bits_match_reference_and_windows(stream, enc,
                                                         jax_enc, hop):
    s = stream[:1200]
    filters = enc._require_state()["filters"]
    got = rolling_sketch_bits(torch.from_numpy(s), filters, 3, L, hop)
    want = jax_rolling_bits(jnp.asarray(s),
                            jnp.asarray(jax_enc.arrays()["filters"]), 3, L,
                            hop, use_pallas=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    per_window = ops.sketch_bits(torch.from_numpy(_windows(s, L, hop)),
                                 filters, 3)
    np.testing.assert_array_equal(got.numpy(), per_window.numpy())


def test_global_shingle_ids_match_reference(stream, enc):
    filters = enc._require_state()["filters"]
    gbits = ops.sketch_bits_stream(torch.from_numpy(stream), filters, 3)
    got = global_shingle_ids(gbits, 8)
    want = jax_global_ids(jnp.asarray(gbits.numpy()), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_delta_histograms_match_per_window():
    rng = np.random.default_rng(11)
    w, step, ngram, f = 8, 2, 4, 2
    length, hop = 40, 6
    stream = torch.from_numpy(rng.standard_normal(400).astype(np.float32))
    filters = torch.from_numpy(rng.standard_normal((w, f)).astype(
        np.float32))
    n_b = (length - w) // step + 1
    s, shift, dim = n_b - ngram + 1, hop // step, f << ngram
    nw = num_windows(400, length, hop)
    gids = global_shingle_ids(ops.sketch_bits_stream(stream, filters, step),
                              ngram)
    got = delta_histograms(gids, s, shift, nw, dim)
    bits = ops.sketch_bits(torch.from_numpy(_windows(stream.numpy(), length,
                                                     hop)), filters, step)
    want = torch.stack([shingle.shingle_histogram(b, ngram) for b in bits])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hop", [3, 4, 5, 6, 1])
def test_rolling_signatures_match_reference_and_encode_batch(
        stream, enc, jax_enc, hop):
    s = stream[:1200]
    got = rolling_signatures(torch.from_numpy(s), enc, L, hop)
    want = jax_rolling_signatures(jnp.asarray(s), jax_enc, L, hop,
                                  backend="jnp")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        enc.band_keys(got).numpy().view(np.uint32),
        np.asarray(jax_enc.band_keys(want)))
    own = enc.encode_batch(torch.from_numpy(_windows(s, L, hop)))
    np.testing.assert_array_equal(got.numpy(), own.numpy())


@pytest.mark.parametrize("hop", [4, 5])
def test_rolling_signatures_chunk_invariant(stream, enc, hop):
    s = torch.from_numpy(stream[:900])
    whole = rolling_signatures(s, enc, L, hop)
    for chunk in (1, 7, 64):
        np.testing.assert_array_equal(
            rolling_signatures(s, enc, L, hop, chunk=chunk).numpy(),
            whole.numpy())


def test_dense_fallback_multires_matches_reference(stream):
    params = dict(window=24, step=3, ngrams=(6, 8), num_filters=1,
                  num_hashes=20, num_tables=20)
    jenc = jax_make_encoder(JaxIndexSpec(encoder="ssh-multires",
                                         params=params), length=L)
    tenc = convert.encoder_from_arrays(
        IndexSpec(encoder="ssh-multires", params=params), jenc.arrays(),
        "cpu")
    s = stream[:1000]
    for hop in (3, 5):
        got = rolling_signatures(torch.from_numpy(s), tenc, L, hop, chunk=9)
        want = jax_rolling_signatures(jnp.asarray(s), jenc, L, hop,
                                      backend="jnp")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        own = tenc.encode_batch(torch.from_numpy(_windows(s, L, hop)))
        np.testing.assert_array_equal(got.numpy(), own.numpy())


def test_dense_fallback_count_sketch_matches_encode_batch(stream):
    spec = IndexSpec(encoder="ssh-cs", params=dict(
        window=24, step=3, ngram=8, num_hashes=20, num_tables=10,
        width=128))
    tenc = make_encoder(spec, "cpu")
    s = stream[:900]
    for hop in (3, 4):
        got = rolling_signatures(torch.from_numpy(s), tenc, L, hop, chunk=11)
        own = tenc.encode_batch(torch.from_numpy(_windows(s, L, hop)))
        np.testing.assert_array_equal(got.numpy(), own.numpy())


def test_srp_and_bad_streams_are_refused(stream, enc):
    srp = make_encoder(IndexSpec(encoder="srp", params=dict(
        num_hashes=20, num_tables=10)), "cpu", length=L)
    jsrp = jax_make_encoder(JaxIndexSpec(encoder="srp", params=dict(
        num_hashes=20, num_tables=10)), length=L)
    msg = "strided-filter sketch encoder"
    with pytest.raises(ValueError, match=msg):
        rolling_signatures(torch.from_numpy(stream), srp, L, HOP)
    with pytest.raises(ValueError, match=msg):
        jax_rolling_signatures(jnp.asarray(stream), jsrp, L, HOP)
    with pytest.raises(ValueError, match="not materialized"):
        rolling_signatures(torch.from_numpy(stream),
                           type(enc)(SPEC), L, HOP)
    with pytest.raises(ValueError, match="holds no window"):
        rolling_signatures(torch.from_numpy(stream[:L - 1]), enc, L, HOP)
    with pytest.raises(ValueError, match="1-D"):
        rolling_signatures(torch.zeros(2, 500), enc, L, HOP)
    with pytest.raises(ValueError, match="fewer than the shingle length"):
        rolling_signatures(torch.from_numpy(stream), enc, 40, HOP)
    with pytest.raises(ValueError, match="length and hop"):
        num_windows(100, L, 0)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", QUERY_STARTS)
def test_search_matches_reference(stream, sub, jax_sub, start):
    q = _query(stream, start)
    got = sub.search(q, CFG)
    want = jax_sub.search(jnp.asarray(q), JAX_CFG)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.offsets, np.asarray(want.offsets))
    np.testing.assert_array_equal(got.offsets, got.ids * HOP)
    assert got.n_candidates == want.n_candidates
    dp = np.array([dtw_dp_reference(q, stream[o:o + L], CFG.band)
                   for o in got.offsets])
    np.testing.assert_allclose(got.dists, dp, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(want.dists), dp, rtol=1e-4,
                               atol=1e-7)
    if start % HOP == 0 and start != QUERY_STARTS[-1]:
        assert int(got.offsets[0]) == start and got.dists[0] == 0.0


def test_exclusion_zone_matches_reference(stream, sub, jax_sub):
    q = _query(stream, 800)
    for knobs in ({}, dict(exclusion_zone=0, topk=3),
                  dict(exclusion_zone=20)):
        got = sub.search(q, CFG.replace(**knobs))
        want = jax_sub.search(jnp.asarray(q), JAX_CFG.replace(**knobs))
        np.testing.assert_array_equal(got.offsets, np.asarray(want.offsets))
        zone = knobs.get("exclusion_zone", L // 2)
        gap = np.abs(got.offsets[:, None] - got.offsets[None, :])
        np.fill_diagonal(gap, 1 << 30)
        assert gap.min() >= zone and len(got.ids) <= knobs.get("topk", 5)
    # with no zone the pool is not oversampled: neighbours come back
    res0 = sub.search(q, CFG.replace(exclusion_zone=0, topk=3))
    assert np.abs(np.diff(np.sort(res0.offsets))).min() < L // 2


def test_search_telemetry(stream, sub, jax_sub):
    q = _query(stream, 404)
    res = sub.search(q, CFG)
    want = jax_sub.search(jnp.asarray(q), JAX_CFG)
    assert set(res.stats.stage_seconds) == set(want.stats.stage_seconds)
    assert res.stats.stage_seconds["encode_amortized"] == \
        sub.encode_seconds / sub.num_windows
    assert res.stats.n_windows == sub.num_windows == want.stats.n_windows
    assert res.n_windows == res.n_database == sub.num_windows
    assert res.stream_length == len(stream)
    assert res.stats.index_bytes == sub.nbytes()
    assert res.pruned_by_hash_frac == pytest.approx(want.pruned_by_hash_frac)


def test_query_shape_and_window_errors(sub, jax_sub):
    for index, zeros in ((sub, np.zeros), (jax_sub, jnp.zeros)):
        cfg = CFG if index is sub else JAX_CFG
        with pytest.raises(ValueError, match="one window"):
            index.search(zeros(L + 1, np.float32), cfg)
        with pytest.raises(ValueError, match="subseq_window"):
            index.search(zeros(L, np.float32),
                         cfg.replace(subseq_window=L * 2))


def test_sig_cache_hits_on_a_repeated_query(stream, sub):
    q = _query(stream, 640)
    sub.inner.sig_cache = None
    first = sub.search(q, CFG)
    second = sub.search(q, CFG)
    assert (first.stats.sig_cache_hit, second.stats.sig_cache_hit) == (0, 1)
    np.testing.assert_array_equal(first.ids, second.ids)


# ---------------------------------------------------------------------------
# growth and persistence
# ---------------------------------------------------------------------------

def test_extend_stream_matches_rebuild_and_reference(stream, enc):
    jsub = JaxSub.build(stream[:2000], JAX_SPEC, length=L, hop=HOP,
                        backend="jnp")
    sub = _carried_sub(jsub)
    n_new = sub.extend_stream(stream[2000:2600])
    assert n_new == jsub.extend_stream(stream[2000:2600]) \
        == num_windows(2600, L, HOP) - num_windows(2000, L, HOP)
    np.testing.assert_array_equal(sub.inner.signatures.numpy(),
                                  np.asarray(jsub.inner.signatures))
    np.testing.assert_array_equal(sub.inner.keys.numpy().view(np.uint32),
                                  np.asarray(jsub.inner.keys))
    rebuilt = rolling_signatures(torch.from_numpy(stream[:2600]), enc, L,
                                 HOP)
    np.testing.assert_array_equal(sub.inner.signatures.numpy(),
                                  rebuilt.numpy())
    assert sub.stream.shape[0] == 2600
    assert sub.extend_stream(np.zeros(0, np.float32)) == 0
    before = sub.num_windows
    assert sub.extend_stream(np.zeros(1, np.float32)) in (0, 1)
    assert sub.num_windows >= before and sub.stream.shape[0] == 2601


def _same_index(a, b):
    np.testing.assert_array_equal(a.inner.signatures.numpy(),
                                  np.asarray(b.inner.signatures))
    np.testing.assert_array_equal(a.inner.keys.numpy().view(np.uint32),
                                  np.asarray(b.inner.keys))
    np.testing.assert_array_equal(a.stream.numpy(), np.asarray(b.stream))


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_save_load_across_packages(tmp_path, stream, sub, jax_sub, saver):
    """A directory saved by either package loads in the other with the
    same arrays, answers with the same ids and grows alike."""
    q = _query(stream, 1200)
    if saver == "port":
        sub.save(tmp_path, CFG)
        loaded, cfg = JaxSub.load(tmp_path)
        assert cfg == JAX_CFG.replace(backend="auto")
        _same_index(sub, loaded)
        got = loaded.search(jnp.asarray(q), JAX_CFG)
        want = sub.search(q, CFG)
        port, ref = SubsequenceIndex.load(tmp_path, device="cpu")[0], loaded
    else:
        jax_sub.save(tmp_path, JAX_CFG)
        loaded, cfg = SubsequenceIndex.load(tmp_path, device="cpu")
        assert cfg == CFG.replace(backend="jnp")
        _same_index(loaded, jax_sub)
        got = loaded.search(q, CFG)
        want = jax_sub.search(jnp.asarray(q), JAX_CFG)
        port, ref = loaded, JaxSub.load(tmp_path)[0]
    np.testing.assert_array_equal(got.ids, want.ids)
    meta = json.loads((tmp_path / "subseq_db.json").read_text())
    assert meta["n_windows"] == jax_sub.num_windows
    # both packages grow the loaded state alike
    tail = np.asarray(synthetic_ecg(400, seed=9), np.float32)
    assert port.extend_stream(tail) == ref.extend_stream(tail) > 0
    _same_index(port, ref)


def test_tampered_directory_is_refused(tmp_path, sub):
    sub.save(tmp_path, CFG)
    assert is_subseq_dir(tmp_path) and not is_subseq_dir(tmp_path / "x")
    meta_path = tmp_path / "subseq_db.json"
    meta = json.loads(meta_path.read_text())
    for change, match in ((dict(hop=HOP + 1), "geometry/artifact"),
                          (dict(format_version=9), "format_version"),
                          (dict(spec=dict(meta["spec"], params=dict(
                              SMOKE, num_hashes=20))),
                           "does not match IndexSpec")):
        meta_path.write_text(json.dumps({**meta, **change}))
        with pytest.raises(ValueError, match=match):
            SubsequenceIndex.load(tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError, match="subseq_db.json"):
        sub_persistence.load_subseq(tmp_path / "missing", device="cpu")


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

def test_facade_stream_verbs(tmp_path, stream):
    db = TimeSeriesDB.build_stream(stream, SPEC, CFG, device="cpu")
    q = _query(stream, 1200)
    res = db.search_subsequence(q)
    assert int(res.offsets[0]) == 1200 and res.dists[0] == 0.0
    assert db.length == L and len(db) == db.subseq.num_windows
    assert db.subseq.stream.device == db.device == torch.device("cpu")
    assert db.index.series is None and db.index.env_upper is None
    np.testing.assert_array_equal(
        db.search_subsequence(q, CFG.replace(topk=2)).ids, res.ids[:2])
    assert db.extend_stream(np.asarray(synthetic_ecg(300, seed=2),
                                       np.float32)) > 0
    db.save(tmp_path / "db")
    db2 = TimeSeriesDB.load(tmp_path / "db", device="cpu")
    assert db2.config == CFG and len(db2) == len(db)
    np.testing.assert_array_equal(db2.search_subsequence(q).ids,
                                  db.search_subsequence(q).ids)
    tail = np.asarray(synthetic_ecg(200, seed=4), np.float32)
    assert db2.extend_stream(tail) == db.extend_stream(tail)
    torch.testing.assert_close(db2.index.signatures, db.index.signatures)


def test_fixed_length_and_stream_verbs_refuse_each_other(stream):
    db = TimeSeriesDB.build_stream(stream, SPEC, CFG, device="cpu")
    q = _query(stream, 1200)
    for call in (lambda: db.search(q), lambda: db.search_batch(q[None]),
                 lambda: db.add(np.zeros((2, L), np.float32)),
                 lambda: db.add_stream(np.zeros((2, L), np.float32))):
        with pytest.raises(ValueError, match="search_subsequence"):
            call()
    series = extract_subsequences(stream, L, stride=16)
    db3 = TimeSeriesDB.build(series, SPEC, SearchConfig(searcher="local"),
                             device="cpu")
    for call in (lambda: db3.search_subsequence(q),
                 lambda: db3.extend_stream(np.zeros(10, np.float32)),
                 lambda: db3.subseq):
        with pytest.raises(ValueError, match="build_stream"):
            call()
    # the reference refuses the same calls
    jdb = JaxDB.build_stream(stream, spec=JAX_SPEC, config=JAX_CFG)
    with pytest.raises(ValueError, match="search_subsequence"):
        jdb.search(jnp.asarray(q))


def test_build_stream_requires_window_and_accepts_the_knobs():
    with pytest.raises(ValueError, match="subseq_window"):
        TimeSeriesDB.build_stream(np.zeros(500, np.float32), SPEC,
                                  SearchConfig(), device="cpu")
    with pytest.raises(ValueError, match="subseq_window"):
        JaxDB.build_stream(np.zeros(500, np.float32), spec=JAX_SPEC,
                           config=JaxSearchConfig())
    for knob in (dict(subseq_window=64), dict(subseq_hop=2),
                 dict(exclusion_zone=0)):
        SearchConfig(**knob).validate()
        JaxSearchConfig(**knob).validate()
    with pytest.raises(ValueError, match="subseq_hop"):
        SearchConfig(subseq_hop=0).validate()


def test_series_less_index_folds_and_refuses_envelopes(sub):
    inner = sub.inner
    with pytest.raises(ValueError, match="stored series"):
        inner.candidate_envelopes(8)
    n = int(inner.signatures.shape[0])
    index = SSHIndex(encoder=inner.encoder, signatures=inner.signatures,
                     keys=inner.keys, series=None, build_backend="cpu")
    index.insert_encoded(None, inner.signatures[:3], inner.keys[:3])
    assert int(index.signatures.shape[0]) == n + 3 and index.series is None
    assert index.device == torch.device("cpu")
    full = SSHIndex(encoder=inner.encoder, signatures=inner.signatures[:2],
                    keys=inner.keys[:2], series=torch.zeros(2, L),
                    build_backend="cpu")
    with pytest.raises(ValueError, match="must include them"):
        full.insert_encoded(None, inner.signatures[:1], inner.keys[:1])
