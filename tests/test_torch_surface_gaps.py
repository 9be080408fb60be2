"""The gaps the surface walk (``test_torch_surface.py``) found, closed in
the port and held against ``repro`` (jnp) on the CPU.

Same numpy inputs and the same random state (the reference's, carried
across by ``repro_torch.convert``) in both packages.  Integers
(signatures, counts, ids, ``dtw_evals``, ``n_windows``) are held exact;
DTW distances to the float64 DP, the port at rtol 1e-6 and the reference
at 1e-4 (ROADMAP §3).  The ``backend`` knob: ``"auto"``, ``"pallas"``
and ``"jnp"`` give the default's bits on CPU tensors, ``"jnp"`` is
refused on a CUDA device (faked here by the device the check reads), and
an unknown name is refused everywhere.
"""
import dataclasses
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs.base import recsys_shapes as jax_recsys_shapes
from repro.core import SSHIndex as JaxIndex
from repro.core import SSHParams as JaxParams
from repro.core import search as jsearch
from repro.data.timeseries import extract_subsequences, synthetic_ecg
from repro.db import SearchConfig as JaxSearchConfig
from repro.db import TimeSeriesDB as JaxDB
from repro.db import config as jconfig
from repro.distributed import dist_index as jdist
from repro.encoders import IndexSpec as JaxIndexSpec
from repro.encoders import make_encoder as jax_make_encoder
from repro.launch import hlo_graph as jhlo
from repro.subseq import SubsequenceIndex as JaxSub
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer, restore_checkpoint
from repro_torch.configs.base import recsys_shapes
from repro_torch.core import index as tindex
from repro_torch.core import rerank as rr
from repro_torch.core import search
from repro_torch.core.dtw import dtw_dp_reference as dp
from repro_torch.core.index import HostBuckets, SSHIndex, SSHParams
from repro_torch.db import SearchConfig
from repro_torch.db import config as tconfig
from repro_torch.distributed import dist_index
from repro_torch.encoders import IndexSpec, make_encoder
from repro_torch.encoders.base import Encoder
from repro_torch.encoders.sigcache import SignatureCache, row_bytes
from repro_torch.kernels import ops
from repro_torch.launch import hlo_graph
from repro_torch.streaming.ingest import StreamIngestor
from repro_torch.subseq import SubsequenceIndex, rolling_signatures

jindex = importlib.import_module("repro.core.index")

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = torch.device("cpu")
FIELDS = dict(window=24, step=3, ngram=8, num_hashes=20, num_tables=10)
PARAMS = SSHParams(**FIELDS)
KNOBS = dict(topk=5, top_c=64, band=6, multiprobe_offsets=3)
N, M = 1024, 128
QIDS = [3, 70, 300, 512, 900]
BACKENDS = ("auto", "pallas", "jnp")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_text(text):
    return text.replace("repro.", "repro_torch.")


@pytest.fixture(scope="module")
def series():
    return extract_subsequences(synthetic_ecg(N * 16 + M, seed=4), M,
                                stride=16, max_count=N, znorm=True)


@pytest.fixture(scope="module")
def jfns():
    return jindex.SSHFunctions.create(JaxParams(**FIELDS))


@pytest.fixture(scope="module")
def fns(jfns):
    return convert.ssh_functions_from_arrays(
        jfns.params, np.asarray(jfns.filters),
        {f: np.asarray(getattr(jfns.cws, f)) for f in jfns.cws._fields},
        "cpu")


@pytest.fixture(scope="module")
def carried(series):
    """The reference's index and its port twin on the same state."""
    jdb = JaxDB.build(jnp.asarray(series), spec=JaxParams(**FIELDS).to_spec(),
                      config=JaxSearchConfig(backend="jnp", **KNOBS))
    ji = jdb.index
    index = convert.index_from_arrays(
        PARAMS.to_spec(), ji.enc.arrays(), np.asarray(ji.signatures),
        np.asarray(ji.keys), series, env_upper=np.asarray(ji.env_upper),
        env_lower=np.asarray(ji.env_lower), env_radius=ji.env_radius,
        device="cpu")
    return ji, index


def _held(series, qid, dists, band, rtol):
    exact = [dp(series[qid], series[i], band) for i in dists[0]]
    np.testing.assert_allclose(dists[1], exact, rtol=rtol)


# -- SearchResult.dtw_evals, SearchStats.n_windows ---------------------------

def test_dtw_evals_of_a_whole_series_search(series, carried):
    ji, index = carried
    for qid in QIDS:
        want = jsearch.ssh_search(jnp.asarray(series[qid]), ji,
                                  config=JaxSearchConfig(backend="jnp",
                                                         **KNOBS))
        got = search.ssh_search(series[qid], index, SearchConfig(**KNOBS))
        assert got.dtw_evals == want.dtw_evals == got.n_candidates
        assert got.stats.n_windows == want.stats.n_windows == 0
        np.testing.assert_array_equal(got.ids, want.ids)


SUB_SPEC = dict(window=24, step=3, ngram=8, num_filters=2, num_hashes=40,
                num_tables=20)
SUB_KNOBS = dict(topk=5, top_c=128, band=8, searcher="local",
                 subseq_window=128, subseq_hop=4)


@pytest.fixture(scope="module")
def subs():
    """The reference's subsequence index and the port's on its state."""
    stream = np.asarray(synthetic_ecg(3000, seed=3), np.float32)
    jsub = JaxSub.build(stream, JaxIndexSpec(encoder="ssh", params=SUB_SPEC),
                        length=128, hop=4, backend="jnp")
    spec = IndexSpec(encoder="ssh", params=SUB_SPEC)
    enc = convert.encoder_from_arrays(spec, jsub.inner.enc.arrays(), "cpu")
    sigs = rolling_signatures(_t(stream), enc, 128, 4)
    inner = SSHIndex(encoder=enc, signatures=sigs, keys=enc.band_keys(sigs),
                     series=None, build_backend="cpu")
    sub = SubsequenceIndex(inner=inner, stream=_t(stream), length=128, hop=4)
    return stream, jsub, sub


def test_dtw_evals_and_n_windows_of_a_subsequence_search(subs):
    stream, jsub, sub = subs
    for start in (1200, 800, 405):
        q = stream[start:start + 128]
        want = jsub.search(jnp.asarray(q), JaxSearchConfig(backend="jnp",
                                                           **SUB_KNOBS))
        got = sub.search(q, SearchConfig(**SUB_KNOBS))
        np.testing.assert_array_equal(got.ids, want.ids)
        assert got.dtw_evals == want.dtw_evals == got.n_candidates
        assert got.stats.n_windows == want.stats.n_windows == sub.num_windows
        assert got.n_windows == want.n_windows


# -- the SearchConfig InitVar shims ---------------------------------------

def test_flat_batcher_knobs_fold_into_the_policy_once():
    with pytest.warns(DeprecationWarning) as got:
        cfg = SearchConfig(max_batch=16, max_wait_ms=1.0)
    with pytest.warns(DeprecationWarning) as want:
        jcfg = JaxSearchConfig(max_batch=16, max_wait_ms=1.0)
    assert len(got) == 1 and got[0].filename == __file__
    assert str(got[0].message) == _port_text(str(want[0].message))
    assert dataclasses.asdict(cfg.batch_policy) == \
        dataclasses.asdict(jcfg.batch_policy)
    assert cfg.to_dict() == jcfg.to_dict()
    # not readable back, as the reference's; replace keeps the policy
    assert cfg.max_batch is None and jcfg.max_batch is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cfg.replace(topk=5).batch_policy == cfg.batch_policy
        assert SearchConfig(batch_policy=cfg.batch_policy) == cfg
    # the loose-kwarg shim folds the two names with one warning
    kw = {"max_batch": 16, "max_wait_ms": 1.0, "topk": 5}
    for mod in (tconfig, jconfig):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            folded = mod.config_from_legacy_kwargs("f", dict(kw))
        assert len(w) == 1 and folded.topk == 5
        assert dataclasses.asdict(folded.batch_policy) == \
            dataclasses.asdict(cfg.batch_policy)


# -- SSHIndex(fns=...) and .enc --------------------------------------------

def test_fns_built_index_searches_as_the_reference(series, jfns, fns,
                                                   carried):
    _, index = carried
    jsigs = jindex.build_signatures(jnp.asarray(series), jfns)
    jidx = JaxIndex(fns=jfns, signatures=jsigs,
                    keys=jindex.band_keys(jsigs, jfns.params),
                    series=jnp.asarray(series))
    sigs = tindex.build_signatures(series, fns)
    idx = SSHIndex(fns=fns, signatures=sigs,
                   keys=tindex.band_keys(sigs, PARAMS), series=_t(series),
                   build_backend="cpu")
    # the encoder adopts fns' tensors: no copy, the same hashing
    assert idx.enc is idx.encoder
    assert idx.enc.state()["filters"].data_ptr() == fns.filters.data_ptr()
    assert idx.fns.params == PARAMS
    np.testing.assert_array_equal(sigs.numpy(), np.asarray(jsigs))
    cfg = SearchConfig(**KNOBS)
    jcfg = JaxSearchConfig(backend="jnp", **KNOBS)
    for qid in QIDS:
        want = jsearch.ssh_search(jnp.asarray(series[qid]), jidx,
                                  config=jcfg)
        got = search.ssh_search(series[qid], idx, cfg)
        enc_built = search.ssh_search(series[qid], index, cfg)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.ids, enc_built.ids)
        _held(series, qid, (got.ids, got.dists), KNOBS["band"], 1e-6)
        _held(series, qid, (got.ids, np.asarray(want.dists)), KNOBS["band"],
              1e-4)
        assert got.dtw_evals == want.dtw_evals


def test_fns_construction_forms_and_refusals(series, fns):
    sigs = tindex.build_signatures(series[:64], fns)
    keys = tindex.band_keys(sigs, PARAMS)
    by_position = SSHIndex(fns, sigs, keys, _t(series[:64]))
    assert by_position.fns.params == PARAMS
    assert torch.equal(by_position.query_signature(_t(series[5])), sigs[5])
    with pytest.raises(TypeError, match="encoder= or the legacy fns="):
        SSHIndex(signatures=sigs, keys=keys)
    with pytest.raises(TypeError, match="twice"):
        SSHIndex(fns, sigs, keys, _t(series[:64]), fns=fns)
    with pytest.raises(TypeError, match="signatures= and keys="):
        SSHIndex(fns=fns)
    # dataclasses.replace re-feeds the view and keeps the encoder
    again = dataclasses.replace(by_position, series=None)
    assert again.encoder is by_position.encoder and again.series is None


def test_host_bucket_tables_read_as_the_reference(carried):
    ji, index = carried
    want = jindex.HostBuckets(index.num_tables)
    want.insert(np.asarray(ji.keys))
    got = HostBuckets(index.num_tables)
    got.insert(index.keys[:600])
    got.insert(index.keys[600:], base_id=600)
    assert got.tables == [dict(t) for t in want.tables]


# -- make_encoder(materialize=), SignatureCache.key(series) ----------------

def test_make_encoder_without_state_then_loaded():
    spec = PARAMS.to_spec()
    jenc = jax_make_encoder(JaxParams(**FIELDS).to_spec())
    bare = make_encoder(spec, materialize=False)
    assert not bare.materialized
    assert not jax_make_encoder(JaxParams(**FIELDS).to_spec(),
                                materialize=False).materialized
    enc = bare.load_arrays(jenc.arrays(), "cpu")
    x = np.random.default_rng(0).normal(size=(6, M)).astype(np.float32)
    np.testing.assert_array_equal(enc.encode_batch(_t(x)).numpy(),
                                  np.asarray(jenc.encode_batch(
                                      jnp.asarray(x), backend="jnp")))


def test_signature_cache_keys_a_series_as_its_row_bytes(carried):
    """A series, its tensor and its row bytes give one key, the one the
    port's callers make, so hits and misses do not change."""
    _, index = carried
    spec = index.encoder.spec
    q = np.random.default_rng(1).normal(size=M)
    content = row_bytes(q)[0]
    key = SignatureCache.key(content, spec, "cpu", "sig")
    for form in (q, q.astype(np.float32), torch.from_numpy(q), list(q)):
        assert SignatureCache.key(form, spec, "cpu", "sig") == key
    assert SignatureCache.key(q[None], spec, "cpu", "sig") != key
    index.sig_cache = None
    _, hit = index.query_signature_cached(_t(q.astype(np.float32)))
    assert not hit and index.sig_cache.get(key) is not None
    _, hit = index.query_signature_cached(_t(q.astype(np.float32)), content)
    assert hit


# -- the backend knob -------------------------------------------------------

def _equal_for_every_backend(call):
    want = call()
    for b in BACKENDS:
        got = call(backend=b)
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError, match="backend must be one of"):
        call(backend="bogus")


def test_encoder_backend_gives_the_default_bits(series, carried):
    _, index = carried
    x = _t(series[:40])
    srp = make_encoder(IndexSpec(encoder="srp", params=dict(num_hashes=16,
                                                            num_tables=4)),
                       "cpu", length=M)
    cs = make_encoder(IndexSpec(encoder="ssh-cs", params=dict(
        window=24, step=3, ngram=8, num_hashes=20, num_tables=10, rows=2,
        width=128)), "cpu")
    for enc in (index.encoder, srp, cs):
        _equal_for_every_backend(lambda **kw: enc.encode(x[0], **kw))
        _equal_for_every_backend(lambda **kw: enc.encode_batch(x, **kw))
        _equal_for_every_backend(
            lambda **kw: enc.encode_chunked(x, 16, **kw))
    for enc in (index.encoder, cs):
        _equal_for_every_backend(
            lambda **kw: enc.encode_multiprobe(x[0], 3, **kw))
        _equal_for_every_backend(
            lambda **kw: enc.encode_batch_multiprobe(x[:5], 3, **kw))
    _equal_for_every_backend(lambda **kw: cs.sketch_batch(x, 16, **kw))


def test_search_backend_gives_the_default_ids(series, carried):
    _, index = carried
    q = _t(series[QIDS[1]])
    cand = search.hash_probe(q, index, 64)
    _equal_for_every_backend(lambda **kw: search.hash_probe(q, index, 64,
                                                            **kw))
    _equal_for_every_backend(lambda **kw: rr.dtw_candidates(
        q, index.series[cand], 6, **kw))
    _equal_for_every_backend(lambda **kw: rr.rerank(
        q, cand, index, 5, 6, **kw)[:2])
    qs = _t(series[QIDS])
    ids = torch.stack([search.hash_probe(_t(series[i]), index, 64)
                       for i in QIDS])
    _equal_for_every_backend(lambda **kw: rr.rerank_batch(
        qs, ids, torch.ones_like(ids, dtype=torch.bool), index, 5, 6,
        **kw)[:3])

    def ucr(**kw):
        r = search.ucr_search(q, index.series, topk=5, band=6, **kw)
        return r.ids, r.dists, r.dtw_evals
    _equal_for_every_backend(ucr)


def test_build_backend_gives_the_default_index(series):
    spec = PARAMS.to_spec()
    _equal_for_every_backend(lambda **kw: SSHIndex.build(
        series[:200], spec=spec, device="cpu", **kw).signatures)
    stream = np.asarray(synthetic_ecg(1500, seed=3), np.float32)
    enc = make_encoder(spec, "cpu")
    _equal_for_every_backend(lambda **kw: rolling_signatures(
        stream, enc, 128, 4, **kw))
    _equal_for_every_backend(lambda **kw: SubsequenceIndex.build(
        stream, spec, length=128, hop=4, device="cpu",
        **kw).inner.signatures)

    def ingest(**kw):
        ing = StreamIngestor(enc, **kw)
        ing.append(series[:30])
        merged = ing.merge(StreamIngestor(enc, **kw))
        assert merged.backend == ing.backend == kw.get("backend", "auto")
        return torch.cat([s.signatures for s in merged._segments])
    _equal_for_every_backend(ingest)


def test_jnp_backend_is_refused_on_a_cuda_device(monkeypatch, series,
                                                 carried):
    """The check reads the device the work would run on; faked to CUDA,
    ``"jnp"`` raises before anything runs, ``"auto"`` passes."""
    _, index = carried
    enc = index.encoder
    x = _t(series[:4])
    cuda = torch.device("cuda")
    monkeypatch.setattr(Encoder, "device", property(lambda self: cuda))
    monkeypatch.setattr(SSHIndex, "device", property(lambda self: cuda))
    monkeypatch.setattr(ops, "resolve_device", lambda device=None: cuda)
    calls = (lambda b: enc.encode(x[0], backend=b),
             lambda b: enc.encode_batch(x, backend=b),
             lambda b: enc.encode_chunked(x, backend=b),
             lambda b: enc.encode_multiprobe(x[0], 2, backend=b),
             lambda b: enc.encode_batch_multiprobe(x, 2, backend=b),
             lambda b: StreamIngestor(enc, backend=b),
             lambda b: rolling_signatures(x.reshape(-1), enc, 128, 4,
                                          backend=b),
             lambda b: search.hash_probe(x[0], index, 8, backend=b),
             lambda b: rr.rerank(x[0], torch.arange(8), index, 5, 6,
                                 backend=b),
             lambda b: rr.rerank_batch(x, torch.zeros(4, 8, dtype=torch.long),
                                       torch.ones(4, 8, dtype=torch.bool),
                                       index, 5, 6, backend=b),
             lambda b: SSHIndex.build(series[:8], spec=PARAMS.to_spec(),
                                      backend=b),
             lambda b: SubsequenceIndex.build(series[0], PARAMS.to_spec(),
                                              length=64, backend=b))
    for call in calls:
        with pytest.raises(ValueError, match="device='cpu'"):
            call("jnp")
    with pytest.raises(ValueError, match="device='cpu'"):
        ops.check_backend("jnp", torch.device("cuda"))
    assert enc.encode_batch(x, backend="auto").shape == (4, 20)


def test_build_index_backend_flag(tmp_path, monkeypatch):
    from repro_torch.db import TimeSeriesDB
    from repro_torch.launch import build_index
    argv = ["--points", "600", "--length", "128", "--device", "cpu"]
    build_index.main(argv + ["--out", str(tmp_path / "auto")])
    build_index.main(argv + ["--backend", "jnp", "--out",
                             str(tmp_path / "jnp")])
    a = TimeSeriesDB.load(tmp_path / "auto", device="cpu")
    b = TimeSeriesDB.load(tmp_path / "jnp", device="cpu")
    assert torch.equal(a.index.signatures, b.index.signatures)
    assert build_index.parse_args(["--out", "x"]).backend == "auto"
    monkeypatch.setattr(ops, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(ValueError, match="device='cpu'"):
        build_index.main(["--backend", "jnp", "--out", str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()


# -- the rest: recsys_shapes, restore_latest, build_sharded, Cost.add,
#    serve_lm's keywords --------------------------------------------------

def test_recsys_shapes_take_seq_len():
    for seq_len in (0, 20):
        got, want = recsys_shapes(seq_len), jax_recsys_shapes(seq_len)
        assert list(got) == list(want)
        for name in got:
            assert got[name].kind == want[name].kind
            assert got[name].meta == want[name].meta


def test_restore_latest_places_leaves_as_restore_checkpoint(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones(4, np.int32), "d": np.zeros(2, np.float32)}}
    ck = Checkpointer(tmp_path)
    assert ck.restore_latest(tree, shardings={"a": "cpu"}) == (None, tree)
    ck.save(3, tree)
    ck.save(5, {**tree, "a": tree["a"] + 1})
    ck.wait()
    where = {"a": "cpu", "b": {"c": CPU}}
    step, got = ck.restore_latest(tree, shardings=where)
    step_w, want = restore_checkpoint(tmp_path, tree, shardings=where)
    assert step == step_w == 5
    assert isinstance(got["a"], torch.Tensor) and got["a"].device == CPU
    assert isinstance(got["b"]["c"], torch.Tensor)
    assert isinstance(got["b"]["d"], np.ndarray)
    for path in (("a",), ("b", "c"), ("b", "d")):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        assert type(g) is type(w)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # the reference's restore_latest reads the same step and values
    jstep, jtree = JaxCheckpointer(str(tmp_path)).restore_latest(tree)
    assert jstep == 5
    np.testing.assert_array_equal(np.asarray(jtree["a"]), tree["a"] + 1)
    np.testing.assert_array_equal(np.asarray(got["a"]), tree["a"] + 1)


def test_legacy_build_sharded_and_make_query_fn_params(series, jfns, fns):
    mesh = jax.make_mesh((1,), ("data",))
    want = np.asarray(jdist.build_sharded(jnp.asarray(series), jfns.filters,
                                          jfns.cws._asdict(), jfns.params,
                                          mesh))
    cws = fns.cws._asdict()
    for shards in (1, 4):
        cpu_mesh = [CPU] * shards
        for got in (
                dist_index.build_sharded(_t(series), fns.filters, cws,
                                         PARAMS, cpu_mesh),
                dist_index.build_sharded(_t(series), filters=fns.filters,
                                         cws=fns.cws, params=PARAMS,
                                         mesh=cpu_mesh),
                dist_index.build_sharded(_t(series),
                                         tindex.encoder_of(fns), cpu_mesh)):
            assert len(got) == shards
            np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    with pytest.raises(TypeError):
        dist_index.build_sharded(_t(series), fns.filters, cws, PARAMS,
                                 [CPU], encoder=tindex.encoder_of(fns))
    knobs = dict(top_c=64, band=6, topk=5)
    jq = jdist.make_query_fn(jfns.params, mesh, length=M,
                             config=JaxSearchConfig(backend="jnp", **knobs))
    q_fn = dist_index.make_query_fn(params=PARAMS, mesh=[CPU], length=M,
                                    config=SearchConfig(**knobs))
    sigs = torch.from_numpy(np.array(want))
    for qid in QIDS:
        jids, jd = jq(jnp.asarray(series), jnp.asarray(want), jfns.filters,
                      jfns.cws._asdict(), jnp.asarray(series[qid]))
        ids, d = q_fn([_t(series)], [sigs], fns.filters, cws,
                      _t(series[qid]))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        _held(series, qid, (ids.numpy(), d.numpy()), 6, 1e-6)
        _held(series, qid, (ids.numpy(), np.asarray(jd)), 6, 1e-4)


def test_cost_add_as_the_reference():
    got, want = hlo_graph.Cost(dot_flops=3.0), jhlo.Cost(dot_flops=3.0)
    other, jother = hlo_graph.Cost(dot_flops=2.0), jhlo.Cost(dot_flops=2.0)
    for c in (other, jother):
        c.coll_bytes["all-reduce"] = 8.0
        c.coll_counts["all-gather"] = 1.0
    got.add(other, mult=4.0)
    want.add(jother, mult=4.0)
    got.add(other)
    want.add(jother)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_coll_bytes == want.total_coll_bytes == 40.0


def test_serve_lm_takes_the_reference_names():
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import serve_lm
    arch = get_arch("granite-3-2b")
    by_name = serve_lm(arch=arch, requests=1, smoke=True, gen_len=2,
                       device="cpu")
    by_position = serve_lm(arch, 1, True, gen_len=2, device="cpu")
    assert torch.equal(by_name.generated, by_position.generated)
    with pytest.raises(TypeError, match="not both"):
        serve_lm(arch.smoke_config, arch=arch, device="cpu")
    with pytest.raises(TypeError, match="needs an LMConfig"):
        serve_lm(device="cpu")
