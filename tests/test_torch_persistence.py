"""Saved databases and checkpoints read across the two packages, on the
CPU.

A directory written by the JAX package (``backend="jnp"``) loads in the
port and one written by the port loads in the JAX package, in format v2
and in the older v1; both then give the same top-k ids through the
``batched`` and ``local`` searchers.  Distances are held to the float64
DP (``dtw_dp_reference``): the port's at rtol 1e-6, the reference's at
1e-4 (its float32 DP is the looser one; ROADMAP.md §3).  Checkpoints
read across with one and two shards; tampered metas are refused by both;
the ``arrays`` block of the meta is the same whichever package saved
the same index.
"""
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs.ssh_ecg import SMOKE as JAX_SMOKE
from repro.core.dtw import dtw_dp_reference
from repro.data.timeseries import make_benchmark_db, warp_series
from repro.db import SearchConfig as JaxSearchConfig
from repro.db import TimeSeriesDB as JaxDB
from repro.encoders import IndexSpec as JaxIndexSpec
from repro_torch import checkpoint
from repro_torch.configs.ssh_ecg import SMOKE
from repro_torch.db import SearchConfig, TimeSeriesDB, persistence
from repro_torch.encoders import IndexSpec

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

QIDS = [3, 150, 333, 480]
KNOBS = dict(topk=10, top_c=64, band=6, multiprobe_offsets=3)
PARAMS_CS = dict(SMOKE.params, rows=4, width=1024, base_bits=4)


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


@pytest.fixture(scope="module")
def jax_saved(series, tmp_path_factory):
    """(directory, database) saved by the JAX package."""
    jdb = JaxDB.build(jnp.asarray(series), spec=JAX_SMOKE.to_spec(),
                      config=JaxSearchConfig(backend="jnp", **KNOBS))
    d = tmp_path_factory.mktemp("jax_db")
    jdb.save(d)
    return d, jdb


@pytest.fixture(scope="module")
def port_saved(series, tmp_path_factory):
    """(directory, database) saved by the port."""
    db = TimeSeriesDB.build(series, SMOKE, SearchConfig(**KNOBS),
                            device="cpu")
    d = tmp_path_factory.mktemp("port_db")
    db.save(d)
    return d, db


def _meta(d):
    return json.loads((d / persistence.META_FILE).read_text())


def _same_answers(port_db, jax_db, queries, searcher):
    """Both databases through ``searcher``: equal ids, distances held to
    the float64 DP."""
    got = port_db.with_config(port_db.config.replace(
        searcher=searcher)).search_batch(queries)
    want = jax_db.with_config(jax_db.config.replace(
        searcher=searcher)).search_batch(jnp.asarray(queries))
    series = port_db.index.series.numpy()
    for q, g, w in zip(queries, got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        exact = [dtw_dp_reference(q, series[i], port_db.config.band)
                 for i in g.ids]
        np.testing.assert_allclose(g.dists, exact, rtol=1e-6)
        np.testing.assert_allclose(w.dists, exact, rtol=1e-4)
    return got


@pytest.mark.parametrize("searcher", ["batched", "local"])
def test_reference_database_loads_in_the_port(jax_saved, queries,
                                              searcher):
    d, jdb = jax_saved
    db = TimeSeriesDB.load(d, device="cpu")
    assert db.config.backend == "jnp" and db.spec == SMOKE
    np.testing.assert_array_equal(db.index.signatures.numpy(),
                                  np.asarray(jdb.index.signatures))
    np.testing.assert_array_equal(db.index.keys.numpy().view(np.uint32),
                                  np.asarray(jdb.index.keys))
    assert db.index.env_radius == jdb.index.env_radius == KNOBS["band"]
    _same_answers(db, jdb, queries, searcher)


@pytest.mark.parametrize("searcher", ["batched", "local"])
def test_port_database_loads_in_the_reference(port_saved, queries,
                                              searcher):
    d, db = port_saved
    jdb = JaxDB.load(d)
    meta = _meta(d)
    assert meta["build_backend"] == "jnp"          # the reference's knob
    assert meta[persistence.ROUTE_KEY] == "cpu"    # the port's own
    assert jdb.index.build_backend == "jnp"
    assert JaxIndexSpec.from_dict(meta["spec"]) == jdb.spec
    np.testing.assert_array_equal(np.asarray(jdb.index.keys),
                                  db.index.keys.numpy().view(np.uint32))
    _same_answers(db, jdb, queries, searcher)


def _to_v1(src, dst):
    """Rewrite a v2 directory into the v1 form
    (``repro/db/persistence.py:107-121``): SSHParams fields in
    ``params``, encoder leaves at the top level."""
    meta = _meta(src)
    tree_like = {k: np.zeros(v["shape"], np.dtype(v["dtype"]))
                 for k, v in meta["arrays"].items()}
    _, arrays = jax_restore(src / "index", tree_like,
                            step=meta["checkpoint_step"])
    arrays = {k.removeprefix("encoder/"): np.asarray(v)
              for k, v in arrays.items()}
    jax_save(dst / "index", 0, arrays, keep=2)
    spec = meta.pop("spec")
    meta.update(format_version=1, checkpoint_step=0,
                params=dict(spec["params"], seed=spec["seed"]),
                arrays={k.removeprefix("encoder/"): v
                        for k, v in meta["arrays"].items()})
    (dst / persistence.META_FILE).write_text(json.dumps(meta))


def test_v1_directory_reads_in_both(jax_saved, queries, tmp_path):
    src, jdb = jax_saved
    _to_v1(src, tmp_path)
    db = TimeSeriesDB.load(tmp_path, device="cpu")
    jv1 = JaxDB.load(tmp_path)
    assert db.spec == SMOKE and jv1.spec == jdb.spec
    got = _same_answers(db, jv1, queries, "batched")
    want = jdb.search_batch(jnp.asarray(queries))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)


def test_sshcs_aggregate_carries_across(series, tmp_path):
    """A reference ``"ssh-cs"`` database with a live ``cs/agg``, loaded by
    both packages; one more chunk ingested into each gives equal
    signatures and aggregates, and the port's re-save reads back in the
    reference with the same aggregate."""
    jdb = JaxDB.build(jnp.asarray(series[:400]),
                      spec=JaxIndexSpec(encoder="ssh-cs", params=PARAMS_CS),
                      config=JaxSearchConfig(backend="jnp", **KNOBS))
    jdb.add_stream(jnp.asarray(series[400:500]))
    jdb.flush()
    jdb.save(tmp_path / "ref")
    db = TimeSeriesDB.load(tmp_path / "ref", device="cpu")
    jl = JaxDB.load(tmp_path / "ref")
    np.testing.assert_array_equal(
        db.index.encoder.aggregate_sketch().numpy(),
        np.asarray(jdb.index.enc.aggregate_sketch()))
    for d in (db, jl):
        d.add_stream(series[500:])
        d.flush()
    np.testing.assert_array_equal(db.index.signatures.numpy(),
                                  np.asarray(jl.index.signatures))
    np.testing.assert_array_equal(db.index.keys.numpy().view(np.uint32),
                                  np.asarray(jl.index.keys))
    agg = np.asarray(jl.index.enc.aggregate_sketch())
    assert np.abs(agg).sum() > 0
    np.testing.assert_array_equal(
        db.index.encoder.aggregate_sketch().numpy(), agg)
    db.save(tmp_path / "port")
    back = JaxDB.load(tmp_path / "port")
    np.testing.assert_array_equal(
        np.asarray(back.index.enc.aggregate_sketch()), agg)
    # the encoder leaves (uint32 hash coefficients among them) are saved
    # with the reference's names, shapes and dtypes
    enc_leaves = [{k: v for k, v in _meta(tmp_path / d)["arrays"].items()
                   if k.startswith("encoder/")} for d in ("port", "ref")]
    assert enc_leaves[0] == enc_leaves[1]
    assert enc_leaves[0]["encoder/cs/bucket_a"]["dtype"] == "uint32"


@pytest.mark.parametrize("n_shards", [1, 2])
def test_checkpoints_read_across_packages(tmp_path, n_shards):
    rng = np.random.default_rng(0)
    tree = {"sigs": rng.integers(-9, 9, (6, 4)).astype(np.int32),
            "nested": {"b": rng.normal(size=(6,)).astype(np.float32),
                       "a": rng.normal(size=(3, 2)).astype(np.float32)},
            "done": np.asarray(5, np.int32)}
    like = {"sigs": np.zeros((6, 4), np.int32),
            "nested": {"b": np.zeros(6, np.float32),
                       "a": np.zeros((3, 2), np.float32)},
            "done": np.zeros((), np.int32)}
    checkpoint.save_checkpoint(tmp_path / "port", 7, tree,
                               n_shards=n_shards)
    jax_save(tmp_path / "ref", 7, tree, n_shards=n_shards)
    for src in ("port", "ref"):
        m = json.loads((tmp_path / src / "step_0000000007" /
                        "manifest.json").read_text())
        assert m["n_shards"] == n_shards
        assert list(m["arrays"]) == ["done", "nested/a", "nested/b", "sigs"]
        step, jgot = jax_restore(tmp_path / src, like)
        step2, got = checkpoint.restore_checkpoint(tmp_path / src, like)
        assert step == step2 == 7
        for k in ("sigs", "done"):
            np.testing.assert_array_equal(np.asarray(jgot[k]), tree[k])
            np.testing.assert_array_equal(got[k], tree[k])
        for k in ("a", "b"):
            np.testing.assert_array_equal(got["nested"][k],
                                          tree["nested"][k])
            np.testing.assert_array_equal(np.asarray(jgot["nested"][k]),
                                          tree["nested"][k])
    with pytest.raises(ValueError, match="checkpoint shape"):
        checkpoint.restore_checkpoint(tmp_path / "ref",
                                      {**like, "sigs": np.zeros((5, 4))})
    ck = checkpoint.Checkpointer(tmp_path / "async", keep=2,
                                 async_save=True, n_shards=n_shards)
    for s in range(4):
        ck.save(s, {**tree, "done": np.asarray(s, np.int32)})
    ck.wait()
    assert checkpoint.all_steps(tmp_path / "async") == [2, 3]
    step, got = ck.restore_latest(like)
    assert step == 3 and int(got["done"]) == 3


@pytest.mark.parametrize("tamper", ["num_hashes", "encoder", "version",
                                    "leaf"])
def test_tampered_metas_are_refused(port_saved, tmp_path, tamper):
    src, _ = port_saved
    d = tmp_path / "db"
    shutil.copytree(src, d)
    meta = _meta(d)
    if tamper == "num_hashes":
        meta["spec"]["params"]["num_hashes"] = 40
    elif tamper == "encoder":
        meta["spec"] = {"encoder": "srp", "params": {}, "seed": 7}
    elif tamper == "version":
        meta["format_version"] = 3
    else:
        del meta["arrays"]["encoder/cws/beta"]
    (d / persistence.META_FILE).write_text(json.dumps(meta))
    with pytest.raises(ValueError):
        TimeSeriesDB.load(d, device="cpu")
    with pytest.raises(ValueError):
        JaxDB.load(d)


def test_resave_after_add(port_saved, series, queries, tmp_path):
    src, _ = port_saved
    d = tmp_path / "db"
    shutil.copytree(src, d)
    db = TimeSeriesDB.load(d, device="cpu")
    db.add(queries[2:])
    want = db.search_batch(queries)
    db.save(d)
    db.save(d)
    assert checkpoint.all_steps(d / "index") == [1, 2]
    again = TimeSeriesDB.load(d, device="cpu")
    assert len(again) == len(series) + 2
    for g, w in zip(again.search_batch(queries), want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.dists, w.dists)
    assert int(again.search(queries[3]).ids[0]) == len(series) + 1
    assert len(JaxDB.load(d)) == len(series) + 2


def test_arrays_block_is_the_same_whichever_package_saved(jax_saved,
                                                          tmp_path):
    src, _ = jax_saved
    TimeSeriesDB.load(src, device="cpu").save(tmp_path)
    ref, port = _meta(src), _meta(tmp_path)
    assert port["arrays"] == ref["arrays"]
    assert port["spec"] == ref["spec"] and port["config"] == ref["config"]
    assert port["arrays"]["keys"]["dtype"] == "uint32"
    assert set(port) - set(ref) == {persistence.ROUTE_KEY}


def test_saved_spec_reads_in_both_packages():
    spec = IndexSpec(encoder="ssh-multires", params=dict(ngrams=[6, 8]))
    assert JaxIndexSpec.from_dict(spec.to_dict()).to_dict() == \
        spec.to_dict()
    assert hash(spec) == hash(IndexSpec.from_dict(spec.to_dict()))
