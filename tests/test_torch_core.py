"""The port's core modules against ``repro.core`` (jnp), on the CPU.

Same numpy inputs for both packages.  Integer outputs (shingle ids,
histograms, band keys) must be exact; envelopes exact (max/min);
lower bounds rtol 1e-5 (float32 sums in another order); CWS hashes
agree on at least 99.9 % of entries (the reference's XLA ``log`` is one
ulp off on a few integers, see ``repro_torch.core.minhash``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lower_bounds as jlb
from repro.core import minhash as jmh
from repro.core import shingle as jsh
from repro.core import sketch as jsk
from repro.db import SearchConfig as JaxSearchConfig
from repro.encoders import IndexSpec as JaxIndexSpec
from repro_torch import convert
from repro_torch.configs import ssh_ecg
from repro_torch.core import lower_bounds as lb
from repro_torch.core import minhash, shingle, sketch
from repro_torch.db import SearchConfig, make_searcher
from repro_torch.encoders import IndexSpec, SSHEncoder
from repro_torch.kernels import ops

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)


def _walks(n, m, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, m)).cumsum(1).astype(np.float32)


@pytest.mark.parametrize("radius", [1, 4, 11])
def test_envelope_exact(radius):
    x = _walks(6, 40, radius)
    u, l = lb.envelope(torch.from_numpy(x), radius)
    ju, jl = jlb.envelope(jnp.asarray(x), radius)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))


def test_lower_bounds_match_jax():
    r, m = 5, 64
    q = _walks(1, m, 1)[0]
    cands = _walks(30, m, 2)
    tq, tc = torch.from_numpy(q), torch.from_numpy(cands)
    jq, jc = jnp.asarray(q), jnp.asarray(cands)
    cu, cl = lb.envelope(tc, r)
    pairs = [
        (lb.lb_kim(tq, tc), jlb.lb_kim(jq, jc)),
        (lb.lb_keogh_env(tq, cu, cl),
         jlb.lb_keogh_env(jq, jnp.asarray(cu.numpy()),
                          jnp.asarray(cl.numpy()))),
        (lb.lb_keogh2(tq, tc, r), jlb.lb_keogh2(jq, jc, r)),
        (lb.lb_improved(tq, tc, r), jlb.lb_improved(jq, jc, r)),
        (lb.lb_improved_pairs(tq.expand(30, m), tc, r),
         jlb.lb_improved_pairs(jnp.broadcast_to(jq, (30, m)), jc, r)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_cascade_staged_matches_jax():
    r, m = 4, 48
    qs = _walks(3, m, 7)
    cands = _walks(3 * 25, m, 8).reshape(3, 25, m)
    best = np.array([40.0, 90.0, 400.0], np.float32)
    got = lb.cascade_staged(torch.from_numpy(qs), torch.from_numpy(cands), r,
                            torch.from_numpy(best))
    for b in range(3):
        want = jlb.cascade_staged(jnp.asarray(qs[b]), jnp.asarray(cands[b]),
                                  r, jnp.float32(best[b]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


def test_sketch_bits_and_shingles_exact():
    rng = np.random.default_rng(3)
    x = _walks(5, 128, 3)
    filt = rng.normal(size=(24, 2)).astype(np.float32)
    bits = sketch.sketch_bits(torch.from_numpy(x), torch.from_numpy(filt), 3)
    jbits = np.asarray(jsk.sketch_bits(jnp.asarray(x), jnp.asarray(filt), 3))
    flips = int((bits.numpy() != jbits).sum())
    print(f"sketch sign flips vs jax: {flips} of {jbits.size}")
    assert flips <= jbits.size // 1000
    assert sketch.num_sketch_bits(128, 24, 3) == jsk.num_sketch_bits(128, 24,
                                                                     3)
    b0 = jbits[0].copy()                                 # (N_B, F)
    np.testing.assert_array_equal(
        shingle.pack_ngrams(torch.from_numpy(b0.T), 8).numpy(),
        np.asarray(jsh.pack_ngrams(jnp.asarray(b0.T), 8)))
    np.testing.assert_array_equal(
        shingle.shingle_histogram(torch.from_numpy(b0), 8).numpy(),
        np.asarray(jsh.shingle_histogram(jnp.asarray(b0), 8)))
    for valid in (8, 20, 35):
        np.testing.assert_array_equal(
            shingle.shingle_histogram_masked(torch.from_numpy(b0), 8,
                                             valid).numpy(),
            np.asarray(jsh.shingle_histogram_masked(jnp.asarray(b0), 8,
                                                    valid)))


def _cws_state(k, d, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-12, 1.0, size=(4, k, d)).astype(np.float32)
    r = -np.log(u[0]) - np.log(u[1])
    c = -np.log(u[2]) - np.log(u[3])
    beta = rng.uniform(size=(k, d)).astype(np.float32)
    return dict(log_r=np.log(r), r=r, log_c=np.log(c), beta=beta)


def test_cws_hash_agreement_and_active_form():
    k, d = 20, 256
    fields = _cws_state(k, d, 4)
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 9, size=(300, d)) \
        * (rng.uniform(size=(300, d)) < 0.1)
    counts = counts.astype(np.int32)
    tparams = minhash.CWSParams(**{f: torch.from_numpy(v)
                                   for f, v in fields.items()})
    jparams = jmh.CWSParams(**{f: jnp.asarray(v) for f, v in fields.items()})
    got = minhash.cws_hash(torch.from_numpy(counts), tparams).numpy()
    want = np.stack([np.asarray(jmh.cws_hash(jnp.asarray(c), jparams))
                     for c in counts])
    rate = float(np.mean(got == want))
    print(f"cws_hash agreement with jax: {rate:.6f} "
          f"({int(np.sum(got != want))} of {got.size} hashes differ)")
    assert rate >= 0.999
    # the active-element form used by the encoder equals the dense form
    ids = np.full((300, 40), d, np.int64)
    for i, row in enumerate(counts):
        nz = np.repeat(np.nonzero(row)[0], row[row > 0])[:40]
        ids[i, :len(nz)] = rng.permutation(nz)
    tids = torch.from_numpy(ids)
    dense = shingle.histogram_from_ids(tids, d)
    np.testing.assert_array_equal(
        minhash.cws_hash_active(tids, tparams).numpy(),
        minhash.cws_hash(dense, tparams).numpy())


def test_combine_bands_exact():
    rng = np.random.default_rng(6)
    sigs = rng.integers(0, 1 << 15, size=(50, 40)).astype(np.int32)
    want = np.asarray(jmh.combine_bands(jnp.asarray(sigs), 20))
    got = minhash.combine_bands(torch.from_numpy(sigs), 20).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_random_state_draws_the_reference_distributions():
    enc = SSHEncoder(ssh_ecg.SMOKE).materialize("cpu")
    st = enc._require_state()
    assert tuple(st["filters"].shape) == (24, 1)
    assert bool((st["cws/r"] > 0).all())
    assert bool(((st["cws/beta"] >= 0) & (st["cws/beta"] < 1)).all())
    # Gamma(2, 1) has mean 2
    assert float(st["cws/r"].mean()) == pytest.approx(2.0, rel=0.05)
    again = SSHEncoder(ssh_ecg.SMOKE).materialize("cpu")._require_state()
    assert all(torch.equal(st[k], again[k]) for k in st)


def test_config_and_spec_read_like_the_reference():
    spec = ssh_ecg.CONFIG
    assert spec.to_dict() == JaxIndexSpec.from_dict(spec.to_dict()).to_dict()
    assert IndexSpec.from_dict(spec.to_dict()) == spec
    jcfg = dataclasses.asdict(JaxSearchConfig())
    for k, v in SearchConfig().to_dict().items():
        assert jcfg[k] == v, k
    assert jcfg["searcher"] == "batched"     # the default in both
    assert ssh_ecg.search_config(length=512).band == 25
    with pytest.raises(ValueError):
        SearchConfig(top_c=5, topk=10).validate()
    SearchConfig(searcher="local").validate()
    # the name is checked by the registry, as the reference's: queued
    # searchers are refused by make_searcher, not by validate
    SearchConfig(searcher="distributed").validate()
    with pytest.raises(ValueError, match="queued in ROADMAP"):
        make_searcher(None, SearchConfig(searcher="distributed"))
    with pytest.raises(ValueError, match="backend must be one of"):
        SearchConfig(backend="cuda").validate()
    with pytest.raises(ValueError, match="device='cpu'"):
        ops.check_backend("jnp", torch.device("cuda"))
    for backend in ("auto", "pallas", "jnp"):
        ops.check_backend(backend, torch.device("cpu"))
    with pytest.raises(ValueError, match="backend must be one of"):
        ops.check_backend("cuda", torch.device("cpu"))


def test_multiprobe_offset_checks_match_reference():
    enc = SSHEncoder(ssh_ecg.SMOKE).materialize("cpu")
    q = torch.zeros((1, 40))
    with pytest.raises(ValueError, match="too short"):
        enc.encode_batch_multiprobe(q[:, :25], 3)
    with pytest.raises(ValueError, match="fewer than the shingle length"):
        enc.encode_batch_multiprobe(q, 3)
    with pytest.raises(ValueError, match=">= 1"):
        enc.encode_batch_multiprobe(q, 0)


def test_converted_state_is_checked_against_the_spec():
    arrays = SSHEncoder(ssh_ecg.SMOKE).materialize("cpu").arrays()
    state = convert.encoder_state_from_arrays(arrays, "cpu")
    assert SSHEncoder(ssh_ecg.SMOKE).load_state(state).arrays().keys() \
        == arrays.keys()
    with pytest.raises(ValueError, match="missing leaves"):
        convert.encoder_state_from_arrays(
            {k: v for k, v in arrays.items() if k != "cws/beta"}, "cpu")
    with pytest.raises(ValueError, match="unknown leaves"):
        convert.encoder_state_from_arrays(
            {**arrays, "extra": arrays["filters"]}, "cpu")
    with pytest.raises(ValueError, match="spec implies"):
        SSHEncoder(ssh_ecg.CONFIG).load_state(state)       # K=40, n=15
    with pytest.raises(ValueError, match="K=40"):
        convert.index_from_arrays(
            ssh_ecg.CONFIG, SSHEncoder(ssh_ecg.CONFIG).materialize(
                "cpu").arrays(), np.zeros((3, 20), np.int32),
            np.zeros((3, 20), np.uint32), np.zeros((3, 64), np.float32),
            device="cpu")
