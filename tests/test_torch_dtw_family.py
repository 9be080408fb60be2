"""The port's DTW family, lower-bound statistics and chunked pair helpers
against ``repro.core`` (jnp), on the CPU.

Same numpy inputs for both packages.  DTW values are held to the float64
DP (``dtw_dp_reference``) at rtol 1e-6 for the port and 1e-4 for the
reference (its float32 cumsum/cummin column identity drifts; ROADMAP §3);
threshold decisions (exact or BIG) and every integer exactly;
``cascade_stats`` fractions equal to the reference's up to 1/N for each
candidate whose bound lies within float32 rounding of ``best_so_far``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import dtw as tdtw
from repro_torch.core import lower_bounds as tlb
from repro_torch.core import rerank as trr

jdtw = importlib.import_module("repro.core.dtw")  # repro.core.dtw is a function
jlb = importlib.import_module("repro.core.lower_bounds")
jrr = importlib.import_module("repro.core.rerank")
dp = jdtw.dtw_dp_reference

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

BIG = 1e30


def _walks(n, m, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, m)).cumsum(1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_to_dp(got, x, ys, band, rtol):
    want = np.array([dp(x, y, band) for y in ys])
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol)


@pytest.mark.parametrize("band", [None, 5])
@pytest.mark.parametrize("m_x,m_y", [(40, 32), (32, 40)])
def test_rectangular_dtw_is_repaired(m_x, m_y, band):
    """Series of different lengths, the band around the scaled diagonal:
    the port's ``dtw`` raised here before; now it equals the float64 DP
    at 1e-6 and the reference at 1e-4."""
    x, y = _walks(1, m_x, m_x)[0], _walks(1, m_y, 100 + m_y)[0]
    got = tdtw.dtw(_t(x), _t(y), band)
    assert got.dtype == torch.float32 and got.dim() == 0
    want = dp(x, y, band)
    ref = float(jdtw.dtw(jnp.asarray(x), jnp.asarray(y), band=band))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    np.testing.assert_allclose(float(got), ref, rtol=1e-4)
    np.testing.assert_allclose(float(tdtw.dtw_distance(_t(x), _t(y), band)),
                               np.sqrt(want), rtol=1e-6)


@pytest.mark.parametrize("band", [None, 0, 3, 7])
def test_rectangular_band_cells_match_the_dp(band):
    """Lengths whose scaled diagonal is not exact in binary (slope 0.8,
    1.25, 3) and a band of 0: the port keeps exactly the DP's cells."""
    for m_x, m_y in ((24, 30), (30, 24), (45, 15), (15, 45)):
        x, y = _walks(1, m_x, 7)[0], _walks(1, m_y, 8)[0]
        np.testing.assert_allclose(float(tdtw.dtw(_t(x), _t(y), band)),
                                   dp(x, y, band), rtol=1e-6)


@pytest.mark.parametrize("band", [None, 6])
def test_equal_length_dtw_and_batch(band):
    q = _walks(1, 64, 1)[0]
    cands = _walks(9, 64, 2)
    assert float(tdtw.dtw(_t(q), _t(cands[0]), band)) == pytest.approx(
        dp(q, cands[0], band), rel=1e-6)
    got = tdtw.dtw_batch(_t(q), _t(cands), band).numpy()
    _close_to_dp(got, q, cands, band, 1e-6)
    ref = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(cands),
                                    band=band))
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    # the batch equals the single form element for element
    one = [float(tdtw.dtw(_t(q), _t(c), band)) for c in cands]
    np.testing.assert_array_equal(got, np.float32(one))


def test_dtw_batch_on_unequal_lengths():
    q = _walks(1, 48, 3)[0]
    cands = _walks(5, 40, 4)
    for band in (None, 4):
        got = tdtw.dtw_batch(_t(q), _t(cands), band).numpy()
        _close_to_dp(got, q, cands, band, 1e-6)
        ref = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(cands),
                                        band=band))
        np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_znormalize_matches_reference():
    x = _walks(4, 100, 5) * 3.0 + 7.0
    got = tdtw.znormalize(_t(x)).numpy()
    want = np.asarray(jdtw.znormalize(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.mean(-1), 0.0, atol=1e-5)
    np.testing.assert_allclose(tdtw.znormalize(_t(x.T), axis=0).numpy(),
                               np.asarray(jdtw.znormalize(jnp.asarray(x.T),
                                                          axis=0)),
                               rtol=1e-5, atol=1e-5)


def _threshold_between(values):
    """A threshold halfway between the two middle distinct values, far
    from every value in float32 terms."""
    v = np.unique(np.float64(values))
    k = len(v) // 2
    return np.float32((v[k - 1] + v[k]) / 2)


@pytest.mark.parametrize("band", [4, 10])
def test_dtw_banded_threshold_contract(band):
    """Exact where DTW <= threshold, BIG elsewhere; scalar and (C,)
    thresholds; the single form equals the batch."""
    q = _walks(1, 80, 11)[0]
    cands = _walks(24, 80, 12)
    exact = np.array([dp(q, c, band) for c in cands])
    thr = _threshold_between(exact)
    got = tdtw.dtw_banded_batch(_t(q), _t(cands), band, thr).numpy()
    ref = np.asarray(jdtw.dtw_banded_batch(jnp.asarray(q),
                                           jnp.asarray(cands), band,
                                           jnp.float32(thr)))
    kept = exact <= thr
    assert 0 < kept.sum() < len(cands)
    np.testing.assert_array_equal(got >= BIG, ~kept)
    np.testing.assert_array_equal(ref >= BIG, ~kept)
    np.testing.assert_allclose(got[kept], exact[kept], rtol=1e-6)
    np.testing.assert_allclose(got[kept], ref[kept], rtol=1e-4)
    # per-candidate thresholds: each row against its own
    thrs = np.where(np.arange(len(cands)) % 2 == 0, thr, np.float32(BIG))
    got2 = tdtw.dtw_banded_batch(_t(q), _t(cands), band,
                                 _t(thrs.astype(np.float32))).numpy()
    keep2 = kept | (np.arange(len(cands)) % 2 == 1)
    np.testing.assert_array_equal(got2 >= BIG, ~keep2)
    # no threshold: the exact value everywhere
    full = tdtw.dtw_banded_batch(_t(q), _t(cands), band).numpy()
    np.testing.assert_allclose(full, exact, rtol=1e-6)
    for i in (0, 5):
        assert float(tdtw.dtw_banded(_t(q), _t(cands[i]), band, thr)) == \
            got[i]
    with pytest.raises(ValueError, match="equal"):
        tdtw.dtw_banded(_t(q), _t(cands[0][:70]), band)


@pytest.mark.parametrize("band", [None, 5])
def test_dtw_pairwise(band, monkeypatch):
    xs, ys = _walks(4, 64, 21), _walks(7, 64, 22)
    got = tdtw.dtw_pairwise(_t(xs), _t(ys), band).numpy()
    assert got.shape == (4, 7)
    ref = np.asarray(jdtw.dtw_pairwise(jnp.asarray(xs), jnp.asarray(ys),
                                       band=band))
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    for a in range(4):
        _close_to_dp(got[a], xs[a], ys, band, 1e-6)
    # launches of a few pairs give the same bits as one launch
    monkeypatch.setattr(tdtw, "PAIRWISE_CHUNK", 5)
    np.testing.assert_array_equal(
        tdtw.dtw_pairwise(_t(xs), _t(ys), band).numpy(), got)
    # other lengths: a row at a time through the rectangular DP
    rect = tdtw.dtw_pairwise(_t(xs[:2, :50]), _t(ys[:3]), band).numpy()
    for a in range(2):
        _close_to_dp(rect[a], xs[a, :50], ys[:3], band, 1e-6)


def _near_ties(lbs, best):
    """Candidates whose bound lies within float32 rounding of best."""
    tol = 1e-5 * max(abs(float(best)), 1.0)
    return int(sum(np.sum(np.abs(np.float64(v) - float(best)) <= tol)
                   for v in lbs))


@pytest.mark.parametrize("radius", [4, 12])
def test_cascade_stats_match_reference(radius):
    """The five pruning fractions over N = 2048 candidates against the
    10th-best banded DTW, as ``benchmarks/table1_lb_pruning.py`` sets
    ``best_so_far``."""
    n, m = 2048, 96
    series = _walks(n, m, 30 + radius)
    q = series[5] + np.random.default_rng(1).normal(
        scale=0.3, size=m).astype(np.float32)
    exact = tdtw.dtw_batch(_t(q), _t(series), radius).numpy()
    best = np.float32(np.sort(exact)[9])
    got = tlb.cascade_stats(_t(q), _t(series), radius, best)
    want = jlb.cascade_stats(jnp.asarray(q), jnp.asarray(series), radius,
                             jnp.float32(best))
    assert set(got) == set(want) == {"kim", "keogh", "keogh2", "improved",
                                     "combined"}
    tq, tc = _t(q), _t(series)
    u, l = tlb.envelope(tq, radius)
    lbs = [tlb.lb_kim(tq, tc).numpy(), tlb.lb_keogh(u, l, tc).numpy(),
           tlb.lb_keogh2(tq, tc, radius).numpy(),
           tlb.lb_improved(tq, tc, radius).numpy()]
    ties = _near_ties(lbs, best)
    print(f"radius {radius}: fractions {({k: float(v) for k, v in got.items()})}"
          f"; {ties} bounds within float32 rounding of best_so_far")
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        assert abs(float(got[k]) - float(want[k])) <= ties / n + 1e-7, k
    # the fractions are those of the bounds the port computes
    for key, v in zip(("kim", "keogh", "keogh2", "improved"), lbs):
        assert float(got[key]) == pytest.approx(np.mean(v >= best), abs=1e-7)
    assert float(got["combined"]) >= max(float(got[k]) for k in
                                         ("kim", "keogh", "keogh2",
                                          "improved"))


def test_pair_chunk_constants_match_reference():
    assert (trr.PAIR_CHUNK, trr.PAIR_CHUNK_SMALL) == \
        (jrr.PAIR_CHUNK, jrr.PAIR_CHUNK_SMALL)


@pytest.mark.parametrize("p", [1, 31, 300])
def test_dtw_pairs_chunked(p):
    """P not a multiple of the reference's chunks, threshold scalar,
    (P,) and none; host arrays, equal to one launch over all pairs and to
    the reference's ``backend="jnp"`` within its DTW tolerance."""
    band = 6
    q, c = _walks(p, 64, 40 + p), _walks(p, 64, 50 + p)
    exact = np.array([dp(a, b, band) for a, b in zip(q, c)])
    one = tdtw.dtw_banded_pairs(_t(q), _t(c), band).numpy()
    got = trr.dtw_pairs_chunked(_t(q), _t(c), band)
    assert isinstance(got, np.ndarray) and got.shape == (p,)
    np.testing.assert_array_equal(got, one)
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    ref = jrr.dtw_pairs_chunked(jnp.asarray(q), jnp.asarray(c), band,
                                backend="jnp")
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    thr = _threshold_between(exact) if p > 1 else np.float32(exact[0] * 2)
    kept = exact <= thr
    for t in (thr, np.full(p, thr, np.float32)):
        g = trr.dtw_pairs_chunked(_t(q), _t(c), band, threshold=t)
        r = jrr.dtw_pairs_chunked(jnp.asarray(q), jnp.asarray(c), band,
                                  backend="jnp", threshold=t)
        np.testing.assert_array_equal(g >= BIG, ~kept)
        np.testing.assert_array_equal(np.asarray(r) >= BIG, ~kept)
        np.testing.assert_array_equal(g[kept], one[kept])
    with pytest.raises(ValueError, match="device='cpu'|backend"):
        trr.dtw_pairs_chunked(_t(q), _t(c), band, backend="cuda")


@pytest.mark.parametrize("p", [0, 33, 290])
def test_lb_improved_pairs_chunked(p):
    band = 5
    q, c = _walks(p, 64, 60), _walks(p, 64, 61)
    got = trr.lb_improved_pairs_chunked(_t(q), _t(c), band)
    assert isinstance(got, np.ndarray) and got.shape == (p,)
    if not p:
        return
    np.testing.assert_array_equal(
        got, tlb.lb_improved_pairs(_t(q), _t(c), band).numpy())
    want = jrr.lb_improved_pairs_chunked(jnp.asarray(q), jnp.asarray(c),
                                         band)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
