"""The row schedule of the DTW kernels, emulated on the CPU.

``kernels.ref.dtw_band_rows_ref`` sweeps the candidate's rows in band
coordinates with the row-minimum abandon, as ``dtw_rows_kernel`` in
``csrc/dtw_wavefront.cu`` does, in plain torch.  Min is exact and
commutative, so computing each cell once from its three finished
neighbours in any order gives the plain wavefront's bits: the emulation
is held bit-equal to ``ref.dtw_pairs_ref``.  Against the JAX package
(``repro.kernels.ref.dtw_pairs_ref``) the nearest-pair ids and the
exact-or-BIG decisions are held equal, the latter on thresholds at least
1e-3 relative from the exact cost; the distances are held within rtol
1e-6 of the float64 ``repro.core.dtw.dtw_dp_reference``, the bar of the
port's other DTW tests (the JAX package's plain DTW is itself off by up
to 6e-5, so its values are not the yardstick).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dtw import dtw_dp_reference
from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.dtw_wavefront import (ROWS_TILE, dtw_schedule,
                                               ROWS_MAX_RADIUS)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

BIG = 1e30
P = 12
THRESHOLDS = ("none", "scalar", "per_pair", "exact", "below_rows")


def _walks(p, m, seed):
    """z-normalised random walks (constant rows for m = 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        w = rng.normal(size=(p, m)).cumsum(1)
        if m > 1:
            w = (w - w.mean(1, keepdims=True)) / w.std(1, keepdims=True)
        out.append(w.astype(np.float32))
    return out


def _threshold(kind, exact, rng):
    """A threshold of ``kind`` for the exact costs (P,)."""
    if kind == "none":
        return None
    if kind == "scalar":
        return torch.tensor(float(np.median(exact.numpy())))
    if kind == "per_pair":
        return exact * torch.tensor(rng.choice([0.5, 0.9, 1.1, 2.0], P),
                                    dtype=torch.float32)
    if kind == "exact":
        return exact.clone()               # strict >: every value kept
    # below every row minimum: the first row's costs already exceed it
    return torch.full((P,), -1.0)


@pytest.mark.parametrize("m", [1, 2, 3, 40, 96])
@pytest.mark.parametrize("band", [0, 1, 2, 6, "m-1", None])
def test_row_schedule_emulation_bit_equal_to_plain(m, band):
    band = m - 1 if band == "m-1" else band
    q, c = _walks(P, m, seed=m * 31 + (band if band is not None else 99))
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    exact = ref.dtw_pairs_ref(tq, tc, band)
    rng = np.random.default_rng(m)
    for kind in THRESHOLDS:
        thr = _threshold(kind, exact, rng)
        got = ref.dtw_band_rows_ref(tq, tc, band, thr)
        want = ref.dtw_pairs_ref(tq, tc, band, thr)
        assert torch.equal(got, want), kind
        if kind == "exact":
            assert torch.equal(got, exact)
        if kind == "below_rows":
            assert bool((got == BIG).all())
    # the single-query form: one query row broadcast to every pair
    one = ref.dtw_wavefront_ref(tq[0], tc, band)
    assert torch.equal(ref.dtw_band_rows_ref(tq[:1].expand_as(tc), tc, band),
                       one)


@pytest.mark.parametrize("m", [1, 2, 3, 40, 96])
@pytest.mark.parametrize("band", [0, 1, 2, 6, "m-1", None])
def test_row_schedule_emulation_against_jax(m, band):
    band = m - 1 if band == "m-1" else band
    q, c = _walks(P, m, seed=m * 17 + (band if band is not None else 77))
    got = ref.dtw_band_rows_ref(torch.from_numpy(q), torch.from_numpy(c),
                                band).numpy()
    want = np.asarray(jref.dtw_pairs_ref(jnp.asarray(q), jnp.asarray(c),
                                         band=band))
    dp = np.array([dtw_dp_reference(q[i], c[i], band) for i in range(P)])
    np.testing.assert_allclose(got, dp, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.argsort(got, kind="stable")[:5],
                                  np.argsort(want, kind="stable")[:5])
    # exact-or-BIG decisions on thresholds clear of the exact cost
    factors = np.random.default_rng(band or 0).choice([0.5, 0.99, 1.01, 2.0],
                                                      P)
    thr = (got * factors).astype(np.float32)
    got_t = ref.dtw_band_rows_ref(torch.from_numpy(q), torch.from_numpy(c),
                                  band, torch.from_numpy(thr)).numpy()
    want_t = np.asarray(jref.dtw_pairs_ref(
        jnp.asarray(q), jnp.asarray(c), band=band,
        threshold=jnp.asarray(thr)))
    clear = np.abs(thr - got) > 1e-3 * np.maximum(got, 1e-30)
    np.testing.assert_array_equal((got_t >= BIG * 0.5)[clear],
                                  (want_t >= BIG * 0.5)[clear])
    # a zero cost (m = 2 walks are +-1 after z-normalising) survives any
    # non-negative threshold
    np.testing.assert_array_equal(got_t >= BIG * 0.5,
                                  (factors < 1) & (got > 0))


def test_row_schedule_abandons_at_tile_ends_only_in_effect():
    """Pairs abandon at different tiles: those past their thresholds give
    BIG, the others their exact cost, whichever tile the bound fires in."""
    m, band = 3 * ROWS_TILE + 5, 6
    q, c = _walks(P, m, seed=5)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    exact = ref.dtw_pairs_ref(tq, tc, band)
    # 1 %, 30 %, 60 %, 99 %, 100 % and 200 % of the exact cost
    frac = torch.tensor([0.01, 0.3, 0.6, 0.99, 1.0, 2.0] * 2)
    thr = exact * frac
    got = ref.dtw_band_rows_ref(tq, tc, band, thr)
    assert torch.equal(got, ref.dtw_pairs_ref(tq, tc, band, thr))
    assert torch.equal(got[frac >= 1.0], exact[frac >= 1.0])
    assert bool((got[frac < 1.0] == BIG).all())


@pytest.mark.parametrize("n,m,r,want", [
    (1, 512, 25, "diagonals"), (303, 512, 25, "diagonals"),
    (213863, 512, 25, "rows"), (27650, 512, 25, "rows"),
    (213863, 512, ROWS_MAX_RADIUS + 1, "diagonals"),
    (10 ** 6, 1024, 1023, "diagonals"), (10 ** 5, 128, 6, "rows")])
def test_schedule_rule(n, m, r, want):
    assert dtw_schedule(n, m, r) == want
