"""The plain PyTorch versions of the port's kernels against the JAX
package, on the CPU, and the device dispatch around them.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: collision counts and count-sketch tables exact (sums of +-1
are exact integers in float32); sketch projections rtol 1e-5 with a
1e-5 absolute floor (float32 reassociation of a W-term sum whose terms
are O(1)); DTW rtol 1e-5, atol 1e-6 (the port's wavefront and the
reference's cumsum/cummin window DP round the same sums in different
orders), with the exact-or-BIG decision identical on thresholds no
closer than 1e-5 relative to the exact cost.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dtw import dtw as jdtw
from repro.core.dtw import dtw_dp_reference
from repro.kernels import ref as jref
from repro.kernels.collision_count import \
    collision_count as pallas_collision_count
from repro.kernels.collision_count import \
    collision_count_batch as pallas_collision_count_batch
from repro.kernels.count_sketch import cs_tables as pallas_cs_tables
from repro_torch.core import dtw as tdtw
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.collision_count import (collision_count,
                                                 collision_count_batch)
from repro_torch.kernels.count_sketch import cs_tables
from repro_torch.kernels.dtw_wavefront import (dtw_wavefront,
                                               dtw_wavefront_pairs)
from repro_torch.kernels.sketch_conv import sketch_conv

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

BIG = 1e30


@pytest.mark.parametrize("f,step", [(1, 3), (3, 1), (2, 5)])
def test_sketch_conv_ref_matches_jax(f, step):
    rng = np.random.default_rng(f * 7 + step)
    x = rng.normal(size=(16, 128)).astype(np.float32)
    filt = rng.normal(size=(24, f)).astype(np.float32)
    got = ref.sketch_conv_ref(torch.from_numpy(x), torch.from_numpy(filt),
                              step).numpy()
    want = np.asarray(jref.sketch_conv_ref(jnp.asarray(x), jnp.asarray(filt),
                                           step))
    assert got.shape == want.shape == (16, (128 - 24) // step + 1, f)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,n,k", [(1, 130, 20), (9, 257, 40), (4, 64, 7)])
def test_collision_count_batch_ref_exact(b, n, k):
    rng = np.random.default_rng(n)
    db = rng.integers(0, 3, size=(n, k)).astype(np.int32)
    q = rng.integers(0, 3, size=(b, k)).astype(np.int32)
    got = ref.collision_count_batch_ref(torch.from_numpy(q),
                                        torch.from_numpy(db)).numpy()
    want = np.asarray(jref.collision_count_batch_ref(jnp.asarray(q),
                                                     jnp.asarray(db)))
    np.testing.assert_array_equal(got, want)
    # the reference's Pallas kernel still runs in interpret mode
    pallas = np.asarray(pallas_collision_count_batch(
        jnp.asarray(q), jnp.asarray(db), interpret=True))
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == np.int32


def _pairs(p, m, seed):
    """z-normalised random walks, the repo's usual DTW inputs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        w = rng.normal(size=(p, m)).cumsum(1)
        w = (w - w.mean(1, keepdims=True)) / w.std(1, keepdims=True)
        out.append(w.astype(np.float32))
    return out


# band=None takes the reference's full-column DP, whose cumsum/cummin
# identity loses precision with the column length (about 1e-5 relative
# at m = 40 against the float64 DP, where the port's direct recurrence
# stays near 2e-7); m = 24 keeps the reference inside rtol 1e-5
_LEN = {2: 48, 6: 48, None: 24}


@pytest.mark.parametrize("band", [2, 6, None])
def test_dtw_pairs_ref_matches_jax(band):
    q, c = _pairs(40, _LEN[band], seed=band or 0)
    got = ref.dtw_pairs_ref(torch.from_numpy(q), torch.from_numpy(c),
                            band).numpy()
    want = np.asarray(jref.dtw_pairs_ref(jnp.asarray(q), jnp.asarray(c),
                                         band=band))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    exact = np.array([dtw_dp_reference(q[i], c[i], band) for i in range(8)])
    np.testing.assert_allclose(got[:8], exact, rtol=1e-6)   # float64 DP
    one = tdtw.dtw(torch.from_numpy(q[0]), torch.from_numpy(c[0]), band)
    assert float(one) == got[0]
    assert float(one) == pytest.approx(
        float(jdtw(jnp.asarray(q[0]), jnp.asarray(c[0]), band=band)),
        rel=1e-5)


@pytest.mark.parametrize("band", [2, 6, None])
def test_dtw_pairs_ref_threshold_contract_matches_jax(band):
    q, c = _pairs(60, _LEN[band], seed=10 + (band or 0))
    exact = ref.dtw_pairs_ref(torch.from_numpy(q), torch.from_numpy(c),
                              band).numpy()
    factors = np.random.default_rng(1).choice([0.5, 0.9, 1.1, 2.0], 60)
    thr = (exact * factors).astype(np.float32)
    got = ref.dtw_pairs_ref(torch.from_numpy(q), torch.from_numpy(c), band,
                            torch.from_numpy(thr)).numpy()
    want = np.asarray(jref.dtw_pairs_ref(jnp.asarray(q), jnp.asarray(c),
                                         band=band,
                                         threshold=jnp.asarray(thr)))
    # no lane within 1e-5 relative of its threshold: decisions identical
    np.testing.assert_array_equal(got >= BIG * 0.5, want >= BIG * 0.5)
    np.testing.assert_array_equal(got >= BIG * 0.5, factors < 1)
    kept = got < BIG * 0.5
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[kept], exact[kept])


def test_dtw_threshold_tie_survives_and_cells_count_the_band():
    q, c = _pairs(8, 30, seed=3)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    exact = ref.dtw_pairs_ref(tq, tc, 4)
    # strict >: a threshold equal to the exact cost keeps the value
    assert torch.equal(ref.dtw_pairs_ref(tq, tc, 4, exact), exact)
    below = torch.nextafter(exact, torch.zeros_like(exact))
    assert bool((ref.dtw_pairs_ref(tq, tc, 4, below) == BIG).all())
    # without a threshold every pair runs the whole band
    _, cells = tdtw.dtw_pairs_work(tq, tc, 4)
    r, m = 4, 30
    assert bool((cells == m * (2 * r + 1) - r * (r + 1)).all())
    # an abandoned pair runs fewer cells
    _, cut = tdtw.dtw_pairs_work(tq, tc, 4, exact * 0.1)
    assert bool((cut < cells).all())


def test_ops_dispatch_takes_plain_versions_on_cpu():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 50)).astype(np.float32))
    f = torch.from_numpy(rng.normal(size=(10, 1)).astype(np.float32))
    ops.reset_launch_counts()
    assert torch.equal(ops.sketch_conv(x, f, 2), ref.sketch_conv_ref(x, f, 2))
    assert torch.equal(ops.sketch_bits(x, f, 2),
                       (ref.sketch_conv_ref(x, f, 2) >= 0).to(torch.uint8))
    qk = torch.zeros((2, 5), dtype=torch.int32)
    assert torch.equal(ops.collision_count_batch(qk, qk),
                       torch.full((2, 2), 5, dtype=torch.int32))
    d = ops.dtw_rerank_pairs(x, x.flip(0), None)
    assert torch.equal(d, ref.dtw_pairs_ref(x, x.flip(0), None))
    # the plain versions launch nothing
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 40))
    with pytest.raises(ValueError, match="CUDA"):
        sketch_conv(x, torch.zeros((8, 1)), 2)
    k = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        collision_count_batch(k, k)
    with pytest.raises(ValueError, match="CUDA"):
        dtw_wavefront_pairs(x, x, 3)


@pytest.mark.parametrize("n,k", [(130, 20), (257, 40), (64, 7)])
def test_collision_count_ref_exact(n, k):
    rng = np.random.default_rng(n + k)
    db = rng.integers(0, 3, size=(n, k)).astype(np.int32)
    q = rng.integers(0, 3, size=k).astype(np.int32)
    got = ref.collision_count_ref(torch.from_numpy(q),
                                  torch.from_numpy(db)).numpy()
    want = np.asarray(jref.collision_count_ref(jnp.asarray(q),
                                               jnp.asarray(db)))
    np.testing.assert_array_equal(got, want)
    # the reference's Pallas kernel runs in interpret mode
    pallas = np.asarray(pallas_collision_count(jnp.asarray(q),
                                               jnp.asarray(db),
                                               interpret=True))
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, ref.collision_count_batch_ref(torch.from_numpy(q[None]),
                                           torch.from_numpy(db))[0].numpy())


@pytest.mark.parametrize("b,r,s,width", [(3, 4, 300, 256), (2, 4, 131, 128),
                                         (1, 1, 17, 1024)])
def test_cs_tables_ref_bit_identical(b, r, s, width):
    rng = np.random.default_rng(width + s)
    bkt = rng.integers(-1, width, (b, r, s)).astype(np.int32)
    sgn = np.where(bkt < 0, 0.0,
                   rng.choice([-1.0, 1.0], (b, r, s))).astype(np.float32)
    got = ref.cs_tables_ref(torch.from_numpy(bkt), torch.from_numpy(sgn),
                            width).numpy()
    want = np.asarray(jref.cs_tables_ref(jnp.asarray(bkt), jnp.asarray(sgn),
                                         width))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(pallas_cs_tables(jnp.asarray(bkt), jnp.asarray(sgn),
                                         width, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    assert got.shape == (b, r, width) and got.dtype == np.float32


@pytest.mark.parametrize("band", [2, 6, None])
@pytest.mark.parametrize("thr_kind", ["none", "scalar", "per_candidate"])
def test_dtw_wavefront_ref_matches_jax(band, thr_kind):
    m = _LEN[band]
    q, c = _pairs(40, m, seed=20 + (band or 0))
    query = q[0]
    exact = ref.dtw_wavefront_ref(torch.from_numpy(query),
                                  torch.from_numpy(c), band).numpy()
    thr = None
    if thr_kind == "scalar":
        # midway between two exact costs: no lane sits at its threshold
        srt = np.sort(exact)
        thr = np.float32((srt[19] + srt[20]) / 2)
    elif thr_kind == "per_candidate":
        factors = np.random.default_rng(2).choice([0.5, 0.9, 1.1, 2.0], 40)
        thr = (exact * factors).astype(np.float32)
    got = ref.dtw_wavefront_ref(
        torch.from_numpy(query), torch.from_numpy(c), band,
        None if thr is None else torch.as_tensor(thr)).numpy()
    want = np.asarray(jref.dtw_wavefront_ref(
        jnp.asarray(query), jnp.asarray(c), band=band,
        threshold=None if thr is None else jnp.asarray(thr)))
    np.testing.assert_array_equal(got >= BIG * 0.5, want >= BIG * 0.5)
    kept = got < BIG * 0.5
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[kept], exact[kept])
    if thr is not None:
        np.testing.assert_array_equal(~kept, exact > thr)
    dp = np.array([dtw_dp_reference(query, c[i], band) for i in range(8)])
    np.testing.assert_allclose(exact[:8], dp, rtol=1e-6)   # float64 DP
    # the same bits as the pair form on the broadcast query
    pairs = ref.dtw_pairs_ref(torch.from_numpy(np.repeat(q[:1], 40, 0)),
                              torch.from_numpy(c), band).numpy()
    np.testing.assert_array_equal(exact, pairs)


def test_new_ops_dispatch_takes_plain_versions_on_cpu():
    rng = np.random.default_rng(8)
    ops.reset_launch_counts()
    db = torch.from_numpy(rng.integers(0, 2, (9, 5)).astype(np.int32))
    assert torch.equal(ops.collision_count(db[0], db),
                       ref.collision_count_ref(db[0], db))
    x = torch.from_numpy(rng.normal(size=(6, 30)).astype(np.float32))
    assert torch.equal(ops.dtw_rerank(x[0], x, 4),
                       ref.dtw_wavefront_ref(x[0], x, 4))
    assert torch.equal(ops.dtw_rerank(x[0], x, None, 1.0),
                       ref.dtw_wavefront_ref(x[0], x, None, 1.0))
    bkt = torch.tensor([[[0, 3, -1, 3, 9]]], dtype=torch.int32)
    sgn = torch.tensor([[[1.0, -1.0, 0.0, -1.0, 1.0]]])
    # bucket -1 and buckets past the width contribute nothing
    assert ops.cs_tables(bkt, sgn, 4).tolist() == [[[1.0, 0.0, 0.0, -2.0]]]
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


def test_new_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 40))
    k = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        collision_count(k[0], k)
    with pytest.raises(ValueError, match="CUDA"):
        dtw_wavefront(x[0], x, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cs_tables(torch.zeros((1, 2, 3), dtype=torch.int32),
                  torch.zeros((1, 2, 3)), 8)
