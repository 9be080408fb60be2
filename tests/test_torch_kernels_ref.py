"""The plain PyTorch versions of the port's three kernels against the JAX
package, on the CPU, and the device dispatch around them.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: collision counts exact; sketch projections rtol 1e-5 with a
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
    collision_count_batch as pallas_collision_count_batch
from repro_torch.core import dtw as tdtw
from repro_torch.kernels import ops, ref
from repro_torch.kernels.collision_count import collision_count_batch
from repro_torch.kernels.dtw_wavefront import dtw_wavefront_pairs
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
    assert ops.launch_counts() == {"sketch_conv": 0, "collision_count": 0,
                                   "dtw_wavefront": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 40))
    with pytest.raises(ValueError, match="CUDA"):
        sketch_conv(x, torch.zeros((8, 1)), 2)
    k = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        collision_count_batch(k, k)
    with pytest.raises(ValueError, match="CUDA"):
        dtw_wavefront_pairs(x, x, 3)
