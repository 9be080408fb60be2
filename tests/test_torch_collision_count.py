"""The collision-count kernels' padding rule and tile walk, in plain
PyTorch on the CPU, against the JAX package.

The CUDA kernels (``csrc/collision_count.cu``) pad the key axis to
``k_pad(K)`` slots with the TPU kernel's sentinels (database INT32_MIN,
query INT32_MAX), and the single-query kernel reads the database as
256-row tiles, each span widened to 16-byte boundaries.
``ref.collision_count_padded_ref`` and ``ref.collision_count_stream_ref``
are those two rules in plain PyTorch.  Here they must equal the plain
counts, the JAX package's plain references and its Pallas kernels
(``collision_count_batch``, ``collision_count``, in interpret mode),
exactly: on keys that include both sentinels, at K not a multiple of 8,
and with the database's base 0-3 words past a 16-byte boundary.  Inputs
are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.collision_count import \
    collision_count as pallas_collision_count
from repro.kernels.collision_count import \
    collision_count_batch as pallas_collision_count_batch
from repro_torch.kernels import collision_count as cc
from repro_torch.kernels import ref

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

_I32 = np.iinfo(np.int32)
_EXTREME = np.array([_I32.min, _I32.max, -1, 0, 1, 2], dtype=np.int32)


def _keys(rng, shape):
    """int32 keys: half of the columns from _EXTREME (both sentinels as
    real keys), the rest from {0, 1, 2}."""
    k = shape[-1]
    x = rng.integers(0, 3, size=shape).astype(np.int32)
    cols = rng.permutation(k)[:max(1, k // 2)]
    x[..., cols] = rng.choice(_EXTREME, size=x[..., cols].shape)
    return x


def _queries_like(rng, db, b):
    """``b`` database rows with about half their keys redrawn, so that
    every count from 0 to K occurs."""
    q = db[rng.integers(0, db.shape[0], b)].copy()
    flip = rng.random(q.shape) < 0.5
    q[flip] = _keys(rng, q.shape)[flip]
    return q


@pytest.mark.parametrize("k,want", [(1, 8), (7, 8), (8, 8), (9, 16),
                                    (33, 40), (40, 40), (63, 64), (64, 64)])
def test_k_pad(k, want):
    assert cc.k_pad(k) == want
    # a stage holds the widened span and the last row's reads past K
    assert cc.one_stage_words(k) >= cc.ONE_TILE * k + 6 + cc.k_pad(k) - k
    assert cc.one_stage_words(k) % 32 == 0


@pytest.mark.parametrize("k", [1, 7, 20, 33, 40, 63, 64])
def test_padding_rule_matches_jax(k):
    rng = np.random.default_rng(k)
    db = _keys(rng, (300, k))
    q = _queries_like(rng, db, 7)
    got = ref.collision_count_padded_ref(torch.from_numpy(q),
                                         torch.from_numpy(db)).numpy()
    plain = ref.collision_count_batch_ref(torch.from_numpy(q),
                                          torch.from_numpy(db)).numpy()
    want = np.asarray(jref.collision_count_batch_ref(jnp.asarray(q),
                                                     jnp.asarray(db)))
    pallas = np.asarray(pallas_collision_count_batch(
        jnp.asarray(q), jnp.asarray(db), interpret=True))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == np.int32 and len(np.unique(got)) >= min(k + 1, 3)


@pytest.mark.parametrize("k", [1, 8, 33, 40, 64])
@pytest.mark.parametrize("lead", [0, 1, 2, 3])
def test_tile_walk_matches_jax(k, lead):
    rng = np.random.default_rng(10 * k + lead)
    n = 600                           # two full tiles and a ragged one
    db = _keys(rng, (n, k))
    q = _queries_like(rng, db, 1)[0]
    got = ref.collision_count_stream_ref(torch.from_numpy(q),
                                         torch.from_numpy(db), lead).numpy()
    want = np.asarray(jref.collision_count_ref(jnp.asarray(q),
                                               jnp.asarray(db)))
    pallas = np.asarray(pallas_collision_count(
        jnp.asarray(q), jnp.asarray(db), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, ref.collision_count_ref(
        torch.from_numpy(q), torch.from_numpy(db)).numpy())

