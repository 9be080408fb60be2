"""The CUDA-core flash kernel's schedule, in plain PyTorch on the CPU,
against the port's plain version and the JAX package.

The kernel (``csrc/flash_attention.cu``, ``flash_attention_simt_kernel``)
runs only on the card; ``ref.flash_attention_simt_ref`` walks its
schedule step for step: blocks of 64 query rows, warps of 16 rows,
64-key tiles in groups of 8, Q scaled by
scale·log2(e) once, exp2, each lane's own partial row sum; per warp the
tiles past its causal diagonal are not visited, the sub-blocks past it
in the crossing tile are skipped, and on the diagonal sub-block only the
(row group, key group) pairs that hold a visible key are computed, with
P.V reading P only where it was written (NaN elsewhere).  Here the walk
must agree, within the float32 route's bound ``REORDER · max|v|``, with

* the port's plain version ``ref.flash_attention_ref`` over head dims
  16, 20, 64, 72, 96 and 128 (tiles of 32, 64, 96 and 128 columns), GQA
  groups 1 and 4, S != T both ways, causal and not, and a zero or
  negative scale;
* the JAX package's ``chunked_attention`` (numpy in, (B, S, H, D)
  layout) wherever the two masks mean the same: causal at S == T and
  every non-causal case (for S != T under causal the JAX model aligns
  the queries to the end of the keys, the TPU kernel and the port to 0).

Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import chunked_attention as jax_chunked
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)


def _inputs(b, h, hk, s, t, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=sh).astype(np.float32)).to(dtype)
            for sh in ((b, h, s, d), (b, hk, t, d), (b, hk, t, d))]


def _check(got, want, v):
    err = (got - want.float()).abs()
    bound = fa.error_bound(got, want.float(), v.float())
    assert bool(torch.isfinite(got).all())
    assert bool((err <= bound).all()), float(err.max())


# (B, H, Hk, S, T, D, causal)
CASES = [
    (1, 4, 4, 130, 130, 64, True),
    (1, 4, 4, 130, 130, 64, False),
    (2, 8, 2, 128, 128, 64, True),         # the serve gate's layout, cut
    (1, 3, 3, 37, 200, 64, True),          # S < T
    (1, 3, 3, 200, 37, 64, True),          # S > T
    (1, 3, 3, 77, 131, 64, False),
    (1, 4, 1, 150, 150, 16, True),         # group 4, D 16 in a 32 tile
    (1, 4, 4, 100, 60, 16, False),
    (1, 8, 2, 140, 140, 72, True),         # D 72: 96 columns
    (1, 2, 2, 96, 170, 72, False),
    (1, 4, 1, 150, 150, 96, True),
    (1, 2, 2, 50, 210, 96, True),
    (1, 4, 4, 150, 150, 128, True),
    (1, 4, 1, 90, 170, 128, False),
    (1, 2, 2, 70, 70, 20, True),           # D not a multiple of 8
    (1, 2, 2, 1, 1, 64, True),
]


@pytest.mark.parametrize("b,h,hk,s,t,d,causal", CASES)
def test_simt_schedule_matches_plain(b, h, hk, s, t, d, causal):
    q, k, v = _inputs(b, h, hk, s, t, d, s * 7 + t + d)
    got = ref.flash_attention_simt_ref(q, k, v, causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    _check(got, ref.flash_attention_ref(q, k, v, causal=causal), v)


@pytest.mark.parametrize("b,h,hk,s,t,d,causal",
                         [c for c in CASES if c[3] == c[4] or not c[6]])
def test_simt_schedule_matches_jax_chunked_attention(b, h, hk, s, t, d,
                                                     causal):
    q, k, v = _inputs(b, h, hk, s, t, d, s * 5 + t + d)
    got = ref.flash_attention_simt_ref(q, k, v, causal)
    want = jax_chunked(*(jnp.asarray(x.transpose(1, 2).numpy())
                         for x in (q, k, v)), causal=causal)
    _check(got, torch.from_numpy(np.array(want)).transpose(1, 2), v)


@pytest.mark.parametrize("scale", [0.0, -0.3, 0.05])
def test_simt_schedule_scales(scale):
    """The scale (times log2 e) is folded into Q before the row max, so a
    zero or negative scale gives the plain version's weights."""
    q, k, v = _inputs(1, 4, 2, 130, 130, 64, 21)
    got = ref.flash_attention_simt_ref(q, k, v, True, scale)
    _check(got, ref.flash_attention_ref(q, k, v, causal=True, scale=scale),
           v)


def test_simt_schedule_bf16_inputs():
    """bf16 inputs (refused by the tensor-core rule) are read as float32;
    the output rounds once to bf16 in the kernel."""
    q, k, v = _inputs(1, 4, 2, 150, 150, 48, 5, torch.bfloat16)
    got = ref.flash_attention_simt_ref(q, k, v, True)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=True)
    _check(got, want, v)


@pytest.mark.parametrize("d,want", [(1, (32, 4, 16)), (16, (32, 4, 16)),
                                    (33, (64, 4, 16)), (64, (64, 4, 16)),
                                    (72, (96, 4, 16)), (96, (96, 4, 16)),
                                    (128, (128, 4, 16)),
                                    (136, (160, 4, 16)),
                                    (192, (192, 4, 16))])
def test_simt_tiling(d, want):
    assert ref.simt_tiling(d) == want


# (B, H, Hk, S, T, D, Dv, causal): MLA's (192, 128) in the (192, 128)
# tiles, unequal dims in the (160, 128), (128, 128) and (64, 64) tiles
DV_CASES = [
    (1, 4, 4, 130, 130, 192, 128, True),
    (1, 2, 2, 77, 150, 192, 128, False),
    (1, 4, 2, 100, 100, 136, 64, True),
    (1, 4, 1, 90, 90, 64, 128, True),
    (1, 2, 2, 70, 70, 40, 24, True),
]


def _dv_inputs(b, h, hk, s, t, d, dv, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=sh).astype(np.float32))
            for sh in ((b, h, s, d), (b, hk, t, d), (b, hk, t, dv))]


@pytest.mark.parametrize("b,h,hk,s,t,d,dv,causal", DV_CASES)
def test_simt_schedule_at_two_head_dims(b, h, hk, s, t, d, dv, causal):
    """The schedule with a V head dim unlike the Q/K one against the
    plain version, (B, H, S, Dv) out, MLA's scale where D is 192."""
    q, k, v = _dv_inputs(b, h, hk, s, t, d, dv, s + d + dv)
    scale = 192 ** -0.5 if d == 192 else None
    got = ref.flash_attention_simt_ref(q, k, v, causal, scale)
    assert got.shape == (b, h, s, dv)
    _check(got, ref.flash_attention_ref(q, k, v, causal=causal,
                                        scale=scale), v)


@pytest.mark.parametrize("b,h,hk,s,t,d,dv,causal",
                         [c for c in DV_CASES if c[3] == c[4] or not c[7]])
def test_simt_schedule_at_two_head_dims_matches_jax(b, h, hk, s, t, d, dv,
                                                    causal):
    q, k, v = _dv_inputs(b, h, hk, s, t, d, dv, s * 3 + d + dv)
    scale = 192 ** -0.5 if d == 192 else None
    got = ref.flash_attention_simt_ref(q, k, v, causal, scale)
    want = jax_chunked(*(jnp.asarray(x.transpose(1, 2).numpy())
                         for x in (q, k, v)), causal=causal, scale=scale)
    _check(got, torch.from_numpy(np.array(want)).transpose(1, 2), v)


@pytest.mark.parametrize("d", [0, 193, 256])
def test_simt_tiling_refuses_wider_head_dims(d):
    with pytest.raises(ValueError, match="192"):
        ref.simt_tiling(d)
