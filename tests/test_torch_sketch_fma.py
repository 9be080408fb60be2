"""The sketch kernel's arithmetic and its tiling, in plain PyTorch on the
CPU, against the JAX package.

The CUDA kernel (``csrc/sketch_conv.cu``) computes every projection as
one fused multiply-add chain over the taps w = 0 .. W-1 from 0.0, and
``ref.sketch_conv_fma_ref`` emulates that chain exactly (``ref.fma_f32``:
the product in float64, TwoSum, one rounding to float32 with the
residual's sign breaking a midpoint); the card holds the kernel to it
bit for bit.  Here:

* ``fma_f32`` rounds once, on midpoints built so that a second rounding
  goes the wrong way, and against exact rational arithmetic;
* the emulation equals the JAX package's plain sketch
  (``repro.kernels.ref.sketch_conv_ref``) within the bound of reordering
  a W-term sum, 2·W·2^-24·Σ|x·f|, and its sign bits equal the JAX
  package's ``sketch_bits`` on the SMOKE encoder's filter wherever
  |projection| exceeds that bound;
* a walk of the kernel's tiling — a warp a tile of 32·P windows of a
  row, a lane P consecutive windows, the span of x it reads walked once,
  each x applied to every window p whose tap w = j - step·p lies in
  [0, W) — is bit-identical to the emulation for steps 1-5, W 8 to 128,
  1 and 3 filters and N_B not a multiple of P (two tiles a row).

Inputs are made with numpy from a seed.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketch as jsk
from repro.kernels import ref as jref
from repro_torch.configs import ssh_ecg
from repro_torch.data.timeseries import extract_subsequences, synthetic_ecg
from repro_torch.encoders import SSHEncoder
from repro_torch.kernels import ref
from repro_torch.kernels import sketch_conv as sk

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

_F32 = torch.float32


def _f32(x):
    return torch.tensor([x], dtype=_F32)


def _exact_fma(a: float, b: float, c: float) -> np.float32:
    """a*b + c rounded once to float32 (nearest, ties to even), from
    exact rationals."""
    ex = Fraction(a) * Fraction(b) + Fraction(c)
    x = np.float32(float(ex))
    cands = [np.nextafter(x, np.float32(-np.inf)), x,
             np.nextafter(x, np.float32(np.inf))]
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - ex),
                                     int(np.array(y).view(np.int32)) & 1))


# (a, b, c, want): the exact sum a*b + c lies next to a float32 midpoint
# that float64 rounds it onto, so rounding twice goes the wrong way
TIES = [
    # 1 + 2^-24 + 2^-54: above the midpoint of 1 and 1 + 2^-23
    (3303821 * 2.0 ** -30, 325 * 2.0 ** -24, 1.0, 1.0 + 2.0 ** -23),
    # 1 + 2^-23 + 2^-24 - 2^-70: below the midpoint, rounds to the odd one
    (1.0 + 2.0 ** -23, (1.0 - 2.0 ** -23) * 2.0 ** -24, 1.0 + 2.0 ** -23,
     1.0 + 2.0 ** -23),
    # negated
    (-3303821 * 2.0 ** -30, 325 * 2.0 ** -24, -1.0, -(1.0 + 2.0 ** -23)),
    # an exact midpoint: ties to even
    (1.0, 2.0 ** -24, 1.0, 1.0),
    (1.0, 2.0 ** -24, 1.0 + 2.0 ** -23, 1.0 + 2.0 ** -22),
]


@pytest.mark.parametrize("a,b,c,want", TIES)
def test_fma_f32_rounds_once_at_midpoints(a, b, c, want):
    got = ref.fma_f32(_f32(a), _f32(b), _f32(c))
    assert float(got) == want == float(_exact_fma(a, b, c))


@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e6])
def test_fma_f32_equals_exact_rounding(scale):
    rng = np.random.default_rng(int(scale * 7) + 1)
    a = rng.normal(size=400).astype(np.float32)
    b = rng.normal(size=400).astype(np.float32)
    # c near -a*b half the time: cancellation leaves few bits
    c = np.where(rng.random(400) < 0.5, -(a * b),
                 rng.normal(size=400) * scale).astype(np.float32)
    got = ref.fma_f32(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    want = np.array([_exact_fma(float(x), float(y), float(z))
                     for x, y, z in zip(a, b, c)], dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _bound(x, filt, step):
    """2·W·2^-24·Σ|x·f|: the float32 bound of reordering a W-term sum."""
    w = filt.shape[0]
    return 2 * w * 2.0 ** -24 * ref.sketch_conv_ref(x.abs(), filt.abs(),
                                                    step)


@pytest.mark.parametrize("w,step,f,m", [(80, 3, 1, 512), (24, 3, 1, 128),
                                        (24, 1, 3, 130), (17, 5, 2, 301)])
def test_fma_ref_matches_jax_sketch(w, step, f, m):
    rng = np.random.default_rng(w * 10 + step)
    x = rng.normal(size=(9, m)).cumsum(1).astype(np.float32)
    filt = rng.normal(size=(w, f)).astype(np.float32)
    want = np.array(jref.sketch_conv_ref(jnp.asarray(x),
                                         jnp.asarray(filt), step))
    xt, ft = torch.from_numpy(x), torch.from_numpy(filt)
    got = ref.sketch_conv_fma_ref(xt, ft, step)
    assert got.shape == want.shape and got.dtype == _F32
    err = (got - torch.from_numpy(want)).abs()
    assert bool((err <= _bound(xt, ft, step)).all()), float(err.max())


def test_fma_ref_sign_bits_match_jax_on_smoke():
    """The SMOKE encoder's own filter (W 24, step 3) on z-normalised
    synthetic ECG windows, as the index hashes them."""
    spec = ssh_ecg.SMOKE
    filt = SSHEncoder(spec).materialize("cpu")._require_state()["filters"]
    step = spec.params["step"]
    x = torch.from_numpy(extract_subsequences(
        synthetic_ecg(300 * 16 + 128, seed=3), 128, stride=16,
        max_count=300, znorm=True))
    proj = ref.sketch_conv_fma_ref(x, filt, step)
    want = np.array(jsk.sketch_bits(jnp.asarray(x.numpy()),
                                    jnp.asarray(filt.numpy()), step))
    clear = proj.abs() > _bound(x, filt, step)
    assert float(clear.float().mean()) > 0.99
    got = (proj >= 0).to(torch.uint8)
    assert torch.equal(got[clear], torch.from_numpy(want)[clear])


def _kernel_walk(x: torch.Tensor, filt: torch.Tensor, step: int
                 ) -> torch.Tensor:
    """The kernel's schedule: per row tile of TILE = 32·P windows and per
    filter, lane l owns windows t0 + l·P .. + P - 1 and walks the segment
    from its first window's start, x_j for j = 0 .. step·(P - 1) + W - 1,
    applying each to every window p with tap w = j - step·p in [0, W)."""
    b, m = x.shape
    w_, f_ = filt.shape
    n_b = (m - w_) // step + 1
    out = torch.full((b, n_b, f_), float("nan"))
    lanes = torch.arange(32)
    for t0 in range(0, n_b, sk.TILE):
        start = t0 * step
        seg = torch.zeros((b, sk.seg_floats(w_, step)), dtype=_F32)
        n = min((sk.TILE - 1) * step + w_, m - start)
        seg[:, :n] = x[:, start:start + n]
        base = lanes * sk.P * step
        for f in range(f_):
            acc = torch.zeros((b, 32, sk.P), dtype=_F32)
            for j in range(step * (sk.P - 1) + w_):
                ps = [p for p in range(sk.P) if 0 <= j - step * p < w_]
                taps = filt[[j - step * p for p in ps], f]
                acc[:, :, ps] = ref.fma_f32(seg[:, base + j, None], taps,
                                            acc[:, :, ps])
            t = t0 + lanes[:, None] * sk.P + torch.arange(sk.P)[None, :]
            keep = t < n_b
            assert bool(out[:, t[keep], f].isnan().all())  # written once
            out[:, t[keep], f] = acc[:, keep]
    return out


@pytest.mark.parametrize("f", [1, 3])
@pytest.mark.parametrize("w", [8, 24, 80, 128])
@pytest.mark.parametrize("step", [1, 2, 3, 4, 5])
def test_kernel_walk_bit_identical_to_fma_ref(step, w, f):
    n_b = sk.TILE + 3                      # two tiles, not a multiple of P
    m = w + step * (n_b - 1) + step - 1    # a ragged row end
    rng = np.random.default_rng(step * 1000 + w * 10 + f)
    x = torch.from_numpy(rng.normal(size=(2, m)).cumsum(1).astype(
        np.float32))
    filt = torch.from_numpy(rng.normal(size=(w, f)).astype(np.float32))
    got = _kernel_walk(x, filt, step)
    want = ref.sketch_conv_fma_ref(x, filt, step)
    assert got.shape == want.shape == (2, n_b, f)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_shared_memory_sizes():
    """The wrapper's sizes of the kernel's shared memory: a segment
    holds the span of a tile's windows and the 16-byte lead; a block
    fits at ssh-ecg's W 80, step 3 with 4 warps."""
    for w, step in ((80, 3), (24, 1), (7, 5)):
        assert sk.seg_floats(w, step) % 4 == 0
        assert sk.seg_floats(w, step) >= (sk.TILE - 1) * step + w + 3
    assert sk.smem_bytes(80, 1, 3, warps=4) == 4 * (80 + 4 * 560)
    assert sk.smem_bytes(80, 1, 3, warps=4) <= sk.SMEM_LIMIT
