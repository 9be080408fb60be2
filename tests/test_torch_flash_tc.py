"""The tensor-core flash kernel's arithmetic and its error bounds, on the CPU.

The kernel (``csrc/flash_attention.cu``, ``flash_attention_tc_kernel``)
runs only on the card; ``ref.flash_attention_tc_ref`` emulates its
arithmetic in plain torch, step for step (key tiles of 128 at head dims
up to 64, else 64; a running max in log2 units; the weights p rounded to
bf16 before P·V; float32 accumulation; l summed from the unrounded p;
1/l once at the end), and the card holds the kernel to it.  The tests
hold

* the bf16 emulation to the port's plain version within the tensor-core
  route's ``error_bound`` against it (one bf16 ulp plus
  (2^-13 + 2^-8) · sum_j w_j |v_j| per element), over causal and not,
  ragged S != T, GQA groups 1/4/8, head dims 16/64/128 and max |v| from
  1e-2 to 1e2;
* the tight bound against the emulation itself (one ulp,
  2^-13 · sum_j w_j |v_j| and the emulation's ``spread``): weights
  computed in another order stay within it, and a wrong tile of V
  fails it where the output averages over a thousand keys;
* the float32 route's bound to what it was;
* the emulation without the rounding, in float32, to the JAX reference
  ``repro.kernels.ref.flash_attention_ref`` (KV heads repeated, numpy in)
  at 1e-5: the tiling and the log2 recurrence compute the TPU kernel's
  function;
* the routing rule on the inputs it reads.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)


def _abs_out(q, k, v, causal, scale=None):
    """sum_j w_j |v_j| from the plain version: its weights applied to |v|."""
    return ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                   causal=causal, scale=scale)


def _inputs(b, h, hk, s, t, d, seed, vscale=1.0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((b, h, s, d), (b, hk, t, d), (b, hk, t, d)))
    return [torch.tensor(x).to(dtype) for x in (q, k, v * vscale)]


# (B, H, Hk, S, T, D, causal, max |v| scale)
BF16_CASES = [
    (1, 4, 4, 130, 130, 64, True, 1.0),
    (1, 4, 4, 130, 130, 64, False, 1.0),
    (1, 3, 3, 37, 200, 64, True, 1.0),        # S < T
    (1, 3, 3, 200, 37, 64, True, 1.0),        # S > T
    (1, 3, 3, 77, 131, 64, False, 1.0),
    (2, 8, 8, 100, 100, 64, True, 1.0),       # GQA group 1
    (2, 8, 2, 100, 100, 64, True, 1.0),       # group 4
    (2, 8, 1, 100, 100, 64, True, 1.0),       # group 8
    (1, 4, 2, 150, 150, 16, True, 1.0),
    (1, 4, 2, 150, 150, 128, True, 1.0),      # two 64-column chunks
    (1, 4, 2, 150, 150, 128, False, 1.0),
    (1, 4, 2, 300, 300, 64, True, 1e-2),
    (1, 4, 2, 300, 300, 64, True, 1e2),
    (1, 4, 2, 90, 170, 128, False, 1e2),
]


@pytest.mark.parametrize("b,h,hk,s,t,d,causal,vscale", BF16_CASES)
def test_tc_emulation_within_the_tensor_core_bound(b, h, hk, s, t, d,
                                                   causal, vscale):
    q, k, v = _inputs(b, h, hk, s, t, d, s * 7 + t + d, vscale)
    emu = ref.flash_attention_tc_ref(q, k, v, causal)
    plain = ref.flash_attention_ref(q, k, v, causal=causal)
    assert emu.out.dtype == torch.bfloat16 and emu.out.shape == plain.shape
    abs_out = _abs_out(q, k, v, causal)
    torch.testing.assert_close(emu.abs_out, abs_out, rtol=1e-5, atol=0)
    err = (emu.out.float() - plain.float()).abs()
    bound = fa.error_bound(emu.out, plain, v, abs_out)
    assert bool((err <= bound).all()), float((err / bound).max())


def test_rounded_weights_need_the_new_term():
    """The bf16 weights move the output by more than the float32 route's
    bound allows, and by more than reordering alone per element, so the
    tensor-core route cannot be held to either."""
    q, k, v = _inputs(2, 8, 1, 100, 100, 64, 3)
    emu = ref.flash_attention_tc_ref(q, k, v, causal=True)
    plain = ref.flash_attention_ref(q, k, v, causal=True)
    abs_out = _abs_out(q, k, v, True)
    err = (emu.out.float() - plain.float()).abs()
    assert not bool((err <= fa.error_bound(emu.out, plain, v)).all())
    no_rounding = fa.error_bound(emu.out, plain, v, abs_out,
                                 spread=torch.zeros_like(abs_out))
    assert not bool((err <= no_rounding).all())
    assert bool((err <= fa.error_bound(emu.out, plain, v, abs_out)).all())


def test_error_bound_terms_by_route():
    """The float32 route keeps its bound, 2^-13 max |v| (and bf16 outputs
    of the CUDA-core kernel one ulp more); the tensor-core route's terms
    are per element: (2^-13 + 2^-8) abs_out against the plain version,
    2^-13 abs_out + spread against the emulation."""
    rng = np.random.default_rng(4)
    v = torch.tensor(rng.normal(size=(1, 2, 50, 16)), dtype=torch.float32)
    out = torch.tensor(rng.normal(size=(1, 4, 30, 16)), dtype=torch.float32)
    abs_out = torch.tensor(rng.uniform(0, 2, size=out.shape),
                           dtype=torch.float32)
    spread = torch.tensor(rng.uniform(0, 1e-3, size=out.shape),
                          dtype=torch.float32)
    vmax = float(v.abs().max())
    f32 = fa.error_bound(out, out, v)
    assert fa.REORDER == 2.0 ** -13 and fa.P_ROUND == 2.0 ** -8
    assert bool((f32 == fa.REORDER * vmax).all())
    ob, vb = out.bfloat16(), v.bfloat16()
    simt = fa.error_bound(ob, ob, vb)
    ulp = simt - fa.REORDER * float(vb.float().abs().max())
    tc = fa.error_bound(ob, ob, vb, abs_out)
    torch.testing.assert_close(tc - ulp, (fa.REORDER + fa.P_ROUND)
                               * abs_out, rtol=1e-5, atol=1e-9)
    tight = fa.error_bound(ob, ob, vb, abs_out, spread)
    torch.testing.assert_close(tight - ulp, fa.REORDER * abs_out + spread,
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("b,h,hk,s,t,d,causal,vscale", BF16_CASES[::3])
def test_spread_covers_weights_computed_in_another_order(b, h, hk, s, t, d,
                                                         causal, vscale):
    """Logits moved by 2^-17 relative (the kernel's p, within 2^-13 of
    the emulation's, stand-in) change some rounded weights, and the
    output stays within the tight bound of the emulation."""
    q, k, v = _inputs(b, h, hk, s, t, d, s * 7 + t + d, vscale)
    emu = ref.flash_attention_tc_ref(q, k, v, causal)
    moved = ref.flash_attention_tc_ref(q, k, v, causal,
                                       scale=d ** -0.5 * (1 + 2.0 ** -17))
    assert not torch.equal(moved.out, emu.out)
    err = (moved.out.float() - emu.out.float()).abs()
    bound = fa.error_bound(moved.out, emu.out, v, emu.abs_out, emu.spread)
    assert bool((err <= bound).all()), float((err / bound).max())


def test_tight_bound_sees_a_wrong_value_tile():
    """A kernel that read one tile of V as zeros: the rows past the tile
    average over 1,500 keys, so the tile moves them little, and the bound
    against the plain version misses a quarter of their elements; the
    tight bound against the emulation, a quarter of its size or less,
    rejects nearly all of them."""
    q, k, v = _inputs(1, 2, 1, 2048, 2048, 64, 17)
    emu = ref.flash_attention_tc_ref(q, k, v, causal=True)
    wrong_v = v.clone()
    wrong_v[:, :, 1024:1152] = 0
    wrong = ref.flash_attention_tc_ref(q, k, wrong_v, causal=True).out
    plain = ref.flash_attention_ref(q, k, v, causal=True)
    late = slice(1536, None)               # rows 1,536.. see > 1,500 keys
    err_plain = (wrong.float() - plain.float()).abs()[:, :, late]
    err_emu = (wrong.float() - emu.out.float()).abs()[:, :, late]
    loose = fa.error_bound(wrong, plain, v, emu.abs_out)[:, :, late]
    tight = fa.error_bound(wrong, emu.out, v, emu.abs_out,
                           emu.spread)[:, :, late]
    seen_plain = float((err_plain > loose).float().mean())
    seen_emu = float((err_emu > tight).float().mean())
    assert seen_emu > 0.9 and seen_emu > seen_plain, (seen_emu, seen_plain)
    assert float(tight.median()) < float(loose.median()) / 4


# (B, H, Hk, S, T, D, causal): S == T under causal, where the JAX oracle
# and the kernel place the queries alike
F32_CASES = [
    (1, 2, 2, 160, 160, 64, True),
    (2, 4, 1, 70, 70, 16, True),
    (1, 4, 2, 45, 190, 128, False),
    (2, 4, 4, 130, 33, 64, False),
]


@pytest.mark.parametrize("b,h,hk,s,t,d,causal", F32_CASES)
def test_tc_emulation_float32_matches_jax_reference(b, h, hk, s, t, d,
                                                    causal):
    q, k, v = _inputs(b, h, hk, s, t, d, s + t, dtype=torch.float32)
    emu = ref.flash_attention_tc_ref(q, k, v, causal).out
    g = h // hk
    want = jax_flash_ref(jnp.asarray(q.numpy()),
                         jnp.asarray(np.repeat(k.numpy(), g, 1)),
                         jnp.asarray(np.repeat(v.numpy(), g, 1)),
                         causal=causal)
    np.testing.assert_allclose(emu.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_routing_rule():
    """bf16, head dim a multiple of 8 up to 128, 16-byte-aligned bases and
    (b, h, s) strides (where the axis has more than one entry) and a
    positive scale take the tensor cores; anything else the CUDA-core
    kernel."""
    rule = fa.takes_tensor_cores
    q, k = _bf16(2, 8, 40, 64), _bf16(2, 2, 40, 64)
    assert rule(q, k, k)
    assert not rule(q.float(), k.float(), k.float())
    for scale, ok in ((None, True), (0.05, True), (0.0, False),
                      (-0.3, False), (float("nan"), False)):
        assert rule(q, k, k, scale) == ok, scale
    for d, ok in ((8, True), (72, True), (128, True), (12, False),
                  (136, False)):
        assert rule(_bf16(1, 2, 9, d), _bf16(1, 1, 9, d),
                    _bf16(1, 1, 9, d)) == ok, d
    # the model's (B, S, H, D) activations as views, and a head slice
    x, y = _bf16(2, 40, 8, 64), _bf16(2, 40, 2, 64)
    assert rule(x.transpose(1, 2), y.transpose(1, 2), y.transpose(1, 2))
    assert rule(x.transpose(1, 2)[:, 2:6], y.transpose(1, 2)[:, :1],
                y.transpose(1, 2)[:, :1])
    # 2 bytes off a 16-byte boundary; a broadcast (stride 0) KV head axis
    flat = _bf16(2 * 8 * 40 * 64 + 8)
    assert flat.data_ptr() % 16 == 0
    assert not rule(flat[1:1 + q.numel()].view(q.shape), k, k)
    assert rule(flat[8:8 + q.numel()].view(q.shape), k, k)
    wide = k[:, :1].expand(2, 4, 40, 64)
    assert not rule(_bf16(2, 8, 40, 64), wide, wide)
    # an axis of extent 1 is never stepped: its stride does not count
    one = torch.as_strided(_bf16(40 * 64 + 8), (1, 1, 40, 64),
                           (3, 5, 64, 1))
    assert rule(one, one, one)


# (B, H, Hk, S, T, D, Dv, causal, scale): MLA's Q/K 192 and V 128 with
# its scale (128 + 64)^-0.5, phi3's 96 (computed at 128 columns) and the
# 128 of granite-3-8b and dbrx, then unequal dims either way
DV_CASES = [
    (1, 4, 4, 150, 150, 192, 128, True, 192 ** -0.5),
    (2, 4, 4, 130, 130, 96, 96, True, None),
    (1, 4, 1, 140, 140, 128, 128, True, None),
    (1, 3, 3, 77, 131, 192, 128, False, 192 ** -0.5),
    (1, 4, 2, 100, 100, 136, 64, True, 0.09),
    (1, 4, 2, 90, 170, 64, 128, False, None),
]


@pytest.mark.parametrize("b,h,hk,s,t,d,dv,causal,scale", DV_CASES)
def test_tc_emulation_at_two_head_dims(b, h, hk, s, t, d, dv, causal,
                                       scale):
    """The bf16 emulation with a V head dim unlike the Q/K one (key tiles
    of 64 wherever either dim exceeds 64) within the tensor-core bound of
    the plain version, (B, H, S, Dv) out."""
    q, k, v = _inputs(b, h, hk, s, t, d, s + t + d + dv)
    v = torch.tensor(np.random.default_rng(dv).normal(
        size=(b, hk, t, dv)).astype(np.float32)).bfloat16()
    emu = ref.flash_attention_tc_ref(q, k, v, causal, scale)
    plain = ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    assert emu.out.shape == plain.shape == (b, h, s, dv)
    abs_out = _abs_out(q, k, v, causal, scale)
    torch.testing.assert_close(emu.abs_out, abs_out, rtol=1e-5, atol=0)
    err = (emu.out.float() - plain.float()).abs()
    bound = fa.error_bound(emu.out, plain, v, abs_out)
    assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.parametrize("b,h,hk,s,t,d,dv,causal,scale",
                         [c for c in DV_CASES if c[3] == c[4] or not c[7]])
def test_tc_emulation_float32_at_two_head_dims_matches_jax(
        b, h, hk, s, t, d, dv, causal, scale):
    """Unrounded, the emulation computes the JAX model's attention
    (``repro.models.layers.chunked_attention``, (B, S, H, D) layout, GQA
    and Dv != D as the MLA prefill calls it) to float32 reordering."""
    from repro.models.layers import chunked_attention as jax_chunked
    rng = np.random.default_rng(d * dv + s)
    q, k, v = (torch.tensor(rng.normal(size=sh).astype(np.float32))
               for sh in ((b, h, s, d), (b, hk, t, d), (b, hk, t, dv)))
    emu = ref.flash_attention_tc_ref(q, k, v, causal, scale).out
    want = jax_chunked(*(jnp.asarray(x.transpose(1, 2).numpy())
                         for x in (q, k, v)), causal=causal, scale=scale)
    np.testing.assert_allclose(emu.transpose(1, 2).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_routing_rule_two_head_dims():
    """The tensor cores take a Q/K head dim that is a multiple of 8 up to
    192 and a V head dim that is one up to 128: MLA's (192, 128) does,
    (200, 128), (192, 136) and (192, 124) do not."""
    rule = fa.takes_tensor_cores
    assert fa.MAX_HEAD_DIM == 192 and fa.MAX_V_HEAD_DIM == 128
    for d, dv, ok in ((192, 128, True), (96, 96, True), (128, 128, True),
                      (64, 128, True), (136, 64, True), (200, 128, False),
                      (192, 136, False), (192, 124, False),
                      (188, 128, False)):
        assert rule(_bf16(1, 4, 9, d), _bf16(1, 4, 9, d),
                    _bf16(1, 4, 9, dv), 192 ** -0.5) == ok, (d, dv)
    # the MLA prefill's k: nope and a rope part broadcast to every head,
    # concatenated, as a (B, S, H, D) view
    k = torch.cat([_bf16(2, 30, 4, 128), _bf16(2, 30, 1, 64).expand(
        2, 30, 4, 64)], dim=-1).transpose(1, 2)
    v = _bf16(2, 30, 4, 128).transpose(1, 2)
    assert rule(_bf16(2, 30, 4, 192).transpose(1, 2), k, v)
