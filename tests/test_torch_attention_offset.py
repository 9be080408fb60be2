"""Attention with a query offset and a per-batch key bound, on the CPU.

The reference's ``repro.models.layers.chunked_attention`` aligns causal
queries to the end of the keys (query i sits at T - S + i) and masks the
keys at positions >= ``kv_valid[b]``; the port's ``chunked_attention``
passes ``q_offset = T - S`` and ``kv_valid`` to both flash kernels, whose
plain version (``ref.flash_attention_ref``) and emulations
(``ref.flash_attention_simt_ref``, ``ref.flash_attention_tc_ref``) carry
the same mask.  Inputs come from numpy with a seed.

Tolerances, each with its reason:
* float32 forward: rtol 1e-5 / atol 1e-5 — the same sums in another
  order;
* float32 gradients: 1e-5 x max |jax grad| (as ``test_torch_train.py``);
* bf16 tensor-core emulation against the plain version: the route's own
  ``error_bound`` with ``abs_out``.

Rows that see no key (kv_valid[b] = 0, or a causal row with i + T - S <
0) are 0 in the port.  The reference gives sum(V) / T padded to
``kv_chunk`` there (its masked logits are -1e30, not -inf, so every
padded slot weighs 1): a fault of the reference that depends on its
tiling, pinned below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)


def _inputs(b, s, t, h, hk, d, dv, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, s, h, d), (b, t, hk, d), (b, t, hk, dv))]


def _kv_valid(kind, b, t, seed):
    """None, or (B,) int32 with a 0, a T and seeded values between."""
    if kind is None:
        return None
    rng = np.random.default_rng(seed)
    kv = rng.integers(1, t, size=b).astype(np.int32)
    if kind == "mixed":
        kv[0], kv[-1] = 0, t
    return kv


def _seen(b, s, t, causal, kv):
    """(B, S) bool: the row sees at least one key."""
    kv_len = np.full(b, t) if kv is None else np.clip(kv, 0, t)
    rows = np.arange(s)[None, :]
    seen = np.broadcast_to(kv_len[:, None] > 0, (b, s))
    if causal:
        seen = seen & (rows + t - s >= 0)
    return seen


# (B, S, T, H, Hk, D, Dv, causal, kv_valid kind)
CASES = [
    (2, 13, 37, 4, 2, 16, 16, True, None),        # S < T, GQA
    (3, 13, 37, 4, 2, 16, 16, True, "mixed"),
    (3, 13, 37, 4, 1, 24, 16, True, "mixed"),     # MLA's Dv != D
    (2, 29, 29, 4, 2, 16, 16, True, "mixed"),     # S = T
    (2, 29, 29, 4, 4, 24, 16, False, "mixed"),
    (2, 41, 23, 4, 2, 16, 16, True, None),        # S > T
    (3, 41, 23, 4, 2, 24, 16, True, "mixed"),
    (2, 13, 37, 4, 2, 16, 16, False, "ones"),     # kv_valid, no zero
    (2, 1, 37, 4, 2, 16, 16, True, "mixed"),      # one decode step
]


@pytest.mark.parametrize("b,s,t,h,hk,d,dv,causal,kind", CASES)
def test_chunked_attention_offset_and_key_bound_match_jax(
        b, s, t, h, hk, d, dv, causal, kind):
    q, k, v = _inputs(b, s, t, h, hk, d, dv, b + s + t + d)
    kv = _kv_valid(kind, b, t, s + t)
    want = np.asarray(jlayers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_chunk=16, kv_chunk=8, scale=d ** -0.5,
        kv_valid=None if kv is None else jnp.asarray(kv)))
    got = layers.chunked_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
        q_chunk=16, kv_chunk=8, scale=d ** -0.5,
        kv_valid=None if kv is None else torch.tensor(kv)).numpy()
    assert got.shape == (b, s, h, dv)
    seen = _seen(b, s, t, causal, kv)
    np.testing.assert_allclose(got[seen], want[seen], rtol=1e-5, atol=1e-5)
    assert not np.any(got[~seen])


@pytest.mark.parametrize("kv_chunk", [8, 16])
def test_reference_fault_rows_that_see_no_key(kv_chunk):
    """The reference's row that sees no key is sum(V) / T padded to its
    kv chunk (for every query head of a KV head), so it changes with the
    tiling; the port's is 0."""
    b, s, t, h, hk, d = 2, 4, 20, 4, 2, 16
    q, k, v = _inputs(b, s, t, h, hk, d, d, 3)
    kv = np.array([0, t], np.int32)
    want = np.asarray(jlayers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_chunk=16, kv_chunk=kv_chunk, kv_valid=jnp.asarray(kv)))
    padded = -(-t // kv_chunk) * kv_chunk
    fault = np.repeat(v[0].sum(0) / padded, h // hk, axis=0)   # (H, Dv)
    np.testing.assert_allclose(want[0], np.broadcast_to(fault, want[0].shape),
                               rtol=1e-5, atol=1e-6)
    got = layers.chunked_attention(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), causal=True,
                                   kv_valid=torch.tensor(kv)).numpy()
    assert not np.any(got[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


# (B, S, T, H, Hk, D, Dv, causal, kv_valid kind): every row sees a key
GRAD_CASES = [
    (2, 13, 37, 4, 2, 16, 16, True, None),
    (3, 13, 37, 4, 2, 24, 16, True, "ones"),
    (2, 29, 29, 4, 4, 16, 16, False, "ones"),
]


@pytest.mark.parametrize("b,s,t,h,hk,d,dv,causal,kind", GRAD_CASES)
@pytest.mark.parametrize("block_elems", [1 << 27, 2 * 4 * 37 * 5])
def test_offset_gradient_matches_jax(b, s, t, h, hk, d, dv, causal, kind,
                                     block_elems, monkeypatch):
    """``ops.FlashAttention``'s backward with the offset and key bound
    against ``jax.grad`` of the reference's chunked attention, whole and
    in blocks of a few query rows."""
    monkeypatch.setattr(ref, "BWD_BLOCK_ELEMS", block_elems)
    q, k, v = _inputs(b, s, t, h, hk, d, dv, 11 + s + t)
    kv = _kv_valid(kind, b, t, 5)
    w = np.random.default_rng(1).normal(size=(b, s, h, dv)).astype(
        np.float32)

    def jloss(q, k, v):
        o = jlayers.chunked_attention(
            q, k, v, causal=causal, q_chunk=16, kv_chunk=16,
            kv_valid=None if kv is None else jnp.asarray(kv))
        return jnp.sum(o * w)
    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = layers.chunked_attention(
        tq, tk, tv, causal=causal,
        kv_valid=None if kv is None else torch.tensor(kv))
    (o * torch.tensor(w)).sum().backward()
    for got, jgrad in zip((tq, tk, tv), want):
        jgrad = np.asarray(jgrad)
        np.testing.assert_allclose(got.grad.numpy(), jgrad, rtol=0,
                                   atol=1e-5 * float(np.abs(jgrad).max()))


def test_rows_without_keys_have_no_gradient():
    """A batch with kv_valid 0 and causal rows before the first key: the
    output there is 0 whatever q, k and v are, and so is the gradient
    those rows send."""
    q, k, v = _inputs(2, 9, 5, 2, 1, 16, 16, 4)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = layers.chunked_attention(tq, tk, tv, causal=True,
                                 kv_valid=torch.tensor([0, 5]))
    assert not bool(o[0].any()) and not bool(o[1, :4].any())
    o.sum().backward()
    assert not bool(tq.grad[0].any()) and not bool(tq.grad[1, :4].any())
    assert not bool(tk.grad[0].any()) and not bool(tv.grad[0].any())
    assert bool(tq.grad[1, 4:].any())


def _bhsd(b, h, hk, s, t, d, dv, seed, dtype=torch.float32, vscale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((b, h, s, d), (b, hk, t, d), (b, hk, t, dv)))
    return [torch.tensor(x).to(dtype) for x in (q, k, v * vscale)]


# (B, H, Hk, S, T, D, Dv, causal, q_offset, kv_valid kind): multi-tile
# shapes (64-row blocks, 16-row warps, 64- and 128-key tiles); offsets
# that line up with the 16-row sub-blocks and ones that do not
EMU_CASES = [
    (2, 2, 1, 100, 230, 64, 64, True, 130, "mixed"),   # T - S, unaligned
    (2, 2, 2, 100, 228, 64, 64, True, 128, "mixed"),   # T - S, aligned
    (2, 2, 1, 130, 130, 64, 64, True, 0, "mixed"),
    (1, 2, 1, 150, 90, 32, 32, True, -60, None),       # S > T
    (1, 2, 1, 150, 86, 32, 32, True, -64, None),       # S > T, aligned
    (2, 2, 2, 70, 190, 96, 64, True, 16, "mixed"),
    (2, 2, 1, 70, 190, 48, 32, False, 0, "mixed"),
    (3, 2, 1, 65, 140, 16, 16, True, 75, "ones"),
]


@pytest.mark.parametrize("b,h,hk,s,t,d,dv,causal,off,kind", EMU_CASES)
def test_emulations_with_offset_match_the_plain_version(
        b, h, hk, s, t, d, dv, causal, off, kind):
    """The CUDA-core kernel's schedule (skips only where the offset lines
    up with its sub-blocks; a skipped pair some row sees would show as
    NaN) and the tensor-core kernel's recurrence in float32 against the
    plain version, 0 where a row sees no key."""
    q, k, v = _bhsd(b, h, hk, s, t, d, dv, s + t + off)
    kv = _kv_valid(kind, b, t, s)
    kv = None if kv is None else torch.tensor(kv)
    plain = ref.flash_attention_ref(q, k, v, causal, None, off, kv)
    simt = ref.flash_attention_simt_ref(q, k, v, causal, None, off, kv)
    tc = ref.flash_attention_tc_ref(q, k, v, causal, None, off, kv).out
    assert not bool(torch.isnan(plain).any())
    torch.testing.assert_close(simt, plain, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tc, plain, rtol=1e-5, atol=1e-5)
    hidden = ref.attention_hidden(s, t, causal, off, kv)
    none = (hidden.all(-1) if hidden is not None
            else torch.zeros((1, 1, s), dtype=torch.bool))
    none = none.expand(b, h, s)
    for out in (plain, simt, tc):
        assert not bool(out[none].any())


@pytest.mark.parametrize("b,h,hk,s,t,d,dv,causal,off,kind", EMU_CASES[:6])
def test_tc_emulation_bf16_within_its_bound_with_offset(
        b, h, hk, s, t, d, dv, causal, off, kind):
    q, k, v = _bhsd(b, h, hk, s, t, d, dv, s * 3 + t + off,
                    dtype=torch.bfloat16)
    kv = _kv_valid(kind, b, t, t)
    kv = None if kv is None else torch.tensor(kv)
    emu = ref.flash_attention_tc_ref(q, k, v, causal, None, off, kv)
    plain = ref.flash_attention_ref(q, k, v, causal, None, off, kv)
    abs_out = ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                      causal, None, off, kv)
    torch.testing.assert_close(emu.abs_out, abs_out, rtol=1e-5, atol=0)
    err = (emu.out.float() - plain.float()).abs()
    bound = fa.error_bound(emu.out, plain, v, abs_out)
    assert bool((err <= bound).all()), float((err / bound).max())


def test_ops_flash_attention_takes_the_offset_on_the_cpu():
    """``ops.flash_attention`` on a CPU tensor is the plain version with
    the same offset and key bound, and a (B,) bound of another length is
    refused."""
    q, k, v = _bhsd(2, 4, 2, 9, 21, 16, 16, 2)
    kv = torch.tensor([3, 21])
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, True, None, 12, kv),
        ref.flash_attention_ref(q, k, v, True, None, 12, kv), rtol=0,
        atol=0)
    with pytest.raises(ValueError, match="kv_valid"):
        ops.flash_attention(q, k, v, True, None, 0, torch.tensor([3]))
