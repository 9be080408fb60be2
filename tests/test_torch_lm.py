"""The port's LM serving path against the JAX package on the CPU.

Inputs come from numpy with a seed and go through both packages; the
model tests carry the reference's parameters (``init_params(PRNGKey(0))``
on the SMOKE configs: granite-3-2b, dense GQA; dbrx-132b, MoE with a
ragged tail at 2 x 37 tokens in groups of 64; deepseek-v2-lite-16b, MoE
with a shared expert and MLA) across with
``convert.lm_params_from_arrays``.  The reference's Pallas flash kernel
does not run on this JAX (no ``pl.load``), so the port's attention is
held to the reference's plain oracle and to its ``chunked_attention``.

Tolerances, each with its reason:
* float32 attention, layers: 1e-5 / 1e-6 — the same arithmetic summed
  in another order;
* float32 model: rtol 1e-4 (atol 1e-5 on logits of size ~1) — 2 layers
  of matrix products in another order;
* bf16 attention: 3e-2, the reference's own bf16 bar
  (``tests/test_flash_attention.py``): its oracle rounds the logits and
  the softmax weights to bf16, the port's keeps both in float32;
* bf16 prefill: 5 % of max |logit| — the reference rounds every product
  and the attention weights to bf16 (``layers.py:73``), the port's
  attention keeps the weights in float32 (the MoE models route the same
  tokens to the same experts here: no gate lies near a tie).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dbrx_132b as jdbrx
from repro.configs import deepseek_v2_lite_16b as jdeepseek
from repro.configs import granite_3_2b as jgranite
from repro.configs import granite_3_8b as jgranite8
from repro.configs import phi3_mini_3_8b as jphi3
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro_torch import convert
from repro_torch.configs import (dbrx_132b, deepseek_v2_lite_16b,
                                 granite_3_2b, granite_3_8b, phi3_mini_3_8b)
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import layers, moe
from repro_torch.models import transformer as T

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = "cpu"
SMOKE32 = dataclasses.replace(granite_3_2b.SMOKE, dtype="float32")
JSMOKE32 = dataclasses.replace(jgranite.SMOKE, dtype="float32")
#: every LM config, the port's module beside the reference's
CONFIGS = {"granite-3-2b": (granite_3_2b, jgranite),
           "granite-3-8b": (granite_3_8b, jgranite8),
           "phi3-mini-3.8b": (phi3_mini_3_8b, jphi3),
           "dbrx-132b": (dbrx_132b, jdbrx),
           "deepseek-v2-lite-16b": (deepseek_v2_lite_16b, jdeepseek)}
#: the MoE and MLA models, whose SMOKE configs the parity tests run
NEW_PATHS = ["dbrx-132b", "deepseek-v2-lite-16b"]

# the shapes of tests/test_flash_attention.py
FLASH_SHAPES = [
    (1, 2, 32, 32, 16, True),
    (2, 4, 64, 64, 32, True),
    (1, 1, 40, 40, 16, True),
    (2, 2, 32, 32, 16, False),
    (1, 2, 16, 64, 16, True),       # s < t
]


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("b,h,s,t,d,causal", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_reference_oracle(b, h, s, t, d, causal, dtype):
    rng = np.random.default_rng(b * 100 + s + t + d)
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((b, h, s, d), (b, h, t, d), (b, h, t, d)))
    tdt = getattr(torch, dtype)
    jdt = jnp.dtype(dtype)
    got = ref.flash_attention_ref(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                                  causal=causal)
    assert got.dtype == tdt and got.shape == (b, h, s, d)
    if causal and s < t:
        # query i sees keys 0..i (the TPU kernel); the oracle aligns the
        # queries to the end of the keys, so compare on the first s keys,
        # as tests/test_flash_attention.py does
        k, v = k[:, :, :s], v[:, :, :s]
    want = jax_flash_ref(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                         jnp.asarray(v, jdt), causal=causal)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


def test_flash_ref_gqa_equals_repeated_heads_and_cpu_route():
    rng = np.random.default_rng(3)
    q = _t(rng.normal(size=(2, 8, 21, 16)))
    k = _t(rng.normal(size=(2, 2, 21, 16)))
    v = _t(rng.normal(size=(2, 2, 21, 16)))
    want = ref.flash_attention_ref(q, k.repeat_interleave(4, 1),
                                   v.repeat_interleave(4, 1), causal=True)
    torch.testing.assert_close(ref.flash_attention_ref(q, k, v, causal=True),
                               want, rtol=0, atol=0)
    ops.reset_launch_counts()
    torch.testing.assert_close(ops.flash_attention(q, k, v), want, rtol=0,
                               atol=0)
    assert ops.launch_counts()["flash_attention"] == 0   # CPU: plain version
    # scale: the oracle at scale c equals q * c * sqrt(D) at the default
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=False, scale=0.1),
        ref.flash_attention_ref(q * 0.4, k, v), rtol=1e-5, atol=1e-6)


def test_flash_error_bound_is_one_ulp_plus_reordering():
    """The card's tolerance: one bf16 unit in the last place at the
    larger value (none in float32) plus 2^-13 max |v|."""
    from repro_torch.kernels.flash_attention import REORDER, error_bound
    plain = torch.tensor([1.0, 0.75, -3.0, 0.0], dtype=torch.bfloat16)
    kern = torch.tensor([1.0078125, 0.75, -3.0, 0.0], dtype=torch.bfloat16)
    v = torch.tensor([[-2.0, 1.0]], dtype=torch.bfloat16)
    got = error_bound(kern, plain, v)
    want = torch.tensor([2.0 ** -7, 2.0 ** -8, 2.0 ** -6, 2.0 ** -133])
    torch.testing.assert_close(got, want + 2 * REORDER, rtol=0, atol=0)
    f32 = error_bound(plain.float(), plain.float(), v.float())
    assert bool((f32 == 2 * REORDER).all())


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax(causal):
    rng = np.random.default_rng(5)
    b, s, h, hk, d = 2, 37, 4, 2, 16        # S not a multiple of the chunk
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     q_chunk=16, kv_chunk=8)
    got = layers.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                   q_chunk=16, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dv,scale", [(24, 16, 24 ** -0.5),
                                        (12, 20, 0.3)])
def test_chunked_attention_two_head_dims_matches_jax(causal, d, dv, scale):
    """The V head dim unlike the Q/K one (MLA's (dn + dr, dv) at SMOKE
    size, and the reverse) with an explicit scale, GQA, S not a multiple
    of the chunk: (B, S, H, Dv) out."""
    rng = np.random.default_rng(5)
    b, s, h, hk = 2, 37, 4, 2
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((b, s, h, d), (b, s, hk, d), (b, s, hk, dv)))
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     q_chunk=16, kv_chunk=8, scale=scale)
    got = layers.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                   q_chunk=16, kv_chunk=8, scale=scale)
    assert got.shape == (b, s, h, dv)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_chunked_attention_refuses_unported_forms():
    """The forms once refused, causal S != T and ``kv_valid``, are
    computed now: S = 4 queries against T = 6 keys sit at positions 2..5,
    as in the reference (tests/test_torch_attention_offset.py holds the
    rest)."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 4, 2, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 6, 2, 16)).astype(np.float32)
            for _ in range(2))
    valid = np.array([6, 3], np.int32)
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True,
                                     kv_valid=jnp.asarray(valid))
    got = layers.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                                   kv_valid=torch.tensor(valid))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(6)
    b, t, h, hk, d = 3, 29, 8, 4, 16
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, t, hk, d)).astype(np.float32)
    valid = np.array([t, t - 5, 7], np.int32)
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(valid))
    got = layers.decode_attention(_t(q), _t(k), _t(v),
                                  torch.tensor(valid))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-6)


def test_rms_norm_and_swiglu_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(_t(x), _t(w)).numpy(),
        _np(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    wg, wu = (rng.normal(size=(64, 96)).astype(np.float32) * 0.1
              for _ in range(2))
    wd = rng.normal(size=(96, 64)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        layers.swiglu(_t(x), _t(wg), _t(wu), _t(wd)).numpy(),
        _np(jlayers.swiglu(*map(jnp.asarray, (x, wg, wu, wd)))),
        rtol=1e-6, atol=1e-6)
    # bf16: the same cast order (normalise in f32, cast, scale in bf16)
    got = layers.rms_norm(_t(x, torch.bfloat16), _t(w, torch.bfloat16))
    want = jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(w, jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize("pos_rank", [1, 2])
def test_apply_rope_matches_jax(pos_rank):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = (np.arange(9, dtype=np.int32) if pos_rank == 1 else
           rng.integers(0, 500, size=(2, 9)).astype(np.int32))
    np.testing.assert_allclose(
        layers.apply_rope(_t(x), torch.tensor(pos), 1e4).numpy(),
        _np(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch,name", [
    pytest.param(arch, name, id=name if arch == "granite-3-2b"
                 else f"{arch}-{name}")
    for arch in CONFIGS for name in ("CONFIG", "SMOKE")])
def test_configs_equal_the_reference(arch, name):
    """Field for field; the same parameter paths, shapes and dtypes (the
    float32 MoE router) and the same count.  The reference's
    ``param_count`` multiplies each leaf's shape in int32 (``jnp.prod``),
    which wraps for a leaf of 2^31 elements or more (dbrx's stacked
    experts, 42.3e9): there the two agree modulo 2^32, and the port's
    equals the exact sum of the reference's leaf sizes."""
    ours, theirs = (getattr(m, name) for m in CONFIGS[arch])
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.moe_cfg.__dict__ == theirs.moe_cfg.__dict__
    shapes = jax.eval_shape(lambda: jT.init_params(theirs,
                                                   jax.random.PRNGKey(0)))
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(l.shape)
             for path, l in leaves}
    assert jflat == T.param_shapes(ours)
    for path, l in leaves:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        assert str(T.param_dtype(ours, key))[6:] == str(l.dtype), key
    exact = sum(math.prod(l.shape) for _, l in leaves)
    assert ours.param_count() == exact
    assert theirs.param_count() % 2 ** 32 == exact % 2 ** 32
    if all(math.prod(l.shape) < 2 ** 31 for _, l in leaves):
        assert theirs.param_count() == exact


def test_serving_archs_are_the_configs():
    assert set(serve.LM_ARCHS) == set(CONFIGS)
    for arch, (mod, _) in CONFIGS.items():
        assert serve.LM_ARCHS[arch] is mod.ARCH
        assert mod.ARCH.config is mod.CONFIG and mod.ARCH.smoke_config is mod.SMOKE


def test_init_params_distributions_and_seed():
    cfg = dataclasses.replace(SMOKE32, d_model=256, n_heads=8, n_kv_heads=2,
                              d_ff=512, n_layers=4)
    p = T.init_params(cfg, torch.Generator().manual_seed(1), CPU)
    again = T.init_params(cfg, torch.Generator().manual_seed(1), CPU)
    other = T.init_params(cfg, torch.Generator().manual_seed(2), CPU)
    assert torch.equal(p["layers"]["wq"], again["layers"]["wq"])
    assert not torch.equal(p["layers"]["wq"], other["layers"]["wq"])
    so = 0.02 / (2 * cfg.n_layers) ** 0.5
    for path, t in T.flatten(p).items():
        assert tuple(t.shape) == T.param_shapes(cfg)[path]
        assert t.dtype == torch.float32
        if path in ("ln_f", "layers/ln_attn", "layers/ln_mlp"):
            assert bool((t == 1).all())
            continue
        want = so if path in ("layers/wo", "layers/w_down") else 0.02
        assert abs(float(t.std()) / want - 1) < 0.05, path
        assert abs(float(t.mean())) < 0.05 * want, path
    bf = T.init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                       torch.Generator().manual_seed(1), CPU)
    assert torch.equal(bf["embed"], p["embed"].to(torch.bfloat16))


def _jax_params(jcfg, seed=0):
    params = jT.init_params(jcfg, jax.random.PRNGKey(seed))
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_lm_params_exact(dtype):
    jcfg = dataclasses.replace(jgranite.SMOKE, dtype=dtype)
    cfg = dataclasses.replace(granite_3_2b.SMOKE, dtype=dtype)
    _, arrays = _jax_params(jcfg)
    params = convert.lm_params_from_arrays(arrays, cfg, device=CPU)
    flat = T.flatten(params)
    for path, a in T.flatten(arrays).items():
        t = flat[path]
        assert t.dtype == cfg.torch_dtype and tuple(t.shape) == a.shape
        if dtype == "bfloat16":       # the bit patterns, not just values
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    bad = dict(T.flatten(arrays))
    bad.pop("layers/wq")
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params_from_arrays(T.unflatten(bad), cfg, device=CPU)
    with pytest.raises(ValueError, match="config implies"):
        convert.lm_params_from_arrays(
            arrays, dataclasses.replace(cfg, d_ff=64), device=CPU)


@pytest.fixture(scope="module")
def smoke_state():
    """The reference's SMOKE parameters (float32) and the port's copy."""
    jparams, arrays = _jax_params(JSMOKE32)
    return jparams, convert.lm_params_from_arrays(arrays, SMOKE32,
                                                  device=CPU)


def _tokens(b, s, seed=11):
    return np.random.default_rng(seed).integers(0, SMOKE32.vocab, (b, s))


def test_prefill_and_forward_match_jax(smoke_state):
    jparams, params = smoke_state
    toks = _tokens(2, 21)
    want = jT.prefill(jparams, jnp.asarray(toks, jnp.int32), JSMOKE32)
    got = T.prefill(params, torch.tensor(toks), SMOKE32)
    assert got.shape == (2, 1, SMOKE32.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-5)
    full_want, _ = jT.forward(jparams, jnp.asarray(toks, jnp.int32),
                              JSMOKE32)
    full, aux = T.forward(params, torch.tensor(toks), SMOKE32)
    assert aux.dtype == torch.float32 and float(aux) == 0.0    # dense
    np.testing.assert_allclose(full.numpy(), _np(full_want), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(full[:, -1:], got, rtol=1e-5, atol=1e-6)


def test_decode_steps_and_cache_match_jax(smoke_state):
    jparams, params = smoke_state
    b, steps = 2, 24
    toks = _tokens(b, steps, seed=12)
    jcache = jT.init_cache(JSMOKE32, b, steps + 4)
    cache = T.init_cache(SMOKE32, b, steps + 4, device=CPU)
    jdec = jax.jit(lambda p, c, t: jT.decode_step(p, c, t, JSMOKE32))
    for i in range(steps):
        jl, jcache = jdec(jparams, jcache, jnp.asarray(toks[:, i:i + 1],
                                                       jnp.int32))
        lg, cache = T.decode_step(params, cache, torch.tensor(toks[:, i:i + 1]),
                                  SMOKE32)
        np.testing.assert_allclose(lg.numpy(), _np(jl), rtol=1e-4, atol=1e-5,
                                   err_msg=f"step {i}")
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), _np(jcache[key]),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(cache["length"].numpy(),
                                  np.asarray(jcache["length"]))


def test_serve_tokens_match_jax(smoke_state):
    """The reference's serve_lm loop (2 prompts of 16, 8 greedy tokens)
    on both packages: the same generated tokens."""
    jparams, params = smoke_state
    b, p, g = 2, 16, 8
    prompts = np.random.default_rng(0).integers(0, SMOKE32.vocab, (b, p))
    jdec = jax.jit(lambda pr, c, t: jT.decode_step(pr, c, t, JSMOKE32))
    jcache = jT.init_cache(JSMOKE32, b, p + g)
    jtoks = jnp.asarray(prompts, jnp.int32)
    for i in range(p):
        logits, jcache = jdec(jparams, jcache, jtoks[:, i:i + 1])
    jout = []
    for _ in range(g):
        nxt = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        jout.append(nxt)
        logits, jcache = jdec(jparams, jcache, nxt)
    want = np.asarray(jnp.concatenate(jout, axis=1))
    res = serve.serve_lm(SMOKE32, params, prompts, gen_len=g, device=CPU)
    np.testing.assert_array_equal(res.generated.numpy(), want)
    assert res.prefill_logits.shape == (b, 1, SMOKE32.vocab)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_prefill_agrees_with_stepped_decode(dtype, tol):
    """The chip gate at SMOKE size: the prefill's last-position logits
    (the flash path's causal mask) equal the decode logits after the last
    prompt token (``decode_attention``'s ``kv_valid`` mask), within
    ``tol`` x max |logit| — float32 reordering, or bf16 rounding at other
    places on the two paths — with the argmax equal where the top-2
    margin exceeds that."""
    cfg = dataclasses.replace(granite_3_2b.SMOKE, dtype=dtype)
    res = serve.serve_lm(cfg, batch=3, prompt_len=19, gen_len=2, seed=4,
                         device=CPU)
    out = serve.check_prefill_against_decode(res, tol)
    assert out["rows"] == 3 and out["rel_diff"] <= tol
    if dtype == "float32":
        assert out["rows_decided"] == out["argmax_equal"] == 3
    # a wrong mask is caught: decode logits of another prompt
    res.prompt_logits = res.prompt_logits.roll(1, dims=0)
    with pytest.raises(RuntimeError, match="disagree"):
        serve.check_prefill_against_decode(res, tol)


def test_prefill_bf16_close_to_jax():
    jcfg = jgranite.SMOKE
    cfg = granite_3_2b.SMOKE
    assert cfg.dtype == "bfloat16"
    jparams, arrays = _jax_params(jcfg, seed=3)
    params = convert.lm_params_from_arrays(arrays, cfg, device=CPU)
    toks = _tokens(2, 33, seed=13)
    want = _np(jT.prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg))
    got = T.prefill(params, torch.tensor(toks), cfg).float().numpy()
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_serve_cli_on_cpu(capsys):
    assert serve.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5", "--gen-len",
                       "3"]) == 0
    out = capsys.readouterr().out
    assert "granite-3-2b (smoke) on cpu" in out and "sample: [" in out
    assert serve.main(["--arch", "ssh-ecg", "--device", "cpu",  # the fleet
                       "--replication", "2", "--requests", "1",
                       "--batch-size", "1"]) == 0
    out = capsys.readouterr().out
    assert "fleet serving is single-probe" in out and "fleet: hedged=" in out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "phi3-mini", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["granite-3-8b", "phi3-mini-3.8b"]
                         + NEW_PATHS)
def test_serve_cli_lm_arches_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "5", "--gen-len",
                       "2"]) == 0
    out = capsys.readouterr().out
    assert f"{arch} (smoke) on cpu" in out and "sample: [" in out


# -- MoE (dbrx) and MoE + MLA (deepseek-v2-lite) SMOKE configs ------------

def _configs(arch, dtype):
    mod, jmod = CONFIGS[arch]
    return (dataclasses.replace(mod.SMOKE, dtype=dtype),
            dataclasses.replace(jmod.SMOKE, dtype=dtype))


@pytest.fixture(scope="module", params=NEW_PATHS)
def new_state(request):
    """(arch, the reference's float32 SMOKE parameters, the port's copy)."""
    cfg, jcfg = _configs(request.param, "float32")
    jparams, arrays = _jax_params(jcfg)
    return (request.param, jparams,
            convert.lm_params_from_arrays(arrays, cfg, device=CPU))


def _close(got, want, rtol=1e-5):
    """Within rtol of each value, and of max |want| near zero."""
    want = _np(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("arch", NEW_PATHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_moe_mla_params_exact(arch, dtype):
    """Every leaf bit for bit, the router float32 beside bf16 weights;
    a router cast to the model's type is refused."""
    cfg, jcfg = _configs(arch, dtype)
    _, arrays = _jax_params(jcfg)
    params = convert.lm_params_from_arrays(arrays, cfg, device=CPU)
    flat = T.flatten(params)
    assert flat["layers/router"].dtype == torch.float32
    for path, a in T.flatten(arrays).items():
        t = flat[path]
        assert t.dtype == T.param_dtype(cfg, path)
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    if dtype == "bfloat16":
        bad = dict(T.flatten(arrays))
        bad["layers/router"] = np.asarray(
            jnp.asarray(bad["layers/router"], jnp.bfloat16))
        with pytest.raises(ValueError, match="router"):
            convert.lm_params_from_arrays(T.unflatten(bad), cfg, device=CPU)


def test_init_params_moe_mla_dtypes_and_scales():
    cfg = dataclasses.replace(deepseek_v2_lite_16b.SMOKE, n_layers=3,
                              d_model=128)
    p = T.flatten(T.init_params(cfg, torch.Generator().manual_seed(4), CPU))
    so = 0.02 / (2 * cfg.n_layers) ** 0.5
    assert set(p) == set(T.param_shapes(cfg))
    for path, t in p.items():
        assert tuple(t.shape) == T.param_shapes(cfg)[path]
        assert t.dtype == T.param_dtype(cfg, path)
        if path.endswith(("ln_f", "ln_attn", "ln_mlp")):
            continue
        want = so if path.endswith(("wo", "we_down", "ws_down")) else 0.02
        assert abs(float(t.float().std()) / want - 1) < 0.1, path
    assert p["layers/router"].dtype == torch.float32
    assert p["layers/wq"].dtype == torch.bfloat16


def test_moe_mla_prefill_and_forward_match_jax(new_state):
    arch, jparams, params = new_state
    cfg, jcfg = _configs(arch, "float32")
    toks = _tokens(2, 37)               # 74 tokens: a group of 64 + a tail
    full_want, _ = jT.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    full, _ = T.forward(params, torch.tensor(toks), cfg)
    assert full.shape == (2, 37, cfg.vocab)
    _close(full, full_want)
    got = T.prefill(params, torch.tensor(toks), cfg)
    _close(got, jT.prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg))
    torch.testing.assert_close(full[:, -1:], got, rtol=1e-5, atol=1e-6)


def test_moe_mla_decode_steps_and_cache_match_jax(new_state):
    """Stepped decode (MLA: the absorbed path over the latent cache; the
    MoE in decode groups of B tokens), logits and cache every step."""
    arch, jparams, params = new_state
    cfg, jcfg = _configs(arch, "float32")
    b, steps = 3, 12
    toks = _tokens(b, steps, seed=12)
    jcache = jT.init_cache(jcfg, b, steps + 4)
    cache = T.init_cache(cfg, b, steps + 4, device=CPU)
    assert set(cache) == set(jcache)
    jdec = jax.jit(lambda p, c, t: jT.decode_step(p, c, t, jcfg))
    for i in range(steps):
        jl, jcache = jdec(jparams, jcache,
                          jnp.asarray(toks[:, i:i + 1], jnp.int32))
        lg, cache = T.decode_step(params, cache,
                                  torch.tensor(toks[:, i:i + 1]), cfg)
        _close(lg, jl)
    for key in cache:
        if key == "length":
            np.testing.assert_array_equal(cache[key].numpy(),
                                          np.asarray(jcache[key]))
        else:
            assert cache[key].shape == jcache[key].shape
            _close(cache[key], jcache[key])


def test_moe_mla_serve_tokens_match_jax(new_state):
    """The reference's serve_lm loop (2 prompts of 16, 8 greedy tokens):
    the same generated tokens."""
    arch, jparams, params = new_state
    cfg, jcfg = _configs(arch, "float32")
    b, p, g = 2, 16, 8
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (b, p))
    jdec = jax.jit(lambda pr, c, t: jT.decode_step(pr, c, t, jcfg))
    jcache = jT.init_cache(jcfg, b, p + g)
    jtoks = jnp.asarray(prompts, jnp.int32)
    for i in range(p):
        logits, jcache = jdec(jparams, jcache, jtoks[:, i:i + 1])
    jout = []
    for _ in range(g):
        nxt = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        jout.append(nxt)
        logits, jcache = jdec(jparams, jcache, nxt)
    res = serve.serve_lm(cfg, params, prompts, gen_len=g, device=CPU)
    np.testing.assert_array_equal(res.generated.numpy(),
                                  np.asarray(jnp.concatenate(jout, axis=1)))


@pytest.mark.parametrize("arch", NEW_PATHS)
def test_moe_mla_prefill_bf16_close_to_jax(arch):
    cfg, jcfg = _configs(arch, "bfloat16")
    jparams, arrays = _jax_params(jcfg, seed=3)
    params = convert.lm_params_from_arrays(arrays, cfg, device=CPU)
    toks = _tokens(2, 33, seed=13)
    want = _np(jT.prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg))
    got = T.prefill(params, torch.tensor(toks), cfg).float().numpy()
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


@pytest.mark.parametrize("arch", NEW_PATHS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_moe_prefill_agrees_with_stepped_decode(arch, dtype, tol):
    """The chip gate at SMOKE size for the MoE models, at a capacity
    factor that drops nothing in the prefill's group or the decode's
    (C >= n_g, as the reference's own decode test sets it): the
    prefill's last logits equal the decode logits after the prompt."""
    mod, _ = CONFIGS[arch]
    cfg = dataclasses.replace(mod.SMOKE, dtype=dtype,
                              capacity_factor=float(mod.SMOKE.n_experts))
    for n_g in (cfg.moe_group_size, 3):
        assert moe.capacity(cfg.moe_cfg, n_g) >= n_g
    res = serve.serve_lm(cfg, batch=3, prompt_len=19, gen_len=2, seed=4,
                         device=CPU)
    out = serve.check_prefill_against_decode(res, tol)
    assert out["rows"] == 3 and out["rel_diff"] <= tol
