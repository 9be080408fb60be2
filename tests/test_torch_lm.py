"""The port's LM serving path against the JAX package on the CPU.

Inputs come from numpy with a seed and go through both packages; the
model tests carry the reference's parameters (``init_params(PRNGKey(0))``
on the granite-3-2b SMOKE config) across with
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
  attention keeps the weights in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import granite_3_2b as jgranite
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro_torch import convert
from repro_torch.configs import granite_3_2b
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models import transformer as T

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = "cpu"
SMOKE32 = dataclasses.replace(granite_3_2b.SMOKE, dtype="float32")
JSMOKE32 = dataclasses.replace(jgranite.SMOKE, dtype="float32")

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


def test_chunked_attention_refuses_unported_forms():
    x = torch.zeros((1, 4, 2, 16))
    with pytest.raises(NotImplementedError, match="S=4 != T=6"):
        layers.chunked_attention(x, torch.zeros((1, 6, 2, 16)),
                                 torch.zeros((1, 6, 2, 16)))
    with pytest.raises(NotImplementedError, match="MLA"):
        layers.chunked_attention(x, x, torch.zeros((1, 4, 2, 8)))


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


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_configs_equal_the_reference(name):
    ours = dataclasses.asdict(getattr(granite_3_2b, name))
    theirs = dataclasses.asdict(getattr(jgranite, name))
    assert ours == theirs
    cfg = getattr(granite_3_2b, name)
    shapes = jax.eval_shape(lambda: jT.init_params(getattr(jgranite, name),
                                                   jax.random.PRNGKey(0)))
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(l.shape)
             for path, l in jax.tree_util.tree_leaves_with_path(shapes)}
    assert jflat == T.param_shapes(cfg)
    assert cfg.param_count() == getattr(jgranite, name).param_count()


def test_unported_configs_raise():
    for kw, item in ((dict(moe=True), "MoE"), (dict(mla=True), "MLA")):
        cfg = dataclasses.replace(SMOKE32, **kw)
        with pytest.raises(NotImplementedError, match=item):
            T.init_params(cfg, device=CPU)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.init_cache(cfg, 1, 4, device=CPU)


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
    full = T.forward(params, torch.tensor(toks), SMOKE32)
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
