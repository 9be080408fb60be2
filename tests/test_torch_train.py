"""The port's LM training against the JAX package on the CPU.

Inputs come from numpy with a seed; the models carry the reference's
parameters (``init_params(PRNGKey(0))`` on the SMOKE configs) across with
``convert.lm_params_from_arrays``.  The reference has no backward kernel:
``jax.grad`` differentiates its chunked jnp ``chunked_attention``, so the
port's ``ops.FlashAttention`` (the plain forward here, the chunked plain
backward) is held to that gradient.

Tolerances, each with its reason:
* float64 gradcheck: torch's defaults (eps 1e-6, atol 1e-5, rtol 1e-3);
* float32 attention gradients: 1e-5 x max |jax grad| — the same sums in
  another order (measured 2e-7 to 5e-7 of the max);
* float32 model loss and gradients (2 layers): rtol 1e-4 and 1e-5 x max
  |jax grad| per leaf (measured below 7e-7 of the max);
* AdamW on the same gradients: 1e-6 relative, and 1e-6 x max of the
  leaf near zero (where b1 m + (1 - b1) g cancels) — a rounding apart
  (the port fuses a multiply into an add where the reference rounds
  twice; the grad norms, summed in another order, scale the clip);
* the launcher against the reference's ``train_step``: the gradients
  agree to float32 reordering, which Adam's normalised step can turn into
  a sign flip of a near-zero gradient, moving a parameter by up to
  2 x sum of lr_t; parameters within that, losses within 1e-4.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.configs import dbrx_132b as jdbrx
from repro.configs import deepseek_v2_lite_16b as jdeepseek
from repro.configs import granite_3_2b as jgranite
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro.train import grad_compress as jgc
from repro.train.optimizer import AdamW as JAdamW
from repro_torch import convert
from repro_torch.configs import (dbrx_132b, deepseek_v2_lite_16b,
                                 granite_3_2b)
from repro_torch.configs.base import TensorSpec
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps, train
from repro_torch.models import layers, moe
from repro_torch.models import transformer as T
from repro_torch.train import grad_compress as gc
from repro_torch.train.optimizer import AdamW, AdamWState, tree_leaves

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = "cpu"
MODELS = {"granite-3-2b": (granite_3_2b, jgranite),
          "dbrx-132b": (dbrx_132b, jdbrx),
          "deepseek-v2-lite-16b": (deepseek_v2_lite_16b, jdeepseek)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_to_max(got, want, frac=1e-5, rtol=1e-4):
    want = _np(want)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=frac * max(np.abs(want).max(), 1e-30))


# --------------------------------------------------------------------------
# the attention gradient
# --------------------------------------------------------------------------

#: (B, S, T, H, Hk, D, Dv, causal)
GRAD_SHAPES = [
    (2, 37, 37, 4, 2, 16, 16, True),     # GQA, causal, a ragged chunk
    (1, 40, 40, 4, 4, 24, 16, True),     # Dv != D (MLA's split)
    (2, 19, 33, 6, 2, 8, 12, False),     # non-causal, S != T, GQA, Dv != D
    (1, 24, 24, 2, 1, 8, 8, False),      # non-causal, one KV head
]


@pytest.mark.parametrize("causal,h,hk,d,dv", [
    (True, 4, 2, 4, 3), (False, 4, 2, 4, 3), (True, 2, 2, 5, 5),
    (False, 3, 1, 3, 4)])
@pytest.mark.parametrize("block_elems", [1 << 27, 40])
def test_flash_function_gradcheck_float64(causal, h, hk, d, dv, block_elems,
                                          monkeypatch):
    """``FlashAttention`` (forward plain, backward chunked) against finite
    differences in float64; ``block_elems`` 40 forces blocks of a few
    rows."""
    monkeypatch.setattr(ref, "BWD_BLOCK_ELEMS", block_elems)
    rng = np.random.default_rng(h * 10 + d + causal)
    s = t = 6
    q = torch.tensor(rng.normal(size=(1, h, s, d)), requires_grad=True)
    k = torch.tensor(rng.normal(size=(1, hk, t, d)), requires_grad=True)
    v = torch.tensor(rng.normal(size=(1, hk, t, dv)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.FlashAttention.apply(q, k, v, causal, 0.7),
        (q, k, v))


@pytest.mark.parametrize("b,s,t,h,hk,d,dv,causal", GRAD_SHAPES)
@pytest.mark.parametrize("block_elems", [1 << 27, 600])
def test_chunked_attention_grad_matches_jax(b, s, t, h, hk, d, dv, causal,
                                            block_elems, monkeypatch):
    """The port's ``chunked_attention`` differentiated through the
    Function against ``jax.grad`` of the reference's ``chunked_attention``
    (float32, chunks of 16), at one block and at blocks of a few rows."""
    monkeypatch.setattr(ref, "BWD_BLOCK_ELEMS", block_elems)
    rng = np.random.default_rng(b + s + t + h + d + dv)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, t, hk, dv)).astype(np.float32)
    w = rng.normal(size=(b, s, h, dv)).astype(np.float32)

    def jloss(q, k, v):
        o = jlayers.chunked_attention(q, k, v, causal=causal, q_chunk=16,
                                      kv_chunk=16)
        return jnp.sum(o * w)
    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = layers.chunked_attention(tq, tk, tv, causal=causal, q_chunk=16,
                                 kv_chunk=16)
    (o * torch.tensor(w)).sum().backward()
    for got, ref_grad in zip((tq, tk, tv), want):
        assert got.grad.dtype == torch.float32
        _close_to_max(got.grad.numpy(), ref_grad)


@pytest.mark.parametrize("block_elems", [1 << 27, 2 * 6 * 29, 2 * 6 * 29 * 7])
def test_bwd_ref_equals_autograd_through_the_plain_version(block_elems,
                                                           monkeypatch):
    """The chunked backward against autograd through
    ``flash_attention_ref`` (which keeps the (S, T) logits), causal GQA at
    Dv != D, whole and in blocks of 1 and 7 rows."""
    monkeypatch.setattr(ref, "BWD_BLOCK_ELEMS", block_elems)
    rng = np.random.default_rng(7)
    q = torch.tensor(rng.normal(size=(2, 6, 29, 24)), dtype=torch.float32,
                     requires_grad=True)
    k = torch.tensor(rng.normal(size=(2, 2, 29, 24)), dtype=torch.float32,
                     requires_grad=True)
    v = torch.tensor(rng.normal(size=(2, 2, 29, 16)), dtype=torch.float32,
                     requires_grad=True)
    do = torch.tensor(rng.normal(size=(2, 6, 29, 16)), dtype=torch.float32)
    o = ref.flash_attention_ref(q, k, v, causal=True, scale=0.3)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      o.detach(), do, True, 0.3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))


def test_bwd_block_rows_rule():
    assert ref.bwd_block_rows(4, 32, 4096, 4096) == 256   # granite, batch 4
    assert ref.bwd_block_rows(1, 16, 2048, 2048) == 2048  # at most S
    assert ref.bwd_block_rows(1, 1, 10, 10) == 10            # at most S
    assert ref.bwd_block_rows(64, 64, 1 << 16, 1 << 16) == 1   # at least 1
    rows = ref.bwd_block_rows(3, 5, 1 << 20, 1000)
    assert rows % 64 == 0 and 3 * 5 * rows * 1000 <= ref.BWD_BLOCK_ELEMS


def test_flash_builds_a_graph_only_under_grad():
    """Inputs that need no gradient (the serving path) leave no autograd
    node on the output; under grad the node is the Function's."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.tensor(rng.normal(size=(1, 2, 8, 8)),
                            dtype=torch.float32) for _ in range(3))
    assert ops.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_(True)
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None


# --------------------------------------------------------------------------
# the loss and the model's gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 11, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 11))
    mask = (rng.random((3, 11)) < 0.6).astype(np.float32) if masked else None
    want = jlayers.cross_entropy_loss(
        jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy_loss(
        torch.tensor(logits).to(torch.bfloat16), torch.tensor(labels),
        None if mask is None else torch.tensor(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    empty = layers.cross_entropy_loss(torch.tensor(logits),
                                      torch.tensor(labels),
                                      torch.zeros(3, 11))
    assert float(empty) == 0.0      # an empty mask divides by 1


def _model_state(arch):
    mod, jmod = MODELS[arch]
    cfg = dataclasses.replace(mod.SMOKE, dtype="float32")
    jcfg = dataclasses.replace(jmod.SMOKE, dtype="float32")
    jparams = jT.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_arrays(jax.tree.map(np.asarray, jparams),
                                           cfg, device=CPU)
    return cfg, jcfg, jparams, params


def _lm_batch(cfg, b=2, s=37, seed=5):
    """2 x 37 tokens: the MoE SMOKE groups of 64 leave a ragged tail."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s)),
            rng.integers(0, cfg.vocab, (b, s)))


def _grads(params, cfg, toks, labels):
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
        leaf.grad = None
    loss, metrics = T.loss_fn(params, {"tokens": torch.tensor(toks),
                                       "labels": torch.tensor(labels)}, cfg)
    loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    grads = {p: t.grad.clone() for p, t in T.flatten(params).items()}
    return loss.detach(), metrics, grads


@pytest.fixture(scope="module", params=list(MODELS))
def model_state(request):
    return (request.param,) + _model_state(request.param)


def test_loss_fn_and_grads_match_jax(model_state):
    """loss, ce, aux and every parameter's gradient against
    ``jax.value_and_grad(repro.models.transformer.loss_fn)``: dense, MoE
    (with a ragged tail) and MoE with shared experts and MLA."""
    arch, cfg, jcfg, jparams, params = model_state
    toks, labels = _lm_batch(cfg)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32)}
    (jl, jm), jgrads = jax.value_and_grad(
        lambda p: jT.loss_fn(p, jbatch, jcfg), has_aux=True)(jparams)
    loss, metrics, grads = _grads(params, cfg, toks, labels)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(jm["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                               rtol=1e-5, atol=1e-7)
    assert (float(metrics["aux"]) > 0) == cfg.moe
    jflat = T.flatten(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(grads)
    for path, g in grads.items():
        assert g.dtype == T.param_dtype(cfg, path), path
        _close_to_max(g.numpy(), jflat[path])
    if cfg.moe:     # the aux loss and the gate weights reach the router
        assert float(grads["layers/router"].abs().max()) > 0


def test_remat_on_equals_off_and_routes_alike(model_state, monkeypatch):
    """Per-layer remat recomputes the forward in the backward: the loss
    and every gradient equal remat off bit for bit, and every recomputed
    MoE gating routes the tokens as the first pass did."""
    arch, cfg, jcfg, jparams, params = model_state
    toks, labels = _lm_batch(cfg, seed=9)
    routes = []
    real_gating = moe.gating

    def recording(logits, mcfg, n_g):
        routing, aux = real_gating(logits, mcfg, n_g)
        routes.append(routing.expert.clone())
        return routing, aux
    monkeypatch.setattr(moe, "gating", recording)
    off = _grads(params, dataclasses.replace(cfg, remat=False), toks, labels)
    assert len(routes) == (cfg.n_layers if cfg.moe else 0)
    routes.clear()
    on = _grads(params, dataclasses.replace(cfg, remat=True), toks, labels)
    assert torch.equal(on[0], off[0])
    for path in off[2]:
        assert torch.equal(on[2][path], off[2][path]), path
    if cfg.moe:
        # forward then, layer by layer from the last, its recompute
        n = cfg.n_layers
        assert len(routes) == 2 * n
        first, recomputed = routes[:n], routes[n:][::-1]
        for a, b in zip(first, recomputed):
            assert torch.equal(a, b)


def test_remat_recomputes_the_attention_forward(monkeypatch):
    """With remat, the attention forward runs twice a layer (once in the
    backward's recompute); without, once."""
    cfg, _, _, params = _model_state("granite-3-2b")
    toks, labels = _lm_batch(cfg, s=16)
    calls = []
    real = ref.flash_attention_ref

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(ref, "flash_attention_ref", counting)
    _grads(params, dataclasses.replace(cfg, remat=False), toks, labels)
    assert len(calls) == cfg.n_layers
    calls.clear()
    _grads(params, dataclasses.replace(cfg, remat=True), toks, labels)
    assert len(calls) == 2 * cfg.n_layers
    calls.clear()
    with torch.no_grad():                # serving: no remat, no Function
        T.prefill(params, torch.tensor(toks), cfg)
    assert len(calls) == cfg.n_layers


def test_forward_returns_logits_and_aux(model_state):
    arch, cfg, jcfg, jparams, params = model_state
    toks, _ = _lm_batch(cfg)
    with torch.no_grad():
        logits, aux = T.forward(params, torch.tensor(toks), cfg)
    jlogits, jaux = jT.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    assert logits.shape == (2, 37, cfg.vocab) and aux.dtype == torch.float32
    _close_to_max(logits.numpy(), jlogits)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def _opt_tree(rng):
    """A small tree with bf16 and float32 leaves, nested like the LM's."""
    return {"embed": rng.normal(size=(6, 4)).astype(np.float32),
            "layers": {"w": rng.normal(size=(2, 4, 3)).astype(np.float32),
                       "router": rng.normal(size=(4, 5)).astype(np.float32)},
            "ln_f": np.ones(4, np.float32)}


@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_three_steps_match_jax(clip):
    """m, v, master, params (bf16 beside float32), grad_norm and lr of
    three updates on the same gradients, the clip active (grad norm ~30)
    or off; warm-up 2 and weight decay 0.1."""
    rng = np.random.default_rng(0)
    arrays = _opt_tree(rng)
    bf16 = {"embed", "w"}
    kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=2, grad_clip=clip)
    jopt, opt = JAdamW(**kw), AdamW(**kw)

    def jleaf(path, a):
        return jnp.asarray(a, jnp.bfloat16 if path in bf16 else jnp.float32)

    def tleaf(path, a):
        return torch.tensor(a).to(torch.bfloat16 if path in bf16
                                  else torch.float32)
    jparams = {"embed": jleaf("embed", arrays["embed"]),
               "layers": {k: jleaf(k, v) for k, v in arrays["layers"].items()},
               "ln_f": jleaf("ln_f", arrays["ln_f"])}
    params = {"embed": tleaf("embed", arrays["embed"]),
              "layers": {k: tleaf(k, v) for k, v in arrays["layers"].items()},
              "ln_f": tleaf("ln_f", arrays["ln_f"])}
    jstate, state = jopt.init(jparams), opt.init(params)
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 8).astype(
            np.float32), arrays)
        jg = {"embed": jleaf("embed", g["embed"]),
              "layers": {k: jleaf(k, v) for k, v in g["layers"].items()},
              "ln_f": jleaf("ln_f", g["ln_f"])}
        tg = {"embed": tleaf("embed", g["embed"]),
              "layers": {k: tleaf(k, v) for k, v in g["layers"].items()},
              "ln_f": tleaf("ln_f", g["ln_f"])}
        jparams, jstate, jm = jopt.update(jparams, jstate, jg)
        params, state, m = opt.update(params, state, tg)
        assert int(state.step) == int(jstate.step) == i + 1
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert m["lr"] == float(jm["lr"])
        for got, want in ((state.m, jstate.m), (state.v, jstate.v),
                          (state.master, jstate.master)):
            for gl, wl in zip(tree_leaves(got), jax.tree.leaves(want)):
                assert gl.dtype == torch.float32
                wl = np.asarray(wl)
                np.testing.assert_allclose(gl.numpy(), wl, rtol=1e-6,
                                           atol=1e-6 * np.abs(wl).max())
        for gl, wl in zip(tree_leaves(params), jax.tree.leaves(jparams)):
            assert str(gl.dtype)[6:] == str(wl.dtype)
            # a master one rounding apart may round to the next bf16
            np.testing.assert_allclose(gl.float().numpy(), _np(wl),
                                       rtol=2 ** -8)


def test_adamw_updates_slices_in_place(monkeypatch):
    """Slicing the leaves (``CHUNK``) changes nothing; params and state
    are updated in place."""
    from repro_torch.train import optimizer
    rng = np.random.default_rng(4)
    base = {"a": torch.tensor(rng.normal(size=(37, 5)), dtype=torch.float32)
            .to(torch.bfloat16),
            "b": torch.tensor(rng.normal(size=(11,)), dtype=torch.float32)}
    grads = {k: torch.tensor(rng.normal(size=v.shape), dtype=torch.float32)
             .to(v.dtype) for k, v in base.items()}
    opt = AdamW(lr=1e-2, warmup_steps=1)
    results = []
    for chunk in (1 << 25, 7):
        monkeypatch.setattr(optimizer, "CHUNK", chunk)
        params = {k: v.clone() for k, v in base.items()}
        state = opt.init(params)
        a_ptr = params["a"].data_ptr()
        out, state, m = opt.update(params, state, grads)
        assert out["a"].data_ptr() == a_ptr
        results.append((out, state, m))
    (p1, s1, m1), (p2, s2, m2) = results
    for k in base:
        assert torch.equal(p1[k], p2[k]) and torch.equal(s1.m[k], s2.m[k])
        assert torch.equal(s1.master[k], s2.master[k])
    torch.testing.assert_close(m1["grad_norm"], m2["grad_norm"], rtol=1e-6,
                               atol=0)


def test_adamw_converges_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, warmup_steps=1, grad_clip=None)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = opt.update(params, state, g)
    torch.testing.assert_close(params["w"], target, atol=1e-2, rtol=0)


# --------------------------------------------------------------------------
# gradient compression (as tests/test_infra.py holds the reference's)
# --------------------------------------------------------------------------

def test_topk_keeps_largest_and_matches_jax():
    rng = np.random.default_rng(0)
    g = rng.normal(size=100).astype(np.float32)
    out = gc.topk_compress(torch.tensor(g), 0.1).numpy()
    kept = np.nonzero(out)[0]
    assert len(kept) >= 10
    thresh = np.sort(np.abs(g))[-10]
    assert np.all(np.abs(g[kept]) >= thresh - 1e-6)
    np.testing.assert_array_equal(out, np.asarray(
        jgc.topk_compress(jnp.asarray(g), 0.1)))


def test_int8_roundtrip_error_and_noise_parity():
    """The bound of the reference's test, and the reference's
    quantisation bit for bit given its own noise."""
    rng = np.random.default_rng(1)
    g = rng.normal(size=256).astype(np.float32)
    q, s = gc.int8_quantize(torch.tensor(g),
                            torch.Generator().manual_seed(0))
    assert q.dtype == torch.int8
    back = gc.int8_dequantize(q, s)
    assert float((back - torch.tensor(g)).abs().max()) <= float(s) * 1.01
    key = jax.random.PRNGKey(3)
    jq, js = jgc.int8_quantize(jnp.asarray(g), key)
    noise = np.asarray(jax.random.uniform(key, g.shape, jnp.float32, -0.5,
                                          0.5))
    tq, ts = gc.int8_quantize_noise(torch.tensor(g), torch.tensor(noise))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)


def test_error_feedback_unbiased_over_time():
    rng = np.random.default_rng(2)
    true = torch.tensor(rng.normal(size=64), dtype=torch.float32)
    frac, rounds = 0.05, 400
    residual = gc.init_residual({"w": true})
    sent_total = torch.zeros_like(true)
    jres = jgc.init_residual({"w": jnp.asarray(true.numpy())})
    for i in range(rounds):
        sent, residual = gc.compress_with_feedback(
            {"w": true}, residual, scheme="topk", topk_frac=frac)
        sent_total += sent["w"]
        if i < 20:      # the reference's sends, round for round
            jsent, jres = jgc.compress_with_feedback(
                {"w": jnp.asarray(true.numpy())}, jres, scheme="topk",
                topk_frac=frac)
            np.testing.assert_array_equal(sent["w"].numpy(),
                                          np.asarray(jsent["w"]))
    avg = (sent_total / rounds).numpy()
    bound = 2.0 * float(true.abs().max()) / (frac * rounds)
    np.testing.assert_allclose(avg, true.numpy(), atol=bound)
    assert np.abs(avg - true.numpy()).max() < 0.5


def test_compression_schemes_run():
    rng = np.random.default_rng(3)
    grads = {"a": torch.tensor(rng.normal(size=(8, 8)), dtype=torch.float32),
             "b": {"c": torch.tensor(rng.normal(size=5),
                                     dtype=torch.bfloat16)}}
    res = gc.init_residual(grads)
    for scheme in ("topk", "int8", "none"):
        sent, res2 = gc.compress_with_feedback(
            grads, res, scheme=scheme,
            generator=torch.Generator().manual_seed(1))
        assert sent["a"].shape == (8, 8) and sent["b"]["c"].shape == (5,)
        assert res2["b"]["c"].dtype == torch.float32
        for k in ("a",):
            torch.testing.assert_close(sent[k] + res2[k], grads[k])
    with pytest.raises(ValueError, match="Generator"):
        gc.compress_with_feedback(grads, res, scheme="int8")
    with pytest.raises(ValueError):
        gc.compress_with_feedback(grads, res, scheme="fp4")


# --------------------------------------------------------------------------
# configs, steps and the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(MODELS) + ["granite-3-8b",
                                                  "phi3-mini-3.8b"])
def test_arch_defs_match_the_reference(arch):
    from repro.configs import get_arch as jget_arch
    ours, theirs = get_arch(arch), jget_arch(arch)
    assert ours.family == theirs.family == "lm"
    assert set(ours.shapes) == set(theirs.shapes)
    for shape, cell in theirs.shapes.items():
        assert ours.shapes[shape].kind == cell.kind
        assert ours.shapes[shape].meta == cell.meta
        kind, spec = ours.input_specs(shape)
        jkind, jspec = theirs.input_specs(shape)
        assert kind == jkind
        flat = jax.tree_util.tree_leaves_with_path(jspec)
        ours_flat = dict(jax.tree_util.tree_leaves_with_path(
            spec, is_leaf=lambda x: isinstance(x, TensorSpec)))
        assert len(flat) == len(ours_flat)
        for path, s in flat:
            o = ours_flat[path]
            assert o.shape == tuple(s.shape), path
            assert str(o.dtype)[6:] == str(s.dtype), path


def test_steps_refuse_what_is_queued():
    from repro_torch.configs.base import ArchDef, ShapeCell
    recsys = ArchDef("bst", "recsys", None, None,
                     {"train_batch": ShapeCell("train", {"batch": 8})})
    for fn in (lambda: steps.init_fn(recsys, "train_batch"),
               lambda: steps.make_step(recsys, "train_batch", "train"),
               lambda: recsys.input_specs("train_batch")):
        with pytest.raises(NotImplementedError, match="7.5"):
            fn()
    with pytest.raises(NotImplementedError, match="7.8"):
        steps.make_step(get_arch("ssh-ecg"), "build", "build")
    with pytest.raises(NotImplementedError, match="7.8"):
        steps.abstract_state(get_arch("granite-3-2b"), "train_4k")
    assert steps.make_optimizer("lm") == AdamW(lr=3e-4, weight_decay=0.1)


def test_prefill_and_decode_steps():
    arch = get_arch("granite-3-2b")
    params = steps.init_fn(arch, "prefill_32k", smoke=True, device=CPU)(
        torch.Generator().manual_seed(0))
    toks = torch.tensor(np.random.default_rng(0).integers(0, 256, (2, 9)))
    last = steps.make_step(arch, "prefill_32k", "prefill", smoke=True)(
        params, {"tokens": toks})
    assert last.shape == (2, 1, 256) and last.grad_fn is None
    cache = T.init_cache(arch.smoke_config, 2, 9, CPU)
    decode = steps.make_step(arch, "decode_32k", "decode", smoke=True)
    for i in range(9):
        logits, cache = decode(params, cache, toks[:, i:i + 1])
    torch.testing.assert_close(logits.float(), last.float(), rtol=0.05,
                               atol=0.05 * float(last.abs().max()))
    _, spec = arch.input_specs("decode_32k")
    assert spec["cache"]["k"] == TensorSpec((40, 128, 32768, 8, 64),
                                            torch.bfloat16)


@pytest.mark.parametrize("step_idx", [0, 3])
def test_synthetic_batch_matches_reference(step_idx):
    """The same batch as the reference's ``synthetic_batch``: labels drawn
    before tokens (sorted keys)."""
    jarch = jgranite.ARCH
    want = jtrain.synthetic_batch(jarch, "train_4k", True, step_idx)
    got = train.synthetic_batch(get_arch("granite-3-2b"), "train_4k", True,
                                step_idx, CPU)
    assert list(got) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    cut = train.cut_batch(get_arch("granite-3-2b"), "train_4k", 4)
    assert cut.input_specs("train_4k")[1]["tokens"].shape == (4, 4096)
    assert get_arch("granite-3-2b").shapes["train_4k"].meta["batch"] == 256


def _float32_arch(module):
    return dataclasses.replace(
        module.ARCH, smoke_config=dataclasses.replace(module.SMOKE,
                                                      dtype="float32"))


def test_train_main_matches_reference_and_resumes(tmp_path, monkeypatch):
    """``launch.train.main --smoke --device cpu`` in float32 against the
    reference's ``train_step`` on the same batches from the same state:
    the reference writes step 0 (its initial parameters and AdamW state),
    the port resumes it and trains to step 3 (a checkpoint at 2 and 3);
    the reference restores the port's step 3 and trains steps 3-4 beside
    the port's resumed run.  Losses within 1e-4, parameters within 2 x
    sum lr_t of the reference's."""
    arch32 = _float32_arch(granite_3_2b)
    monkeypatch.setattr(train, "get_arch", lambda name: arch32)
    jarch = _float32_arch(jgranite)
    jparams = jsteps.init_fn(jarch, "train_4k", smoke=True)()
    jopt = jsteps.make_optimizer("lm")
    jstate = jopt.init(jparams)
    jck.save_checkpoint(tmp_path, 0, {"params": jparams, "opt": jstate})
    jstep = jax.jit(jsteps.make_step(jarch, "train_4k", "train", smoke=True))

    def jrun(params, state, start, stop):
        losses = []
        for i in range(start, stop):
            params, state, m = jstep(params, state, jtrain.synthetic_batch(
                jarch, "train_4k", True, i))
            losses.append(float(m["loss"]))
        return params, state, losses

    argv = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    run = train.main(argv + ["--steps", "3"])
    assert run.start == 0 and [r["step"] for r in run.history] == [0, 1, 2]
    jp3, js3, jlosses = jrun(jparams, jstate, 0, 3)
    np.testing.assert_allclose([r["loss"] for r in run.history], jlosses,
                               rtol=1e-4)
    assert [r["lr"] for r in run.history] == [
        float(jopt.schedule(jnp.int32(i))) for i in (1, 2, 3)]
    assert jck.all_steps(tmp_path) == [0, 2, 3]
    # the reference resumes the port's float32 checkpoint
    step, restored = jck.restore_checkpoint(tmp_path,
                                            {"params": jp3, "opt": js3})
    assert step == 3 and int(restored["opt"].step) == 3
    jp5, _, jlosses = jrun(restored["params"], restored["opt"], 3, 5)
    resumed = train.main(argv + ["--steps", "5"])
    assert resumed.start == 3
    np.testing.assert_allclose([r["loss"] for r in resumed.history], jlosses,
                               rtol=1e-4)
    atol = 2 * sum(jopt.schedule(jnp.int32(i)) for i in range(1, 6))
    jflat = T.flatten(jax.tree.map(np.asarray, jp5))
    for path, t in T.flatten(resumed.params).items():
        np.testing.assert_allclose(t.detach().numpy(), jflat[path], rtol=0,
                                   atol=float(atol))
    manifest = json.loads((tmp_path / "step_0000000005" / "manifest.json")
                          .read_text())
    assert "opt/.master/layers/wq" in manifest["arrays"]


def test_train_main_bf16_smoke_checkpoints_and_resumes(tmp_path):
    """The real SMOKE config (bf16): finite losses near log(vocab), the
    bf16 parameters checkpointed and resumed, the batch cut reported."""
    argv = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    run = train.main(argv + ["--steps", "2"])
    assert all(np.isfinite(r["loss"]) for r in run.history)
    assert abs(run.history[0]["loss"] - np.log(256)) < 0.1
    manifest = json.loads((tmp_path / "step_0000000002" / "manifest.json")
                          .read_text())
    assert manifest["arrays"]["params/embed"]["dtype"] == "bfloat16"
    assert manifest["arrays"]["opt/.master/embed"]["dtype"] == "float32"
    resumed = train.main(argv + ["--steps", "3"])
    assert resumed.start == 2 and len(resumed.history) == 1
    again = train.main(argv + ["--steps", "3"])     # nothing left to run
    assert again.start == 3 and again.history == []
    def state(run):
        return [leaf for tree in (run.params, run.opt_state.m,
                                  run.opt_state.v, run.opt_state.master)
                for leaf in tree_leaves(tree)]
    for a, b in zip(state(resumed), state(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)   # bit for bit


def test_train_main_cuts_the_batch_and_the_depth(capsys):
    run = train.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                      "--steps", "1", "--batch", "2"])
    assert "batch CUT from 256 to 2" in capsys.readouterr().out
    assert len(run.history) == 1
    assert run.params["layers"]["wq"].shape[0] == 2
    run = train.main(["--arch", "dbrx-132b", "--smoke", "--device", "cpu",
                      "--steps", "1", "--layers", "1", "--batch", "2"])
    assert "depth CUT from 2 to 1 layers" in capsys.readouterr().out
    assert run.params["layers"]["we_gate"].shape[0] == 1
    assert len(run.history) == 1 and run.history[0]["aux"] > 0
    cut = train.cut_layers(get_arch("granite-3-8b"), 3)
    assert cut.config.n_layers == 3 and cut.smoke_config.n_layers == 2
    with pytest.raises(SystemExit):
        train.main(["--arch", "ssh-ecg", "--device", "cpu"])


def test_train_step_metrics_and_learning():
    """Eight AdamW steps at lr 3e-3, warm-up 1, on one batch (the
    reference's ``test_loss_decreases``) lower the loss by more than 0.1;
    the metrics are those of the reference's train step."""
    arch = get_arch("granite-3-2b")
    params = steps.init_fn(arch, "train_4k", smoke=True, device=CPU)(
        torch.Generator().manual_seed(1))
    opt = AdamW(lr=3e-3, warmup_steps=1)
    state = opt.init(params)
    step = steps.make_step(arch, "train_4k", "train", smoke=True,
                           optimizer=opt)
    toks = torch.tensor(np.random.default_rng(0).integers(0, 256, (4, 24)))
    losses = []
    for _ in range(8):
        params, state, m = step(params, state, {"tokens": toks,
                                                "labels": toks})
        losses.append(float(m["loss"]))
    assert set(m) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert all(p.grad is None for p in tree_leaves(params))
    assert isinstance(state, AdamWState) and int(state.step) == 8
    assert losses[-1] < losses[0] - 0.1
