"""The port's Mixture-of-Experts against the JAX package on the CPU.

Inputs come from numpy with a seed and go through both packages.  The
port's ``gating`` returns each assignment's expert, queue position, keep
flag and weight; the tests expand that into the reference's one-hot
``dispatch`` and ``combine`` (G, N, E, C) tensors.

Tolerances, each with its reason:
* routing (expert and keep of every assignment, hence dispatch): exact;
* combine weights and the aux loss: rtol 1e-6, float32 softmax and
  renormalisation in another order;
* ``moe_ffn`` in float32: rtol 1e-5, the expert products and the combine
  summed in another order (k terms against E·C);
* ``moe_ffn`` in bf16: 2 % of max |out|, both round the products to bf16
  at other places (the reference's combine einsum sums E·C bf16 terms);
* the flops helpers: equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

# (n_experts, top_k, capacity_factor, group_size): drops at 1.25 with 8
# experts top-2 and more at 0.5; none where C >= n_g
CFGS = [(8, 2, 1.25, 16), (4, 2, 0.5, 16), (16, 4, 1.25, 32),
        (6, 3, 6.0 / 3, 16)]


def _cfgs(e, k, cf, gs, d=32, ff=24, n_shared=0):
    kw = dict(n_experts=e, top_k=k, d_model=d, d_ff=ff, n_shared=n_shared,
              capacity_factor=cf, group_size=gs)
    return moe.MoEConfig(**kw), jmoe.MoEConfig(**kw)


def _expand(routing, e, c):
    """The reference's dispatch (bool) and combine (float32) tensors
    (G, N, E, C) from the compact routing."""
    g, n, k = routing.expert.shape
    dispatch = torch.zeros((g, n, e, c), dtype=torch.bool)
    combine = torch.zeros((g, n, e, c))
    gi, ni, ki = torch.nonzero(routing.keep, as_tuple=True)
    ei = routing.expert[gi, ni, ki]
    ci = routing.position[gi, ni, ki]
    dispatch[gi, ni, ei, ci] = True
    combine[gi, ni, ei, ci] = routing.weight[gi, ni, ki]
    return dispatch, combine


@pytest.mark.parametrize("e,k,cf,gs", CFGS)
def test_capacity_matches_reference(e, k, cf, gs):
    cfg, jcfg = _cfgs(e, k, cf, gs)
    for n_g in (1, 3, 8, 16, 64, 512):
        assert moe.capacity(cfg, n_g) == jmoe.capacity(jcfg, n_g)


@pytest.mark.parametrize("e,k,cf,gs", CFGS)
def test_gating_matches_reference(e, k, cf, gs):
    """Routing exactly the reference's, drops included; the combine
    weights and the aux loss to float32 reordering."""
    cfg, jcfg = _cfgs(e, k, cf, gs)
    logits = np.random.default_rng(e * 10 + k).normal(
        size=(3, gs, e)).astype(np.float32)
    routing, aux = moe.gating(torch.tensor(logits), cfg, gs)
    jdisp, jcomb, jaux = jmoe.gating(jnp.asarray(logits), jcfg, gs)
    c = moe.capacity(cfg, gs)
    dispatch, combine = _expand(routing, e, c)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jdisp) > 0)
    np.testing.assert_allclose(combine.numpy(), np.asarray(jcomb),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    dropped = int((~routing.keep).sum())
    assert (dropped > 0) == (cf < 1.5), dropped       # the cases' intent
    # dropped assignments are those past the capacity, nothing else
    assert bool((routing.keep == (routing.position < c)).all())


def test_gating_ties_go_to_the_lower_index():
    """Equal gates: the lower expert index first, as ``lax.top_k``."""
    cfg, jcfg = _cfgs(8, 3, 2.0, 4)
    logits = np.zeros((1, 4, 8), np.float32)
    logits[0, 1, [2, 5, 6]] = 1.0
    logits[0, 2, 7] = 2.0
    routing, _ = moe.gating(torch.tensor(logits), cfg, 4)
    assert routing.expert[0].tolist() == [[0, 1, 2], [2, 5, 6], [7, 0, 1],
                                          [0, 1, 2]]
    jdisp, _, _ = jmoe.gating(jnp.asarray(logits), jcfg, 4)
    dispatch, _ = _expand(routing, 8, moe.capacity(cfg, 4))
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jdisp) > 0)


def _weights(rng, e, d, ff):
    """The router (d, E) and the experts' (E, d, ff), (E, d, ff),
    (E, ff, d), float32."""
    router = rng.normal(size=(d, e)).astype(np.float32) * 0.3
    wg, wu = (rng.normal(size=(e, d, ff)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.normal(size=(e, ff, d)).astype(np.float32) * 0.2
    return router, [wg, wu, wd]


# (n_experts, top_k, capacity_factor, group_size, B, S): B·S a multiple
# of the group, with a ragged tail (through expert 0), one group of fewer
# tokens than group_size (decode), and no drops
FFN_CASES = [(8, 2, 1.25, 16, 2, 24), (8, 2, 1.25, 16, 3, 13),
             (4, 2, 0.5, 16, 2, 16), (16, 4, 1.25, 64, 2, 5),
             (6, 3, 2.0, 16, 1, 37)]


@pytest.mark.parametrize("e,k,cf,gs,b,s", FFN_CASES)
def test_moe_ffn_float32_matches_reference(e, k, cf, gs, b, s):
    d, ff = 32, 24
    cfg, jcfg = _cfgs(e, k, cf, gs, d, ff)
    rng = np.random.default_rng(e + k + b * s)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    router, (wg, wu, wd) = _weights(rng, e, d, ff)
    got, aux = moe.moe_ffn(*(torch.tensor(a) for a in (x, router, wg, wu,
                                                       wd)), cfg)
    want, jaux = jmoe.moe_ffn(*(jnp.asarray(a) for a in (x, router, wg, wu,
                                                         wd)), jcfg)
    assert got.shape == (b, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_moe_ffn_tail_goes_through_expert_zero_with_weight_one():
    """Tokens past the last whole group: expert 0's SwiGLU, unweighted."""
    d, ff = 16, 8
    cfg, _ = _cfgs(4, 2, 1.25, 8, d, ff)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(1, 11, d)).astype(np.float32))
    router, ws = _weights(rng, 4, d, ff)
    wg, wu, wd = (torch.tensor(w) for w in ws)
    out, _ = moe.moe_ffn(x, torch.tensor(router), wg, wu, wd, cfg)
    tail = x[0, 8:]
    want = (torch.nn.functional.silu(tail @ wg[0]) * (tail @ wu[0])) @ wd[0]
    torch.testing.assert_close(out[0, 8:], want, rtol=0, atol=0)


def test_moe_ffn_bf16_close_to_reference():
    """bf16 tokens and experts, the float32 router: the same routing, the
    outputs within bf16 rounding at other places."""
    e, k, d, ff = 8, 2, 32, 24
    cfg, jcfg = _cfgs(e, k, 1.25, 16, d, ff)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 16, d)).astype(np.float32)
    router, ws = _weights(rng, e, d, ff)
    got, aux = moe.moe_ffn(torch.tensor(x).bfloat16(), torch.tensor(router),
                           *(torch.tensor(w).bfloat16() for w in ws), cfg)
    want, jaux = jmoe.moe_ffn(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(router),
                              *(jnp.asarray(w, jnp.bfloat16) for w in ws),
                              jcfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 0.02 * np.abs(want).max(), err
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("n_tokens", [1, 8, 100, 512, 16384])
def test_flops_helpers_equal(n_tokens):
    for e, k, cf, gs in CFGS + [(16, 4, 1.25, 512), (64, 6, 1.25, 128)]:
        cfg, jcfg = _cfgs(e, k, cf, gs, 6144, 10752)
        assert moe.moe_dispatch_flops(cfg, n_tokens) == \
            jmoe.moe_dispatch_flops(jcfg, n_tokens)
        assert moe.moe_expert_flops(cfg, n_tokens) == \
            jmoe.moe_expert_flops(jcfg, n_tokens)


def test_moe_config_fields_equal_the_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(moe.MoEConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(jmoe.MoEConfig)]
