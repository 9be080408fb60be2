"""The port's recsys models against the JAX package's, on the CPU.

Each of DLRM, BST, MIND and DIEN at its SMOKE config, on parameters drawn
by the reference and carried across with ``convert.params_from_arrays``
and batches from ``data.recsys_data`` (numpy, a seed): the forward's
logits, the retrieval scores and ``bce_loss`` within rtol 1e-5 (and
1e-5 of the output's largest magnitude, for entries near zero); the
loss's gradient through ``torch.autograd`` against ``jax.grad``, every
leaf within 1e-4 of its largest magnitude (the embedding tables'
scatter-adds and the products sum in another order); one
``make_step(..., "train")`` step's parameters against the reference's
train step within 1e-5 relative.  Also the embedding substrate and the
data generators.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bst as jbst
from repro.configs import dien as jdien
from repro.configs import dlrm_rm2 as jdlrm
from repro.configs import mind as jmind
from repro.data import recsys_data as jdata
from repro.launch import steps as jsteps
from repro.models import embedding as jemb
from repro.models import recsys as jR
from repro_torch import convert
from repro_torch.configs import bst, dien, dlrm_rm2, mind
from repro_torch.data import recsys_data
from repro_torch.launch import steps
from repro_torch.models import embedding, recsys as R
from repro_torch.train.optimizer import tree_leaves

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = "cpu"
ARCHS = {"dlrm-rm2": (dlrm_rm2, jdlrm), "bst": (bst, jbst),
         "mind": (mind, jmind), "dien": (dien, jdien)}
BATCH, N_CAND = 16, 300


def _model(name):
    return name.split("-")[0]


def _batches(name, cfg, seed=3):
    """(serve batch with labels, retrieval batch) as numpy."""
    if name == "dlrm-rm2":
        b = recsys_data.dlrm_batch(BATCH, cfg.n_dense, cfg.n_sparse,
                                   cfg.vocab, seed=seed)
    else:
        b = recsys_data.seq_batch(BATCH, cfg.seq_len, cfg.vocab,
                                  getattr(cfg, "n_profile", 8), seed=seed)
        if name != "bst":
            del b["profile"]
    r = recsys_data.retrieval_batch(N_CAND, getattr(cfg, "seq_len", 1),
                                    cfg.vocab, seed=seed + 1)
    if name == "dlrm-rm2":
        del r["history"]
    else:
        del r["dense"], r["sparse"]
    return b, r


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=rtol,
        atol=rtol * max(float(np.abs(want).max()), 1e-30))


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    name = request.param
    mod, jmod = ARCHS[name]
    assert dataclasses.asdict(mod.SMOKE) == dataclasses.asdict(jmod.SMOKE)
    assert dataclasses.asdict(mod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
    jparams = jsteps.init_fn(jmod.ARCH, "train_batch", smoke=True)(
        jax.random.PRNGKey(7))
    arrays = jax.tree.map(np.asarray, jparams)
    params = convert.params_from_arrays(arrays, CPU)
    batch, ret = _batches(name, mod.SMOKE)
    return name, mod, jmod, jparams, params, batch, ret


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_params_carry_across_in_structure(model):
    name, mod, _, jparams, params, _, _ = model
    jleaves = jax.tree.leaves(jparams)
    leaves = tree_leaves(params)
    assert len(leaves) == len(jleaves)
    for t, a in zip(leaves, jleaves):         # the same flattening order
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    fresh = steps.init_fn(mod.ARCH, "train_batch", smoke=True, device=CPU)()
    assert [tuple(t.shape) for t in tree_leaves(fresh)] == [
        tuple(a.shape) for a in jleaves]
    if name == "dlrm-rm2":    # the top MLP takes embed_dim + n_pairs = 415
        assert tuple(params["top"][0]["w"].shape) == (64 + 351, 512)


def test_forward_retrieval_and_loss(model):
    name, mod, jmod, jparams, params, batch, ret = model
    feats = {k: v for k, v in batch.items() if k != "labels"}
    want = jsteps._recsys_forward(jmod.SMOKE)(jparams, _j(feats))
    got = steps._recsys_forward(mod.SMOKE)(params, _t(feats))
    assert got.shape == (BATCH,)
    _close(got.detach(), want)
    jret = jsteps._recsys_retrieval(jmod.SMOKE)(jparams, _j(ret))
    serve = steps.make_step(mod.ARCH, "serve_p99", "serve", smoke=True)
    retrieve = steps.make_step(mod.ARCH, "retrieval_cand", "retrieval",
                               smoke=True)
    scores = retrieve(params, _t(ret))
    assert scores.shape == (N_CAND,) and scores.grad_fn is None
    _close(scores, jret)
    logits = serve(params, _t(feats))
    assert logits.grad_fn is None
    _close(logits, want)
    labels = batch["labels"]
    _close(R.bce_loss(logits, torch.as_tensor(labels)),
           jR.bce_loss(want, jnp.asarray(labels)))


def test_loss_gradient_matches_jax(model):
    name, mod, jmod, jparams, params, batch, _ = model
    jloss = jsteps._loss_for(jmod.ARCH, "train_batch", True)
    (jl, _), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jparams, _j(batch))
    loss = steps._loss_for(mod.ARCH, "train_batch", True)
    for p in tree_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    l, metrics = loss(params, _t(batch))
    l.backward()
    assert set(metrics) == {"bce"}
    _close(l.detach(), jl)
    for p, g in zip(tree_leaves(params), jax.tree.leaves(jgrads)):
        g = np.asarray(g)
        assert p.grad is not None and p.grad.shape == g.shape
        np.testing.assert_allclose(
            p.grad.numpy(), g, rtol=0,
            atol=1e-4 * max(float(np.abs(g).max()), 1e-30))
        p.requires_grad_(False)
        p.grad = None


def test_train_step_matches_jax(model):
    name, mod, jmod, jparams, _, batch, _ = model
    jopt = jsteps.make_optimizer("recsys")
    jstep = jax.jit(jsteps.make_step(jmod.ARCH, "train_batch", "train",
                                     smoke=True))
    jp, _, jm = jstep(jparams, jopt.init(jparams), _j(batch))
    params = convert.params_from_arrays(jax.tree.map(np.asarray, jparams),
                                        CPU)
    opt = steps.make_optimizer("recsys")
    step = steps.make_step(mod.ARCH, "train_batch", "train", smoke=True)
    params, state, m = step(params, opt.init(params), _t(batch))
    assert set(m) == {"bce", "loss", "grad_norm", "lr"}
    assert int(state.step) == 1 and m["lr"] == float(jm["lr"])
    _close(m["loss"], jm["loss"])
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    for p, want in zip(tree_leaves(params), jax.tree.leaves(jp)):
        assert p.grad is None
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-8)


# --------------------------------------------------------------------------
# the embedding substrate and the data
# --------------------------------------------------------------------------

def test_embedding_lookup_wraps_negative_and_large_ids():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(37, 5)).astype(np.float32)
    ids = np.array([[0, -1, 36, 37], [-38, 1000, -1000, 2**31 - 1]],
                   np.int32)
    want = np.asarray(jemb.embedding_lookup(jnp.asarray(table),
                                            jnp.asarray(ids)))
    for dt in (torch.int32, torch.int64):
        got = embedding.embedding_lookup(torch.as_tensor(table),
                                         torch.as_tensor(ids, dtype=dt))
        assert got.shape == (2, 4, 5)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[0, 1], table[36])     # Python's sign
    np.testing.assert_array_equal(
        embedding.positional_embedding(torch.as_tensor(table), 4).numpy(),
        table[:4])


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_jax(mode, weighted):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(-60, 120, 40).astype(np.int32)
    seg = rng.integers(0, 9, 40).astype(np.int32)     # bag 9 stays empty
    w = rng.uniform(size=40).astype(np.float32) if weighted else None
    want = jemb.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                              jnp.asarray(seg), 10, mode,
                              None if w is None else jnp.asarray(w))
    got = embedding.embedding_bag(torch.as_tensor(table),
                                  torch.as_tensor(ids), torch.as_tensor(seg),
                                  10, mode,
                                  None if w is None else torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert not got[9].any()
    with pytest.raises(ValueError, match="mode"):
        embedding.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids),
                                torch.as_tensor(seg), 10, "max")


@pytest.mark.parametrize("seed", [0, 5])
def test_recsys_data_equals_the_reference(seed):
    pairs = [
        (recsys_data.dlrm_batch(33, 13, 26, 1000, seed=seed),
         jdata.dlrm_batch(33, 13, 26, 1000, seed=seed)),
        (recsys_data.seq_batch(17, 20, 5000, 8, seed=seed),
         jdata.seq_batch(17, 20, 5000, 8, seed=seed)),
        (recsys_data.retrieval_batch(100, 12, 777, seed=seed),
         jdata.retrieval_batch(100, 12, 777, seed=seed)),
    ]
    for got, want in pairs:
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
