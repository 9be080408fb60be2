"""The port's NequIP, its equivariant tables and the graph data against
the JAX package, on the CPU.

The CG and Wigner tables are the reference's numpy, copied line for line,
so they agree to 1e-12 on one machine.  The model runs on parameters
drawn by the reference and carried across with
``convert.params_from_arrays``: energies, node energies, the loss and
the forces within rtol 1e-4 (and 1e-4 of the largest magnitude, for
entries near zero).  The port sums a message's terms in another order
than the reference's 4-operand einsum (a CG-times-harmonic table first,
then one batched product a path) and adds the messages of one output l
before one scatter-add, where the reference scatters a path at a time:
the two agree to float32 reordering, not bit for bit.  Then the
symmetries of ``tests/test_models_gnn.py`` held on the port: energy
invariance and force equivariance under a rotation and a shift,
permutation invariance, inert self-loops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graph as jgraph
from repro.models import equivariant as jeq
from repro.models import nequip as jNQ
from repro_torch import convert
from repro_torch.data import graph
from repro_torch.models import equivariant as eq
from repro_torch.models import nequip as NQ
from repro_torch.train.optimizer import tree_leaves

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CPU = "cpu"
JCFG = jNQ.NequIPConfig(n_layers=2, channels=8, d_feat=4)
CFG = NQ.NequIPConfig(n_layers=2, channels=8, d_feat=4)


def _close(got, want, rtol=1e-4):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=rtol,
        atol=rtol * max(float(np.abs(want).max()), 1e-30))


@pytest.fixture(scope="module")
def params():
    jparams = jNQ.init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, convert.params_from_arrays(
        jax.tree.map(np.asarray, jparams), CPU)


def _batches():
    """A random graph (with node targets) and a molecule batch, numpy."""
    g = graph.random_graph(20, 60, 4, seed=2)
    m = graph.molecule_batch(5, 6, 12, d_feat=4, seed=1)
    return {"graph": (g, None), "molecule": (m, 5)}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def small_batch():
    rng = np.random.default_rng(0)
    n, e = 14, 48
    return {
        "node_feat": rng.normal(size=(n, 4)).astype(np.float32),
        "positions": (rng.normal(size=(n, 3)) * 2).astype(np.float32),
        "edge_src": rng.integers(0, n, e).astype(np.int32),
        "edge_dst": rng.integers(0, n, e).astype(np.int32),
    }


# --------------------------------------------------------------------------
# tables and geometry
# --------------------------------------------------------------------------

def test_cg_and_wigner_tables_equal_the_reference():
    assert eq.allowed_paths(2) == jeq.allowed_paths(2)
    assert len(eq.allowed_paths(2)) == 15
    for path in eq.allowed_paths(2):
        np.testing.assert_allclose(eq.real_cg(*path), jeq.real_cg(*path),
                                   rtol=0, atol=1e-12)
    assert not eq.real_cg(0, 0, 2).any()           # the triangle fails
    for seed in (0, 3):
        rot = eq.random_rotation(seed)
        np.testing.assert_array_equal(rot, jeq.random_rotation(seed))
        for l in (0, 1, 2, 3):
            np.testing.assert_allclose(eq.wigner_d(l, rot),
                                       jeq.wigner_d(l, rot), rtol=0,
                                       atol=1e-12)


def test_sh_and_rbf_match_the_reference():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(30, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    for l in (0, 1, 2):
        got = NQ.sh_l(l, torch.as_tensor(pts, dtype=torch.float32))
        want = jNQ.sh_l(l, jnp.asarray(pts, jnp.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy(), eq.real_sh(l, pts),
                                   atol=1e-5)
    r = np.concatenate([[0.0, 1e-7, 4.99, 5.0, 7.0],
                        rng.uniform(0, 6, 40)]).astype(np.float32)
    got = NQ.bessel_rbf(torch.as_tensor(r), 8, 5.0)
    want = jNQ.bessel_rbf(jnp.asarray(r), 8, 5.0)
    _close(got, want, rtol=1e-5)
    assert not got[-43:][r[-43:] >= 5.0].any()      # zero past the cutoff


# --------------------------------------------------------------------------
# the model against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["graph", "molecule"])
def test_forward_loss_and_forces_match_jax(params, which):
    jparams, tparams = params
    batch, n_graphs = _batches()[which]
    jb, tb = _j(batch), _t(batch)
    _close(NQ.forward(tparams, tb, CFG, n_graphs=n_graphs).detach(),
           jNQ.forward(jparams, jb, JCFG, n_graphs=n_graphs))
    _close(NQ.node_energies(tparams, tb, CFG).detach(),
           jNQ.node_energies(jparams, jb, JCFG))
    loss, metrics = NQ.loss_fn(tparams, tb, CFG, n_graphs=n_graphs)
    jloss, _ = jNQ.loss_fn(jparams, jb, JCFG, n_graphs=n_graphs)
    assert set(metrics) == {"mse"}
    _close(loss.detach(), jloss)
    _close(NQ.forces(tparams, tb, CFG), jNQ.forces(jparams, jb, JCFG))


def test_loss_gradient_matches_jax(params):
    jparams, tparams = params
    batch, _ = _batches()["graph"]
    jgrads = jax.grad(lambda p: jNQ.loss_fn(p, _j(batch), JCFG)[0])(jparams)
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = NQ.loss_fn(tparams, _t(batch), CFG)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-4 * max(float(np.abs(jg).max()),
                                                   1e-30))


def test_init_params_shapes_equal_the_reference():
    for cfg, jcfg in ((CFG, JCFG),
                      (NQ.NequIPConfig(), jNQ.NequIPConfig())):
        ours = NQ.init_params(cfg, torch.Generator().manual_seed(1), CPU)
        theirs = jax.eval_shape(lambda: jNQ.init_params(
            jcfg, jax.random.PRNGKey(0)))
        flat = jax.tree_util.tree_leaves_with_path(theirs)
        assert len(tree_leaves(ours)) == len(flat)
        for t, (path, s) in zip(tree_leaves(ours), flat):
            assert tuple(t.shape) == tuple(s.shape), path
        assert set(ours["layers"]["self_mix"]) == {"0", "1", "2"}


# --------------------------------------------------------------------------
# symmetries (tests/test_models_gnn.py's, on the port)
# --------------------------------------------------------------------------

def test_energy_invariance(params, small_batch):
    _, p = params
    b = _t(small_batch)
    e1 = NQ.forward(p, b, CFG)
    rot = torch.as_tensor(eq.random_rotation(7), dtype=torch.float32)
    e2 = NQ.forward(p, dict(b, positions=b["positions"] @ rot.T + 5.0), CFG)
    assert float((e1 - e2).abs()[0]) < 5e-5 * (1 + abs(float(e1[0])))


def test_force_equivariance(params, small_batch):
    _, p = params
    b = _t(small_batch)
    rot = torch.as_tensor(eq.random_rotation(11), dtype=torch.float32)
    f1 = NQ.forces(p, b, CFG)
    f2 = NQ.forces(p, dict(b, positions=b["positions"] @ rot.T - 2.0), CFG)
    np.testing.assert_allclose(f2.numpy(), (f1 @ rot.T).numpy(), atol=2e-5)


def test_permutation_invariance(params, small_batch):
    _, p = params
    b = _t(small_batch)
    n = b["positions"].shape[0]
    perm = np.random.default_rng(5).permutation(n)
    inv = torch.as_tensor(np.argsort(perm))
    b2 = {"node_feat": b["node_feat"][perm], "positions": b["positions"][perm],
          "edge_src": inv[b["edge_src"].long()],
          "edge_dst": inv[b["edge_dst"].long()]}
    e1, e2 = NQ.forward(p, b, CFG), NQ.forward(p, b2, CFG)
    assert float((e1 - e2).abs()[0]) < 1e-4


def test_self_loop_edges_are_inert(params, small_batch):
    """Padding edges (self-loops) change neither the energy nor the
    forces: the padded sampled-subgraph contract."""
    _, p = params
    b = _t(small_batch)
    pad = torch.zeros(16, dtype=torch.int32)
    b2 = dict(b, edge_src=torch.cat([b["edge_src"], pad]),
              edge_dst=torch.cat([b["edge_dst"], pad]))
    e1, e2 = NQ.forward(p, b, CFG), NQ.forward(p, b2, CFG)
    assert float((e1 - e2).abs()[0]) < 1e-5
    np.testing.assert_allclose(NQ.forces(p, b2, CFG).numpy(),
                               NQ.forces(p, b, CFG).numpy(), atol=1e-6)


# --------------------------------------------------------------------------
# graph data
# --------------------------------------------------------------------------

def _equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed", [0, 9])
def test_graph_data_equals_the_reference(seed):
    _equal(graph.random_graph(50, 200, 7, seed=seed),
           jgraph.random_graph(50, 200, 7, seed=seed))
    _equal(graph.molecule_batch(4, 9, 20, 3, seed=seed),
           jgraph.molecule_batch(4, 9, 20, 3, seed=seed))
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 300, 2000).astype(np.int32)
    dst = rng.integers(0, 300, 2000).astype(np.int32)
    dst[dst == 7] = 8                                   # node 7: no in-edges
    csr, jcsr = (graph.CSRGraph.from_edges(src, dst, 300),
                 jgraph.CSRGraph.from_edges(src, dst, 300))
    np.testing.assert_array_equal(csr.indptr, jcsr.indptr)
    np.testing.assert_array_equal(csr.indices, jcsr.indices)
    assert csr.degree(7) == 0 and csr.degree(8) == jcsr.degree(8)
    seeds = np.array([7, 3, 299, 8, 0], np.int32)
    got = graph.sample_neighbors(csr, seeds, (4, 3), seed=seed)
    _equal(got, jgraph.sample_neighbors(jcsr, seeds, (4, 3), seed=seed))
    n, e = graph.sampled_subgraph_shape(5, (4, 3))
    assert (n, e) == jgraph.sampled_subgraph_shape(5, (4, 3)) == (85, 80)
    assert len(got["nodes"]) == n and len(got["edge_src"]) == e
    assert graph.sampled_subgraph_shape(1024, (15, 10)) == (169984, 168960)
