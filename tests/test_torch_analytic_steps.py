"""Analytic MODEL_FLOPS, the abstract state and the SSH steps against the
JAX package.

* ``launch.analytic.model_flops`` equals the reference's for every
  (arch, shape): the same arithmetic over the same configs, so exactly;
* ``launch.steps.abstract_state`` (the initialisers run on the meta
  device) has the paths, shapes and dtypes of the reference's
  (``jax.eval_shape``) for every cell, dbrx-132b's 131.6 B parameters
  included, at no memory;
* the SSH build step's signatures are bit-equal to the reference's
  ``build_step`` (its dense CWS over the (B, 2^n) histogram; the port's
  over the active shingles) at the SMOKE and the full ssh-ecg config,
  on the reference's own parameters carried across with
  ``convert.params_from_arrays``;
* the query step's ids equal the reference's, and its distances lie
  within rtol 1e-6 of the float64 DP (``core.dtw.dtw_dp_reference``);
  the reference's float32 DTW within 1e-4 of it at length 128 and 5e-4
  at length 512 (ROADMAP.md §3: its cumsum/cummin columns lose
  precision, more the longer the series: 1.5e-4 measured at 512, and
  3.8e-6 for a series against itself, hence atol 1e-5).

Inputs come from numpy with a seed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import analytic as janalytic
from repro.launch import steps as jsteps
from repro_torch import convert
from repro_torch.configs.base import TensorSpec
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.core.dtw import dtw_dp_reference
from repro_torch.data.timeseries import make_benchmark_db, random_walk
from repro_torch.launch import analytic, steps
from repro_torch.train.optimizer import AdamWState

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

CELLS = [(n, s) for n in list_archs() for s in get_arch(n).shapes]


@pytest.mark.parametrize("name,shape", CELLS)
def test_model_flops_equal_the_reference(name, shape):
    got = analytic.model_flops(get_arch(name), shape)
    want = janalytic.model_flops(jget_arch(name), shape)
    assert got == want and got > 0


def test_every_reference_cell_is_a_port_cell():
    for name in list_archs():
        assert set(get_arch(name).shapes) == set(jget_arch(name).shapes)


def _jpath(p):
    for attr in ("key", "idx", "name"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    return str(p)


def _jleaves(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(_jpath(p) for p in path):
            (tuple(x.shape), np.dtype(x.dtype).name) for path, x in leaves}


def _leaves(tree, path=()):
    if isinstance(tree, TensorSpec):
        return {"/".join(path): (tuple(tree.shape), str(tree.dtype)[6:])}
    if isinstance(tree, AdamWState):
        out = {}
        for f in tree._fields:
            out.update(_leaves(getattr(tree, f), path + (f,)))
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, path + (str(i),)))
        return out
    raise TypeError(f"unexpected leaf {type(tree)} at {path}")


@pytest.mark.parametrize("name,shape", CELLS)
def test_abstract_state_matches_eval_shape(name, shape):
    kind, state = steps.abstract_state(get_arch(name), shape)
    jkind, jstate = jsteps.abstract_state(jget_arch(name), shape)
    assert kind == jkind and len(state) == len(jstate)
    for i, (got, want) in enumerate(zip(state, jstate)):
        assert _leaves(got, (str(i),)) == _jleaves({str(i): want})


def test_abstract_params_take_no_memory_at_dbrx_scale():
    params = steps.abstract_params(get_arch("dbrx-132b"), "train_4k")
    n = sum(int(np.prod(s.shape)) for s in _leaves_values(params))
    assert n == 131_596_523_520
    opt = steps.abstract_opt_state(get_arch("dbrx-132b"), params)
    assert opt.step == TensorSpec((), torch.int32)
    assert all(s.dtype == torch.float32 for s in _leaves_values(opt.master))


def _leaves_values(tree):
    if isinstance(tree, TensorSpec):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_values(v)]
    return [x for v in tree for x in _leaves_values(v)]


@functools.lru_cache(maxsize=None)
def _carried(smoke):
    """The reference's ssh params (its PRNG) and the same as tensors."""
    jp = jsteps.init_fn(jget_arch("ssh-ecg"), "build_2048", smoke=smoke)()
    arrays = {"filters": np.asarray(jp["filters"]),
              "cws": {k: np.asarray(v) for k, v in jp["cws"].items()}}
    return jp, convert.params_from_arrays(arrays, device="cpu")


def test_ssh_init_draws_the_encoders_state():
    """The port's own draw: the encoder's distributions and leaf names
    from a generator seeded by the spec's seed, reproducible."""
    arch = get_arch("ssh-ecg")
    a = steps.init_fn(arch, "build_2048", device="cpu")()
    b = steps.init_fn(arch, "build_2048", device="cpu")()
    jp, _ = _carried(False)
    assert set(a) == set(jp) and set(a["cws"]) == set(jp["cws"])
    assert tuple(a["filters"].shape) == jp["filters"].shape
    for k, v in a["cws"].items():
        assert tuple(v.shape) == jp["cws"][k].shape
        assert torch.equal(v, b["cws"][k])
    assert torch.equal(a["cws"]["log_r"], torch.log(a["cws"]["r"]))


@pytest.mark.parametrize("smoke,length,n", [(True, 512, 24), (False, 512, 24),
                                            (False, 2048, 6),
                                            (False, 128, 40)])
def test_ssh_build_step_bit_equal_to_reference(smoke, length, n,
                                              monkeypatch):
    jp, p = _carried(smoke)
    rng = np.random.default_rng(length + n)
    x = rng.normal(size=(n, length)).astype(np.float32).cumsum(1)
    x[0] = random_walk(length, seed=3)
    want = np.asarray(jsteps.make_step(jget_arch("ssh-ecg"), "build_2048",
                                       "build", smoke=smoke)(
        jp, {"series": jnp.asarray(x)}))
    build = steps.make_step(get_arch("ssh-ecg"), "build_2048", "build",
                            smoke=smoke)
    got = build(p, {"series": torch.tensor(x)})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # chunks of the active CWS of a few rows change nothing
    monkeypatch.setattr(steps, "SSH_BUILD_CHUNK", 50)
    np.testing.assert_array_equal(build(p, {"series": torch.tensor(x)})
                                  .numpy(), want)


@pytest.mark.parametrize("shape,n,length,ref_rtol", [
    ("query_128", 1500, 128, 1e-4), ("query_2048", 120, 512, 5e-4)])
def test_ssh_query_step_matches_reference(shape, n, length, ref_rtol):
    """ids equal; distances to the float64 DP at rtol 1e-6 (the
    reference's at ``ref_rtol``).  query_2048's step at length 512 (its
    band of 102) keeps the float64 DP short."""
    jp, p = _carried(False)
    db = make_benchmark_db("ecg", n, length, seed=5)
    jarch, arch = jget_arch("ssh-ecg"), get_arch("ssh-ecg")
    jsig = jsteps.make_step(jarch, "build_2048", "build")(
        jp, {"series": jnp.asarray(db)})
    sig = steps.make_step(arch, "build_2048", "build")(
        p, {"series": torch.tensor(db)})
    np.testing.assert_array_equal(sig.numpy(), np.asarray(jsig))
    jquery = jsteps.make_step(jarch, shape, "query")
    query = steps.make_step(arch, shape, "query")
    band = arch.shapes[shape].meta["band"]
    for i in (3, n // 2 + 1):
        wi, wd = jquery(jp, {"query": jnp.asarray(db[i]), "db_sigs": jsig,
                             "db_series": jnp.asarray(db)})
        gi, gd = query(p, {"query": torch.tensor(db[i]), "db_sigs": sig,
                           "db_series": torch.tensor(db)})
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        assert int(gi[0]) == i and float(gd[0]) == 0.0
        dp = np.array([dtw_dp_reference(db[i], db[j], band)
                       for j in gi.numpy()])
        np.testing.assert_allclose(gd.numpy(), dp, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(np.asarray(wd), dp, rtol=ref_rtol,
                                   atol=1e-5)
