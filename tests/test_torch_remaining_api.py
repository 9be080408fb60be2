"""The last public names of ``repro`` that the port lacked, each against
the reference on the same inputs, on the CPU.

``kernels.ops.resolve_backend`` / ``backend_name``,
``models.transformer.init_layer_params``, ``distributed.sharding.
sharding_for``, ``launch.hlo_graph.parse_hlo`` (``Op``,
``Computation``), ``encoders.sigcache.series_digest``,
``SubsequenceIndex.offsets`` / ``window`` / ``save(n_shards)``,
``checkpoint.restore_checkpoint(shardings=)``, the call form
``serve_lm(arch, requests, smoke)``, ``dryrun.run_cell(multi_pod)``,
``ArchDef.index_spec`` / ``search_config`` and
``BatchSearchResult.dtw_evals``.  Integers, ids, digests, shapes,
keys and restored or saved arrays are held exact; random initial
weights by their distribution (the numbers cannot be the reference's).
"""
import dataclasses
import hashlib
import importlib
import inspect
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import base as jconfigs
from repro.core.index import SSHParams as JaxParams
from repro.db import SearchConfig as JaxSearchConfig
from repro.distributed import sharding as jsharding
from repro.encoders import IndexSpec as JaxIndexSpec
from repro.encoders import sigcache as jsigcache
from repro.kernels import ops as jops
from repro.launch import hlo_graph as jhlo
from repro.models import transformer as jtransformer
from repro.serving import batched as jbatched
from repro.subseq import SubsequenceIndex as JaxSub
from repro_torch import convert
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import base as configs
from repro_torch.configs.registry import SSHArch, get_arch
from repro_torch.core.index import SSHIndex, SSHParams
from repro_torch.data.timeseries import synthetic_ecg
from repro_torch.db import SearchConfig
from repro_torch.distributed import sharding
from repro_torch.encoders import IndexSpec, sigcache
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, hlo_graph, mesh
from repro_torch.launch.serve import serve_lm
from repro_torch.models import transformer
from repro_torch.serving import batched
from repro_torch.subseq import SubsequenceIndex, rolling_signatures

jdryrun = importlib.import_module("repro.launch.dryrun")
jserve = importlib.import_module("repro.launch.serve")

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)


# -- kernels/ops ------------------------------------------------------------

def test_resolve_backend_matches_reference():
    """Each knob maps to the reference's tri-state; an unknown name
    raises ``ValueError`` with the reference's text."""
    for name in ("auto", "pallas", "jnp"):
        assert ops.resolve_backend(name) is jops.resolve_backend(name)
    with pytest.raises(ValueError) as got:
        ops.resolve_backend("triton")
    with pytest.raises(ValueError) as want:
        jops.resolve_backend("triton")
    assert str(got.value) == str(want.value)


def test_backend_name_is_the_route_that_runs():
    """On the CPU the plain version runs ("jnp", as the reference's
    ``backend_name`` says off-TPU for None and False); True names the
    kernel, which the port runs only on CUDA, so the CPU still says
    "jnp".  The plain version off the CPU raises, as ``check_backend``
    does; CUDA is the default device and raises where there is none."""
    for use in (None, False):
        assert ops.backend_name(use, "cpu") == jops.backend_name(use) \
            == "jnp"
    assert ops.backend_name(True, "cpu") == "jnp"
    with pytest.raises(ValueError, match="device='cpu'"):
        ops.backend_name(False, "meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.backend_name(None)


# -- models/transformer -----------------------------------------------------

# sha256 of init_params(SMOKE, torch.Generator().manual_seed(3), "cpu"),
# taken before init_params drew through the helper init_layer_params uses
INIT_PARAMS_SHA = {
    "granite-3-2b":
        "234bbfa372f880e3bb31be0fc1b74f18ca823ded5b467a0474d21b2e63f22d61",
    "dbrx-132b":
        "6eb1f439db7160e96c04f4c42852da9269d4dd134ce5349a1c13c192293ab83f",
    "deepseek-v2-lite-16b":
        "32dfddcdc897935f53bb76f026b2272c9912fa08053578ca925850c3a2723ac2",
}


def _sha_params(flat):
    h = hashlib.sha256()
    for k in sorted(flat):
        t = flat[k]
        h.update(k.encode() + str(t.dtype).encode()
                 + str(tuple(t.shape)).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("arch", sorted(INIT_PARAMS_SHA))
def test_init_layer_params_matches_reference(arch):
    """Dense, MoE and MLA layers: the reference's keys, shapes and dtypes
    exactly; norms exactly one; each drawn leaf's standard deviation
    within 10 % of the reference's scale (0.02, 0.02 / sqrt(2 L) for the
    output projections), as the reference's own draw is; and
    ``init_params`` draws what it drew before, bit for bit."""
    cfg = get_arch(arch).smoke_config
    jcfg = importlib.import_module("repro.configs.registry").get_arch(
        arch).smoke_config
    got = transformer.init_layer_params(cfg, torch.Generator().manual_seed(1),
                                        "cpu")
    want = jtransformer.init_layer_params(jcfg, jax.random.PRNGKey(1))
    assert sorted(got) == sorted(want)
    so = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)
    for k, w in want.items():
        t = got[k]
        assert tuple(t.shape) == tuple(w.shape), k
        assert str(t.dtype).split(".")[-1] == str(w.dtype), k
        if k.startswith("ln_"):
            assert bool((t == 1).all()) and bool((np.asarray(w) == 1).all())
            continue
        scale = so if k in ("wo", "w_down", "we_down", "ws_down") else 0.02
        for std in (float(t.float().std()),
                    float(np.asarray(w, np.float32).std())):
            assert abs(std / scale - 1) < 0.1, (k, std, scale)
    flat = transformer.flatten(transformer.init_params(
        cfg, torch.Generator().manual_seed(3), "cpu"))
    assert _sha_params(flat) == INIT_PARAMS_SHA[arch]


# -- distributed/sharding ---------------------------------------------------

CASES = [(("fsdp", "heads", None), (2048, 32, 64)),
         (("vocab", "fsdp"), (49155, 2048)),
         (("batch", None), (256, 4096)),
         (("batch_all", None), (512, 13)),
         (("experts", "fsdp", None), (16, 6144, 10752))]


@pytest.mark.parametrize("logicals,shape", CASES)
def test_sharding_for_matches_reference(logicals, shape):
    """The placement's spec equals the reference ``NamedSharding``'s on
    its (16, 16) and (2, 16, 16) layouts; on a mesh of one device the
    placement names that device."""
    for multi in (False, True):
        port_mesh = mesh.make_production_mesh(multi_pod=multi)
        ref_mesh = AbstractMesh(port_mesh.sizes, port_mesh.axis_names)
        got = sharding.sharding_for(logicals, shape, port_mesh)
        want = jsharding.sharding_for(logicals, shape, ref_mesh)
        assert got.mesh == port_mesh
        assert got.spec == tuple(want.spec)
    one = mesh.make_local_mesh(devices=["cpu"])
    assert sharding.sharding_for(logicals, shape, one).device == \
        torch.device("cpu")
    with pytest.raises(ValueError, match="no tensor on one device"):
        _ = sharding.sharding_for(logicals, shape,
                                  mesh.make_production_mesh()).device


# -- launch/hlo_graph -------------------------------------------------------

def test_parse_hlo_matches_reference():
    """HLO text that JAX lowers here (a scanned matrix product and a
    reduction): the same computations, entry, ops, operands and
    attributes in both parsers."""
    def f(x, y):
        def body(c, _):
            return jnp.tanh(c @ y), None
        c, _ = jax.lax.scan(body, x, None, length=3)
        return c.sum(), c.max(axis=0)

    text = jax.jit(f).lower(jnp.ones((8, 16)), jnp.ones((16, 16))) \
        .compile().as_text()
    got, got_entry = hlo_graph.parse_hlo(text)
    want, want_entry = jhlo.parse_hlo(text)
    assert got_entry == want_entry is not None
    assert sorted(got) == sorted(want) and len(got) > 1
    for name, comp in want.items():
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(comp)
    assert any(op.opcode == "while" for c in got.values()
               for op in c.ops.values())


# -- encoders/sigcache ------------------------------------------------------

def test_series_digest_matches_reference():
    """The blake2b digest of shape and float32 bytes: equal for a float64
    list, a float32 array and a tensor, and the reference's bytes."""
    x = np.random.default_rng(2).normal(size=96)
    want = jsigcache.series_digest(x)
    assert sigcache.series_digest(x.tolist()) == want
    assert sigcache.series_digest(x.astype(np.float32)) == want
    assert sigcache.series_digest(torch.from_numpy(x)) == want
    assert sigcache.series_digest(x[:95]) != want
    block = x.reshape(2, 48)
    assert sigcache.series_digest(block) == jsigcache.series_digest(block)


# -- subseq -----------------------------------------------------------------

SUB_PARAMS = dict(window=24, step=3, ngram=8, num_hashes=20, num_tables=10)
L_SUB, HOP_SUB = 128, 4


@pytest.fixture(scope="module")
def subs():
    """(reference index, the port's on its state)."""
    stream = np.asarray(synthetic_ecg(1500, seed=4), np.float32)
    jsub = JaxSub.build(stream, JaxIndexSpec("ssh", SUB_PARAMS),
                        length=L_SUB, hop=HOP_SUB, backend="jnp")
    spec = IndexSpec("ssh", SUB_PARAMS)
    enc = convert.encoder_from_arrays(spec, jsub.inner.enc.arrays(), "cpu")
    st = torch.from_numpy(stream)
    sigs = rolling_signatures(st, enc, L_SUB, HOP_SUB)
    inner = SSHIndex(encoder=enc, signatures=sigs, keys=enc.band_keys(sigs),
                     series=None, build_backend="cpu")
    return jsub, SubsequenceIndex(inner=inner, stream=st, length=L_SUB,
                                  hop=HOP_SUB)


def test_subseq_offsets_and_window_match_reference(subs):
    jsub, sub = subs
    np.testing.assert_array_equal(sub.offsets(), jsub.offsets())
    assert sub.offsets().dtype == jsub.offsets().dtype == np.int64
    for j in (0, 1, 17, sub.num_windows - 1):
        np.testing.assert_array_equal(sub.window(j).numpy(),
                                      np.asarray(jsub.window(j)))


def test_subseq_save_in_shards_loads_in_both(tmp_path, subs):
    """``save(..., n_shards=2)`` writes two shards, and both packages load
    the directory to the same arrays; the reference's two-shard save loads
    in the port alike."""
    jsub, sub = subs
    cfg = SearchConfig(topk=5, top_c=64, band=6, searcher="local",
                       subseq_window=L_SUB, subseq_hop=HOP_SUB)
    for saver, d in (("port", tmp_path / "port"), ("ref", tmp_path / "ref")):
        if saver == "port":
            sub.save(d, cfg, n_shards=2)
        else:
            jsub.save(d, JaxSearchConfig(backend="jnp"), n_shards=2)
        manifest = json.loads(next(d.glob("index/step_*/manifest.json"))
                              .read_text())
        assert manifest["n_shards"] == 2
        port, _ = SubsequenceIndex.load(d, device="cpu")
        ref, _ = JaxSub.load(d)
        np.testing.assert_array_equal(port.inner.signatures.numpy(),
                                      np.asarray(ref.inner.signatures))
        np.testing.assert_array_equal(port.stream.numpy(),
                                      np.asarray(ref.stream))
        np.testing.assert_array_equal(port.inner.signatures.numpy(),
                                      sub.inner.signatures.numpy())


# -- checkpoint ---------------------------------------------------------------

def test_restore_with_shardings_places_each_leaf(tmp_path):
    """Leaves the shardings name come back as tensors on that device (a
    device, its name, or a one-device mesh's placement), the others as
    host arrays; the values are the reference's restore of the same
    directory, with its shardings."""
    rng = np.random.default_rng(6)
    tree = {"a": rng.normal(size=(4, 6)).astype(np.float32),
            "b": {"c": rng.integers(0, 9, size=(8,)).astype(np.int32),
                  "d": rng.normal(size=(3,)).astype(np.float32)}}
    save_checkpoint(tmp_path / "p", 0, tree, n_shards=2)
    jax_save(tmp_path / "j", 0, tree, n_shards=2)
    one = mesh.make_local_mesh(devices=["cpu"])
    place = sharding.sharding_for(("batch", None), (4, 6), one)
    shardings = {"a": place, "b": {"c": "cpu", "d": None}}
    jdev = jax.devices("cpu")[0]
    jsh = {"a": jax.sharding.SingleDeviceSharding(jdev),
           "b": {"c": jax.sharding.SingleDeviceSharding(jdev), "d": None}}
    for d in ("p", "j"):
        step, got = restore_checkpoint(tmp_path / d, tree,
                                       shardings=shardings)
        _, want = jax_restore(tmp_path / d, tree, shardings=jsh)
        assert step == 0
        assert isinstance(got["a"], torch.Tensor)
        assert got["a"].device == got["b"]["c"].device == \
            torch.device("cpu")
        assert isinstance(got["b"]["d"], np.ndarray)
        for g, w in ((got["a"], want["a"]), (got["b"]["c"], want["b"]["c"]),
                     (got["b"]["d"], want["b"]["d"])):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# -- launch/serve -------------------------------------------------------------

def test_serve_lm_takes_the_reference_call_form():
    """``serve_lm(arch, requests, smoke)``: the reference's smoke serve
    generates (2, 8) tokens, and so does the port's, equal to the
    config form with the defaults; other types are refused."""
    arch = get_arch("granite-3-2b")
    jarch = importlib.import_module("repro.configs.registry").get_arch(
        "granite-3-2b")
    out = io.StringIO()
    with redirect_stdout(out):
        jserve.serve_lm(jarch, 4, True)
    assert "generated (2, 8) tokens" in out.getvalue()
    ref_form = serve_lm(arch, 4, True, device="cpu")
    cfg_form = serve_lm(arch.smoke_config, device="cpu")
    assert tuple(ref_form.generated.shape) == (2, 8)
    assert torch.equal(ref_form.generated, cfg_form.generated)
    assert torch.equal(ref_form.prefill_logits, cfg_form.prefill_logits)
    with pytest.raises(TypeError, match="takes an int and a bool"):
        serve_lm(arch, None, True, device="cpu")


# -- launch/dryrun ------------------------------------------------------------

def test_run_cell_takes_multi_pod_as_the_reference():
    """The reference's positional form ``(arch_name, shape, multi_pod,
    report_dir, verbose)``: ``multi_pod`` picks its (2, 16, 16) layout
    over (16, 16); the ``"local"`` mesh is reachable by keyword; a mesh
    name in ``multi_pod``'s place is refused."""
    names = list(inspect.signature(dryrun.run_cell).parameters)
    assert names[:5] == list(inspect.signature(
        jdryrun.run_cell).parameters)
    single = dryrun.run_cell("ssh-ecg", "query_2048", False, None, False)
    multi = dryrun.run_cell("ssh-ecg", "query_2048", True, None, False)
    assert (single["mesh"], single["n_chips"]) == ("single", 256)
    assert (multi["mesh"], multi["n_chips"]) == ("multi", 512)
    assert multi["mesh_axes"] == {"pod": 2, "data": 16, "model": 16}
    by_name = dryrun.run_cell("ssh-ecg", "query_2048", report_dir=None,
                              verbose=False, mesh="multi")
    assert by_name["memory"] == multi["memory"]
    local = dryrun.run_cell("ssh-ecg", "query_2048", report_dir=None,
                            verbose=False, mesh="local")
    assert local["mesh"] == "local"
    with pytest.raises(TypeError, match="multi_pod is a bool"):
        dryrun.run_cell("ssh-ecg", "query_2048", "single", None, False)


# -- configs/base -------------------------------------------------------------

def _archs(family="ssh", search=True):
    fields = dict(window=24, step=3, ngram=8, num_hashes=20, num_tables=10)
    knobs = dict(topk=5, top_c=64, band=6, multiprobe_offsets=3)
    port = configs.ArchDef(
        name="toy", family=family, config=SSHParams(**fields),
        smoke_config=SSHParams(**dict(fields, ngram=6)), shapes={},
        search_defaults=SearchConfig(**knobs) if search else None)
    ref = jconfigs.ArchDef(
        name="toy", family=family, config=JaxParams(**fields),
        smoke_config=JaxParams(**dict(fields, ngram=6)), shapes={},
        search_defaults=JaxSearchConfig(**knobs) if search else None)
    return port, ref


def test_archdef_index_spec_and_search_config_match_reference():
    """``index_spec`` (full, smoke, with overrides) and ``search_config``
    (as is, at a length, with overrides) equal the reference's; the
    other families and arches without defaults raise its errors; the
    SSH registry arches are ``ArchDef``s that take both from there."""
    port, ref = _archs()
    for kw in ({}, {"smoke": True}, {"ngram": 7}):
        assert port.index_spec(**kw).to_dict() == ref.index_spec(**kw) \
            .to_dict()
    for args, kw in (((), {}), ((512,), {}), ((), {"topk": 3}),
                     ((2048,), {"top_c": 32})):
        assert port.search_config(*args, **kw).to_dict() == \
            ref.search_config(*args, **kw).to_dict()
    for family, search in (("lm", True), ("ssh", False)):
        p, r = _archs(family, search)
        what = "index_spec" if family == "lm" else "search_config"
        with pytest.raises(ValueError) as got:
            getattr(p, what)()
        with pytest.raises(ValueError) as want:
            getattr(r, what)()
        assert str(got.value) == str(want.value)
    ecg = get_arch("ssh-ecg")
    assert isinstance(ecg, SSHArch) and isinstance(ecg, configs.ArchDef)
    assert ecg.family == "ssh" and "index_spec" not in vars(SSHArch)
    assert ecg.index_spec() == ecg.config
    assert ecg.search_config(length=512).band == 25


# -- serving/batched ----------------------------------------------------------

def test_batch_search_result_dtw_evals_matches_reference():
    """The re-rank survivors summed over the batch, on the same
    fields."""
    fields = dict(ids=np.zeros((3, 2), np.int64),
                  dists=np.zeros((3, 2), np.float32), n_queries=3,
                  n_database=100, n_union=40,
                  n_candidates=np.array([12, 0, 31]),
                  pruned_by_hash_frac=np.zeros(3),
                  pruned_total_frac=np.zeros(3), wall_seconds=0.1)
    got = batched.BatchSearchResult(**fields).dtw_evals
    assert got == jbatched.BatchSearchResult(**fields).dtw_evals == 43
    assert isinstance(got, int)
