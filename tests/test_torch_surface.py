"""The reference's public surface, walked at run time against the port.

Every module of ``repro`` is imported beside the ``repro_torch`` module of
the same path.  For every public name the reference module defines (its
functions, classes and top-level assignments), the port module must have:

* the name itself;
* for a function, each of its parameters, by name;
* for a class, each public member of ``dir()`` (inherited ones too), each
  annotated attribute, each dataclass field and ``InitVar``, each
  attribute a method assigns on ``self``, each constructor parameter and
  each parameter of each method.

A ``**kwargs`` (or ``*args``) in the port's signature does not count as
having a parameter.  What the port lacks on purpose is listed in
``BY_DESIGN`` with a one-line reason, and an entry the port now has fails
the walk as stale, so the table cannot hide a gap.
"""
import ast
import dataclasses
import functools
import importlib
import inspect
import pkgutil
import textwrap
import warnings

import pytest

import repro

pytestmark = pytest.mark.torch_port

KEY = ("a jax.random key; the port draws from an explicit torch.Generator "
       "(or IndexSpec.seed)")
PALLAS = ("a Pallas knob; on the port the tensor's device and `backend` "
          "choose the route")
TILE = "a TPU block shape; each CUDA kernel sets its own tiles in csrc/"
JDTYPE = "a JAX dtype; the port's is the torch dtype (`torch_dtype`)"
HLO = ("XLA's HLO text, or an HLO opcode filter; the port reads "
       "torch.profiler events (and filters kernel kinds with `kinds=`)")
JAX_TYPE = "a JAX type alias; the port annotates with torch types"
TRACE = ("counts JAX (re)traces; the port runs eagerly and counts kernel "
         "launches (`ops.launch_counts`)")

#: what the port lacks by design, by reference module (``repro.`` left
#: out), then by item: ``name``, ``Class.member``, ``fn(param)``,
#: ``Class(param)`` or ``Class.method(param)``
BY_DESIGN = {
    "checkpoint.checkpointer": {"PyTree": JAX_TYPE},
    "configs.base": {"SDS": JAX_TYPE},
    "core.minhash": {"make_cws(key)": KEY},
    "core.sketch": {"make_filter(key)": KEY},
    "core.srp": {"make_srp(key)": KEY},
    "distributed.dist_index": {
        "shard_map_nocheck": "a jax.shard_map wrapper; the port's mesh is "
                             "a list of devices, each shard launched on "
                             "its own"},
    "encoders.base": {"Hasher.materialize(key)": KEY,
                      "Sketcher.materialize(key)": KEY},
    "encoders.pipeline": {
        "CWSHasher.materialize(key)": KEY,
        "GaussianFilterSketcher.materialize(key)": KEY,
        "MultiResSSHEncoder.trace_counts": TRACE,
        "PipelineEncoder.trace_counts": TRACE,
        "SSHEncoder.trace_counts": TRACE},
    "fleet.worker": {"FleetWorker.query_shard(use_pallas)": PALLAS},
    "kernels.collision_count": {
        "LANES": TILE, "collision_count(interpret)": PALLAS,
        "collision_count_batch(interpret)": PALLAS},
    "kernels.count_sketch": {"CHUNK": TILE, "cs_tables(interpret)": PALLAS},
    "kernels.dtw_wavefront": {
        "BIG": "the port's is core.dtw.BIG (1e30), which the kernel "
               "wrappers read",
        "LANES": TILE, "dtw_wavefront(interpret)": PALLAS,
        "dtw_wavefront_pairs(interpret)": PALLAS},
    "kernels.flash_attention": {
        "NEG_INF": "the TPU kernel's masked logit; the CUDA kernels mask in "
                   "their own code",
        "flash_attention(interpret)": PALLAS,
        "flash_attention(kv_block)": PALLAS,
        "flash_attention(q_block)": PALLAS},
    "kernels.ops": {f"{fn}({knob})": PALLAS
                    for fn in ("collision_count", "collision_count_batch",
                               "cs_tables", "dtw_rerank", "dtw_rerank_pairs",
                               "flash_attention", "sketch_bits_stream",
                               "sketch_conv")
                    for knob in ("interpret", "use_pallas")},
    "kernels.sketch_conv": {"TB": TILE, "TN": TILE,
                            "sketch_conv(interpret)": PALLAS},
    "launch.hlo_analysis": {"collective_stats(hlo_text_lines)": HLO,
                            "op_census(hlo_text_lines)": HLO,
                            "op_census(ops)": HLO},
    "launch.hlo_graph": {"executed_costs(text)": HLO},
    "launch.steps": {"PyTree": JAX_TYPE},
    "models.nequip": {"NequIPConfig.jdtype": JDTYPE,
                      "init_params(key)": KEY},
    "models.recsys": {f"{m}_init(key)": KEY
                      for m in ("bst", "dien", "dlrm", "mind")},
    "models.transformer": {"LMConfig.jdtype": JDTYPE,
                           "init_layer_params(key)": KEY,
                           "init_params(key)": KEY},
    "serving.batched": {"batch_probe(interpret)": PALLAS,
                        "batch_probe(use_pallas)": PALLAS,
                        "ssh_search_batch(use_pallas)": PALLAS},
    "streaming.count_sketch": {"make_cs_params(key)": KEY},
    "streaming.encoder": {"CountSketchShingler.materialize(key)": KEY,
                          "StreamingSSHEncoder.trace_counts": TRACE},
    "subseq.rolling": {"rolling_sketch_bits(interpret)": PALLAS,
                       "rolling_sketch_bits(use_pallas)": PALLAS},
    "train.grad_compress": {"compress_with_feedback(key)": KEY,
                            "int8_quantize(key)": KEY},
}

MODULES = sorted(m.name[len("repro."):] for m in pkgutil.walk_packages(
    repro.__path__, "repro."))

_SKIP_KINDS = (inspect.Parameter.VAR_POSITIONAL,
               inspect.Parameter.VAR_KEYWORD)


def _params(fn, drop_first=False):
    """The names a caller can pass to ``fn`` (``*args`` and ``**kwargs``
    name none), less the first when ``drop_first`` (``self``, ``cls``);
    None when ``fn`` has no signature."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    ps = [p for p in sig.parameters.values() if p.kind not in _SKIP_KINDS]
    if drop_first and ps and ps[0].kind != inspect.Parameter.KEYWORD_ONLY:
        ps = ps[1:]
    return {p.name for p in ps}


def _assigned_on_self(cls):
    """Attributes the methods of ``cls`` assign on ``self``."""
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(cls)))
    except (OSError, TypeError, SyntaxError):
        return set()
    return {n.attr for n in ast.walk(tree)
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store)
            and isinstance(n.value, ast.Name) and n.value.id == "self"}


def _members(cls):
    """Public members of ``cls`` and its bases, instance attributes too:
    ``dir()``, class annotations, dataclass fields and ``InitVar``s,
    attributes assigned on ``self``."""
    names = set(dir(cls))
    for c in cls.__mro__:
        names |= set(vars(c).get("__annotations__", {}))
        if c.__module__.split(".")[0] in ("repro", "repro_torch"):
            names |= _assigned_on_self(c)
    if dataclasses.is_dataclass(cls):
        names |= set(cls.__dataclass_fields__)
    return {n for n in names if not n.startswith("_")}


def _method(cls, name):
    """(function, drop_first) of member ``name``, or (None, False) when it
    is no function (a property, a field, a constant)."""
    for c in cls.__mro__:
        if name in vars(c):
            attr = vars(c)[name]
            break
    else:
        return None, False
    if isinstance(attr, staticmethod):
        return attr.__func__, False
    if isinstance(attr, classmethod):
        return attr.__func__, True
    if inspect.isfunction(attr):
        return attr, True
    return None, False


def _defined(mod):
    """Public names ``mod`` defines: its functions, classes and top-level
    assignments (AST), and what else carries its ``__module__``."""
    names = {n for n, v in vars(mod).items()
             if getattr(v, "__module__", None) == mod.__name__}
    tree = ast.parse(inspect.getsource(mod))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return sorted(n for n in names if not n.startswith("_"))


def _class_gaps(name, ref, port):
    gaps = []
    have_init = _params(port)
    for p in sorted(_params(ref) or ()):
        if have_init is not None and p not in have_init:
            gaps.append(f"{name}({p})")
    have = _members(port)
    for member in sorted(_members(ref)):
        if member not in have:
            gaps.append(f"{name}.{member}")
            continue
        fn, drop = _method(ref, member)
        if fn is None:
            continue
        pfn, pdrop = _method(port, member)
        if pfn is None:
            if not callable(getattr(port, member, None)):
                gaps.append(f"{name}.{member}()")
            continue
        want, got = _params(fn, drop), _params(pfn, pdrop)
        if want is not None and got is not None:
            gaps += [f"{name}.{member}({p})" for p in sorted(want - got)]
    return gaps


@functools.lru_cache(maxsize=None)
def surface_gaps(modname):
    """What the port module lacks of reference module ``modname``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = importlib.import_module(f"repro.{modname}")
        port = importlib.import_module(f"repro_torch.{modname}")
    gaps = []
    for name in _defined(ref):
        obj = getattr(ref, name)
        if not hasattr(port, name):
            gaps.append(name)
            continue
        pobj = getattr(port, name)
        if getattr(obj, "__module__", None) != ref.__name__:
            continue                       # a constant: the name is enough
        if inspect.isclass(obj):
            if inspect.isclass(pobj):
                gaps += _class_gaps(name, obj, pobj)
            else:
                gaps.append(f"{name} is not a class")
        elif callable(obj):
            want, got = _params(obj), _params(pobj)
            if want is not None and got is not None:
                gaps += [f"{name}({p})" for p in sorted(want - got)]
    return frozenset(gaps)


@pytest.mark.parametrize("modname", MODULES)
def test_port_has_the_reference_surface(modname):
    """Every public name, member, field, InitVar and parameter of the
    reference module is in the port module of the same path, or listed in
    ``BY_DESIGN``."""
    lacking = surface_gaps(modname) - set(BY_DESIGN.get(modname, {}))
    assert not lacking, sorted(lacking)


@pytest.mark.parametrize("modname", MODULES)
def test_no_stale_by_design_entry(modname):
    """Every ``BY_DESIGN`` entry is still missing from the port: one the
    port now has must leave the table."""
    stale = set(BY_DESIGN.get(modname, {})) - surface_gaps(modname)
    assert not stale, sorted(stale)


def test_by_design_names_walked_modules_with_reasons():
    assert set(BY_DESIGN) <= set(MODULES), set(BY_DESIGN) - set(MODULES)
    for modname, entries in BY_DESIGN.items():
        for item, reason in entries.items():
            assert isinstance(reason, str) and len(reason) > 20, (modname,
                                                                  item)
    # ROADMAP §1's eleven top-level names are among them
    top = [(m, i) for m, e in BY_DESIGN.items() for i in e
           if "(" not in i and "." not in i]
    assert len(top) == 11, top


def test_walk_sees_instance_attributes():
    """Class annotations, dataclass fields without a default and
    attributes assigned on ``self`` count as members, where a bare
    ``hasattr`` on the class misses them."""
    from repro_torch.core.search import SearchResult
    from repro_torch.encoders.base import Encoder
    from repro_torch.streaming.ingest import StreamIngestor
    assert not hasattr(Encoder, "num_hashes")
    assert "num_hashes" in _members(Encoder)
    assert not hasattr(SearchResult, "ids")
    assert "ids" in _members(SearchResult)
    assert not hasattr(StreamIngestor, "encoder")
    assert "encoder" in _members(StreamIngestor)


def test_var_keyword_does_not_count():
    def ref(a, b=1, *, knob=None):
        return a

    def port(a, *args, **kwargs):
        return a

    assert _params(ref) - _params(port) == {"b", "knob"}
    assert _params(lambda self, x: x, drop_first=True) == {"x"}


def test_walk_finds_a_planted_gap(monkeypatch):
    """A member, a parameter and a name taken from the port show up."""
    from repro_torch.core import search
    from repro_torch.launch import hlo_graph
    surface_gaps.cache_clear()
    try:
        monkeypatch.delattr(search.SearchResult, "dtw_evals")
        monkeypatch.setattr(search, "ucr_search",
                            lambda query, series, **kw: None)
        monkeypatch.delattr(hlo_graph, "Op")
        assert {"SearchResult.dtw_evals", "ucr_search(band)",
                "ucr_search(backend)"} <= surface_gaps("core.search")
        assert "Op" in surface_gaps("launch.hlo_graph")
    finally:
        surface_gaps.cache_clear()
