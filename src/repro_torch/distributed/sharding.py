"""Logical-axis sharding rules with divisibility-checked fallbacks
(counterpart of ``repro.distributed.sharding``).

Every parameter and input dim is tagged with a *logical* axis name; the
table maps logical axes to (preferred) mesh axes.  A mesh axis is
assigned only when the dim's size divides the axis size, otherwise the
next candidate is tried or the dim is replicated.  This is divisibility
arithmetic over a ``launch.mesh.MeshSpec``'s axis sizes, so it needs no
device: a spec is a tuple with one entry a dim (a mesh axis name, a
tuple of names, or None for replicated), the reference's
``PartitionSpec``, and the trees hold such tuples where the reference's
hold ``NamedSharding``s.  The port runs on one card, where every spec
reduces to replication; the dry run (``launch.dryrun``) reads the specs
to reckon each cell's bytes per device on the reference's meshes.

Conventions: ``fsdp`` shards parameters over the data-parallel axes
(ZeRO-3 style; dbrx-132b's 263 GB of bf16 weights need it), ``model``
is the tensor-parallel axis.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.launch.mesh import MeshSpec, dp_axes

#: one entry a dim: a mesh axis, a tuple of axes, or None (replicated)
Spec = Tuple[Any, ...]

# logical axis -> ordered mesh-axis candidates (first divisible wins)
LOGICAL_RULES: Dict[str, Tuple[str, ...]] = {
    "fsdp": ("dp",),          # expands to the mesh's dp axes
    "model": ("model",),
    "batch": ("dp",),
    # families with no tensor-parallel dimension (recsys/gnn/ssh) shard
    # their batch over every mesh axis
    "batch_all": ("all", "dp"),
    "experts": ("model",),
    "vocab": ("model",),
    "heads": ("model",),
    "head_dim": ("model",),
    "ff": ("model",),
    "seq": ("dp",),
    "nodes": ("dp",),
    "edges": ("dp",),
    "candidates": ("dp",),
    "table_rows": ("model",),
    "replicated": (),
}


def _resolve_axis(logical: Optional[str], dim: int, mesh: MeshSpec):
    """Logical name -> concrete mesh axis (or None), divisibility-checked."""
    if logical is None:
        return None
    for cand in LOGICAL_RULES.get(logical, ()):
        if cand in ("dp", "all"):
            axes = (tuple(mesh.axis_names) if cand == "all"
                    else dp_axes(mesh))
            if not axes:
                continue
            size = math.prod(mesh.shape[a] for a in axes)
            if size > 0 and dim % size == 0:
                return axes if len(axes) > 1 else axes[0]
        elif cand in mesh.axis_names and dim % mesh.shape[cand] == 0:
            return cand
    return None


def spec_for(logicals: Sequence[Optional[str]], shape: Sequence[int],
             mesh: MeshSpec) -> Spec:
    """Resolve per-dim logical names into a spec, never assigning one
    mesh axis twice."""
    used = set()
    out = []
    for logical, dim in zip(logicals, shape):
        ax = _resolve_axis(logical, dim, mesh)
        key = tuple(ax) if isinstance(ax, tuple) else (ax,)
        if ax is not None and not (set(key) & used):
            out.append(ax)
            used.update(key)
        else:
            out.append(None)
    return tuple(out)


def shard_factor(spec: Spec, mesh: MeshSpec) -> int:
    """How many ways a tensor with ``spec`` is split over ``mesh``: the
    product of the sizes of every axis its dims are assigned."""
    n = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                n *= mesh.shape[a]
    return n


# --------------------------------------------------------------------------
# parameter rules per model family (matched on the param path)
# --------------------------------------------------------------------------

# (regex on "/"-joined path, logical axes for the *trailing* dims).
# Stacked layer params have a leading L dim -> replicated (scan axis).
LM_PARAM_RULES = [
    (r"embed$", ("vocab", "fsdp")),
    (r"head$", ("fsdp", "vocab")),
    (r"ln_.*$", ("replicated",)),
    (r"wq$", ("fsdp", "heads", None)),
    (r"wk$", ("fsdp", "heads", "head_dim")),      # kv_heads may not divide
    (r"wv$", ("fsdp", "heads", "head_dim")),
    (r"wo$", ("heads", None, "fsdp")),
    (r"w_dkv$", ("fsdp", "model")),
    (r"w_uk$", ("fsdp", "heads", None)),
    (r"w_uv$", ("fsdp", "heads", None)),
    (r"router$", ("fsdp", None)),
    (r"we_(gate|up)$", ("experts", "fsdp", None)),
    (r"we_down$", ("experts", None, "fsdp")),
    (r"ws_(gate|up)$", ("fsdp", "ff")),
    (r"ws_down$", ("ff", "fsdp")),
    (r"w_(gate|up)$", ("fsdp", "ff")),
    (r"w_down$", ("ff", "fsdp")),
]

GNN_PARAM_RULES = [
    (r".*", ("replicated",)),          # NequIP params are tiny (<1 MB)
]

RECSYS_PARAM_RULES = [
    (r"tables$", (None, "table_rows", None)),   # (F, V, d) row-sharded
    (r"items$", ("table_rows", None)),
    (r"profile$", ("table_rows", None)),
    (r".*", ("replicated",)),
]

FAMILY_RULES = {"lm": LM_PARAM_RULES, "gnn": GNN_PARAM_RULES,
                "recsys": RECSYS_PARAM_RULES, "ssh": GNN_PARAM_RULES}


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over nested dicts, lists and tuples (a
    NamedTuple keeps its type; ``TensorSpec`` and tensors are leaves);
    ``path`` holds dict keys, field names and list indices as strings."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not hasattr(tree, "dtype"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f),
                                               path + (f,))
                            for f in tree._fields))
    return fn(path, tree)


def param_sharding(params_shapes: Any, mesh: MeshSpec, family: str,
                   stacked_layer_key: str = "layers",
                   drop_fsdp: bool = False) -> Any:
    """Tree of specs for a parameter tree (of meta tensors, tensors or
    ``TensorSpec``s), by the family's rule table.

    ``drop_fsdp=True`` replicates instead of ZeRO-sharding over the data
    axes: the layout for inference when the weights fit a device's
    memory (no optimizer state, no per-layer weight all-gathers).
    """
    rules = FAMILY_RULES[family]

    def leaf_spec(path, leaf):
        pstr = "/".join(path)
        shape = tuple(leaf.shape)
        stacked = stacked_layer_key in path
        trailing = shape[1:] if stacked and len(shape) > 1 else shape
        logicals: Tuple[Optional[str], ...] = ()
        for pat, logi in rules:
            if re.search(pat, pstr):
                logicals = logi
                break
        if logicals == ("replicated",):
            logicals = (None,) * len(trailing)
        if drop_fsdp:
            logicals = tuple(None if l == "fsdp" else l for l in logicals)
        if len(logicals) != len(trailing):
            logicals = (None,) * len(trailing)     # arity mismatch: replicate
        spec = spec_for(logicals, trailing, mesh)
        if stacked and len(shape) > 1:
            spec = (None,) + spec
        return spec

    return tree_map_with_path(leaf_spec, params_shapes)


def batch_sharding(specs: Any, mesh: MeshSpec,
                   overrides: Optional[Dict[str, Spec]] = None,
                   batch_logical: str = "batch") -> Any:
    """Default input sharding: first dim over the batch axes (when
    divisible); per-key overrides (regex on the path) win.
    ``batch_logical='batch_all'`` spreads the batch over every mesh axis
    (the families without tensor parallelism)."""
    overrides = overrides or {}

    def leaf(path, s):
        pstr = "/".join(path)
        for k, v in overrides.items():
            if re.search(k, pstr):
                return tuple(v)
        if not s.shape:
            return ()
        logicals = (batch_logical,) + (None,) * (len(s.shape) - 1)
        return spec_for(logicals, s.shape, mesh)

    return tree_map_with_path(leaf, specs)
