"""``ArchDef`` — the contract between the configs, the step builders
and the train launcher (counterpart of ``repro.configs.base``).

Each lm, gnn and recsys config module exports ``ARCH = ArchDef(...)``.
``input_specs`` returns a :class:`TensorSpec` for every model input of a
shape cell (shape and dtype, no allocation), and ``kind`` selects the
step the cell runs (train / prefill / decode / serve / retrieval; build
/ query for the SSH arches, ``configs.registry.SSHArch``, whose cells
:func:`ssh_specs` describes).  The reference's specs are
``jax.ShapeDtypeStruct``; the port keeps its own record with a torch
dtype.

GNN note: node and edge counts are padded to multiples of 4096, as the
reference pads them to shard evenly on its meshes; padding edges are
self-loops, which the model masks by the zero-length-edge rule (see
``repro_torch.models.nequip``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch


class TensorSpec(NamedTuple):
    """A model input's shape and dtype (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _pad_to(n: int, mult: int) -> int:
    return int(math.ceil(n / mult) * mult)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    kind: str                # train | prefill | decode | serve | retrieval
    meta: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str                    # lm | gnn | recsys
    config: Any
    smoke_config: Any
    shapes: Dict[str, ShapeCell]
    # optional per-shape config override (the GNN's d_feat differs per cell)
    config_for_shape: Optional[Callable[[Any, str], Any]] = None

    def cell_config(self, shape: str) -> Any:
        """The config a cell runs: ``config``, through
        ``config_for_shape`` where the arch has one."""
        if self.config_for_shape is not None:
            return self.config_for_shape(self.config, shape)
        return self.config

    def input_specs(self, shape: str) -> Tuple[str, Dict[str, Any]]:
        cell = self.shapes[shape]
        cfg = self.cell_config(shape)
        return cell.kind, _SPEC_BUILDERS[self.family](cfg, cell)


def lm_specs(cfg, cell: ShapeCell) -> Dict[str, Any]:
    m = cell.meta
    b, s = m["batch"], m["seq"]
    if cell.kind == "train":
        return {"tokens": TensorSpec((b, s), torch.int32),
                "labels": TensorSpec((b, s), torch.int32)}
    if cell.kind == "prefill":
        return {"tokens": TensorSpec((b, s), torch.int32)}
    if cell.kind == "decode":
        from repro_torch.models.transformer import cache_shapes
        cache = {k: TensorSpec(*v) for k, v in cache_shapes(cfg, b, s).items()}
        return {"tokens": TensorSpec((b, 1), torch.int32), "cache": cache}
    raise ValueError(cell.kind)


def gnn_specs(cfg, cell: ShapeCell) -> Dict[str, Any]:
    m = cell.meta
    n = _pad_to(m["n_nodes"], 4096)
    e = _pad_to(m["n_edges"], 4096)
    specs = {
        "node_feat": TensorSpec((n, m["d_feat"]), torch.float32),
        "positions": TensorSpec((n, 3), torch.float32),
        "edge_src": TensorSpec((e,), torch.int32),
        "edge_dst": TensorSpec((e,), torch.int32),
    }
    if m.get("n_graphs"):
        specs["graph_ids"] = TensorSpec((n,), torch.int32)
        specs["energy"] = TensorSpec((m["n_graphs"],), torch.float32)
    else:
        specs["node_targets"] = TensorSpec((n,), torch.float32)
    return specs


def recsys_specs(cfg, cell: ShapeCell) -> Dict[str, Any]:
    m = cell.meta
    b = m["batch"]
    name = cfg.name
    if cell.kind == "retrieval":
        nc = m["n_candidates"]
        if name.startswith("dlrm"):
            return {"dense": TensorSpec((1, cfg.n_dense), torch.float32),
                    "sparse": TensorSpec((1, cfg.n_sparse), torch.int32),
                    "cand_ids": TensorSpec((nc,), torch.int32)}
        return {"history": TensorSpec((1, cfg.seq_len), torch.int32),
                "cand_ids": TensorSpec((nc,), torch.int32)}
    # train / serve share the batch structure (train adds labels)
    if name.startswith("dlrm"):
        specs = {"dense": TensorSpec((b, cfg.n_dense), torch.float32),
                 "sparse": TensorSpec((b, cfg.n_sparse), torch.int32)}
    elif name.startswith("bst"):
        specs = {"history": TensorSpec((b, cfg.seq_len), torch.int32),
                 "target": TensorSpec((b,), torch.int32),
                 "profile": TensorSpec((b, cfg.n_profile), torch.int32)}
    else:  # mind / dien
        specs = {"history": TensorSpec((b, cfg.seq_len), torch.int32),
                 "target": TensorSpec((b,), torch.int32)}
    if cell.kind == "train":
        specs["labels"] = TensorSpec((b,), torch.float32)
    return specs


class SSHParams(NamedTuple):
    """An ``"ssh"`` IndexSpec's stage params with the encoder's defaults
    filled in (the reference's ``repro.core.index.SSHParams``)."""
    window: int
    step: int
    ngram: int
    num_filters: int
    num_hashes: int
    num_tables: int
    seed: int


def ssh_params(spec) -> SSHParams:
    """:class:`SSHParams` of an ``"ssh"`` ``IndexSpec``."""
    from repro_torch.encoders.pipeline import SSHEncoder
    p = {**SSHEncoder.DEFAULTS, **spec.params}
    return SSHParams(*(int(p[f]) for f in SSHParams._fields[:-1]),
                     seed=int(spec.seed))


def ssh_specs(cfg, cell: ShapeCell) -> Dict[str, Any]:
    """An SSH cell's inputs (``repro/configs/base.py:152-162``): ``build``
    a (batch, length) block of series; ``query`` one series against the
    database's (N, K) signatures and (N, length) series."""
    m = cell.meta
    if cell.kind == "build":
        return {"series": TensorSpec((m["batch"], m["length"]),
                                     torch.float32)}
    if cell.kind == "query":
        k = ssh_params(cfg).num_hashes
        return {
            "query": TensorSpec((m["length"],), torch.float32),
            "db_sigs": TensorSpec((m["n_database"], k), torch.int32),
            "db_series": TensorSpec((m["n_database"], m["length"]),
                                    torch.float32),
        }
    raise ValueError(cell.kind)


_SPEC_BUILDERS = {"lm": lm_specs, "gnn": gnn_specs, "recsys": recsys_specs,
                  "ssh": ssh_specs}


# canonical LM shape set (assignment block)
def lm_shapes() -> Dict[str, ShapeCell]:
    return {
        "train_4k": ShapeCell("train", {"seq": 4096, "batch": 256}),
        "prefill_32k": ShapeCell("prefill", {"seq": 32768, "batch": 32}),
        "decode_32k": ShapeCell("decode", {"seq": 32768, "batch": 128}),
        "long_500k": ShapeCell("decode", {"seq": 524288, "batch": 1}),
    }


def recsys_shapes() -> Dict[str, ShapeCell]:
    return {
        "train_batch": ShapeCell("train", {"batch": 65536}),
        "serve_p99": ShapeCell("serve", {"batch": 512}),
        "serve_bulk": ShapeCell("serve", {"batch": 262144}),
        "retrieval_cand": ShapeCell("retrieval",
                                    {"batch": 1, "n_candidates": 1_000_000}),
    }
