"""Graph data pipeline: synthetic graph generators + a real neighbor
sampler (numpy CSR, host-side — the standard production split: sampling on
CPU hosts, compute on accelerators).  Counterpart of ``repro.data.graph``:
numpy only, the same draws from ``np.random.default_rng(seed)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def random_graph(n_nodes: int, n_edges: int, d_feat: int, seed: int = 0,
                 positions_scale: float = 3.0) -> Dict[str, np.ndarray]:
    """Random graph with positions (NequIP needs geometry; DESIGN.md §4)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    return {
        "node_feat": rng.normal(0, 1, (n_nodes, d_feat)).astype(np.float32),
        "positions": (rng.normal(0, positions_scale, (n_nodes, 3))
                      .astype(np.float32)),
        "edge_src": src,
        "edge_dst": dst,
        "node_targets": rng.normal(0, 1, n_nodes).astype(np.float32),
    }


def molecule_batch(n_graphs: int, nodes_per: int, edges_per: int,
                   d_feat: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Disjoint union of small molecular graphs (radius-graph edges)."""
    rng = np.random.default_rng(seed)
    n = n_graphs * nodes_per
    pos = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    srcs, dsts = [], []
    for g in range(n_graphs):
        lo = g * nodes_per
        # nearest-neighbour-ish random edges within the molecule
        s = rng.integers(0, nodes_per, edges_per) + lo
        d = rng.integers(0, nodes_per, edges_per) + lo
        srcs.append(s)
        dsts.append(d)
    return {
        "node_feat": rng.normal(0, 1, (n, d_feat)).astype(np.float32),
        "positions": pos,
        "edge_src": np.concatenate(srcs).astype(np.int32),
        "edge_dst": np.concatenate(dsts).astype(np.int32),
        "graph_ids": np.repeat(np.arange(n_graphs), nodes_per
                               ).astype(np.int32),
        "energy": rng.normal(0, 1, n_graphs).astype(np.float32),
    }


@dataclasses.dataclass
class CSRGraph:
    """Compressed sparse row adjacency for host-side neighbor sampling."""
    indptr: np.ndarray      # (N+1,)
    indices: np.ndarray     # (E,)

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, n_nodes: int
                   ) -> "CSRGraph":
        order = np.argsort(dst, kind="stable")
        s = src[order]
        counts = np.bincount(dst, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return cls(indptr=indptr, indices=s.astype(np.int32))

    def degree(self, node: int) -> int:
        return int(self.indptr[node + 1] - self.indptr[node])


def sample_neighbors(graph: CSRGraph, seeds: np.ndarray,
                     fanouts: Sequence[int], seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    """GraphSAGE-style uniform k-hop neighbor sampling (with replacement).

    Returns a *padded, fixed-shape* subgraph (the reference's jit needs one):
      nodes  (n_total,) original node ids, layer-by-layer
      edge_src/edge_dst (n_edges,) indices INTO ``nodes``
      Padded edges are self-loops on node 0 (masked inside the model by the
      zero-length-edge rule).
    """
    rng = np.random.default_rng(seed)
    layers = [seeds.astype(np.int32)]
    srcs, dsts = [], []
    offset = 0
    for fanout in fanouts:
        frontier = layers[-1]
        n_f = len(frontier)
        sampled = np.zeros(n_f * fanout, np.int32)
        for i, node in enumerate(frontier):
            lo, hi = graph.indptr[node], graph.indptr[node + 1]
            if hi > lo:
                sampled[i * fanout:(i + 1) * fanout] = rng.choice(
                    graph.indices[lo:hi], fanout, replace=True)
            else:
                sampled[i * fanout:(i + 1) * fanout] = node  # self-pad
        new_offset = offset + n_f
        srcs.append(np.arange(n_f * fanout, dtype=np.int32) + new_offset)
        dsts.append(np.repeat(np.arange(n_f, dtype=np.int32) + offset,
                              fanout))
        layers.append(sampled)
        offset = new_offset
    nodes = np.concatenate(layers)
    return {
        "nodes": nodes,
        "edge_src": np.concatenate(srcs),
        "edge_dst": np.concatenate(dsts),
        "layer_sizes": np.asarray([len(l) for l in layers], np.int32),
    }


def sampled_subgraph_shape(batch_nodes: int, fanouts: Sequence[int]
                           ) -> Tuple[int, int]:
    """(n_nodes, n_edges) of the padded sampled subgraph."""
    n_nodes, n_edges = batch_nodes, 0
    frontier = batch_nodes
    for f in fanouts:
        n_edges += frontier * f
        frontier = frontier * f
        n_nodes += frontier
    return n_nodes, n_edges
