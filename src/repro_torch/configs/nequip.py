"""nequip [arXiv:2101.03164]: 5 layers, 32 channels, l_max=2, 8 RBF,
cutoff 5 Å, E(3) tensor products (counterpart of
``repro.configs.nequip``).  d_feat varies per shape cell (Cora 1433 /
Reddit 602 / products 100 / molecule species one-hot 16)."""
import dataclasses

from repro_torch.configs.base import ArchDef, ShapeCell
from repro_torch.data.graph import sampled_subgraph_shape
from repro_torch.models.nequip import NequIPConfig

CONFIG = NequIPConfig(name="nequip", n_layers=5, channels=32, l_max=2,
                      n_rbf=8, cutoff=5.0, d_feat=1433)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, channels=8, d_feat=8)

_MB_NODES, _MB_EDGES = sampled_subgraph_shape(1024, (15, 10))

SHAPES = {
    "full_graph_sm": ShapeCell("train", {
        "n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    "minibatch_lg": ShapeCell("train", {
        "n_nodes": _MB_NODES, "n_edges": _MB_EDGES, "d_feat": 602,
        "note": "Reddit 233k nodes / 115M edges sampled at fanout 15-10"}),
    "ogb_products": ShapeCell("train", {
        "n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100}),
    "molecule": ShapeCell("train", {
        "n_nodes": 30 * 128, "n_edges": 64 * 128, "d_feat": 16,
        "n_graphs": 128}),
}


def config_for_shape(cfg, shape):
    """``cfg`` with the cell's node-feature width."""
    return dataclasses.replace(cfg, d_feat=SHAPES[shape].meta["d_feat"])


ARCH = ArchDef(name="nequip", family="gnn", config=CONFIG,
               smoke_config=SMOKE, shapes=SHAPES,
               config_for_shape=config_for_shape)
