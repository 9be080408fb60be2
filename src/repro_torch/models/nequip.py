"""NequIP — E(3)-equivariant interatomic potential (arXiv:2101.03164),
counterpart of ``repro.models.nequip``.

Edges are explicit (src, dst) index lists; the gathers are
``index_select`` and the aggregation ``index_add`` (the reference's
``jnp.take`` and ``jax.ops.segment_sum``).  Features are direct sums of
l = 0..l_max irreps with a common channel multiplicity,
``{str(l): (N, C, 2l+1)}``.  An interaction layer does, per allowed path
(l_in, l_f, l_out):

    msg[e, c, m3] = Σ_{m1 m2} CG[m3,m1,m2] · x_{l_in}[src_e, c, m1]
                                           · Y_{l_f}(r̂_e)[m2] · w_path[e, c]

with w_path = MLP(radial Bessel basis · smooth cutoff), then sums the
messages into their destination nodes, mixes channels per l
(self-interaction), gates l > 0 irreps by scalars and adds the residual.

The product is taken in an explicit order that builds nothing larger
than a message: first ``t[e, m3, m1] = Σ_m2 CG[m3, m1, m2] Y[e, m2]``,
then ``Σ_m1 x[src_e, c, m1] t[e, m3, m1]`` as one batched product, times
``w_path[e, c]``.  A node's features are gathered once per l_in for the
paths that read them, and the messages of one l_out summed before one
scatter-add.  The reference sums the same terms in another order (its
4-operand einsum, one ``segment_sum`` a path), so the two agree to
float32 reordering.

The layers are stacked on a leading L axis (the reference's
``lax.scan``) and run in a Python loop.  Equivariance holds against
:mod:`repro_torch.models.equivariant`'s numerically derived real-basis
CG tables; parity (O(3) against SO(3)) is not tracked, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.equivariant import allowed_paths, real_cg
from repro_torch.train.optimizer import tree_map

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    channels: int = 32           # d_hidden — multiplicity per l
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_feat: int = 16             # input node feature dim (species embed)
    radial_hidden: int = 64
    readout_hidden: int = 32
    dtype: str = "float32"

    @property
    def paths(self) -> List[Tuple[int, int, int]]:
        return allowed_paths(self.l_max)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


# --------------------------------------------------------------------------
# geometry: spherical harmonics (torch mirror of equivariant.real_sh) + RBF
# --------------------------------------------------------------------------

def sh_l(l: int, xyz: torch.Tensor) -> torch.Tensor:
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if l == 0:
        return torch.ones(xyz.shape[:-1] + (1,), dtype=xyz.dtype,
                          device=xyz.device)
    if l == 1:
        return torch.stack([x, y, z], dim=-1)
    if l == 2:
        s3 = torch.tensor(3.0, dtype=xyz.dtype, device=xyz.device).sqrt()
        return torch.stack([
            x * y, y * z, (3 * z * z - 1.0) / (2 * s3), x * z,
            (x * x - y * y) / 2.0], dim=-1) * s3
    raise NotImplementedError(f"l={l}")


def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """sin(nπ r / r_c) / r Bessel basis with a smooth polynomial envelope."""
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rr = torch.clamp(r, min=1e-6)[..., None]
    basis = torch.sin(n * math.pi * rr / cutoff) / rr
    u = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1.0 - 10.0 * u ** 3 + 15.0 * u ** 4 - 6.0 * u ** 5  # C² cutoff
    return basis * env[..., None]


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init_params(cfg: NequIPConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """The reference's tree: ``embed_w``, ``readout_*`` and ``layers``,
    whose leaves (``self_mix`` keyed by ``str(l)``) are stacked on a
    leading L axis; normal draws / sqrt(fan-in), zero biases.  Drawn on
    ``device`` (CUDA unless the caller asks for the CPU) from
    ``generator``, which must live there (default: seeded with 0)."""
    dev = ops.resolve_device(device)
    generator = ops.generator_for(generator, dev)
    dt = cfg.torch_dtype
    c, n_layers = cfg.channels, cfg.n_layers
    n_paths = len(cfg.paths)

    def dense(shape, layers=None):
        fan_in = shape[0]
        if layers is not None:
            shape = (layers,) + tuple(shape)
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return t.mul_(1.0 / math.sqrt(fan_in)).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    layers = {
        "radial_w1": dense((cfg.n_rbf, cfg.radial_hidden), n_layers),
        "radial_b1": zeros(n_layers, cfg.radial_hidden),
        "radial_w2": dense((cfg.radial_hidden, n_paths * c), n_layers),
        "self_mix": {str(l): dense((c, c), n_layers)
                     for l in range(cfg.l_max + 1)},
        "gate_w": dense((c, cfg.l_max * c), n_layers),
        "gate_b": zeros(n_layers, cfg.l_max * c),
    }
    return {
        "embed_w": dense((cfg.d_feat, c)),
        "readout_w1": dense((c, cfg.readout_hidden)),
        "readout_b1": zeros(cfg.readout_hidden),
        "readout_w2": dense((cfg.readout_hidden, 1)),
        "layers": layers,
    }


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------

def _cg_tables(cfg: NequIPConfig, dtype, device) -> List[torch.Tensor]:
    """Each path's CG tensor (2l3+1, 2l1+1, 2l2+1) on the device."""
    return [torch.as_tensor(real_cg(*p), dtype=dtype, device=device)
            for p in cfg.paths]


def _interaction(layer_p: Params, feats: Dict[str, torch.Tensor],
                 src: torch.Tensor, dst: torch.Tensor,
                 sh: Dict[str, torch.Tensor], rbf: torch.Tensor,
                 edge_mask: torch.Tensor, n_nodes: int, cfg: NequIPConfig,
                 cgs: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    c = cfg.channels
    n_edges = rbf.shape[0]
    h = F.silu(rbf @ layer_p["radial_w1"] + layer_p["radial_b1"])
    w = (h @ layer_p["radial_w2"]).reshape(n_edges, len(cfg.paths), c)
    # zero-length edges (self-loops / padding) have no geometry: Y_{l>0}(0)
    # is basis-anisotropic and would silently break equivariance.
    w = w * edge_mask[:, None, None]

    x_src = {l1: feats[str(l1)].index_select(0, src)   # (E, C, 2l1+1)
             for l1 in sorted({p[0] for p in cfg.paths})}
    msgs: Dict[int, torch.Tensor] = {}
    for p_idx, (l1, l2, l3) in enumerate(cfg.paths):
        cg = cgs[p_idx]
        n3, n1, n2 = cg.shape
        t = (sh[str(l2)] @ cg.reshape(n3 * n1, n2).T).reshape(
            n_edges, n3, n1)                            # (E, 2l3+1, 2l1+1)
        msg = torch.bmm(x_src[l1], t.transpose(1, 2)) * w[:, p_idx, :, None]
        msgs[l3] = msg if l3 not in msgs else msgs[l3] + msg
    agg = {}
    for l in range(cfg.l_max + 1):
        zero = feats["0"].new_zeros((n_nodes, c, 2 * l + 1))
        agg[l] = zero.index_add(0, dst, msgs[l]) if l in msgs else zero

    # self-interaction (channel mix per l) + gated nonlinearity + residual
    out = {}
    gates = torch.sigmoid(feats["0"][..., 0] @ layer_p["gate_w"]
                          + layer_p["gate_b"])
    gates = gates.reshape(-1, cfg.l_max, c)
    for l in range(cfg.l_max + 1):
        mixed = (agg[l].transpose(1, 2) @ layer_p["self_mix"][str(l)]
                 ).transpose(1, 2)                      # (N, C, 2l+1)
        if l == 0:
            upd = F.silu(mixed)
        else:
            upd = mixed * gates[:, l - 1, :, None]
        out[str(l)] = feats[str(l)] + upd
    return out


def _node_features(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: NequIPConfig) -> Dict[str, torch.Tensor]:
    """Geometry, the embedding and every interaction layer."""
    dt = cfg.torch_dtype
    pos = batch["positions"].to(dt)
    src = batch["edge_src"].to(torch.int64)
    dst = batch["edge_dst"].to(torch.int64)
    n_nodes = pos.shape[0]

    vec = pos.index_select(0, dst) - pos.index_select(0, src)
    r = torch.linalg.vector_norm(vec + 1e-12, dim=-1)
    unit = vec / torch.clamp(r, min=1e-6)[..., None]
    sh = {str(l): sh_l(l, unit) for l in range(cfg.l_max + 1)}
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff)
    edge_mask = (r > 1e-6).to(dt)

    feats = {"0": (batch["node_feat"].to(dt) @ params["embed_w"])[..., None]}
    for l in range(1, cfg.l_max + 1):
        feats[str(l)] = pos.new_zeros((n_nodes, cfg.channels, 2 * l + 1))
    cgs = _cg_tables(cfg, dt, pos.device)
    for i in range(params["layers"]["radial_w1"].shape[0]):
        layer_p = tree_map(lambda t: t[i], params["layers"])
        feats = _interaction(layer_p, feats, src, dst, sh, rbf, edge_mask,
                             n_nodes, cfg, cgs)
    return feats


def _readout(params: Params, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
    scalars = feats["0"][..., 0]                            # (N, C)
    h = F.silu(scalars @ params["readout_w1"] + params["readout_b1"])
    return (h @ params["readout_w2"])[..., 0]               # (N,)


def forward(params: Params, batch: Dict[str, torch.Tensor],
            cfg: NequIPConfig, n_graphs: Optional[int] = None
            ) -> torch.Tensor:
    """Energy prediction.

    batch: node_feat (N, d_feat), positions (N, 3), edge_src/edge_dst
    (E,) ints, optional graph_ids (N,) with ``n_graphs`` for batched
    molecules.  Returns per-graph energies (n_graphs,) or the global
    energy (1,).
    """
    node_e = node_energies(params, batch, cfg)
    if n_graphs is not None and "graph_ids" in batch:
        return node_e.new_zeros((n_graphs,)).index_add(
            0, batch["graph_ids"].to(torch.int64), node_e)
    return node_e.sum(dim=0, keepdim=True)


def node_energies(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: NequIPConfig) -> torch.Tensor:
    """Per-node energies (node-level regression targets)."""
    return _readout(params, _node_features(params, batch, cfg))


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: NequIPConfig, n_graphs: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if "node_targets" in batch:   # node-level regression (full-graph cells)
        node_e = node_energies(params, batch, cfg)
        err = node_e - batch["node_targets"].to(node_e.dtype)
    else:                         # per-graph energies (molecule cell)
        energies = forward(params, batch, cfg, n_graphs=n_graphs)
        err = energies - batch["energy"].to(energies.dtype)
    loss = torch.mean(err * err)
    return loss, {"mse": loss}


def forces(params: Params, batch: Dict[str, torch.Tensor],
           cfg: NequIPConfig) -> torch.Tensor:
    """F = -∂E/∂positions, E the sum of every node's energy, through
    ``torch.autograd.grad`` (no graph is kept)."""
    pos = batch["positions"].detach().requires_grad_(True)
    energy = forward(params, dict(batch, positions=pos), cfg).sum()
    (grad,) = torch.autograd.grad(energy, pos)
    return -grad
