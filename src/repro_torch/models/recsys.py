"""Recsys architectures: DLRM-RM2, BST, MIND, DIEN (counterpart of
``repro.models.recsys``).

Common structure: huge hashed embedding tables, a feature-interaction
op (dot products / a transformer block / capsule routing / GRU + AUGRU),
a small MLP head.  Lookups go through :mod:`repro_torch.models.embedding`.

Every model has ``*_init(cfg, generator=None, device=None)``,
``*_forward(params, batch, cfg) -> logits (B,)`` and
``*_retrieval(params, batch, cfg) -> scores (n_cand,)`` (one user
against ``cand_ids``: one batched product, never a loop), and
:func:`bce_loss` scores clicks.  Parameters are the reference's tree:
nested dicts, the MLPs lists of ``{"w", "b"}``, BST's blocks a list of
dicts.  They are drawn on ``device`` (CUDA unless the caller asks for
the CPU) from ``generator``, which must live there (default: seeded with
0), with the reference's distributions; the numbers are not the
reference's, since ``jax.random`` cannot be reproduced.

The reference's ``lax.scan`` loops (MIND's routing, DIEN's two GRUs)
are Python loops over the steps, its ``stop_gradient`` ``detach()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.embedding import embedding_lookup
from repro_torch.models.layers import rms_norm

Params = Dict[str, Any]


def _generator(generator: Optional[torch.Generator], dev: torch.device
               ) -> torch.Generator:
    return ops.generator_for(generator, dev)


def _dense(gen, dev, shape, dtype=torch.float32, scale=None):
    """Normal draws times ``scale`` (default 1 / sqrt(shape[0]))."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    t = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    return t.mul_(scale).to(dtype)


def _mlp_params(gen, dev, dims):
    return [{"w": _dense(gen, dev, (dims[i], dims[i + 1])),
             "b": torch.zeros((dims[i + 1],), device=dev)}
            for i in range(len(dims) - 1)]


def _mlp(params, x, final_act=False):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1 or final_act:
            x = F.relu(x)
    return x


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits, in float32, the reference's
    stable form."""
    logits = logits.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


# ==========================================================================
# DLRM (arXiv:1906.00091) — RM2 sizing
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab: int = 1_000_000           # rows per table (hashed)
    bot_mlp: Tuple[int, ...] = (13, 512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    dtype: str = "float32"


def dlrm_init(cfg: DLRMConfig, generator: Optional[torch.Generator] = None,
              device=None) -> Params:
    """Tables (F, V, d) at 0.01, the bottom MLP, and the top MLP whose
    first width is ``embed_dim + n_pairs`` (415 at RM2), not
    ``top_mlp[0]``, as the reference's."""
    dev = ops.resolve_device(device)
    gen = _generator(generator, dev)
    tables = _dense(gen, dev, (cfg.n_sparse, cfg.vocab, cfg.embed_dim),
                    getattr(torch, cfg.dtype), scale=0.01)
    n_pairs = (cfg.n_sparse + 1) * cfg.n_sparse // 2
    top_in = cfg.embed_dim + n_pairs
    return {
        "tables": tables,
        "bot": _mlp_params(gen, dev, list(cfg.bot_mlp)),
        "top": _mlp_params(gen, dev, [top_in] + list(cfg.top_mlp)[1:]),
    }


def _field_lookup(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-field lookup, tables (F, V, d), ids (B, F) -> (B, F, d): one
    gather from the tables viewed as (F V, d) at f V + id mod V (the
    reference's ``vmap`` of ``embedding_lookup`` over the fields)."""
    f, v, d = tables.shape
    idx = ids.to(torch.int32).to(torch.int64).remainder(v)
    idx = idx + torch.arange(f, device=ids.device) * v
    return tables.reshape(f * v, d).index_select(
        0, idx.reshape(-1)).reshape(ids.shape[0], f, d)


def dlrm_forward(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: DLRMConfig) -> torch.Tensor:
    """batch: dense (B, 13) f32, sparse (B, 26) int -> logits (B,)."""
    x_d = _mlp(params["bot"], batch["dense"])                 # (B, d)
    emb = _field_lookup(params["tables"], batch["sparse"])    # (B, F, d)
    feats = torch.cat([x_d[:, None, :], emb], dim=1)          # (B, F+1, d)
    inter = torch.bmm(feats, feats.transpose(1, 2))
    n = feats.shape[1]
    iu, ju = torch.triu_indices(n, n, 1, device=feats.device)
    flat = inter[:, iu, ju]                                   # (B, n_pairs)
    top_in = torch.cat([x_d, flat], dim=-1)
    return _mlp(params["top"], top_in)[:, 0]


def dlrm_retrieval(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: DLRMConfig) -> torch.Tensor:
    """One user against ``n_cand`` item ids: dense (1, 13), sparse
    (1, 26), cand_ids (n_cand,) -> (n_cand,).  User tower: the bottom
    MLP plus the mean of the field embeddings; item tower: rows of
    table 0."""
    x_d = _mlp(params["bot"], batch["dense"])                 # (1, d)
    emb = _field_lookup(params["tables"], batch["sparse"])    # (1, F, d)
    user = x_d + emb.mean(dim=1)                              # (1, d)
    items = embedding_lookup(params["tables"][0], batch["cand_ids"])
    return items @ user[0]                                    # (n_cand,)


# ==========================================================================
# BST — Behavior Sequence Transformer (arXiv:1905.06874)
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    embed_dim: int = 32
    seq_len: int = 20
    n_heads: int = 8
    n_blocks: int = 1
    d_ff: int = 128
    mlp: Tuple[int, ...] = (1024, 512, 256)
    vocab: int = 2_000_000
    n_profile: int = 8              # user-profile categorical fields
    dtype: str = "float32"


def bst_init(cfg: BSTConfig, generator: Optional[torch.Generator] = None,
             device=None) -> Params:
    dev = ops.resolve_device(device)
    gen = _generator(generator, dev)
    d = cfg.embed_dim
    items = _dense(gen, dev, (cfg.vocab, d), scale=0.01)
    pos = _dense(gen, dev, (cfg.seq_len + 1, d), scale=0.01)
    profile = _dense(gen, dev, (cfg.n_profile * 1000, d), scale=0.01)
    blocks = []
    for _ in range(cfg.n_blocks):
        blocks.append({
            "wq": _dense(gen, dev, (d, d)), "wk": _dense(gen, dev, (d, d)),
            "wv": _dense(gen, dev, (d, d)), "wo": _dense(gen, dev, (d, d)),
            "ff1": _dense(gen, dev, (d, cfg.d_ff)),
            "ff2": _dense(gen, dev, (cfg.d_ff, d)),
            "ln1": torch.ones((d,), device=dev),
            "ln2": torch.ones((d,), device=dev),
        })
    mlp_in = (cfg.seq_len + 1) * d + cfg.n_profile * d
    return {"items": items, "pos": pos, "profile": profile,
            "blocks": blocks,
            "head": _mlp_params(gen, dev, [mlp_in] + list(cfg.mlp) + [1])}


def _bst_block(p, x, n_heads):
    b, s, d = x.shape
    hd = d // n_heads

    def heads(t):                                   # (B, H, S, hd)
        return t.reshape(b, s, n_heads, hd).transpose(1, 2)
    xn = rms_norm(x, p["ln1"])
    q, k, v = heads(xn @ p["wq"]), heads(xn @ p["wk"]), heads(xn @ p["wv"])
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1)
    o = (probs @ v).transpose(1, 2).reshape(b, s, d)
    x = x + o @ p["wo"]
    xn = rms_norm(x, p["ln2"])
    return x + F.relu(xn @ p["ff1"]) @ p["ff2"]


def bst_forward(params: Params, batch: Dict[str, torch.Tensor],
                cfg: BSTConfig) -> torch.Tensor:
    """batch: history (B, S), target (B,), profile (B, P) ints ->
    logits (B,)."""
    hist = embedding_lookup(params["items"], batch["history"])
    tgt = embedding_lookup(params["items"], batch["target"])[:, None, :]
    seq = torch.cat([hist, tgt], dim=1) + params["pos"][None]
    for blk in params["blocks"]:
        seq = _bst_block(blk, seq, cfg.n_heads)
    prof = embedding_lookup(params["profile"], batch["profile"])
    b = seq.shape[0]
    feats = torch.cat([seq.reshape(b, -1), prof.reshape(b, -1)], dim=-1)
    return _mlp(params["head"], feats)[:, 0]


def bst_retrieval(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: BSTConfig) -> torch.Tensor:
    """One user history against candidate ids: mean-pooled history ·
    item."""
    hist = embedding_lookup(params["items"], batch["history"])
    user = hist.mean(dim=1)                                   # (1, d)
    items = embedding_lookup(params["items"], batch["cand_ids"])
    return items @ user[0]


# ==========================================================================
# MIND — multi-interest capsule network (arXiv:1904.08030)
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    embed_dim: int = 64
    seq_len: int = 50
    n_interests: int = 4
    capsule_iters: int = 3
    vocab: int = 2_000_000
    mlp: Tuple[int, ...] = (256, 64)
    dtype: str = "float32"


def mind_init(cfg: MINDConfig, generator: Optional[torch.Generator] = None,
              device=None) -> Params:
    dev = ops.resolve_device(device)
    gen = _generator(generator, dev)
    d = cfg.embed_dim
    return {
        "items": _dense(gen, dev, (cfg.vocab, d), scale=0.01),
        "s_matrix": _dense(gen, dev, (d, d)),    # shared bilinear map (B2I)
        "head": _mlp_params(gen, dev, [d] + list(cfg.mlp) + [d]),
    }


def _squash(x, dim=-1):
    n2 = torch.sum(x * x, dim=dim, keepdim=True)
    return (n2 / (1 + n2)) * x / torch.sqrt(n2 + 1e-9)


def mind_interests(params: Params, history: torch.Tensor,
                   cfg: MINDConfig) -> torch.Tensor:
    """Dynamic-routing (B2I) capsules: history (B, S) -> (B, K, d).  The
    routing logits see the behaviours detached (the reference's
    ``stop_gradient``); the final capsules are recomputed from the
    logits with the gradient."""
    beh = embedding_lookup(params["items"], history)          # (B, S, d)
    beh_hat = beh @ params["s_matrix"]                        # (B, S, d)
    b, s, d = beh.shape
    fixed = beh_hat.detach()
    logits = beh.new_zeros((b, cfg.n_interests, s))
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(logits, dim=1)                      # over K
        caps = _squash(w @ fixed)                             # (B, K, d)
        logits = logits + caps @ fixed.transpose(1, 2)        # (B, K, S)
    caps = _squash(torch.softmax(logits, dim=1) @ beh_hat)
    return _mlp(params["head"], caps)                         # (B, K, d)


def mind_forward(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: MINDConfig) -> torch.Tensor:
    """Label-aware scoring: the max over interests of interest·target
    (``amax``: a tie shares the gradient, as ``jnp.max``)."""
    interests = mind_interests(params, batch["history"], cfg)  # (B, K, d)
    tgt = embedding_lookup(params["items"], batch["target"])   # (B, d)
    scores = (interests @ tgt[:, :, None])[..., 0]             # (B, K)
    return scores.amax(dim=-1)


def mind_retrieval(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: MINDConfig) -> torch.Tensor:
    interests = mind_interests(params, batch["history"], cfg)  # (1, K, d)
    items = embedding_lookup(params["items"], batch["cand_ids"])
    return (items @ interests[0].T).amax(dim=-1)               # (n_cand,)


# ==========================================================================
# DIEN — GRU + AUGRU interest evolution (arXiv:1809.03672)
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: Tuple[int, ...] = (200, 80)
    vocab: int = 2_000_000
    dtype: str = "float32"


def _gru_params(gen, dev, d_in, d_h):
    p = {}
    for gate in ("z", "r", "h"):
        p[f"w{gate}"] = _dense(gen, dev, (d_in + d_h, d_h))
        p[f"b{gate}"] = torch.zeros((d_h,), device=dev)
    return p


def _gru_cell(p, h, x, att: Optional[torch.Tensor] = None):
    hx = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(hx @ p["wz"] + p["bz"])
    r = torch.sigmoid(hx @ p["wr"] + p["br"])
    hh = torch.tanh(torch.cat([x, r * h], dim=-1) @ p["wh"] + p["bh"])
    if att is not None:             # AUGRU: attention scales the update gate
        z = z * att[:, None]
    return (1 - z) * h + z * hh


def dien_init(cfg: DIENConfig, generator: Optional[torch.Generator] = None,
              device=None) -> Params:
    dev = ops.resolve_device(device)
    gen = _generator(generator, dev)
    d, g = cfg.embed_dim, cfg.gru_dim
    return {
        "items": _dense(gen, dev, (cfg.vocab, d), scale=0.01),
        "gru1": _gru_params(gen, dev, d, g),
        "gru2": _gru_params(gen, dev, g, g),
        "att_w": _dense(gen, dev, (g + d, 1)),
        "head": _mlp_params(gen, dev, [g + 2 * d] + list(cfg.mlp) + [1]),
    }


def _interest_states(p, beh: torch.Tensor, gru_dim: int) -> torch.Tensor:
    """The interest-extraction GRU over the S steps: beh (B, S, d) ->
    states (S, B, g)."""
    h = beh.new_zeros((beh.shape[0], gru_dim))
    states = []
    for t in range(beh.shape[1]):
        h = _gru_cell(p, h, beh[:, t])
        states.append(h)
    return torch.stack(states)


def dien_forward(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: DIENConfig) -> torch.Tensor:
    """batch: history (B, S), target (B,) ints -> logits (B,)."""
    beh = embedding_lookup(params["items"], batch["history"])  # (B, S, d)
    tgt = embedding_lookup(params["items"], batch["target"])   # (B, d)
    b, s, d = beh.shape
    states = _interest_states(params["gru1"], beh, cfg.gru_dim)
    # attention of each interest state against the target, over S
    att_in = torch.cat([states, tgt[None].expand(s, b, d)], dim=-1)
    att = torch.softmax((att_in @ params["att_w"])[..., 0], dim=0)  # (S, B)
    # interest evolution AUGRU
    h = beh.new_zeros((b, cfg.gru_dim))
    for t in range(s):
        h = _gru_cell(params["gru2"], h, states[t], att=att[t])
    feats = torch.cat([h, tgt, beh.mean(dim=1)], dim=-1)
    return _mlp(params["head"], feats)[:, 0]


def dien_retrieval(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: DIENConfig) -> torch.Tensor:
    """The GRU's last state of the one user, cut to its first ``d``
    entries (the reference's ``h[0, :d]``, d the embedding width), plus
    the mean behaviour, against the candidates' rows."""
    beh = embedding_lookup(params["items"], batch["history"])
    d = beh.shape[2]
    h = _interest_states(params["gru1"], beh, cfg.gru_dim)[-1]
    items = embedding_lookup(params["items"], batch["cand_ids"])
    user = h[0, :d] + beh[0].mean(dim=0)
    return items @ user


#: each model's (init, forward, retrieval), by its config's name up to
#: the first "-" (as the reference's step builders pick them)
MODELS = {"dlrm": (dlrm_init, dlrm_forward, dlrm_retrieval),
          "bst": (bst_init, bst_forward, bst_retrieval),
          "mind": (mind_init, mind_forward, mind_retrieval),
          "dien": (dien_init, dien_forward, dien_retrieval)}
