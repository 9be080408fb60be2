"""Analytic MODEL_FLOPS per cell, the useful-compute numerator
(counterpart of ``repro.launch.analytic``).

MODEL_FLOPS counts only the work one step needs:

* LM train: 3 x (2·N_active·D + causal attention), the 6·N·D convention
  (N_active = activated params: attention, top-k experts, shared
  experts, the head);
* LM prefill: the forward third of that;
* LM decode: 2·N_active·B + 2·B·H·(hd + dv)·T attention reads of the
  cache a layer;
* GNN: tensor-product, radial and self-interaction MACs x 3 (train);
* recsys: MLP and interaction MACs x 3 (train) or x 1 (serve);
  embedding gathers are bytes, not FLOPs;
* SSH build: the sketch's projections; SSH query: the signature, the
  collision scan and the banded DTW cells (3 operations a cell: min,
  min, add).

Plain arithmetic over the configs: ``chip_smoke.py`` divides it by a
measured time and the H100's peak for a cell's share of that peak, and
``launch.roofline`` reads it beside the dry run's reports.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ssh_params


def _lm_active_params(cfg) -> Dict[str, float]:
    d, hd, hq = cfg.d_model, cfg.hd, cfg.n_heads
    if cfg.mla:
        attn = (d * hq * (cfg.qk_nope_dim + cfg.qk_rope_dim)     # wq
                + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)       # w_dkv
                + cfg.kv_lora_rank * hq * cfg.qk_nope_dim        # w_uk
                + cfg.kv_lora_rank * hq * cfg.v_head_dim         # w_uv
                + hq * cfg.v_head_dim * d)                       # wo
    else:
        attn = d * hq * hd + 2 * d * cfg.n_kv_heads * hd + hq * hd * d
    if cfg.moe:
        ffn_active = 3 * d * cfg.moe_d_ff * cfg.top_k
        ffn_active += 3 * d * cfg.moe_d_ff * cfg.n_shared
        ffn_active += d * cfg.n_experts            # router
    else:
        ffn_active = 3 * d * cfg.d_ff
    per_layer = attn + ffn_active
    head = d * cfg.vocab
    return {"per_layer": per_layer, "head": head,
            "total": per_layer * cfg.n_layers + head}


def lm_model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    p = _lm_active_params(cfg)
    if kind == "decode":
        tokens = batch
        matmul = 2.0 * p["total"] * tokens
        dv = cfg.v_head_dim if cfg.mla else cfg.hd
        attn = (2.0 * batch * cfg.n_heads * (cfg.hd + dv) * seq
                * cfg.n_layers)
        return matmul + attn
    tokens = batch * seq
    matmul_fwd = 2.0 * p["total"] * tokens
    hd_qk = (cfg.qk_nope_dim + cfg.qk_rope_dim) if cfg.mla else cfg.hd
    dv = cfg.v_head_dim if cfg.mla else cfg.hd
    attn_fwd = (2.0 * batch * seq * seq * cfg.n_heads * (hd_qk + dv)
                * 0.5 * cfg.n_layers)              # causal half
    fwd = matmul_fwd + attn_fwd
    return fwd if kind == "prefill" else 3.0 * fwd


def gnn_model_flops(cfg, meta: Dict) -> float:
    e = meta["n_edges"]
    n = meta["n_nodes"]
    c = cfg.channels
    tp = 0.0
    for (l1, l2, l3) in cfg.paths:
        tp += e * c * (2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1)
    radial = e * (cfg.n_rbf * cfg.radial_hidden
                  + cfg.radial_hidden * len(cfg.paths) * c)
    self_mix = sum(n * c * c * (2 * l + 1) for l in range(cfg.l_max + 1))
    per_layer = 2.0 * (tp + radial + self_mix)
    embed = 2.0 * n * cfg.d_feat * c
    readout = 2.0 * n * (c * cfg.readout_hidden + cfg.readout_hidden)
    fwd = per_layer * cfg.n_layers + embed + readout
    return 3.0 * fwd                                  # train cells


def _mlp_macs(dims, batch):
    return sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1)) * batch


def recsys_model_flops(cfg, kind: str, meta: Dict) -> float:
    b = meta.get("batch", 1)
    name = cfg.name.split("-")[0]
    if kind == "retrieval":
        nc = meta["n_candidates"]
        dim = getattr(cfg, "embed_dim", 64)
        k = getattr(cfg, "n_interests", 1)
        return 2.0 * nc * dim * k
    if name == "dlrm":
        macs = _mlp_macs(cfg.bot_mlp, b)
        f = cfg.n_sparse + 1
        macs += b * f * f * cfg.embed_dim                 # dot interaction
        n_pairs = f * (f - 1) // 2
        macs += _mlp_macs((cfg.embed_dim + n_pairs,) + cfg.top_mlp[1:], b)
    elif name == "bst":
        d, s = cfg.embed_dim, cfg.seq_len + 1
        macs = b * (4 * s * d * d + 2 * s * s * d + 2 * s * d * cfg.d_ff)
        macs += _mlp_macs((s * d + cfg.n_profile * d,) + cfg.mlp + (1,), b)
    elif name == "mind":
        d, s, k = cfg.embed_dim, cfg.seq_len, cfg.n_interests
        macs = b * (s * d * d + cfg.capsule_iters * 2 * k * s * d)
        macs += _mlp_macs((d,) + cfg.mlp + (d,), b * k) + b * k * d
    else:  # dien
        d, g, s = cfg.embed_dim, cfg.gru_dim, cfg.seq_len
        macs = b * s * 3 * ((d + g) * g)                  # GRU1
        macs += b * s * 3 * ((g + g) * g)                 # AUGRU
        macs += b * s * (g + d)                           # attention
        macs += _mlp_macs((g + 2 * d,) + cfg.mlp + (1,), b)
    flops = 2.0 * macs
    return 3.0 * flops if kind == "train" else flops


def ssh_model_flops(cfg, kind: str, meta: Dict) -> float:
    """``cfg``: the arch's ``IndexSpec``."""
    p = ssh_params(cfg)
    if kind == "build":
        b, m = meta["batch"], meta["length"]
        n_b = (m - p.window) // p.step + 1
        return 2.0 * b * n_b * p.window * p.num_filters
    # query: signature + collision scan + banded DTW re-rank
    m = meta["length"]
    n = meta["n_database"]
    n_b = (m - p.window) // p.step + 1
    sig = 2.0 * n_b * p.window
    coll = 2.0 * n * p.num_hashes
    band = 2 * meta["band"] + 1
    dtw = 3.0 * meta["top_c"] * m * band
    return sig + coll + dtw


def model_flops(arch, shape: str) -> float:
    """MODEL_FLOPS of one step of an (arch, shape) cell."""
    cell = arch.shapes[shape]
    cfg = arch.cell_config(shape)
    if arch.family == "lm":
        return lm_model_flops(cfg, cell.kind, cell.meta["batch"],
                              cell.meta["seq"])
    if arch.family == "gnn":
        return gnn_model_flops(cfg, cell.meta)
    if arch.family == "recsys":
        return recsys_model_flops(cfg, cell.kind, cell.meta)
    if arch.family == "ssh":
        return ssh_model_flops(cfg, cell.kind, cell.meta)
    raise ValueError(arch.family)
