"""Decoder-only transformer: the training forward and loss, prefill and
KV-cache decode (counterpart of ``repro.models.transformer``).

Every LM configuration of the repo: dense SwiGLU + GQA (granite-3-2b,
granite-3-8b, phi3-mini), MoE + GQA (dbrx) and MoE with shared experts +
MLA (deepseek-v2-lite).  Parameters are a plain dict with the
reference's names and layouts and the layers stacked on a leading L
axis: ``wq`` (L, d, H, hd), ``wk``/``wv`` (L, d, Hk, hd), ``wo``
(L, H, hd, d); MLA instead ``wq`` (L, d, H, dn + dr), ``w_dkv``
(L, d, r + dr), ``w_uk`` (L, r, H, dn), ``w_uv`` (L, r, H, dv), ``wo``
(L, H, dv, d); dense ``w_gate``/``w_up`` (L, d, ff), ``w_down``
(L, ff, d); MoE ``router`` (L, d, E) in float32 whatever the model's
dtype, ``we_gate``/``we_up`` (L, E, d, ff), ``we_down`` (L, E, ff, d)
and, with shared experts, ``ws_gate``/``ws_up`` (L, d, n_shared ff),
``ws_down`` (L, n_shared ff, d); norms (L, d); ``embed`` (V, d),
``head`` (d, V), ``ln_f`` (d,).  The layers run in a Python loop over
the stacked tensors unbound along L (PyTorch runs eagerly: the
reference's ``lax.scan``), so that their gradients are stacked once and
not scattered into a zeroed (L, ...) tensor a layer.  Under grad with
``cfg.remat`` each layer runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` with ``nothing_saveable``): only the
layer's input is kept and its forward, the flash kernel included, runs
again in the backward.  The reference's sharding constraints are
dropped: this runs on one card.

The cache is ``{"k", "v": (L, B, T, Hk, hd), "length": (B,) int32}``,
for MLA the compressed ``{"c": (L, B, T, r), "k_rope": (L, B, T, dr),
"length"}``.  :func:`decode_step` writes the new entries into the
cache's tensors in place (the reference returns updated copies) and
returns the cache with ``length + 1``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.moe import MoEConfig, moe_ffn

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig``, field for field."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512
    # MLA
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # attention / misc
    rope_theta: float = 1e4
    q_chunk: int = 512
    kv_chunk: int = 1024
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(n_experts=self.n_experts, top_k=self.top_k,
                         d_model=self.d_model, d_ff=self.moe_d_ff,
                         n_shared=self.n_shared,
                         capacity_factor=self.capacity_factor,
                         group_size=self.moe_group_size)

    def param_count(self) -> int:
        return sum(math.prod(shape) for shape in param_shapes(self).values())


def param_shapes(cfg: LMConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape by its path ("embed", "layers/wq", ...)."""
    n, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    h, hk = cfg.n_heads, cfg.n_kv_heads
    layer = {"ln_attn": (d,), "ln_mlp": (d,)}
    if cfg.mla:
        dn, dr, dv, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                         cfg.kv_lora_rank)
        layer.update(wq=(d, h, dn + dr), w_dkv=(d, r + dr),
                     w_uk=(r, h, dn), w_uv=(r, h, dv), wo=(h, dv, d))
    else:
        layer.update(wq=(d, h, hd), wk=(d, hk, hd), wv=(d, hk, hd),
                     wo=(h, hd, d))
    if cfg.moe:
        e, ff = cfg.n_experts, cfg.moe_d_ff
        layer.update(router=(d, e), we_gate=(e, d, ff), we_up=(e, d, ff),
                     we_down=(e, ff, d))
        if cfg.n_shared:
            sf = cfg.n_shared * ff
            layer.update(ws_gate=(d, sf), ws_up=(d, sf), ws_down=(sf, d))
    else:
        layer.update(w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff),
                     w_down=(cfg.d_ff, d))
    return {"embed": (cfg.vocab, d), "head": (d, cfg.vocab), "ln_f": (d,),
            **{f"layers/{k}": (n, *shape) for k, shape in layer.items()}}


def param_dtype(cfg: LMConfig, path: str) -> torch.dtype:
    """A parameter's type: the MoE router is float32 in every model (the
    reference draws it so, ``transformer.py:123``), the rest
    ``cfg.dtype``."""
    return torch.float32 if path == "layers/router" else cfg.torch_dtype


#: parameters drawn at 0.02 / sqrt(2 L) (the rest at 0.02; norms are ones)
_OUT_PROJECTIONS = ("layers/wo", "layers/w_down", "layers/we_down",
                    "layers/ws_down")
_NORMS = ("ln_f", "layers/ln_attn", "layers/ln_mlp")


def flatten(params: Params) -> Dict[str, torch.Tensor]:
    """{"embed": .., "layers": {"wq": ..}} -> {"embed": .., "layers/wq": ..}."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update({f"layers/{k}": v for k, v in params["layers"].items()})
    return out


def unflatten(flat: Dict[str, torch.Tensor]) -> Params:
    params: Params = {"layers": {}}
    for path, t in flat.items():
        if path.startswith("layers/"):
            params["layers"][path[len("layers/"):]] = t
        else:
            params[path] = t
    return params


def _init_leaf(cfg: LMConfig, path: str, shape: Tuple[int, ...],
               generator: torch.Generator, dev: torch.device,
               stacked: bool) -> torch.Tensor:
    """One parameter of ``path`` at ``shape``: ones for a norm, else
    float32 normals times its scale cast to its dtype, drawn a layer at a
    time along a ``stacked`` leading L axis."""
    dt = param_dtype(cfg, path)
    if path in _NORMS:
        return torch.ones(shape, dtype=dt, device=dev)
    scale = (0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)
             if path in _OUT_PROJECTIONS else 0.02)
    t = torch.empty(shape, dtype=dt, device=dev)
    for part in (t if stacked else (t,)):
        part.copy_(torch.randn(part.shape, generator=generator, device=dev,
                               dtype=torch.float32).mul_(scale))
    return t


def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Random weights with the reference's distributions
    (``transformer.py:97-151``): normal * 0.02, normal * 0.02 / sqrt(2L)
    for the output projections (``wo``, ``w_down``, ``we_down``,
    ``ws_down``), ones for the norms, in :func:`param_dtype`.

    Drawn on ``device`` (CUDA unless the caller asks for the CPU) from
    ``generator``, which must live there (default: seeded with 0), one
    layer at a time, so that the float32 draw of a stacked tensor never
    stands beside the whole of it.  The numbers are not the reference's:
    ``jax.random`` cannot be reproduced.
    """
    dev = ops.resolve_device(device)
    generator = ops.generator_for(generator, dev)
    return unflatten({
        path: _init_leaf(cfg, path, shape, generator, dev,
                         stacked=path.startswith("layers/"))
        for path, shape in param_shapes(cfg).items()})


def init_layer_params(cfg: LMConfig,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> Dict[str, torch.Tensor]:
    """One layer's parameters without the leading L axis
    (``transformer.py:97-135``): the reference's keys, shapes, dtypes and
    init scales for dense, MLA and MoE layers, drawn on ``device`` from
    ``generator`` (default: seeded with 0) in :func:`param_shapes`'
    order; :func:`init_params` draws a parameter's layers in turn, so
    its layer 0 is not this draw."""
    dev = ops.resolve_device(device)
    generator = ops.generator_for(generator, dev)
    return {path[len("layers/"):]: _init_leaf(cfg, path, shape[1:],
                                              generator, dev, stacked=False)
            for path, shape in param_shapes(cfg).items()
            if path.startswith("layers/")}


def _layer_params(params: Params, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _gqa_attention(p, x: torch.Tensor, cfg: LMConfig,
                   positions: torch.Tensor) -> torch.Tensor:
    q = layers.apply_rope(_project(x, p["wq"]), positions, cfg.rope_theta)
    k = layers.apply_rope(_project(x, p["wk"]), positions, cfg.rope_theta)
    v = _project(x, p["wv"])
    o = layers.chunked_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                                 kv_chunk=cfg.kv_chunk)
    return o.flatten(2) @ p["wo"].flatten(0, 1)


def _mla_query(p, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr) rotated)."""
    q = _project(x, p["wq"])
    dn = cfg.qk_nope_dim
    return q[..., :dn], layers.apply_rope(q[..., dn:], positions,
                                          cfg.rope_theta)


def _mla_latent(p, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the latent c (B, S, r), the shared rope key (B, S, 1, dr)
    rotated)."""
    ckv = x @ p["w_dkv"]
    r = cfg.kv_lora_rank
    return ckv[..., :r], layers.apply_rope(ckv[..., None, r:], positions,
                                           cfg.rope_theta)


def _mla_attention(p, x: torch.Tensor, cfg: LMConfig,
                   positions: torch.Tensor) -> torch.Tensor:
    """MLA prefill (``transformer.py:177-199``): K and V expanded from the
    latent, the one rope key broadcast to every head; attention at Q/K
    dim dn + dr and V dim dv through the flash kernel, scale
    (dn + dr)^-0.5.  The concatenations make q and k contiguous, as the
    tensor-core kernel's TMA needs."""
    q_nope, q_rope = _mla_query(p, x, cfg, positions)
    c, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = _project(c, p["w_uk"])
    v = _project(c, p["w_uv"])
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1], -1)],
                       dim=-1)
    o = layers.chunked_attention(
        q_full, k_full, v, causal=True, q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk,
        scale=(cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)
    return o.flatten(2) @ p["wo"].flatten(0, 1)


def _ffn(p, x: torch.Tensor, cfg: LMConfig
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense SwiGLU, or the routed experts plus the shared ones
    (``transformer.py:206-215``), and the layer's MoE auxiliary loss
    (float32 zero for a dense model)."""
    if not cfg.moe:
        return (layers.swiglu(x, p["w_gate"], p["w_up"], p["w_down"]),
                x.new_zeros((), dtype=torch.float32))
    y, aux = moe_ffn(x, p["router"], p["we_gate"], p["we_up"],
                     p["we_down"], cfg.moe_cfg)
    if cfg.n_shared:
        y = y + layers.swiglu(x, p["ws_gate"], p["ws_up"], p["ws_down"])
    return y, aux


def _layer(p, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    attn = _mla_attention if cfg.mla else _gqa_attention
    h = x + attn(p, layers.rms_norm(x, p["ln_attn"]), cfg, positions)
    y, aux = _ffn(p, layers.rms_norm(h, p["ln_mlp"]), cfg)
    return h + y, aux


def _trunk(params: Params, tokens: torch.Tensor, cfg: LMConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (final-normed hidden states (B, S, d), the MoE
    auxiliary loss summed over the layers)."""
    x = params["embed"][tokens].to(cfg.torch_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    aux = x.new_zeros((), dtype=torch.float32)
    for i in range(cfg.n_layers):
        p = {k: v[i] for k, v in per_layer.items()}
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _layer, p, x, cfg, positions, use_reentrant=False)
        else:
            x, a = _layer(p, x, cfg, positions)
        aux = aux + a
    return layers.rms_norm(x, params["ln_f"]), aux


def forward(params: Params, tokens: torch.Tensor, cfg: LMConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), the MoE auxiliary loss summed
    over the layers, float32 zero for a dense model)."""
    x, aux = _trunk(params, tokens, cfg)
    return x @ params["head"], aux


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: LMConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(ce + 0.01 aux, {"ce", "aux"}) on ``batch`` {"tokens", "labels"}
    (``transformer.py:253-259``)."""
    logits, aux = forward(params, batch["tokens"], cfg)
    ce = layers.cross_entropy_loss(logits, batch["labels"])
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def prefill(params: Params, tokens: torch.Tensor, cfg: LMConfig
            ) -> torch.Tensor:
    """Prefill serve step: tokens (B, S) -> last-position logits
    (B, 1, V).  The head runs on the last position only: the same
    numbers as ``forward(...)[0][:, -1:]`` without the (B, S, V)
    logits."""
    return _trunk(params, tokens, cfg)[0][:, -1:] @ params["head"]


def cache_shapes(cfg: LMConfig, batch: int, max_len: int
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Every cache tensor's (shape, dtype): K and V, or for MLA the
    latent and the rope key, and the lengths."""
    n, dt = cfg.n_layers, cfg.torch_dtype
    if cfg.mla:
        tensors = {"c": (n, batch, max_len, cfg.kv_lora_rank),
                   "k_rope": (n, batch, max_len, cfg.qk_rope_dim)}
    else:
        shape = (n, batch, max_len, cfg.n_kv_heads, cfg.hd)
        tensors = {"k": shape, "v": shape}
    out = {k: (shape, dt) for k, shape in tensors.items()}
    out["length"] = ((batch,), torch.int32)
    return out


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device=None) -> Params:
    """An empty cache on ``device`` (CUDA unless the caller asks for the
    CPU)."""
    dev = ops.resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in cache_shapes(cfg, batch, max_len).items()}


def _cache_insert(cache_l: torch.Tensor, new: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Write one timestep at each row's position ``lengths``, in place.
    cache_l (B, T, ...), new (B, 1, ...), lengths (B,)."""
    rows = torch.arange(cache_l.shape[0], device=cache_l.device)
    cache_l[rows, lengths.long()] = new[:, 0]
    return cache_l


def _gqa_decode_layer(p, x: torch.Tensor, cache: Params, i: int,
                      lengths: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    positions = lengths[:, None]                           # (B, 1)
    k_c, v_c = cache["k"][i], cache["v"][i]
    q = layers.apply_rope(_project(x, p["wq"]), positions, cfg.rope_theta)
    k = layers.apply_rope(_project(x, p["wk"]), positions, cfg.rope_theta)
    _cache_insert(k_c, k, lengths)
    _cache_insert(v_c, _project(x, p["wv"]), lengths)
    o = layers.decode_attention(q, k_c, v_c, kv_valid=lengths + 1)
    return o.flatten(2) @ p["wo"].flatten(0, 1)


def _mla_decode_layer(p, x: torch.Tensor, cache: Params, i: int,
                      lengths: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Absorbed-matrix MLA decode (``transformer.py:309-337``): q_nope
    W_uk enters the latent space, the logits against the cached latent
    and rope key are float32, the weights are rounded to the cache's type
    before the weighted sum of the latent, and W_uv comes after it; K and
    V are never expanded.  Plain PyTorch, as the reference's is plain
    jnp."""
    positions = lengths[:, None]
    c_c, kr_c = cache["c"][i], cache["k_rope"][i]
    q_nope, q_rope = _mla_query(p, x, cfg, positions)
    c_new, kr_new = _mla_latent(p, x, cfg, positions)
    _cache_insert(c_c, c_new, lengths)
    _cache_insert(kr_c, kr_new[:, :, 0], lengths)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    logits = (torch.einsum("bshr,btr->bhst", q_lat.float(), c_c.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             kr_c.float())) * scale
    t = c_c.shape[1]
    mask = (torch.arange(t, device=c_c.device)[None, :]
            < (lengths + 1).to(c_c.device)[:, None])
    logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", probs.to(c_c.dtype), c_c)
    o = torch.einsum("bshr,rhk->bshk", o_lat, p["w_uv"])
    return o.flatten(2) @ p["wo"].flatten(0, 1)


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: LMConfig) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache).  The
    cache's tensors are updated in place; the returned cache carries
    ``length + 1``."""
    x = params["embed"][tokens].to(cfg.torch_dtype)
    lengths = cache["length"]
    attn = _mla_decode_layer if cfg.mla else _gqa_decode_layer
    for i in range(cfg.n_layers):
        p = _layer_params(params, i)
        h = x + attn(p, layers.rms_norm(x, p["ln_attn"]), cache, i, lengths,
                     cfg)
        x = h + _ffn(p, layers.rms_norm(h, p["ln_mlp"]), cfg)[0]
    logits = layers.rms_norm(x, params["ln_f"]) @ params["head"]
    return logits, dict(cache, length=lengths + 1)
