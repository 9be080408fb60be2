"""Decoder-only transformer for serving: prefill and KV-cache decode
(counterpart of ``repro.models.transformer``).

The dense SwiGLU + GQA family (granite-3-2b, granite-3-8b, phi3-mini).
Parameters are a plain dict with the reference's names and layouts and
the layers stacked on a leading L axis: ``wq`` (L, d, H, hd), ``wk``/``wv``
(L, d, Hk, hd), ``wo`` (L, H, hd, d), ``w_gate``/``w_up`` (L, d, ff),
``w_down`` (L, ff, d), norms (L, d); ``embed`` (V, d), ``head`` (d, V),
``ln_f`` (d,).  The layers run in a Python loop (PyTorch runs eagerly;
the reference's ``lax.scan`` and remat have no counterpart in
inference), and the reference's sharding constraints are dropped: this
runs on one card.  MoE and MLA configurations raise.

The KV cache is ``{"k", "v": (L, B, T, Hk, hd), "length": (B,) int32}``.
:func:`decode_step` writes the new key and value into the cache's
tensors in place (the reference returns updated copies) and returns the
cache with ``length + 1``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers

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

    def param_count(self) -> int:
        return sum(math.prod(shape) for shape in param_shapes(self).values())


def _check_supported(cfg: LMConfig) -> None:
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP.md §1, "
            "model suite: MoE for dbrx)")
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP.md §1, "
            "model suite: MLA for deepseek-v2-lite)")


def param_shapes(cfg: LMConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape by its path ("embed", "layers/wq", ...)."""
    _check_supported(cfg)
    n, d, hd, ff = cfg.n_layers, cfg.d_model, cfg.hd, cfg.d_ff
    h, hk = cfg.n_heads, cfg.n_kv_heads
    return {
        "embed": (cfg.vocab, d), "head": (d, cfg.vocab), "ln_f": (d,),
        "layers/ln_attn": (n, d), "layers/ln_mlp": (n, d),
        "layers/wq": (n, d, h, hd), "layers/wk": (n, d, hk, hd),
        "layers/wv": (n, d, hk, hd), "layers/wo": (n, h, hd, d),
        "layers/w_gate": (n, d, ff), "layers/w_up": (n, d, ff),
        "layers/w_down": (n, ff, d),
    }


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


def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Random weights with the reference's distributions
    (``transformer.py:97-151``): normal * 0.02, normal * 0.02 / sqrt(2L)
    for ``wo`` and ``w_down``, ones for the norms, in ``cfg.dtype``.

    Drawn on ``device`` (CUDA unless the caller asks for the CPU) from
    ``generator``, which must live there (default: seeded with 0).  The
    numbers are not the reference's: ``jax.random`` cannot be reproduced.
    """
    dev = ops.resolve_device(device)
    shapes = param_shapes(cfg)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"parameters are drawn on {dev}")
    dt = cfg.torch_dtype
    so = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)
    flat = {}
    for path, shape in shapes.items():
        if path in ("ln_f", "layers/ln_attn", "layers/ln_mlp"):
            flat[path] = torch.ones(shape, dtype=dt, device=dev)
            continue
        scale = so if path in ("layers/wo", "layers/w_down") else 0.02
        flat[path] = torch.randn(shape, generator=generator, device=dev,
                                 dtype=torch.float32).mul_(scale).to(dt)
    return unflatten(flat)


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


def _ffn(p, x: torch.Tensor) -> torch.Tensor:
    return layers.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _layer(p, x: torch.Tensor, cfg: LMConfig,
           positions: torch.Tensor) -> torch.Tensor:
    h = x + _gqa_attention(p, layers.rms_norm(x, p["ln_attn"]), cfg,
                           positions)
    return h + _ffn(p, layers.rms_norm(h, p["ln_mlp"]))


def _trunk(params: Params, tokens: torch.Tensor, cfg: LMConfig
           ) -> torch.Tensor:
    """tokens (B, S) -> final-normed hidden states (B, S, d)."""
    _check_supported(cfg)
    x = params["embed"][tokens].to(cfg.torch_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(cfg.n_layers):
        x = _layer(_layer_params(params, i), x, cfg, positions)
    return layers.rms_norm(x, params["ln_f"])


def forward(params: Params, tokens: torch.Tensor, cfg: LMConfig
            ) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V).  (The reference also returns
    the MoE auxiliary loss, zero for a dense model.)"""
    return _trunk(params, tokens, cfg) @ params["head"]


def prefill(params: Params, tokens: torch.Tensor, cfg: LMConfig
            ) -> torch.Tensor:
    """Prefill serve step: tokens (B, S) -> last-position logits
    (B, 1, V).  The head runs on the last position only: the same
    numbers as ``forward(...)[:, -1:]`` without the (B, S, V) logits."""
    return _trunk(params, tokens, cfg)[:, -1:] @ params["head"]


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device=None) -> Params:
    """An empty KV cache on ``device`` (CUDA unless the caller asks for
    the CPU)."""
    _check_supported(cfg)
    dev = ops.resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def _cache_insert(cache_l: torch.Tensor, new: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Write one timestep at each row's position ``lengths``, in place.
    cache_l (B, T, ...), new (B, 1, ...), lengths (B,)."""
    rows = torch.arange(cache_l.shape[0], device=cache_l.device)
    cache_l[rows, lengths.long()] = new[:, 0]
    return cache_l


def _gqa_decode_layer(p, x: torch.Tensor, k_c: torch.Tensor,
                      v_c: torch.Tensor, lengths: torch.Tensor,
                      cfg: LMConfig) -> torch.Tensor:
    positions = lengths[:, None]                           # (B, 1)
    q = layers.apply_rope(_project(x, p["wq"]), positions, cfg.rope_theta)
    k = layers.apply_rope(_project(x, p["wk"]), positions, cfg.rope_theta)
    _cache_insert(k_c, k, lengths)
    _cache_insert(v_c, _project(x, p["wv"]), lengths)
    o = layers.decode_attention(q, k_c, v_c, kv_valid=lengths + 1)
    return o.flatten(2) @ p["wo"].flatten(0, 1)


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: LMConfig) -> Tuple[torch.Tensor, Params]:
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache).  The
    cache's k and v are updated in place; the returned cache carries
    ``length + 1``."""
    _check_supported(cfg)
    x = params["embed"][tokens].to(cfg.torch_dtype)
    lengths = cache["length"]
    for i in range(cfg.n_layers):
        p = _layer_params(params, i)
        h = x + _gqa_decode_layer(p, layers.rms_norm(x, p["ln_attn"]),
                                  cache["k"][i], cache["v"][i], lengths, cfg)
        x = h + _ffn(p, layers.rms_norm(h, p["ln_mlp"]))
    logits = layers.rms_norm(x, params["ln_f"]) @ params["head"]
    return logits, {"k": cache["k"], "v": cache["v"], "length": lengths + 1}
