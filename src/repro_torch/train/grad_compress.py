"""Gradient compression for a data-parallel all-reduce (counterpart of
``repro.train.grad_compress``).

Two schemes, both with *error feedback* (residual accumulation) so the
compression bias vanishes over steps (Karimireddy et al., 2019):

  * top-k sparsification — keep the k largest-|g| entries per tensor;
  * int8 stochastic quantisation — per-tensor scale, stochastic rounding
    with uniform noise in [-0.5, 0.5) drawn from a ``torch.Generator``
    the caller passes (``jax.random`` cannot be reproduced, so
    :func:`int8_quantize_noise` takes the noise itself).

Trees are nested dicts of tensors, leaves in sorted key order.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.train.optimizer import tree_leaves, tree_map

Tree = Any


def topk_compress(g: torch.Tensor, frac: float) -> torch.Tensor:
    """Zero out all but the largest-|g| ``frac`` of entries (every entry
    tied with the k-th largest |g| is kept)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(g.abs() >= thresh, g, torch.zeros_like(g))


def int8_quantize_noise(g: torch.Tensor, noise: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale): q = clip(round(g / scale + noise), -127, 127)
    with scale = max(max |g|, 1e-12) / 127, rounding half to even."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale + noise), -127, 127)
    return q.to(torch.int8), scale


def int8_quantize(g: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`int8_quantize_noise` with uniform noise in [-0.5, 0.5) from
    ``generator`` (on ``g``'s device)."""
    noise = torch.rand(g.shape, generator=generator, dtype=g.dtype,
                       device=g.device) - 0.5
    return int8_quantize_noise(g, noise)


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads: Tree, residual: Tree, *, scheme: str,
                           topk_frac: float = 0.01,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[Tree, Tree]:
    """Returns (compressed grads to all-reduce, new residual); ``int8``
    draws each leaf's noise from ``generator`` in leaf order."""
    corrected = tree_map(lambda g, r: g.float() + r, grads, residual)
    if scheme == "topk":
        sent = tree_map(lambda g: topk_compress(g, topk_frac), corrected)
    elif scheme == "int8":
        if generator is None:
            raise ValueError("scheme 'int8' needs a torch.Generator")
        quantized = iter([int8_dequantize(*int8_quantize(g, generator))
                          for g in tree_leaves(corrected)])
        sent = tree_map(lambda _: next(quantized), corrected)
    elif scheme == "none":
        sent = corrected
    else:
        raise ValueError(scheme)
    new_residual = tree_map(lambda c, s: c - s, corrected, sent)
    return sent, new_residual


def init_residual(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
