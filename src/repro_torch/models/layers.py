"""Shared layers of the LM (counterpart of ``repro.models.layers``).

The prefill's attention, :func:`chunked_attention`, goes through
``kernels.ops.flash_attention``: the hand-written CUDA kernels on a CUDA
tensor (bf16 on the tensor cores, float32 on the CUDA cores), the plain
version on the CPU.  The reference computes the same function chunk by
chunk in jnp; it rounds the softmax weights to the model dtype before
the product with V, as the tensor-core kernel does, where the plain
version and the float32 kernel keep them in float32, so the two agree
to float32 reordering in float32 and to bf16 rounding in bf16.  Its gradient, where the inputs require one,
is ``ops.FlashAttention``'s backward: plain PyTorch chunked over query
rows, the gradient ``jax.grad`` takes of the reference's chunked
computation.  :func:`decode_attention` (one query token against the
cache) and :func:`cross_entropy_loss` are plain PyTorch, as the
reference's are plain jnp.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """Normalise in float32, cast back to x's type, then scale by the
    weight in that type (the reference's cast order)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope_frequencies(head_dim: int, theta: float = 1e4,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding on split halves (not interleaved).
    x (B, S, H, D), positions (B, S) or (S,)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs               # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (..., d) @ (d, ff) pair -> (..., d)."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_chunk: int = 512,
                      kv_chunk: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Attention with GQA through the flash kernel.

    q (B, S, H, D); k (B, T, Hk, D); v (B, T, Hk, Dv); H % Hk == 0 ->
    (B, S, H, Dv) in v's type (MLA attends at D = 192, Dv = 128);
    ``scale`` defaults to D^-0.5.  ``q_chunk`` and ``kv_chunk`` are the
    reference's tiling knobs; the kernels tile by their own block sizes
    whatever they say, which changes the sums' order and nothing else.
    The reference's ``kv_valid`` (no caller in either package) is not
    ported; causal attention needs S == T (the reference's S < T
    alignment has no caller either).
    """
    s, t = q.shape[1], k.shape[1]
    if causal and s != t:
        raise NotImplementedError(
            f"causal chunked_attention with S={s} != T={t} is not ported "
            "(no caller; ROADMAP.md §1, model suite)")
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, scale=scale)
    return o.transpose(1, 2).to(v.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_valid: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One decode step over the KV cache.

    q (B, 1, H, D); k (B, T, Hk, D); v (B, T, Hk, Dv); kv_valid (B,):
    keys at positions >= kv_valid[b] are masked.  The logits are float32
    (the reference's ``preferred_element_type``), the weights are rounded
    to v's type before the product with V, as in the reference.
    """
    b, _, h, d = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    qr = q.reshape(b, hk, h // hk, d)
    logits = torch.einsum("bhgd,bkhd->bhgk", qr.float(), k.float()) * scale
    mask = (torch.arange(t, device=k.device)[None, :]
            < kv_valid.to(k.device)[:, None])                     # (B, T)
    logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.to(v.dtype), v)
    return out.reshape(b, 1, h, dv).to(v.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy, logits (..., V) upcast to float32:
    logsumexp - the gold logit, averaged over the tokens (over the masked
    ones, at least 1, when ``mask`` is given)."""
    logits = logits.float()
    nll = (torch.logsumexp(logits, dim=-1)
           - logits.gather(-1, labels.long()[..., None])[..., 0])
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
