"""Wrapper of the CUDA kernel ``csrc/flash_attention.cu`` — the fused
attention forward of the LM prefill on the H100.

It replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.  The source's
header says what bounds it and how its design answers that;
``kernels.ref.flash_attention_ref`` is its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"      # the library
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_QUERY_TILES = 65535      # grid.y, 64 query rows a tile
#: float32 reordering allowance of :func:`error_bound`, times max |v|
REORDER = 2.0 ** -13


def error_bound(kernel_out: torch.Tensor, plain_out: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for outputs of one type.

    Both compute in float32 and round once to the output type, so they
    may differ by one unit in the last place of that type at the larger
    of the two values (none in float32), plus what float32 reordering
    moves: the logits' D-term dots and the rescaled running sums shift
    each softmax weight by about 1e-5 relative, which ``REORDER`` x
    max |v| (1.2e-4 x max |v|) covers with margin.
    """
    mag = torch.maximum(kernel_out.float().abs(), plain_out.float().abs())
    reorder = REORDER * float(v.float().abs().max())
    if plain_out.dtype != torch.bfloat16:
        return torch.full_like(mag, reorder)
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126))) - 7)
    return ulp + reorder


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, Hk, T, D) with H % Hk == 0, float32 or
    bfloat16, on one CUDA device -> (B, H, S, D) in q's type.

    Query head h reads KV head h // (H / Hk).  Under ``causal``, query i
    sees keys 0..i (positions absolute from 0).  ``scale`` defaults to
    D^-0.5.  Any strides with a contiguous last axis are taken as they
    are, so (B, S, H, D) tensors go in as ``transpose(1, 2)`` views; the
    output is laid out in memory as (B, S, H, D) and returned as its
    (B, H, S, D) view, so ``out.transpose(1, 2)`` is contiguous.
    """
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention kernel needs q, k and v on one "
                         f"CUDA device, got {q.device}, {k.device} and "
                         f"{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k "
                        f"and v of one type, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, H, S, D) and k, v (B, Hk, T, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hk < 1 or h % hk:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: need the same B and D and H "
                         f"a multiple of Hk")
    if t == 0:
        raise ValueError("flash_attention needs at least one key")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash_attention needs the head-dim axis of q, k "
                         "and v contiguous (stride 1)")
    if -(-s // 64) > _MAX_QUERY_TILES or b * h >= 2 ** 31:
        raise ValueError(f"flash_attention grid too large for B*H={b * h}, "
                         f"S={s}")
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if b * h * s == 0:
        return out
    lib = _build.load(NAME)
    if d > lib.flash_attention_max_head_dim():
        raise ValueError(f"flash_attention kernel takes D <= "
                         f"{lib.flash_attention_max_head_dim()}, got D={d}")
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, h, hk, s, t, d, *strides,
        float(d ** -0.5 if scale is None else scale), int(causal), stream)
    _build.check(NAME, lib, rc)
    _build.LAUNCHES["flash_attention"] += 1
    return out
