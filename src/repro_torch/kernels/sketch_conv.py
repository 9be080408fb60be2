"""Wrapper of the CUDA kernel ``csrc/sketch_conv.cu`` — the sketch stage's
strided sliding-window projections on the H100.

It replaces the TPU kernel ``repro/kernels/sketch_conv.py::sketch_conv``.
The source's header says what bounds it and how its design answers that;
``kernels.ref.sketch_conv_ref`` is its plain PyTorch version and
``kernels.ref.sketch_conv_fma_ref`` the exact emulation of its
arithmetic (one fused multiply-add chain an output, taps in order).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "sketch_conv"
#: window positions a lane owns, and a warp (the kernel's P and TILE)
P = 5
TILE = 32 * P
SMEM_LIMIT = 227 * 1024


def seg_floats(w: int, step: int) -> int:
    """Floats of one warp's segment of a row in shared memory: the span
    of its TILE windows, 3 more for a 16-byte-aligned start, rounded up
    to a multiple of 4 (``seg_floats`` of the source)."""
    return ((TILE - 1) * step + w + 6) // 4 * 4


def smem_bytes(w: int, f: int, step: int, warps: int = 1) -> int:
    """Shared memory of a block of ``warps`` warps: the filter bank and a
    segment a warp; a one-warp block is the least a launch needs."""
    return 4 * ((w * f + 3) // 4 * 4 + warps * seg_floats(w, step))


def sketch_conv(x: torch.Tensor, filters: torch.Tensor, step: int
                ) -> torch.Tensor:
    """x (B, m) f32, filters (W, F) f32 on one CUDA device -> (B, N_B, F)
    f32 with N_B = (m - W) // step + 1."""
    if not (x.is_cuda and filters.device == x.device):
        raise ValueError("sketch_conv kernel needs x and filters on one "
                         f"CUDA device, got {x.device} and {filters.device}")
    if x.dtype != torch.float32 or filters.dtype != torch.float32:
        raise TypeError(f"sketch_conv takes float32, got {x.dtype} and "
                        f"{filters.dtype}")
    if x.dim() != 2 or filters.dim() != 2:
        raise ValueError(f"x must be (B, m) and filters (W, F), got "
                         f"{tuple(x.shape)} and {tuple(filters.shape)}")
    b, m = x.shape
    w, f = filters.shape
    if step < 1 or m < w:
        raise ValueError(f"need step >= 1 and m >= W, got step={step}, "
                         f"m={m}, W={w}")
    n_b = (m - w) // step + 1
    out = torch.empty((b, n_b, f), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    if smem_bytes(w, f, step) > SMEM_LIMIT:
        raise ValueError(f"sketch_conv: W={w}, F={f}, step={step} needs "
                         "more shared memory than a block has")
    x, filters = x.contiguous(), filters.contiguous()
    lib = _build.load(NAME)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.sketch_conv_launch(x.data_ptr(), filters.data_ptr(),
                                out.data_ptr(), b, m, w, f, step, n_b, stream)
    _build.check(NAME, lib, rc)
    _build.count("sketch_conv")
    return out
