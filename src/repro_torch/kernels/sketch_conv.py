"""Wrapper of the CUDA kernel ``csrc/sketch_conv.cu`` — the sketch stage's
strided sliding-window projections on the H100.

It replaces the TPU kernel ``repro/kernels/sketch_conv.py::sketch_conv``.
The source's header says what bounds it and how its design answers that;
``kernels.ref.sketch_conv_ref`` is its plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "sketch_conv"


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
    x, filters = x.contiguous(), filters.contiguous()
    lib = _build.load(NAME)
    if lib.sketch_conv_smem_bytes(w, f, step) > 227 * 1024:
        raise ValueError(f"sketch_conv: W={w}, F={f}, step={step} needs "
                         "more shared memory than a block has")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.sketch_conv_launch(x.data_ptr(), filters.data_ptr(),
                                out.data_ptr(), b, m, w, f, step, n_b, stream)
    _build.check(NAME, lib, rc)
    _build.LAUNCHES["sketch_conv"] += 1
    return out
