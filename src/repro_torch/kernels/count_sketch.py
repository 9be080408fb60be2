"""Wrapper of the CUDA kernel ``csrc/count_sketch.cu`` — the ``"ssh-cs"``
encoder's signed count-sketch tables on the H100.

It replaces the TPU kernel ``repro/kernels/count_sketch.py::cs_tables``.
The source's header says what bounds it and how its design answers that;
``kernels.ref.cs_tables_ref`` is its plain PyTorch version, equal to it
bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "count_sketch"    # the library


def cs_tables(bucket: torch.Tensor, sign: torch.Tensor, width: int
              ) -> torch.Tensor:
    """bucket (B, R, S) int32 (-1: no contribution) and sign (B, R, S)
    f32 on one CUDA device -> (B, R, width) f32 signed tables."""
    if not (bucket.is_cuda and sign.device == bucket.device):
        raise ValueError("cs_tables kernel needs bucket and sign on one "
                         f"CUDA device, got {bucket.device} and "
                         f"{sign.device}")
    if bucket.dtype != torch.int32 or sign.dtype != torch.float32:
        raise TypeError(f"cs_tables takes int32 buckets and float32 signs, "
                        f"got {bucket.dtype} and {sign.dtype}")
    if bucket.dim() != 3 or bucket.shape != sign.shape:
        raise ValueError(f"need bucket and sign of one (B, R, S) shape, got "
                         f"{tuple(bucket.shape)} and {tuple(sign.shape)}")
    if width < 4 or width % 4:
        raise ValueError(f"cs_tables kernel takes a width that is a positive "
                         f"multiple of 4, got {width}")
    b, r, s = bucket.shape
    out = torch.empty((b, r, width), dtype=torch.float32,
                      device=bucket.device)
    if b * r == 0:
        return out
    lib = _build.load(NAME)
    if width > lib.cs_tables_max_width():
        raise ValueError(f"cs_tables kernel takes width <= "
                         f"{lib.cs_tables_max_width()}, got {width}")
    bucket, sign = bucket.contiguous(), sign.contiguous()
    stream = torch.cuda.current_stream(bucket.device).cuda_stream
    rc = lib.cs_tables_launch(bucket.data_ptr(), sign.data_ptr(),
                              out.data_ptr(), b * r, s, width, stream)
    _build.check(NAME, lib, rc)
    _build.count("cs_tables")
    return out
