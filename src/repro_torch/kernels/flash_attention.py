"""Wrapper of the CUDA kernels ``csrc/flash_attention.cu`` — the fused
attention forward of the LM prefill on the H100.

They replace the TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.  The library holds
two kernels, and :func:`takes_tensor_cores` is the written rule that
picks one (never a fallback on failure):

* the tensor-core kernel (``wgmma`` fed by TMA), for bf16 inputs whose
  Q/K head dim is a multiple of 8 up to 192 and V head dim one up to 128
  (instances at (64, 64), (128, 128) and (192, 128), the MLA prefill's),
  whose base pointers and (b, h, s) strides are 16-byte aligned and whose
  scale is positive; its launches count under ``flash_attention``;
* the CUDA-core kernel (float32 FMAs), for float32 inputs and every other
  bf16 input; its launches count under ``flash_attention_simt``.

The source's header says what bounds each and how its design answers
that; ``kernels.ref.flash_attention_ref`` is the plain PyTorch version of
both, and ``kernels.ref.flash_attention_tc_ref`` the tensor-core kernel's
arithmetic, rounding included (:func:`error_bound` says how each is
compared).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"      # the library, and the tensor-core kernel
SIMT = "flash_attention_simt"  # the CUDA-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_QUERY_TILES = 65535      # grid.y, 64 query rows a tile
#: the library's ``MAX_D`` and ``MAX_DV`` (``flash_attention_max_head_dim()``,
#: ``flash_attention_max_v_head_dim()``): the Q/K and the V head dim, kept
#: here so that a launch makes no second ctypes call
MAX_HEAD_DIM = 192
MAX_V_HEAD_DIM = 128
#: float32 reordering allowance of :func:`error_bound`, relative
REORDER = 2.0 ** -13
#: unit roundoff of bf16: the tensor-core kernel's P enters P.V in bf16
P_ROUND = 2.0 ** -8


def error_bound(kernel_out: torch.Tensor, plain_out: torch.Tensor,
                v: torch.Tensor, abs_out: Optional[torch.Tensor] = None,
                spread: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for outputs of one type.

    Both compute in float32 and round once to the output type, so they
    may differ by one unit in the last place of that type at the larger
    of the two values (none in float32), plus what float32 reordering
    moves.  The logits' D-term dots and the rescaled running sums shift
    each softmax weight w_j = p_j / l by about 1e-5 relative, which moves
    the output by at most twice that times sum_j w_j |v_j| (the weights
    sum to 1); ``REORDER`` (1.2e-4) covers it with margin.

    * The CUDA-core kernel (``abs_out`` None) is held to ``REORDER`` x
      max |v|, which bounds that sum for every element.
    * The tensor-core kernel is held per element, with ``abs_out`` =
      sum_j w_j |v_j| (:func:`ref.flash_attention_tc_ref` returns it).
      Its weights also enter P.V rounded to bf16, p_j (1 + d_j) with
      |d_j| <= u = ``P_ROUND``, while l is summed from the unrounded p:
      the output moves by sum_j w_j d_j v_j, at most u x abs_out.  So
      against the plain version, which keeps the weights in float32 (the
      reference rounds them as the kernel does), the bound is one ulp +
      (``REORDER`` + ``P_ROUND``) x abs_out.
    * Against :func:`ref.flash_attention_tc_ref`, which rounds the
      weights as the kernel does, the roundings agree except where a p
      lies so near a rounding boundary that the kernel's p, computed in
      another order, rounds to the next value; ``spread`` (returned with
      it) bounds what that moves and takes the place of the ``P_ROUND``
      term: one ulp + ``REORDER`` x abs_out + spread.  This is the tight
      check, which sees a kernel that is wrong on a few keys of a long
      row, where the output is a small average of many.
    """
    mag = torch.maximum(kernel_out.float().abs(), plain_out.float().abs())
    if abs_out is None:
        term = torch.full_like(mag, REORDER * float(v.float().abs().max()))
    elif spread is None:
        term = (REORDER + P_ROUND) * abs_out
    else:
        term = REORDER * abs_out + spread
    if plain_out.dtype != torch.bfloat16:
        return term
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126))) - 7)
    return ulp + term


def takes_tensor_cores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: Optional[float] = None) -> bool:
    """The routing rule: bf16 q, k and v whose Q/K head dim is a multiple
    of 8 and at most 192 and whose V head dim is a multiple of 8 and at
    most 128, whose base pointers are 16-byte aligned and whose (b, h, s)
    strides are positive multiples of 8 elements (16 bytes) wherever the
    axis has more than one entry (TMA needs all of that), and a positive
    scale (the kernel folds it into the exponent after the row max), take
    the tensor-core kernel; everything else takes the CUDA-core
    kernel."""
    d, dv = q.shape[-1], v.shape[-1]
    if (q.dtype != torch.bfloat16 or d % 8 or d > MAX_HEAD_DIM or dv % 8
            or dv > MAX_V_HEAD_DIM):
        return False
    if scale is not None and not scale > 0:
        return False
    for x in (q, k, v):
        if x.data_ptr() % 16:
            return False
        for size, stride in zip(x.shape[:3], x.stride()[:3]):
            if size > 1 and (stride <= 0 or stride % 8):
                return False
    return True


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention kernel needs q, k and v on one "
                         f"CUDA device, got {q.device}, {k.device} and "
                         f"{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k "
                        f"and v of one type, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or k.shape[:3] != v.shape[:3]):
        raise ValueError(f"need q (B, H, S, D), k (B, Hk, T, D) and v "
                         f"(B, Hk, T, Dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
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


def _key_bound(kv_valid: Optional[torch.Tensor], q: torch.Tensor):
    """``kv_valid`` as the kernels read it: a contiguous (B,) int32 array
    on q's device (a device copy, never a read on the host), or None."""
    if kv_valid is None:
        return None
    if kv_valid.shape != (q.shape[0],):
        raise ValueError(f"kv_valid must be (B,) = ({q.shape[0]},), got "
                         f"{tuple(kv_valid.shape)}")
    if kv_valid.device != q.device:
        raise ValueError(f"kv_valid must be on {q.device} with q, got "
                         f"{kv_valid.device}")
    if kv_valid.dtype.is_floating_point or kv_valid.dtype == torch.bool:
        raise TypeError(f"kv_valid must be integer, got {kv_valid.dtype}")
    return kv_valid.to(torch.int32).contiguous()


def _launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, scale: Optional[float], q_offset: int = 0,
            kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check(q, k, v)
    if not -2 ** 30 < int(q_offset) < 2 ** 30:
        raise ValueError(f"q_offset {q_offset} out of range")
    bound = _key_bound(kv_valid, q)
    b, h, s, d = q.shape
    hk, t, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, s, h, dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if b * h * s == 0:
        return out
    lib = _build.load(NAME)
    if d > MAX_HEAD_DIM or dv > MAX_V_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes D <= "
                         f"{MAX_HEAD_DIM} and Dv <= {MAX_V_HEAD_DIM}, got "
                         f"D={d}, Dv={dv}")
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (b, h, hk, s, t, d, dv, *strides,
            float(d ** -0.5 if scale is None else scale), int(causal),
            int(q_offset), None if bound is None else bound.data_ptr(),
            stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if kernel == NAME:
        rc = lib.flash_attention_tc_launch(*ptrs, *args)
    else:
        rc = lib.flash_attention_simt_launch(*ptrs, _DTYPES[q.dtype], *args)
    _build.check(NAME, lib, rc)
    _build.count(kernel)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, S, D), k (B, Hk, T, D), v (B, Hk, T, Dv) with H % Hk == 0,
    float32 or bfloat16, on one CUDA device -> (B, H, S, Dv) in q's type,
    through the kernel that :func:`takes_tensor_cores` picks.

    Query head h reads KV head h // (H / Hk).  Query i of batch b sees the
    keys j < min(T, kv_valid[b]) (every key when ``kv_valid``, an integer
    (B,) tensor on q's device, is None) and, under ``causal``, only j <= i
    + ``q_offset`` (0: positions absolute from 0, as in the TPU kernel;
    T - S: the queries aligned to the end of the keys).  A row that sees
    no key comes out 0.  ``scale`` defaults to D^-0.5.  Any strides with
    a contiguous last axis are taken as they are, so (B, S, H, D) tensors
    go in as ``transpose(1, 2)`` views; the
    output is laid out in memory as (B, S, H, Dv) and returned as its
    (B, H, S, Dv) view, so ``out.transpose(1, 2)`` is contiguous.
    """
    kernel = NAME if takes_tensor_cores(q, k, v, scale) else SIMT
    return _launch(kernel, q, k, v, causal, scale, q_offset, kv_valid)


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, scale: Optional[float] = None,
                         q_offset: int = 0,
                         kv_valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """:func:`flash_attention` through the CUDA-core kernel whatever the
    inputs: the yardstick of the tensor-core kernel on the same bf16
    inputs (tests and ``chip_smoke.py``; the model's path never calls
    it)."""
    return _launch(SIMT, q, k, v, causal, scale, q_offset, kv_valid)
