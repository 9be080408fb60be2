"""Device dispatch for the port's kernels (counterpart of
``repro.kernels.ops``).

The tensor's device picks the route: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor takes the plain version in
``kernels.ref``.  There is no fallback from one to the other.

The ``backend`` knob of ``SearchConfig`` keeps the reference's values so
configs read the same: ``"auto"`` and ``"pallas"`` both mean "the kernel
on CUDA, the plain version on the CPU"; ``"jnp"`` names the plain version
and is accepted only on the CPU (:func:`check_backend`).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import collision_count as _cc
from repro_torch.kernels import count_sketch as _cs
from repro_torch.kernels import dtw_wavefront as _dtw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels.sketch_conv import sketch_conv as _sketch_kernel

BACKENDS = ("auto", "pallas", "jnp")

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (the default) and absent.
    ``"meta"`` holds shapes and dtypes and no data (the abstract state of
    ``launch.steps``); no kernel or plain version runs there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch runs on cuda or cpu, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless device='cpu' is passed, and "
            "torch.cuda.is_available() is False here")
    return dev


def generator_for(generator: Optional[torch.Generator],
                  dev: torch.device) -> torch.Generator:
    """``generator`` if it lives on ``dev``'s type, else raise; None gives
    one on ``dev`` seeded with 0.  The meta device draws nothing, so any
    generator serves it (a CPU one by default)."""
    if dev.type == "meta":
        return generator if generator is not None else torch.Generator()
    if generator is None:
        return torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"parameters are drawn on {dev}")
    return generator


def check_backend(backend: str,
                  device: Optional[torch.device] = None) -> None:
    """Validate the ``backend`` knob, and for ``device`` when given."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "jnp" and device is not None and device.type != "cpu":
        raise ValueError("backend='jnp' names the plain versions, which "
                         "run only with device='cpu'")


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    with _build.COUNT_LOCK:
        return {name: _build.LAUNCHES[name] for name in _build.KERNELS}


def reset_launch_counts() -> None:
    with _build.COUNT_LOCK:
        _build.LAUNCHES.clear()


def device_scope(device: torch.device):
    """``device`` as the calling thread's current CUDA device, where the
    kernels launch (the current device is per thread); nothing to enter
    on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _route(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no route for tensors on {t.device}")


def sketch_conv(x: torch.Tensor, filters: torch.Tensor, step: int
                ) -> torch.Tensor:
    """Sliding-window projections (B, m) x (W, F) -> (B, N_B, F)."""
    if _route(x):
        return _sketch_kernel(x, filters, step)
    return ref.sketch_conv_ref(x, filters, step)


def sketch_bits(x: torch.Tensor, filters: torch.Tensor, step: int
                ) -> torch.Tensor:
    """Sign bits (projection >= 0) as uint8, (B, m) -> (B, N_B, F)."""
    return (sketch_conv(x, filters, step) >= 0).to(torch.uint8)


def sketch_bits_stream(stream: torch.Tensor, filters: torch.Tensor,
                       stride: int) -> torch.Tensor:
    """Sign bits of every stride-``stride`` filter projection of one long
    stream, (n,) x (W, F) -> (P, F) uint8 with P = (n - W) // stride + 1
    (``repro/kernels/ops.py:69-87``).  The projection at stream position
    p does not depend on which sliding window reads it, so a subsequence
    index (``repro_torch.subseq``) runs the sketch once over the stream
    at the gcd stride and gathers each window's taps from this grid."""
    return sketch_bits(stream[None, :], filters, stride)[0]


def collision_count_batch(query_keys: torch.Tensor, db_keys: torch.Tensor
                          ) -> torch.Tensor:
    """Batched signature agreement counts (B, K) x (N, K) -> (B, N)."""
    if _route(db_keys):
        return _cc.collision_count_batch(query_keys, db_keys)
    return ref.collision_count_batch_ref(query_keys, db_keys)


def collision_count(query_keys: torch.Tensor, db_keys: torch.Tensor
                    ) -> torch.Tensor:
    """One query's signature agreement counts (K,) x (N, K) -> (N,)."""
    if _route(db_keys):
        return _cc.collision_count(query_keys, db_keys)
    return ref.collision_count_ref(query_keys, db_keys)


def dtw_rerank(query: torch.Tensor, candidates: torch.Tensor,
               band: Optional[int], threshold=None) -> torch.Tensor:
    """One query against a candidate block (m,) x (C, m) -> (C,);
    ``band=None`` is radius m - 1.  ``threshold`` (scalar or (C,)): exact
    where <= threshold, else BIG."""
    if _route(candidates):
        m = candidates.shape[1]
        return _dtw.dtw_wavefront(query, candidates,
                                  m - 1 if band is None else band, threshold)
    return ref.dtw_wavefront_ref(query, candidates, band, threshold)


def dtw_rerank_pairs(queries: torch.Tensor, candidates: torch.Tensor,
                     band: Optional[int],
                     threshold: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Row-aligned pair DTW (P, m) x (P, m) -> (P,); ``band=None`` is
    radius m - 1.  ``threshold`` (P,): exact where <= threshold, else
    BIG."""
    if _route(queries):
        m = queries.shape[1]
        return _dtw.dtw_wavefront_pairs(queries, candidates,
                                        m - 1 if band is None else band,
                                        threshold)
    return ref.dtw_pairs_ref(queries, candidates, band, threshold)


def cs_tables(bucket: torch.Tensor, sign: torch.Tensor, width: int
              ) -> torch.Tensor:
    """Signed count-sketch tables (B, R, S) -> (B, R, width); bucket -1
    contributes nothing."""
    if _route(bucket):
        return _cs.cs_tables(bucket, sign, width)
    return ref.cs_tables_ref(bucket, sign, width)


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward is the flash kernel on a
    CUDA tensor and the plain version on the CPU; the backward is
    ``ref.flash_attention_bwd_ref``, plain PyTorch chunked over query
    rows, on either (the reference has no backward kernel: ``jax.grad``
    differentiates its chunked jnp attention).  It keeps q, k, v and the
    output for the backward, no (S, T) logits."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset=0, kv_valid=None):
        if _route(q):
            o = _fa.flash_attention(q, k, v, causal, scale, q_offset,
                                    kv_valid)
        else:
            o = ref.flash_attention_ref(q, k, v, causal, scale, q_offset,
                                        kv_valid)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.scale = causal, scale
        ctx.q_offset, ctx.kv_valid = q_offset, kv_valid
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, do, ctx.causal,
                                                 ctx.scale, ctx.q_offset,
                                                 ctx.kv_valid)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention q (B, H, S, D), k (B, Hk, T, D), v (B, Hk, T, Dv)
    -> (B, H, S, Dv); query head h reads KV head h // (H / Hk); query i of
    batch b sees keys j < min(T, kv_valid[b]) (every key without
    ``kv_valid``) and under ``causal`` only j <= i + ``q_offset``; a row
    that sees no key is 0.  Differentiable (:class:`FlashAttention`; no
    graph where no input requires grad)."""
    return FlashAttention.apply(q, k, v, causal, scale, q_offset, kv_valid)
