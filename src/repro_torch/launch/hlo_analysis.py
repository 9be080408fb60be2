"""Byte counts, a profiler op census, collective counts and roofline
terms (counterpart of ``repro.launch.hlo_analysis``).

The reference parses XLA's partitioned HLO text: its collectives' result
shapes, an op census of fusions and dots.  The port has no HLO: PyTorch
runs eagerly and the kernels are its own.  What it measures instead
comes from ``torch.profiler``'s records of a window of calls:

* :func:`op_census`: device records by kind (the port's own kernels by
  name, matrix products, NCCL collectives, copies and fills, the rest);
* :func:`kernel_records`: the device records of each of the port's
  kernels, which ``bench.device_time`` holds against the launch counters
  of the same window (both from ``bench.records``, which the
  measurement clock shares);
* :func:`collective_stats`: NCCL kernels by collective kind (none on one
  card); the profiler records no payload, so ``bytes`` stays 0.

:func:`shape_bytes` and :func:`roofline_terms` are the reference's, the
latter with the H100's peaks in the place of the TPU v5e's: 989 TFLOP/s
of dense bf16 on the tensor cores, 3.35 TB/s of HBM, and 450 GB/s a
direction of NVLink (the constants ``chip_smoke.py`` bounds its kernels
with).
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Union

import torch

from repro_torch.bench.records import (PORT_COUNTERS, PORT_KERNELS,  # noqa: F401
                                       count, device_events, kernel_kind,
                                       kernel_records, op_census)

#: bytes an element, by the reference's HLO dtype names
_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: NCCL kernel name fragments (``ncclDevKernel_AllGather_RING_LL`` ...)
_NCCL_KINDS = (("AllGather", "all-gather"), ("AllReduce", "all-reduce"),
               ("ReduceScatter", "reduce-scatter"), ("AllToAll", "all-to-all"),
               ("SendRecv", "collective-permute"),
               ("Broadcast", "collective-permute"))


def shape_bytes(dtype: Union[str, torch.dtype],
                dims: Union[str, Sequence[int]]) -> int:
    """Bytes of a tensor: ``dtype`` an HLO name ("bf16") or a torch dtype,
    ``dims`` "16,512,128" (HLO text) or a sequence of ints.  An unknown
    HLO name counts 4 bytes an element, as the reference counts it."""
    n = 1
    if isinstance(dims, str):
        dims = [int(d) for d in dims.split(",")] if dims else []
    for d in dims:
        n *= int(d)
    if isinstance(dtype, torch.dtype):
        return n * dtype.itemsize
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_stats(events: Iterable) -> Dict[str, Dict]:
    """Per-collective-kind {count, bytes} of the NCCL kernels among the
    device records; the profiler records no payload (``bytes`` 0)."""
    out: Dict[str, Dict] = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for e in device_events(events):
        if "nccl" not in e.key.lower():
            continue
        for frag, kind in _NCCL_KINDS:
            if frag in e.key:
                out[kind]["count"] += count(e)
                break
    return out


# --------------------------------------------------------------------------
# roofline terms (NVIDIA H100 SXM, per card)
# --------------------------------------------------------------------------

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12              # B/s
ICI_BW = 450e9                # B/s a direction of NVLink 4 (the link term)
#: one card's memory, bytes (80 GB)
HBM_BYTES = 80e9


def roofline_terms(total_flops: float, total_bytes: float,
                   collective_bytes: float, n_chips: int) -> Dict[str, float]:
    """The three roofline times (seconds) of one step over the whole
    mesh: FLOPs and bytes are whole-program, collective bytes per
    device."""
    compute_t = total_flops / (n_chips * PEAK_FLOPS_BF16)
    memory_t = total_bytes / (n_chips * HBM_BW)
    collective_t = collective_bytes / ICI_BW
    dominant = max(("compute", compute_t), ("memory", memory_t),
                   ("collective", collective_t), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_t, "memory_s": memory_t,
            "collective_s": collective_t, "dominant": dominant}
