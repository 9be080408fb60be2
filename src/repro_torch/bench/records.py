"""Device records of a ``torch.profiler`` window, by kind.

The port's kernels are known by fragments of their device names
(:data:`PORT_KERNELS`) and by their launch counters
(:data:`PORT_COUNTERS`, ``kernels.ops.launch_counts()``), so a window's
records can be held against the launches it saw
(``bench.device_time.census_window``) and counted by kind
(``launch.hlo_analysis``' op census).
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

import torch

#: the port's kernels (``kernels._build.KERNELS`` grouped where two
#: counters share device functions, as both DTW entry points launch the
#: rows and the diagonals kernels, or one call launches three, as the
#: top-C select's passes) -> fragments of their device names
PORT_KERNELS = {
    "sketch_conv": ("sketch_conv_kernel",),
    "collision_count_batch": ("collision_count_batch_kernel",),
    "collision_count": ("collision_count_kernel",),
    "dtw": ("dtw_rows_kernel", "dtw_diag_kernel"),
    "cs_tables": ("cs_tables_kernel",),
    "flash_attention": ("flash_attention_tc_kernel",),
    "flash_attention_simt": ("flash_attention_simt_kernel",),
    "topc_select": ("topc_histogram_kernel", "topc_threshold_kernel",
                    "topc_scatter_kernel"),
}
#: launch counters of each group of :data:`PORT_KERNELS`
PORT_COUNTERS = {
    "sketch_conv": ("sketch_conv",),
    "collision_count_batch": ("collision_count_batch",),
    "collision_count": ("collision_count",),
    "dtw": ("dtw_wavefront", "dtw_wavefront_pairs"),
    "cs_tables": ("cs_tables",),
    "flash_attention": ("flash_attention",),
    "flash_attention_simt": ("flash_attention_simt",),
    "topc_select": ("topc_histogram", "topc_threshold", "topc_scatter"),
}
#: fragments of matrix-product kernel names (cuBLAS, CUTLASS)
_GEMM = ("gemm", "xmma", "cutlass", "matmul", "_mma", "cublas", "nvjet")


def device_events(events: Iterable) -> list:
    """The device-side records among profiler events (``key_averages()``
    or ``events()``): those on CUDA with device time."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def count(e) -> int:
    return int(getattr(e, "count", 1))


def kernel_kind(name: str) -> str:
    """The census kind of a device record's name: a group of
    :data:`PORT_KERNELS`, ``nccl``, ``gemm``, ``memcpy``, ``memset`` or
    ``other``."""
    for group, frags in PORT_KERNELS.items():
        if any(f in name for f in frags):
            return group
    if "nccl" in name.lower():
        return "nccl"
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    if any(f in name.lower() for f in _GEMM):
        return "gemm"
    return "other"


def op_census(events: Iterable, kinds: Sequence[str] = ()) -> Dict[str, int]:
    """Device records by :func:`kernel_kind` (only ``kinds`` where
    given), the profiler's op census of a window."""
    counts: Dict[str, int] = {}
    for e in device_events(events):
        kind = kernel_kind(e.key)
        if kinds and kind not in kinds:
            continue
        counts[kind] = counts.get(kind, 0) + count(e)
    return counts


def kernel_records(events: Iterable) -> Dict[str, int]:
    """Device records of each group of :data:`PORT_KERNELS` (0 where it
    has none)."""
    census = op_census(events, tuple(PORT_KERNELS))
    return {g: census.get(g, 0) for g in PORT_KERNELS}
