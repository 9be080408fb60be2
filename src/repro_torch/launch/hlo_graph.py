"""Executed matrix FLOPs and collectives of a window of calls
(counterpart of ``repro.launch.hlo_graph``).

The reference parses XLA's HLO text into its computation graph and
multiplies loop bodies by their trip counts, because ``cost_analysis()``
counts a ``while`` body once.  PyTorch runs eagerly, so there is no
graph to parse and no loop to multiply: every executed operation is a
record of ``torch.profiler``.  :func:`executed_costs` sums the FLOPs
the profiler attributes to matrix products (``with_flops=True``:
``aten::mm``, ``addmm``, ``bmm``, ``baddbmm``, the convolutions), 2 x
the result's elements x the contracted extent, as the reference counts
a ``dot``; elementwise FLOPs are left out, as the reference leaves
them.  The port's own kernels (the flash attention among them) report
no FLOPs to the profiler, so their work is counted analytically
(``launch.analytic``).  Collectives are NCCL kernels
(``hlo_analysis.collective_stats``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

from repro_torch.launch.hlo_analysis import COLLECTIVES, collective_stats

#: the operations whose profiler FLOPs are matrix products
MATRIX_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
              "aten::conv1d", "aten::conv2d", "aten::conv3d",
              "aten::convolution", "aten::_convolution")


@dataclasses.dataclass
class Cost:
    dot_flops: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    coll_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


def executed_costs(events: Iterable) -> Cost:
    """Matrix FLOPs and collectives of a profiled window: ``events`` are
    ``prof.key_averages()`` (or ``prof.events()``) of a
    ``torch.profiler.profile(..., with_flops=True)``."""
    events = list(events)
    c = Cost()
    c.dot_flops = float(sum(getattr(e, "flops", 0) or 0 for e in events
                            if e.key in MATRIX_OPS))
    for kind, st in collective_stats(events).items():
        c.coll_counts[kind] = float(st["count"])
        c.coll_bytes[kind] = float(st["bytes"])
    return c
