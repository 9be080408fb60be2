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

The reference's HLO text parser (:func:`parse_hlo`, :class:`Op`,
:class:`Computation`) is kept as it is, pure Python over text, for
reading HLO that another tool wrote; nothing in the port lowers to HLO.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Tuple

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

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        """Add ``mult`` times ``other`` in place (a window's costs summed
        over windows, or scaled by a repeat count)."""
        self.dot_flops += other.dot_flops * mult
        for k in COLLECTIVES:
            self.coll_bytes[k] += other.coll_bytes[k] * mult
            self.coll_counts[k] += other.coll_counts[k] * mult

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


# -- the reference's HLO text parser (``repro/launch/hlo_graph.py:35-115``)

# the patterns as strings (``re`` caches what it builds of them); params
# may be tuple-typed (nested parens): match only the name
_HEADER_RE = r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\("
_OP_RE = (r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*((?:\([^)]*\))|(?:[a-z0-9]+"
          r"\[[0-9,]*\](?:\{[^}]*\})?))\s+([a-z0-9\-]+)\(")
_OPERANDS_RE = r"\(([^)]*)\)"


@dataclasses.dataclass
class Op:
    name: str
    opcode: str
    result_shape: str
    operands: List[str]
    attrs: str


@dataclasses.dataclass
class Computation:
    name: str
    ops: Dict[str, Op]
    order: List[str]


def parse_hlo(text: str) -> Tuple[Dict[str, Computation], Optional[str]]:
    """HLO text -> (computations by name, the entry computation's name)."""
    comps: Dict[str, Computation] = {}
    entry: Optional[str] = None
    cur: Optional[Computation] = None
    for line in text.splitlines():
        stripped = line.strip()
        if cur is None:
            if stripped.endswith("{") and "->" in stripped:
                m = re.match(_HEADER_RE, stripped)
                if m:
                    cur = Computation(m.group(1), {}, [])
                    if stripped.startswith("ENTRY"):
                        entry = cur.name
            continue
        if stripped.startswith("}"):        # may carry a trailing comment
            comps[cur.name] = cur
            cur = None
            continue
        m = re.match(_OP_RE, line)
        if not m:
            continue
        name, shape, opcode = m.group(1), m.group(2), m.group(3)
        rest = line[m.end() - 1:]
        ops_m = re.match(_OPERANDS_RE, rest)
        operands = []
        if ops_m:
            inner = ops_m.group(1)
            # operands may carry a type prefix ("f32[2,3]{1,0} %x") whose
            # shape commas break a naive split: take the %names
            operands = re.findall(r"%([\w.\-]+)", inner)
            if not operands:
                operands = [t.strip() for t in inner.split(",") if t.strip()]
        # attrs keeps the whole rest, operand text included: constants
        # such as `constant(40)` live inside the "operand" parens
        cur.ops[name] = Op(name, opcode, shape, operands, rest)
        cur.order.append(name)
    return comps, entry
