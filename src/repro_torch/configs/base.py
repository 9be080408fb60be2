"""``ArchDef`` — the contract between the LM configs, the step builders
and the train launcher (counterpart of ``repro.configs.base``).

Each LM config module exports ``ARCH = ArchDef(...)``.  ``input_specs``
returns a :class:`TensorSpec` for every model input of a shape cell
(shape and dtype, no allocation), and ``kind`` selects the step the cell
runs (train / prefill / decode).  The reference's specs are
``jax.ShapeDtypeStruct``; the port keeps its own record with a torch
dtype.  Only the ``lm`` family has spec builders here: the gnn and
recsys builders come with their models (ROADMAP.md §1 item 7.5), the ssh
ones with the benchmarks (item 4; the SSH arches are
``configs.registry.SSHArch``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch


class TensorSpec(NamedTuple):
    """A model input's shape and dtype (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    kind: str                      # train | prefill | decode
    meta: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str                    # lm (gnn, recsys: item 7.5)
    config: Any
    smoke_config: Any
    shapes: Dict[str, ShapeCell]

    def cell_config(self, shape: str) -> Any:
        """The config a cell runs (the reference's per-shape override
        serves its gnn cells only, item 7.5)."""
        return self.config

    def input_specs(self, shape: str) -> Tuple[str, Dict[str, Any]]:
        cell = self.shapes[shape]
        cfg = self.cell_config(shape)
        if self.family not in _SPEC_BUILDERS:
            raise NotImplementedError(
                f"no input specs for family {self.family!r} in the port "
                "(ROADMAP.md §1 item 7.5: recsys and gnn)")
        return cell.kind, _SPEC_BUILDERS[self.family](cfg, cell)


def lm_specs(cfg, cell: ShapeCell) -> Dict[str, Any]:
    m = cell.meta
    b, s = m["batch"], m["seq"]
    if cell.kind == "train":
        return {"tokens": TensorSpec((b, s), torch.int32),
                "labels": TensorSpec((b, s), torch.int32)}
    if cell.kind == "prefill":
        return {"tokens": TensorSpec((b, s), torch.int32)}
    if cell.kind == "decode":
        from repro_torch.models.transformer import cache_shapes
        cache = {k: TensorSpec(*v) for k, v in cache_shapes(cfg, b, s).items()}
        return {"tokens": TensorSpec((b, 1), torch.int32), "cache": cache}
    raise ValueError(cell.kind)


_SPEC_BUILDERS = {"lm": lm_specs}


# canonical LM shape set (assignment block)
def lm_shapes() -> Dict[str, ShapeCell]:
    return {
        "train_4k": ShapeCell("train", {"seq": 4096, "batch": 256}),
        "prefill_32k": ShapeCell("prefill", {"seq": 32768, "batch": 32}),
        "decode_32k": ShapeCell("decode", {"seq": 32768, "batch": 128}),
        "long_500k": ShapeCell("decode", {"seq": 524288, "batch": 1}),
    }
