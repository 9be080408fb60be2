"""Dry run of every (arch x shape x mesh) cell: the state's bytes per
device under the sharding rules, and its MODEL_FLOPS (counterpart of
``repro.launch.dryrun``).

The reference lowers and compiles each cell with XLA over 512 fake host
devices and reads ``memory_analysis()``, ``cost_analysis()`` and the
partitioned HLO's collectives.  PyTorch has no such compiler: the port
runs eagerly on one card.  So this dry run compiles nothing.  For each
cell it builds the step's whole argument tuple on the meta device
(``launch.steps.abstract_state``: shapes and dtypes, no memory), shards
it by the reference's rules (``distributed.sharding``, with this
module's :func:`cache_sharding` and :func:`opt_sharding`), and reports
per device the argument bytes, the optimizer's share of them and the
cell's analytic MODEL_FLOPS (``launch.analytic``), in the reference's
key names where a key has a counterpart.  What a compile would add
(temporaries, executed FLOPs, collective payloads) is measured on the
card by ``torch.profiler`` (``launch.hlo_analysis``,
``launch.hlo_graph``), not reckoned here.

Meshes: ``single`` and ``multi`` are the reference's TPU pod layouts,
(16, 16) and (2, 16, 16) (``launch.mesh.make_production_mesh``), kept so
the per-device bytes can be held against the reference's reports;
``local`` is the CUDA devices present, or one card where there is none
(on the CPU), and its report says whether the cell's arguments fit one
card's memory (``fits_device``): which cells one H100 holds.

Usage (CPU only, no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh local
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
      --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.distributed.sharding import (batch_sharding,
                                              param_sharding, shard_factor,
                                              tree_map_with_path)
from repro_torch.launch import analytic, hlo_analysis, steps
from repro_torch.launch.mesh import (MeshSpec, dp_axes, make_local_mesh,
                                     make_production_mesh)
from repro_torch.train.optimizer import AdamWState, tree_leaves

REPORT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESHES = ("single", "multi", "local")


def _dp(mesh: MeshSpec):
    axes = dp_axes(mesh)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _dp_size(mesh: MeshSpec) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def cache_sharding(cache_spec, mesh: MeshSpec, batch: int):
    """LM decode cache: batch over dp when divisible, else seq over dp;
    the trailing latent or head dim over 'model' when divisible."""
    dp = _dp(mesh)
    dps = _dp_size(mesh)
    mp = mesh.shape.get("model", 1)

    def leaf(path, s):
        if path and path[-1] == "length":
            return ()
        dims = [None] * len(s.shape)          # (L, B, T, ...) layouts
        if batch % dps == 0 and batch >= dps:
            dims[1] = dp
        elif s.shape[2] % dps == 0:
            dims[2] = dp
        if s.shape[-1] % mp == 0:
            dims[-1] = "model"
        return tuple(dims)

    return tree_map_with_path(leaf, cache_spec)


def opt_sharding(opt_spec: AdamWState, params_sh) -> AdamWState:
    """AdamW's moments and master weights follow the parameters'
    sharding; the step is replicated."""
    return AdamWState(step=(), m=params_sh, v=params_sh, master=params_sh)


def _bytes(spec) -> int:
    return hlo_analysis.shape_bytes(spec.dtype, spec.shape)


def _param_bytes(params_spec) -> float:
    return float(sum(_bytes(l) for l in tree_leaves(params_spec)))


def shardings_for(arch, shape: str, kind: str, state, mesh: MeshSpec):
    """Spec trees of the step's arguments (the reference's
    ``in_shardings``): inference replicates the weights over the data
    axes when they fit (8 GB a device after model-axis sharding), the
    families without tensor parallelism spread their batch over every
    axis, and the ssh query keeps the query replicated."""
    mp = mesh.shape.get("model", 1)
    drop_fsdp = (kind != "train"
                 and _param_bytes(state[0]) / mp <= 8e9)
    params_sh = param_sharding(state[0], mesh, arch.family,
                               drop_fsdp=drop_fsdp)
    batch_logical = "batch" if arch.family == "lm" else "batch_all"
    if kind == "train":
        opt_sh = opt_sharding(state[1], params_sh)
        overrides = {"^query$": ()} if arch.family == "ssh" else {}
        batch_sh = batch_sharding(state[2], mesh, overrides,
                                  batch_logical=batch_logical)
        return params_sh, opt_sh, batch_sh
    if kind == "decode":
        b = arch.shapes[shape].meta["batch"]
        return (params_sh, cache_sharding(state[1], mesh, b),
                batch_sharding(state[2], mesh))
    overrides = {"query": ()} if arch.family == "ssh" else {}
    return params_sh, batch_sharding(state[1], mesh, overrides,
                                     batch_logical=batch_logical)


def per_device_bytes(tree, specs, mesh: MeshSpec) -> int:
    """Bytes a device holds of ``tree`` (``TensorSpec`` leaves) under the
    spec tree ``specs`` (tuple leaves): each leaf's bytes over its shard
    factor, rounded up."""
    leaves = tree_leaves(_as_lists(tree))
    sh = tree_leaves(_as_lists(specs))
    if len(leaves) != len(sh):
        raise ValueError(f"{len(leaves)} leaves against {len(sh)} specs")
    return int(sum(-(-_bytes(l) // shard_factor(s, mesh))
                   for l, s in zip(leaves, sh)))


def _as_lists(tree):
    """``tree`` with its ``AdamWState`` NamedTuples as lists, so that
    ``tree_leaves`` walks into them (it walks dicts and lists; a
    ``TensorSpec`` or a spec tuple stays a leaf)."""
    if isinstance(tree, dict):
        return {k: _as_lists(v) for k, v in tree.items()}
    if isinstance(tree, (list, AdamWState)):
        return [_as_lists(v) for v in tree]
    return tree


def local_mesh() -> MeshSpec:
    """The ``local`` mesh: the CUDA devices present, or one described
    card where there is none."""
    if torch.cuda.device_count() > 0:
        return make_local_mesh()
    return MeshSpec(("data", "model"), (1, 1))


def device_memory_bytes() -> float:
    """One card's memory: the first CUDA device's, else the H100's 80 GB
    (``hlo_analysis.HBM_BYTES``)."""
    if torch.cuda.device_count() > 0:
        return float(torch.cuda.get_device_properties(0).total_memory)
    return hlo_analysis.HBM_BYTES


def mesh_for(name: str) -> MeshSpec:
    if name == "local":
        return local_mesh()
    return make_production_mesh(multi_pod=name == "multi")


def run_cell(arch_name: str, shape: str, mesh_name: str,
             report_dir: Optional[Path] = REPORT_DIR, verbose: bool = True
             ) -> Dict[str, Any]:
    """One cell's report (written to ``report_dir`` unless None)."""
    arch = get_arch(arch_name)
    t0 = time.time()
    mesh = mesh_for(mesh_name)
    kind, state = steps.abstract_state(arch, shape)
    shardings = shardings_for(arch, shape, kind, state, mesh)
    per_arg = [per_device_bytes(a, s, mesh)
               for a, s in zip(state, shardings)]
    argument_bytes = int(sum(per_arg))
    optimizer_bytes = per_arg[1] if kind == "train" else 0
    n_chips = mesh.size
    mf = analytic.model_flops(arch, shape)
    total_args = sum(_bytes(l) for a in state
                     for l in tree_leaves(_as_lists(a)))
    terms = hlo_analysis.roofline_terms(mf, total_args, 0.0, n_chips)
    hbm = device_memory_bytes()
    report = {
        "arch": arch_name, "shape": shape, "mesh": mesh_name,
        "kind": kind, "n_chips": n_chips,
        "mesh_axes": mesh.shape,
        "compile_seconds": round(time.time() - t0, 1),
        "model_flops": mf,
        "model_flops_per_device": mf / n_chips,
        "memory": {
            "argument_bytes": argument_bytes,
            "parameter_bytes": per_arg[0],
            "optimizer_bytes": optimizer_bytes,
            "device_bytes": hbm,
            "fits_device": argument_bytes <= hbm,
        },
        "roofline": terms,
    }
    if report_dir is not None:
        out = Path(report_dir) / f"{arch_name}__{shape}__{mesh_name}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2))
    if verbose:
        print(f"[OK] {arch_name}/{shape}/{mesh_name}: "
              f"args/device={argument_bytes / 1e9:.3f} GB "
              f"(opt {optimizer_bytes / 1e9:.3f}) "
              f"model_flops={mf:.3e} fits={report['memory']['fits_device']}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", choices=MESHES + ("both", "all"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--report-dir", type=str, default=str(REPORT_DIR))
    args = ap.parse_args(argv)

    if args.all:
        cells = [(n, s) for n in list_archs() for s in get_arch(n).shapes]
    else:
        if args.arch is None:
            ap.error("name --arch or --all")
        arch = get_arch(args.arch)
        shapes = [args.shape] if args.shape else list(arch.shapes)
        cells = [(args.arch, s) for s in shapes]
    meshes = {"both": ("single", "multi"), "all": MESHES}.get(
        args.mesh, (args.mesh,))
    rdir = Path(args.report_dir)
    failures = []
    for name, shape in cells:
        for mesh_name in meshes:
            tag = f"{name}__{shape}__{mesh_name}"
            if args.skip_existing and (rdir / f"{tag}.json").exists():
                print(f"[skip] {tag}")
                continue
            try:
                run_cell(name, shape, mesh_name, rdir)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append(tag)
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        return 1
    print(f"\nAll {len(cells) * len(meshes)} dry-run cells reckoned.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
